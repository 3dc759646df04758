"""Port parity, the sparse layer: specs and masks bit-equal to the JAX
package's, and ``cb_linear_apply``'s forward, dX and d_tiles against
``jax.vjp`` of the reference layer, with the same weights carried across by
``from_numpy``.

Tolerances: specs and masks bit for bit; 1e-5 (rtol and atol) between the
two packages' float32 results (sums of at most a few hundred products in
another order); ``gradcheck``'s own float64 tolerances.
"""
import dataclasses
import gc
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import linear as JL
from repro.sparse import prune as JP
from repro_torch import errors as terrors
from repro_torch import sparse as tsparse
from repro_torch.sparse import linear as TL
from repro_torch.sparse import prune as TP

TOL = dict(rtol=1e-5, atol=1e-5)
SPEC_ARRAYS = ("brow", "bcol", "t_perm", "browT", "bcolT")
SPEC_CASES = [  # (in, out, B, keep, seed)
    (96, 64, 16, 0.4, 0), (64, 96, 16, 0.25, 1), (48, 40, 8, 0.6, 2), (256, 128, 32, 0.5, 1),
    (200, 72, 24, 0.1, 5), (4096, 14336, 128, 0.25, 42), (14336, 4096, 128, 0.25, 44),
]


def _assert_spec_equal(want, got):
    for f in SPEC_ARRAYS:
        a, b = np.asarray(getattr(want, f)), np.asarray(getattr(got, f))
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f
    for f in ("in_features", "out_features", "block_size", "keep_fraction", "mb", "nb"):
        assert getattr(want, f) == getattr(got, f), f
    assert got.num_tiles == want.num_tiles and got.density == want.density
    assert got.flops_per_token() == want.flops_per_token()


def _fields(spec):
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}


@pytest.mark.parametrize("case", SPEC_CASES, ids=[f"{c[0]}x{c[1]}-B{c[2]}" for c in SPEC_CASES])
def test_spec_random_bit_equal(case):
    i, o, B, keep, seed = case
    kw = dict(block_size=B, keep_fraction=keep, seed=seed)
    _assert_spec_equal(JL.cb_spec_random(i, o, **kw), TL.cb_spec_random(i, o, **kw))


@pytest.mark.parametrize("seed", range(4))
def test_masks_and_spec_from_mask_bit_equal(seed):
    rng = np.random.default_rng(seed)
    m, n, B = (40, 72, 8) if seed % 2 else (64, 96, 16)
    w = rng.standard_normal((m, n)).astype(np.float32)
    if seed == 3:
        w[: m // 2] = 0.0                       # empty block rows: coverage picks
        w[-1, :] = 1.0                          # ties at the threshold
    for keep in (0.1, 0.25, 0.6):
        want = JP.block_sparsity_pattern(w, B, keep)
        got = TP.block_sparsity_pattern(w, B, keep)
        np.testing.assert_array_equal(got, want)
        pw, pm = TP.block_magnitude_prune(w, B, keep)
        jw, jm = JP.block_magnitude_prune(w, B, keep)
        np.testing.assert_array_equal(pw, jw)
        np.testing.assert_array_equal(pm, jm)
        kw = dict(block_size=B, keep_fraction=keep)
        spec = TL.spec_from_mask(got, n, m, **kw)
        _assert_spec_equal(JL.spec_from_mask(want, n, m, **kw), spec)
        np.testing.assert_array_equal(TL.spec_block_mask(spec), JL.spec_block_mask(
            JL.spec_from_mask(want, n, m, **kw)))
        np.testing.assert_array_equal(TL.gather_tiles(w, spec),
                                      JL.gather_tiles(w, JL.spec_from_mask(want, n, m, **kw)))


def test_spec_from_mask_row_coverage_and_validation():
    mask = np.zeros((2, 3), bool)
    mask[0, 2] = True                            # block row 1 empty -> pad at (1, 0)
    spec = TL.spec_from_mask(mask, 48, 32, block_size=16, keep_fraction=0.1)
    assert (1, 0) in set(zip(spec.brow.tolist(), spec.bcol.tolist()))
    _assert_spec_equal(JL.spec_from_mask(mask, 48, 32, block_size=16, keep_fraction=0.1), spec)
    with pytest.raises(terrors.InvalidArgError, match="block grid"):
        TL.spec_from_mask(np.zeros((3, 3), bool), 48, 32, block_size=16, keep_fraction=0.1)


def test_refreeze_schedule_and_same_object_contract():
    for step, k in ((0, 3), (3, 3), (4, 3), (6, 3), (5, 0)):
        assert TP.refreeze_due(step, k) == JP.refreeze_due(step, k)
    g = torch.Generator().manual_seed(0)
    params, spec = TL.cb_linear_init(g, 64, 48, block_size=16, keep_fraction=0.5, device="cpu")
    p2, s2, changed = TP.refreeze_spec(params, spec)
    assert not changed and p2 is params and s2 is spec          # mask-stable: same objects
    # drift: zero the strongest tile, so a new block enters the top set
    tiles = params["tiles"].clone()
    tiles[tiles.abs().sum((1, 2)).argmax()] = 0
    drifted = {"tiles": tiles}
    p3, s3, changed = TP.refreeze_spec(drifted, spec)
    assert changed and s3 is not spec and p3["tiles"].dtype == tiles.dtype
    jparams = {"tiles": jnp.asarray(tiles.numpy())}
    jp3, js3, jchanged = JP.refreeze_spec(jparams, JL.spec_from_mask(
        TL.spec_block_mask(spec), 64, 48, block_size=16, keep_fraction=0.5))
    assert jchanged
    _assert_spec_equal(js3, s3)
    np.testing.assert_array_equal(p3["tiles"].numpy(), np.asarray(jp3["tiles"]))


def test_linear_init_structure_and_dense_equivalent():
    g = torch.Generator().manual_seed(3)
    params, spec = TL.cb_linear_init(g, 64, 48, block_size=16, keep_fraction=0.5, device="cpu")
    again = TL.spec_from_mask(TL.spec_block_mask(spec), 64, 48, block_size=16, keep_fraction=0.5)
    _assert_spec_equal(spec, again)
    W = TL.dense_equivalent(params, spec)
    assert tuple(W.shape) == (64, 48)
    jW = JL.dense_equivalent({"tiles": jnp.asarray(params["tiles"].numpy())},
                             JL.spec_from_mask(TL.spec_block_mask(spec), 64, 48,
                                               block_size=16, keep_fraction=0.5))
    np.testing.assert_array_equal(W.numpy(), np.asarray(jW))
    np.testing.assert_array_equal(TL.gather_tiles(W.numpy().T, spec), params["tiles"].numpy())


LAYER_CASES = [  # (in, out, B, keep, group_size, lead)
    (96, 64, 16, 0.4, None, (3, 5)), (64, 96, 16, 0.25, 4, (4,)), (48, 40, 8, 0.6, 1, (2, 3)),
    (200, 72, 24, 0.3, 16, (7,)), (256, 128, 128, 0.5, None, (2, 4)),
]


@pytest.mark.parametrize("case", LAYER_CASES, ids=[f"{c[0]}x{c[1]}-B{c[2]}-G{c[4]}"
                                                   for c in LAYER_CASES])
def test_apply_forward_and_grads_vs_jax_vjp(case):
    """y, dX and d_tiles, both impls, against ``jax.vjp`` of the JAX layer
    (Pallas in interpret mode), the same tiles carried over by ``from_numpy``."""
    i, o, B, keep, G, lead = case
    jspec = JL.cb_spec_random(i, o, block_size=B, keep_fraction=keep, seed=B)
    rng = np.random.default_rng(i + o)
    tiles = (rng.standard_normal((jspec.num_tiles, B, B)) * i**-0.5).astype(np.float32)
    x = rng.standard_normal((*lead, i)).astype(np.float32)
    gy = rng.standard_normal((*lead, o)).astype(np.float32)

    def layer(t, xx):
        return JL.cb_linear_apply({"tiles": t}, jspec, xx, impl="pallas", interpret=True,
                                  group_size=G)

    y, vjp = jax.vjp(layer, jnp.asarray(tiles), jnp.asarray(x))
    dt, dx = vjp(jnp.asarray(gy))
    params, spec = TL.from_numpy({"tiles": tiles}, _fields(jspec), device="cpu")
    _assert_spec_equal(jspec, spec)
    for impl in ("cuda", "reference"):
        t = params["tiles"].clone().requires_grad_(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        yt = TL.cb_linear_apply({"tiles": t}, spec, xt, impl=impl, group_size=G, device="cpu")
        yt.backward(torch.from_numpy(gy))
        assert yt.dtype == torch.float32 and tuple(yt.shape) == (*lead, o)
        np.testing.assert_allclose(yt.detach().numpy(), y, **TOL, err_msg=impl)
        np.testing.assert_allclose(xt.grad.numpy(), dx, **TOL, err_msg=impl)
        np.testing.assert_allclose(t.grad.numpy(), dt, **TOL, err_msg=impl)


def test_gradcheck_float64():
    spec = TL.cb_spec_random(24, 16, block_size=8, keep_fraction=0.5, seed=1)
    g = torch.Generator().manual_seed(0)
    t = torch.randn(spec.num_tiles, 8, 8, generator=g, dtype=torch.float64, requires_grad=True)
    x = torch.randn(3, 24, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b: TL.cb_linear_apply({"tiles": a}, spec, b, impl="reference", device="cpu"),
        (t, x))


def test_bfloat16_tiles_keep_their_dtype_in_grads():
    spec = TL.cb_spec_random(32, 48, block_size=16, keep_fraction=0.5, seed=0)
    params = TL.cb_tiles_init(torch.Generator().manual_seed(1), spec, torch.bfloat16, device="cpu")
    t = params["tiles"].requires_grad_(True)
    x = torch.randn(5, 32, requires_grad=True)
    y = TL.cb_linear_apply({"tiles": t}, spec, x, device="cpu")
    y.sum().backward()
    assert t.grad.dtype == torch.bfloat16 and x.grad.dtype == torch.float32
    want = x.detach() @ TL.dense_equivalent({"tiles": t.detach().float()}, spec)
    np.testing.assert_allclose(y.detach().numpy(), want.numpy(), **TOL)


def test_module_forward_backward_and_cache():
    spec = TL.cb_spec_random(40, 24, block_size=8, keep_fraction=0.5, seed=4)
    layer = tsparse.CBSparseLinear(spec, generator=torch.Generator().manual_seed(2), device="cpu")
    assert [n for n, _ in layer.named_parameters()] == ["tiles"]
    assert "tiles=" in repr(layer)
    x = torch.randn(6, 40)
    y = layer(x)
    assert torch.equal(y, TL.cb_linear_apply({"tiles": layer.tiles}, spec, x, device="cpu"))
    y.square().mean().backward()
    assert layer.tiles.grad is not None and layer.tiles.grad.shape == layer.tiles.shape
    # one device state per (spec, impl, group size, device), reused by every call
    per_spec = TL._MATMUL_CACHE[spec]
    assert list(per_spec) == [("cuda", None, "cpu", None)]
    assert TL._cached_matmul(spec, "cuda", None, "cpu") is next(iter(per_spec.values()))


def test_matmul_cache_drops_dead_specs():
    before = len(TL._MATMUL_CACHE)
    specs = [TL.cb_spec_random(64, 64, block_size=16, keep_fraction=0.5, seed=s) for s in range(6)]
    for spec in specs:
        assert TL._cached_matmul(spec, "reference", None, "cpu") is \
            TL._cached_matmul(spec, "reference", None, "cpu")
    assert len(TL._MATMUL_CACHE) >= before + 6
    del specs, spec
    gc.collect()
    assert len(TL._MATMUL_CACHE) <= before


def test_plan_and_argument_contract():
    spec = TL.cb_spec_random(32, 32, block_size=8, keep_fraction=0.5, seed=0)
    params = TL.cb_tiles_init(torch.Generator().manual_seed(0), spec, device="cpu")
    x = torch.randn(3, 32)
    want = TL.cb_linear_apply(params, spec, x, device="cpu", group_size=4)
    plan = types.SimpleNamespace(block_size=8, group_size=4)
    assert torch.equal(TL.cb_linear_apply(params, spec, x, device="cpu", plan=plan), want)
    for kw in (dict(plan=plan, group_size=2), dict(impl="pallas"), dict(group_size=0)):
        with pytest.raises(terrors.InvalidArgError):
            TL.cb_linear_apply(params, spec, x, device="cpu", **kw)
    with pytest.raises(terrors.InvalidArgError):
        TL.from_numpy({"tiles": np.zeros((1, 8, 8))}, {"brow": spec.brow}, device="cpu")


def test_entry_points_run_on_cuda_by_default():
    spec = TL.cb_spec_random(32, 32, block_size=8, keep_fraction=0.5, seed=0)
    params = TL.cb_tiles_init(torch.Generator().manual_seed(0), spec, device="cpu")
    if torch.cuda.is_available():
        with pytest.raises(terrors.InvalidArgError):
            TL.cb_linear_apply(params, spec, torch.zeros(2, 32))     # CPU tiles, CUDA call
        return
    for call in (lambda: TL.cb_linear_apply(params, spec, torch.zeros(2, 32)),
                 lambda: tsparse.CBSparseLinear(spec),
                 lambda: TL.cb_tiles_init(torch.Generator(), spec),
                 lambda: TL.cb_linear_init(torch.Generator(), 32, 32, block_size=8)):
        with pytest.raises(terrors.DeviceUnavailableError):
            call()
