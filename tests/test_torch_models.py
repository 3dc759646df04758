"""The port's LM stack (``repro_torch.configs`` / ``repro_torch.models``)
against the JAX package's, at smoke size on the CPU.

Every case builds its inputs with numpy from a seed and hands the same
arrays (and, for whole models, the JAX ``Model.init`` weights through
``params_from_numpy``) to both packages. Tolerances:

* float32: ``F32_TOL`` (1e-4 of the result's scale for
  whole models; both sides sum the same float32 products in another order,
  measured ~3e-6 at logits of scale 4);
* bfloat16: ``BF16_TOL`` = 2^-5 of the result's scale. bf16 keeps 8
  significant bits (a step of 2^-8 relative). XLA drops or keeps roundings
  between ops where the port rounds after every op (its bf16 sigmoid, for
  one, rounds after exp, add and divide), so activations differ by an ulp
  here and there, and after two layers and the unembedding the logits by a
  few ulps of their scale (measured up to 1.4%). The bound leaves 2x.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import Model as JModel
from repro.models import layers as JL
from repro_torch import configs as tconfigs
from repro_torch import errors as terrors
from repro_torch.models import Model as TModel, params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

F32_TOL = 1e-4
BF16_TOL = 2.0**-5
ALL_ARCHS = jconfigs.ARCH_IDS + ("cb-paper",)
DENSE_ARCHS = ("granite-8b", "qwen3-32b", "stablelm-3b", "phi3-mini-3.8b", "internvl2-2b",
               "cb-paper")


def _np(a) -> np.ndarray:
    """A JAX or torch array as float32 numpy (bfloat16 widened exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol: float, what: str = "") -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err:.3e} > {tol} * {scale:.3e}"
    return err


def _both(x: np.ndarray, dtype: str):
    """The same numpy array as a JAX and a torch array of ``dtype``."""
    j = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    t = torch.from_numpy(np.ascontiguousarray(x)).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return j, t


def _tol(dtype: str) -> float:
    return BF16_TOL if dtype == "bfloat16" else F32_TOL


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_fields_and_param_counts_match(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    j, t = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert (t.padded_vocab, t.resolved_head_dim) == (j.padded_vocab, j.resolved_head_dim)
    assert t.activation_dtype == {"bfloat16": torch.bfloat16,
                                  "float32": torch.float32}[j.dtype]
    assert t.scaled(dtype="float32").activation_dtype == torch.float32
    for name, shape in jconfigs.SHAPES.items():
        assert dataclasses.asdict(tconfigs.SHAPES[name]) == dataclasses.asdict(shape)
        assert tconfigs.supports_shape(t, tconfigs.SHAPES[name]) == \
            jconfigs.supports_shape(j, shape)


def test_registry_matches():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.cells() == jconfigs.cells()
    assert {a: dataclasses.asdict(c) for a, c in tconfigs.all_configs().items()} == \
        {a: dataclasses.asdict(c) for a, c in jconfigs.all_configs().items()}
    with pytest.raises(KeyError, match="cb-paper"):
        tconfigs.get_config("no-such-arch")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 128)).astype(np.float32) * 3
    w = rng.standard_normal(128).astype(np.float32)
    jx, tx = _both(x, dtype)
    got = TL.rmsnorm(tx, torch.from_numpy(w))
    assert got.dtype == tx.dtype
    _close(got, JL.rmsnorm(jx, jnp.asarray(w)), 1e-6 if dtype == "float32" else 2.0**-8)


@pytest.mark.parametrize("theta", [10_000.0, 1e7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(theta, dtype):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    jc, js = JL.rope_angles(jnp.asarray(pos), 32, theta)
    tc, ts = TL.rope_angles(torch.from_numpy(pos), 32, theta)
    _close(tc, jc, 1e-5, "cos")
    _close(ts, js, 1e-5, "sin")
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    jx, tx = _both(x, dtype)
    got = TL.apply_rope(tx, tc[..., None, :], ts[..., None, :])
    assert got.dtype == tx.dtype
    _close(got, JL.apply_rope(jx, jc[..., None, :], js[..., None, :]),
           1e-5 if dtype == "float32" else 2.0**-7)


ATTN_CASES = {
    # name: (B, Sq, Sk, H, Hkv, kwargs)
    "gqa_causal": (2, 16, 16, 4, 2, dict(causal=True)),
    "mha_causal": (1, 12, 12, 4, 4, dict(causal=True)),
    "chunked_ragged": (2, 40, 40, 4, 1, dict(causal=True, chunk=16)),
    "chunked_window": (1, 48, 48, 4, 2, dict(causal=True, chunk=16, window=8)),
    "window": (2, 20, 20, 2, 1, dict(causal=True, window=5)),
    "noncausal": (2, 6, 10, 4, 2, dict(causal=False)),
    "decode_valid_len": (3, 1, 16, 4, 2, dict(causal=False, kv_valid_len=[1, 7, 16])),
    "offset": (1, 4, 12, 2, 2, dict(causal=True, q_offset=8)),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_core(case, dtype):
    B, Sq, Sk, H, Hkv, kw = ATTN_CASES[case]
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((B, S, h, 16)).astype(np.float32)
               for S, h in ((Sq, H), (Sk, Hkv), (Sk, Hkv)))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    jkw, tkw = dict(kw), dict(kw)
    if "kv_valid_len" in kw:
        vl = np.asarray(kw["kv_valid_len"], np.int32)
        jkw["kv_valid_len"], tkw["kv_valid_len"] = jnp.asarray(vl), torch.from_numpy(vl)
    got = TL.attention_core(tq, tk, tv, **tkw)
    assert got.dtype == tq.dtype
    vl = jkw.pop("kv_valid_len", None)
    want = jax.jit(lambda q, k, v, vl: JL.attention_core(q, k, v, kv_valid_len=vl, **jkw))(
        jq, jk, jv, vl)
    _close(got, want, 1e-5 if dtype == "float32" else 2.0**-7, case)


def test_scatter_step_is_the_reference_blend_bit_for_bit():
    rng = np.random.default_rng(3)
    for dtype in ("float32", "bfloat16"):
        cache = rng.standard_normal((3, 10, 2, 8)).astype(np.float32)
        kv = rng.standard_normal((3, 1, 2, 8)).astype(np.float32)
        slot = np.array([0, 9, 4], np.int32)
        (jc, tc), (jkv, tkv) = _both(cache, dtype), _both(kv, dtype)
        want = JL._scatter_step(jc, jkv, jnp.asarray(slot))
        before = tc.clone()
        got = TL._scatter_step(tc, tkv, torch.from_numpy(slot))
        assert got is tc                                  # in place, as documented
        assert not torch.equal(before, got)
        np.testing.assert_array_equal(_np(got).view(np.uint32), _np(want).view(np.uint32))


def test_decode_cache_and_vocab_mask():
    cfg_j = jconfigs.get_smoke_config("mixtral-8x7b")    # SWA: the cache keeps the window
    cfg_t = tconfigs.get_smoke_config("mixtral-8x7b")
    for max_len in (16, 100):
        j = JL.decode_cache_init(cfg_j, 2, max_len, 3)
        t = TL.decode_cache_init(cfg_t, 2, max_len, 3, device="cpu")
        for name in ("k", "v", "pos"):
            assert tuple(t[name].shape) == j[name].shape
            assert not t[name].any()
        assert t["k"].dtype == torch.bfloat16 and t["pos"].dtype == torch.int32
    np.testing.assert_array_equal(TL.vocab_logit_mask(500, 512).numpy(),
                                  np.asarray(JL.vocab_logit_mask(500, 512)))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "cb_sparse"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply(sparse, dtype):
    arch = "cb-paper" if sparse else "granite-8b"
    jc = jconfigs.get_smoke_config(arch).scaled(dtype=dtype)
    tc = tconfigs.get_smoke_config(arch).scaled(dtype=dtype)
    jspecs, tspecs = JL.build_mlp_specs(jc), TL.build_mlp_specs(tc)
    params, _, _ = JL.mlp_init(jax.random.PRNGKey(0), jc, specs=jspecs)
    if sparse:
        tparams = {k: {"tiles": torch.from_numpy(np.array(v["tiles"]))}
                   for k, v in params.items()}
    else:
        tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    x = np.random.default_rng(4).standard_normal((2, 5, jc.d_model)).astype(np.float32)
    jx, tx = _both(x, dtype)
    want = jax.jit(lambda p, x: JL.mlp_apply(p, jc, x, specs=jspecs))(params, jx)
    for impl in ("cuda", "reference"):             # on CPU tensors: the plain versions
        got = TL.mlp_apply(tparams, tc, tx, specs=tspecs, impl=impl)
        assert got.dtype == tx.dtype
        _close(got, want, 1e-5 if dtype == "float32" else 2.0**-7, impl)


def test_mlp_specs_are_the_references():
    for arch in ("cb-paper",):
        for get in ("get_config", "get_smoke_config"):
            j = JL.build_mlp_specs(getattr(jconfigs, get)(arch))
            t = TL.build_mlp_specs(getattr(tconfigs, get)(arch))
            for name in ("gate", "up", "down"):
                for f in ("brow", "bcol", "t_perm", "browT", "bcolT"):
                    np.testing.assert_array_equal(getattr(t[name], f), getattr(j[name], f))
                assert (t[name].mb, t[name].nb, t[name].num_tiles) == \
                    (j[name].mb, j[name].nb, j[name].num_tiles)
    assert TL.build_mlp_specs(tconfigs.get_config("granite-8b")) is None


# ---------------------------------------------------------------------------
# whole models: forward and teacher-forced decode, same weights
# ---------------------------------------------------------------------------

def _models(arch: str, dtype: str):
    jc = jconfigs.get_smoke_config(arch).scaled(dtype=dtype)
    tc = tconfigs.get_smoke_config(arch).scaled(dtype=dtype)
    jm = JModel(jc)
    params, _ = jm.init(jax.random.PRNGKey(0))
    tm = TModel(tc, "cpu")
    tp = params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jm, params, tm, tp


@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_decode_match_the_reference(arch, dtype):
    jm, params, tm, tp = _models(arch, dtype)
    cfg = tm.cfg
    rng = np.random.default_rng(5)
    B, S = 2, 8
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jkw, tkw = {}, {}
    if cfg.family == "vlm":
        pe = rng.standard_normal((B, cfg.num_patches, cfg.d_model)).astype(np.float32)
        jkw["patch_embeds"], tkw["patch_embeds"] = _both(pe, dtype)
    tol = _tol(dtype)
    want = jax.jit(lambda p, t, kw: jm.forward(p, t, **kw).logits)(params, jnp.asarray(toks),
                                                                    jkw)
    with torch.no_grad():
        out = tm.forward(tp, torch.from_numpy(toks), **tkw)
    assert out.logits.dtype == cfg.activation_dtype
    _close(out.logits, want, tol, "forward")
    last = tm.forward(tp, torch.from_numpy(toks), last_only=True, **tkw).logits
    assert torch.equal(last, out.logits[:, -1:])

    jstep = jax.jit(jm.decode_step)
    jst, tst = jm.init_decode_state(B, S + 4), tm.init_decode_state(B, S + 4)
    got, ref = [], []
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        lg, jst = jstep(params, jst, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos))
        tl, tst = tm.decode_step(tp, tst, torch.from_numpy(toks[:, t:t + 1]),
                                 torch.from_numpy(pos))
        ref.append(_np(lg))
        got.append(_np(tl))
    got, ref = np.stack(got, 1), np.stack(ref, 1)
    _close(got, ref, tol, "decode")
    assert int(tst["pos"][0]) == S
    if cfg.family != "vlm":
        # the port's own decode against its forward (the reference's check)
        _close(got, out.logits, 2e-3 if dtype == "float32" else tol, "decode vs forward")


def test_decode_step_does_not_write_its_input_state():
    _, _, tm, tp = _models("cb-paper", "float32")
    st = tm.init_decode_state(2, 6)
    toks = torch.tensor([[3], [7]], dtype=torch.int32)
    pos = torch.tensor([0, 4], dtype=torch.int32)
    lg1, st1 = tm.decode_step(tp, st, toks, pos)
    copy = {k: v.clone() for k, v in st1.items()}
    lg2, st2 = tm.decode_step(tp, st1, toks, pos + 1)
    lg3, st3 = tm.decode_step(tp, st1, toks, pos + 1)      # a retried step
    assert all(torch.equal(copy[k], st1[k]) for k in copy)
    assert torch.equal(lg2, lg3) and all(torch.equal(st2[k], st3[k]) for k in st2)
    assert not torch.equal(st1["k"], st2["k"])


def test_params_from_numpy_is_bit_equal():
    jm, params, tm, tp = _models("cb-paper", "bfloat16")
    tree = jax.tree_util.tree_map(np.asarray, params)
    assert torch.equal(tp.embed, torch.from_numpy(tree["embed"]))
    assert torch.equal(tp.unembed, torch.from_numpy(tree["unembed"]))
    for i, layer in enumerate(tp.layers):
        assert torch.equal(layer.attn["wq"], torch.from_numpy(tree["layers"]["attn"]["wq"][i]))
        for k in ("gate", "up", "down"):
            assert torch.equal(layer.ffn[k],
                               torch.from_numpy(tree["layers"]["ffn"][k]["tiles"][i]))
        assert torch.equal(layer.norm2, torch.from_numpy(tree["layers"]["norm2"][i]))
    assert len(tp.layers) == tm.cfg.num_layers
    assert sum(p.numel() for p in tp.parameters()) == \
        sum(a.size for a in jax.tree_util.tree_leaves(tree))


def test_port_init_shapes_and_vocab_padding():
    cfg = tconfigs.get_smoke_config("granite-8b").scaled(vocab_size=500)   # pads to 512
    model = TModel(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    jparams, _ = JModel(jconfigs.get_smoke_config("granite-8b").scaled(vocab_size=500)).init(
        jax.random.PRNGKey(0))
    assert sum(p.numel() for p in params.parameters()) == \
        sum(a.size for a in jax.tree_util.tree_leaves(jparams))
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, 500, (2, 8)).astype(np.int32))
    with torch.no_grad():
        logits = model.forward(params, toks).logits.float()
    assert logits.shape == (2, 8, 512) and (logits[..., 500:] < -1e8).all()


def test_unknown_family_raises():
    cfg = tconfigs.get_smoke_config("granite-8b").scaled(family="rnn")
    with pytest.raises(terrors.InvalidArgError, match="unknown family 'rnn'"):
        TModel(cfg, "cpu")
    with pytest.raises(terrors.InvalidArgError, match="unknown family"):
        TT.lm_init(torch.Generator(), cfg, device="cpu")
    with pytest.raises(terrors.InvalidArgError):
        params_from_numpy(cfg, {}, device="cpu")


def test_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    with pytest.raises(terrors.DeviceUnavailableError):
        TModel(tconfigs.get_smoke_config("cb-paper"))
