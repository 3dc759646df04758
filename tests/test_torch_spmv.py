"""Port parity, the slice as a whole: ``repro_torch.kernels.ops.cb_spmv`` on
the CPU against ``repro.kernels.ops.cb_spmv`` (Pallas kernels in interpret
mode, and the reference path), fed the same stream bytes and the same x.

Tolerance 1e-5 between the two packages (float32 sums in another order);
integer-valued data bit for bit; 3e-4 against the float64-free
``dense_oracle`` as in the JAX package's own conformance tests.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import streams as jstreams
from repro.core.spmv_ref import dense_oracle
from repro.kernels import ops as jops
from repro_torch import errors as terrors
from repro_torch.core import CBMatrix as TorchCBMatrix
from repro_torch.core import streams as tstreams
from repro_torch.kernels import ops as tops

import torch_port as tp

TOL = dict(rtol=1e-5, atol=1e-5)
# one group size per scenario, taken in turn, so that every structure, block
# size and group size is reached while each distinct shape compiles once
PACKED = [(s, (4, 16)[i % 2]) for i, s in enumerate(tp.scenario_cut(11))]
FLAT = [(s, (None, 1, 4)[i % 3]) for i, s in enumerate(tp.scenario_cut(13))]


def _x(n, seed=3):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("scn,G", PACKED, ids=[f"{s.name}-G{g}" for s, g in PACKED])
def test_packed_streams_vs_jax(scn, G):
    rows, cols, vals, shape = scn.build_coo()
    js = jstreams.build_super_streams(scn.build(), group_size=G)
    ts = tstreams.build_super_streams(tp.torch_cb(scn), group_size=G)   # the port's own build
    x = _x(shape[1])
    y_pallas = np.asarray(jops.cb_spmv(js.device_put(), jnp.asarray(x), impl="pallas",
                                       interpret=True))
    y_ref = np.asarray(jops.cb_spmv(js.device_put(), jnp.asarray(x), impl="reference"))
    y = tops.cb_spmv(ts, x, device="cpu")
    assert y.dtype == torch.float32 and tuple(y.shape) == (shape[0],)
    np.testing.assert_allclose(y.numpy(), y_pallas, **TOL)
    np.testing.assert_allclose(tops.cb_spmv(ts, x, impl="reference", device="cpu").numpy(),
                               y_ref, **TOL)
    expected = dense_oracle(rows, cols, vals.astype(np.float32), shape, x)
    np.testing.assert_allclose(y.numpy(), expected, rtol=3e-4, atol=3e-4)
    assert torch.equal(y, tops.cb_spmv(ts, torch.from_numpy(x), device="cpu"))


@pytest.mark.parametrize("scn,G", FLAT, ids=[f"{s.name}-G{g}" for s, g in FLAT])
def test_flat_streams_and_group_size_vs_jax(scn, G):
    js = jstreams.build_streams(scn.build())
    ts = tp.to_torch_streams(js)                                         # the JAX package's bytes
    x = _x(js.n)
    y_pallas = np.asarray(jops.cb_spmv(js.device_put(), jnp.asarray(x), impl="pallas",
                                       interpret=True, group_size=G))
    y = tops.cb_spmv(ts, x, device="cpu", group_size=G)
    np.testing.assert_allclose(y.numpy(), y_pallas, **TOL)
    y_ref = np.asarray(jops.cb_spmv(js.device_put(), jnp.asarray(x), impl="reference"))
    np.testing.assert_allclose(tops.cb_spmv(ts, x, impl="reference", device="cpu").numpy(),
                               y_ref, **TOL)
    # launch accounting: pure shape arithmetic, equal to the JAX package's
    assert tops.spmv_launch_stats(ts, G) == jops.spmv_launch_stats(js, G)
    sup = tops._regroup(ts, G or 1)
    stats = tops.spmv_launch_stats(ts, G)
    assert stats["padded"] == sup.padded_work()
    assert stats["steps"] == {"dense": sup.num_dense_groups, "panel": sup.num_panel_groups,
                              "coo": sup.num_coo_groups}


@pytest.mark.parametrize("B", [8, 16, 24])
@pytest.mark.parametrize("G", [1, 4, 16])
def test_integer_data_bit_equal_to_jax(B, G):
    """Exact arithmetic: any difference is a packing or routing bug."""
    rng = np.random.default_rng(B * 100 + G)
    m, n, nnz = 144, 136, 900
    r, c = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    _, idx = np.unique(r * n + c, return_index=True)
    r, c = r[idx], c[idx]
    v = rng.integers(1, 8, len(r)).astype(np.float32)
    x = rng.integers(-4, 5, n).astype(np.float32)
    tcb = TorchCBMatrix.from_coo(r, c, v, (m, n), block_size=B)
    flat, packed = tstreams.build_streams(tcb), tstreams.build_super_streams(tcb, group_size=G)
    from repro.core import CBMatrix as JaxCBMatrix
    jcb = JaxCBMatrix.from_coo(r, c, v, (m, n), block_size=B)
    want = np.asarray(jops.cb_spmv(jstreams.build_super_streams(jcb, group_size=G).device_put(),
                                   jnp.asarray(x), impl="pallas", interpret=True))
    for got in (tops.cb_spmv(packed, x, device="cpu"),
                tops.cb_spmv(flat, x, device="cpu", group_size=G),
                tops.cb_spmv(flat, x, device="cpu"),
                tops.cb_spmv(packed, x, device="cpu", impl="reference"),
                tops.cb_spmv(flat, x, device="cpu", impl="reference")):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B", [8, 16, 24])
def test_bfloat16_payload_vs_jax(B):
    scn = tp.Scenario("block_clustered", B)
    js = jstreams.build_super_streams(scn.build(), group_size=4)
    import dataclasses
    js16 = dataclasses.replace(
        js, **{f: jnp.asarray(getattr(js, f)).astype(jnp.bfloat16)
               for f in ("dense_tiles", "panel_vals", "coo_vals")})
    x = _x(js.n)
    want = np.asarray(jops.cb_spmv(js16, jnp.asarray(x), impl="pallas", interpret=True))
    ts16 = tp.to_torch_streams(js).to("cpu", payload_dtype=torch.bfloat16)
    assert ts16.dense_tiles.dtype == torch.bfloat16
    got = tops.cb_spmv(ts16, x, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # same bytes whether the cast happens in torch or arrives as an ml_dtypes array
    via_numpy = tp.to_torch_streams(js16)
    assert torch.equal(via_numpy.panel_vals, ts16.panel_vals)
    assert torch.equal(tops.cb_spmv(via_numpy, x, device="cpu"), got)


def test_float64_payload_kernel_path_is_float32_reference_is_float64():
    scn = tp.Scenario("power_law", 16, dtype="float64")
    rows, cols, vals, shape = scn.build_coo()
    ts = tstreams.build_super_streams(tp.torch_cb(scn))
    x = _x(shape[1])
    y = tops.cb_spmv(ts, x, device="cpu")
    y_ref = tops.cb_spmv(ts, x, device="cpu", impl="reference")
    assert y.dtype == torch.float32 and y_ref.dtype == torch.float64
    expected = dense_oracle(rows, cols, vals, shape, x)
    np.testing.assert_allclose(y_ref.numpy(), expected, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y.numpy(), expected, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("fmt", ["coo", "csr", "dense"])
def test_empty_formats_are_skipped(fmt):
    """One format only: the other two streams are empty and launch nothing."""
    if fmt == "dense":
        m = n = 32
        rr, cc = np.meshgrid(np.arange(m), np.arange(n), indexing="ij")
        r, c = rr.ravel(), cc.ravel()
        v = np.random.default_rng(0).standard_normal(m * n)
        th = None
    else:
        m = n = 64
        r, c = np.arange(m), (np.arange(m) * 7) % n
        v = np.arange(1, m + 1, dtype=np.float64)
        from repro_torch.core.formats import FormatThresholds
        th = (FormatThresholds(th1=256, th2=256) if fmt == "coo"
              else FormatThresholds(th1=1, th2=256))
    kw = {} if th is None else {"thresholds": th}
    tcb = TorchCBMatrix.from_coo(r, c, v, (m, n), block_size=16, **kw)
    ts = tstreams.build_super_streams(tcb)
    present = {"dense": ts.num_dense_groups, "csr": ts.num_panel_groups,
               "coo": ts.num_coo_groups}
    assert [k for k, g in present.items() if g] == [fmt]
    x = _x(n)
    expected = dense_oracle(r, c, v.astype(np.float32), (m, n), x)
    np.testing.assert_allclose(tops.cb_spmv(ts, x, device="cpu").numpy(), expected,
                               rtol=3e-4, atol=3e-4)
    launches = tops.spmv_launch_stats(ts)["launches"]
    assert sum(launches.values()) == 1


def test_all_zero_matrix_gives_zeros():
    tcb = TorchCBMatrix.from_coo(np.zeros(0, int), np.zeros(0, int), np.zeros(0), (40, 24))
    for ts in (tstreams.build_streams(tcb), tstreams.build_super_streams(tcb)):
        for impl in ("cuda", "reference"):
            y = tops.cb_spmv(ts, _x(24), device="cpu", impl=impl)
            assert tuple(y.shape) == (40,) and not y.any()


def test_group_size_and_plan_conflicts():
    scn = tp.Scenario("uniform", 16)
    tcb = tp.torch_cb(scn)
    flat, packed = tstreams.build_streams(tcb), tstreams.build_super_streams(tcb, group_size=4)
    x = _x(flat.n)
    plan = types.SimpleNamespace(block_size=16, group_size=4)
    want = tops.cb_spmv(packed, x, device="cpu")
    # a plan supplies the group size; an agreeing explicit value is fine
    assert torch.equal(tops.cb_spmv(packed, x, device="cpu", plan=plan), want)
    assert torch.equal(tops.cb_spmv(packed, x, device="cpu", plan=plan, group_size=4), want)
    np.testing.assert_allclose(tops.cb_spmv(flat, x, device="cpu", plan=plan).numpy(),
                               want.numpy(), **TOL)
    bad = [
        dict(group_size=8),                                               # packed with 4
        dict(plan=types.SimpleNamespace(block_size=16, group_size=8)),    # plan vs stream
        dict(plan=plan, group_size=2),                                    # plan vs explicit
        dict(plan=types.SimpleNamespace(block_size=8, group_size=4)),     # plan's block size
        dict(group_size=0),
        dict(impl="pallas"),
    ]
    for kw in bad:
        with pytest.raises(terrors.InvalidArgError) as ei:
            tops.cb_spmv(packed, x, device="cpu", **kw)
        assert ei.value.code == terrors.INVALID_ARGUMENT
        with pytest.raises(terrors.InvalidArgError):
            tops.cb_spmv_into(torch.zeros(packed.m), packed, x, device="cpu", **kw)
    with pytest.raises(terrors.InvalidArgError):
        tops.cb_spmv(flat, x[:-1], device="cpu")                          # x's length


@pytest.mark.parametrize("impl", ["cuda", "reference"])
@pytest.mark.parametrize("kind", ["flat", "packed"])
def test_cb_spmv_into_accumulates_in_place(impl, kind):
    scn = tp.Scenario("ragged_tail", 16)
    rows, cols, vals, shape = scn.build_coo()
    tcb = tp.torch_cb(scn)
    ts = (tstreams.build_streams(tcb) if kind == "flat"
          else tstreams.build_super_streams(tcb, group_size=4))
    G = 4 if kind == "flat" else None
    x = _x(shape[1])
    y0 = np.random.default_rng(1).standard_normal(shape[0]).astype(np.float32)
    y_acc = torch.from_numpy(y0.copy())
    out = tops.cb_spmv_into(y_acc, ts, x, device="cpu", impl=impl, group_size=G)
    assert out is y_acc                          # the caller's own buffer, updated in place
    js = (jstreams.build_streams(scn.build()) if kind == "flat"
          else jstreams.build_super_streams(scn.build(), group_size=4))
    want = np.asarray(jops.cb_spmv_into(
        jnp.asarray(y0), js.device_put(), jnp.asarray(x),
        impl="pallas" if impl == "cuda" else "reference", interpret=True, group_size=G))
    np.testing.assert_allclose(y_acc.numpy(), want, **TOL)
    out2 = tops.cb_spmv_into(y_acc, ts, x, device="cpu", impl=impl, group_size=G)
    np.testing.assert_allclose(
        out2.numpy(), y0 + 2 * dense_oracle(rows, cols, vals.astype(np.float32), shape, x),
        rtol=6e-4, atol=6e-4)
    with pytest.raises(terrors.InvalidArgError):
        tops.cb_spmv_into(torch.zeros(shape[0] + 1), ts, x, device="cpu", impl=impl,
                          group_size=G)


def test_prepared_state_is_cached_on_the_stream():
    tcb = tp.torch_cb(tp.Scenario("banded", 16))
    flat = tstreams.build_streams(tcb)
    x = _x(flat.n)
    tops.cb_spmv(flat, x, device="cpu", group_size=4)
    first = flat._prepared[4]
    tops.cb_spmv(flat, x, device="cpu", group_size=4)
    assert flat._prepared[4] is first and set(flat._prepared) == {4}
    tops.cb_spmv(flat, x, device="cpu")
    assert set(flat._prepared) == {4, 1}
    assert "_prepared" not in flat.to("cpu").__dict__      # a moved copy starts clean


def test_streams_on_the_wrong_device_are_refused():
    ts = tstreams.build_super_streams(tp.torch_cb(tp.Scenario("uniform", 8)))
    if torch.cuda.is_available():
        with pytest.raises(terrors.InvalidArgError):
            tops.cb_spmv(ts, _x(ts.n))           # CPU streams, CUDA call
    else:
        with pytest.raises(terrors.DeviceUnavailableError):
            tops.cb_spmv(ts, _x(ts.n))


@pytest.mark.cuda
def test_cuda_path_bit_equal_runs_on_the_card():
    """impl='cuda' on the card: right, and the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(run `python3 chip_smoke.py` on the GPU machine)")
    scn = tp.Scenario("block_clustered", 16)
    rows, cols, vals, shape = scn.build_coo()
    s = tstreams.build_super_streams(tp.torch_cb(scn)).to()
    x = _x(shape[1])
    y = tops.cb_spmv(s, x)
    assert y.is_cuda and torch.equal(y, tops.cb_spmv(s, x))
    np.testing.assert_allclose(y.cpu().numpy(),
                               dense_oracle(rows, cols, vals.astype(np.float32), shape, x),
                               rtol=3e-4, atol=3e-4)
