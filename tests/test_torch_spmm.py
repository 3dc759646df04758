"""Port parity, the SpMM slice: tile streams, ``super_tile_spmm``'s plain
version, ``ops.cb_spmm`` and its accounting, against the JAX package
(Pallas kernel in interpret mode, and its reference path), fed the same
bytes and the same X.

Tolerances: 1e-5 (rtol and atol) between the two packages, float32 sums of
at most B products taken in another order; integer-valued data bit for bit;
3e-4 against the dense float32 product, as in the JAX package's own
conformance tests. Host artefacts (streams) are bit-equal.
"""
import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import streams as jstreams
from repro.core.spmv_ref import spmm_ref as j_spmm_ref
from repro.data import matrices as jmatrices
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import errors as terrors
from repro_torch.core import streams as tstreams
from repro_torch.core.spmv_ref import spmm_ref as t_spmm_ref
from repro_torch.kernels import cb_combine as t_combine
from repro_torch.kernels import cb_spmm as t_spmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

import torch_port as tp

j_spmm = importlib.import_module("repro.kernels.cb_spmm")

TOL = dict(rtol=1e-5, atol=1e-5)
ODD_NS = (1, 20, 100, 129)
STREAM_CASES = tp.scenario_cut(9)


def _jax_tiles(ts):
    """A JAX-package tile stream as device arrays (what its ops take)."""
    import jax
    return jax.tree_util.tree_map(jnp.asarray, ts)


# ---------------------------------------------------------------------------
# host: tile streams bit-equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scn", STREAM_CASES, ids=tp.ids(STREAM_CASES))
def test_tile_streams_bit_equal(scn):
    """Both builders and the super-tile packer, every group size."""
    rows, cols, vals, shape = scn.build_coo()
    want = jstreams.tile_stream_from_cb(scn.build())
    got = tstreams.tile_stream_from_cb(tp.torch_cb(scn))
    tp.assert_tiles_equal(want, got, scn.name)
    tp.assert_tiles_equal(jstreams.build_tile_stream(rows, cols, vals, shape, scn.block_size),
                          tstreams.build_tile_stream(rows, cols, vals, shape, scn.block_size),
                          scn.name + " from COO")
    for G in (None, 1, 4, 16):
        jsup, tsup = jstreams.build_super_tile_stream(want, G), tstreams.build_super_tile_stream(got, G)
        tp.assert_tiles_equal(jsup, tsup, f"{scn.name} G={G}")
        assert (tsup.num_groups, tsup.slots) == (jsup.num_groups, jsup.slots)
        assert tsup.padded_work() == jsup.padded_work()
        assert tsup.region_nbytes() == jsup.region_nbytes()
        assert tsup.val_itemsize == jsup.val_itemsize
    sup = tstreams.super_tile_stream_from_cb(tp.torch_cb(scn), group_size=4)
    tp.assert_tiles_equal(jstreams.super_tile_stream_from_cb(scn.build(), group_size=4), sup)


def test_super_tile_packer_keeps_bfloat16_bits():
    B = 16
    r, c, v = jmatrices.pruned_weight(120, 104, block_size=B, seed=9)
    jts = jstreams.build_tile_stream(r, c, v.astype(np.float32), (120, 104), B)
    jts.tiles = np.asarray(jnp.asarray(jts.tiles).astype(jnp.bfloat16))
    tts = tp.to_torch_tiles(jts)
    assert tts.tiles.dtype == torch.bfloat16
    tp.assert_tiles_equal(jstreams.build_super_tile_stream(jts, 4),
                          tstreams.build_super_tile_stream(tts, 4))


def test_tile_stream_from_numpy_and_to():
    ts = tstreams.tile_stream_from_cb(tp.torch_cb(tp.Scenario("banded", 16)))
    moved = ts.to("cpu", payload_dtype=torch.bfloat16)
    assert moved is not ts and moved.tiles.dtype == torch.bfloat16 and moved.val_itemsize == 2
    assert moved.brow.dtype == torch.int32 and torch.equal(moved.bcol, ts.bcol)
    assert moved.region_nbytes()["tiles"] * 2 == ts.region_nbytes()["tiles"]
    meta = {k: getattr(ts, k) for k in tp.TILE_META}
    back = tstreams.streams_from_numpy("tile", {f: getattr(ts, f).numpy() for f in tp.TILE_FIELDS},
                                       meta)
    assert type(back) is tstreams.TileStream and torch.equal(back.tiles, ts.tiles)
    with pytest.raises(terrors.InvalidArgError):
        tstreams.streams_from_numpy("super_tile", {"tiles": ts.tiles.numpy()}, meta)
    with pytest.raises(terrors.InvalidArgError):
        tstreams.build_super_tile_stream(ts, 0)


@pytest.mark.parametrize("N", ODD_NS)
def test_spmm_block_n_matches(N):
    for block_n in (128, 256, 512):
        assert tstreams.spmm_block_n(N, block_n) == jstreams.spmm_block_n(N, block_n)
    assert tstreams.LANE == jstreams.LANE
    with pytest.raises(terrors.InvalidArgError, match="multiple of 128"):
        tstreams.spmm_block_n(N, block_n=100)


def test_spmm_ref_matches_jax():
    scn = tp.Scenario("power_law", 16, True)
    X = np.random.default_rng(1).standard_normal((144, 5)).astype(np.float32)
    np.testing.assert_allclose(t_spmm_ref(tp.torch_cb(scn), X), j_spmm_ref(scn.build(), X),
                               **TOL)


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

PLAIN_CASES = [  # (B, Gt, groups, nb, N, tile dtype, X dtype)
    (8, 4, 3, 5, 20, "float32", "float32"),
    (16, 1, 5, 4, 1, "float32", "float32"),
    (24, 16, 2, 3, 100, "bfloat16", "float32"),
    (16, 4, 2, 6, 129, "float64", "bfloat16"),
    (128, 1, 1, 2, 129, "float32", "float32"),
    (128, 2, 1, 2, 20, "bfloat16", "bfloat16"),
]


@pytest.mark.parametrize("integer", [False, True], ids=["random", "integer"])
@pytest.mark.parametrize("case", PLAIN_CASES, ids=[f"B{c[0]}-G{c[1]}-N{c[4]}-{c[5]}-{c[6]}"
                                                   for c in PLAIN_CASES])
def test_plain_vs_pallas(case, integer):
    B, Gt, gt, nb, N, tdt, xdt = case
    rng = np.random.default_rng(B + N)
    draw = ((lambda s: rng.integers(-4, 5, s)) if integer else rng.standard_normal)
    # JAX runs without 64-bit types here: float64 tiles hold float32 values
    tiles = jnp.asarray(draw((gt, Gt * B, B)).astype(np.float32)).astype(
        "float32" if tdt == "float64" else tdt)
    bcol = rng.integers(0, nb, (gt, Gt)).astype(np.int32)
    Xb = jnp.asarray(draw((nb, B, N)).astype(np.float32)).astype(xdt)
    Npad = -(-N // 128) * 128
    want = np.asarray(j_spmm.super_tile_spmm(
        tiles, jnp.asarray(bcol), jnp.pad(Xb, ((0, 0), (0, 0), (0, Npad - N))),
        block_n=Npad, interpret=True))[..., :N]

    def tt(a):
        return tp.tstreams._as_tensor(np.asarray(a))

    args = (tt(tiles).to(getattr(torch, tdt)), torch.from_numpy(bcol), tt(Xb))
    for got in (t_spmm.super_tile_spmm_plain(*args), t_spmm.super_tile_spmm(*args)):
        assert got.dtype == torch.float32 and tuple(got.shape) == (gt, Gt, B, N)
        if integer:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_empty_slots_give_exact_zeros_and_empty_streams_launch_nothing():
    Xb = torch.randn(3, 16, 20)
    out = t_spmm.super_tile_spmm(torch.zeros(2, 64, 16), torch.zeros(2, 4, dtype=torch.int32), Xb)
    assert not out.any()
    before = t_spmm.super_tile_spmm.launches
    assert tuple(t_spmm.super_tile_spmm(torch.zeros(0, 64, 16), torch.zeros(0, 4, dtype=torch.int32),
                                        Xb).shape) == (0, 4, 16, 20)
    assert t_spmm.super_tile_spmm.launches == before      # counts CUDA launches only


def test_wrapper_checks_its_arguments():
    tiles, bcol, Xb = torch.zeros(2, 32, 16), torch.zeros(2, 2, dtype=torch.int32), torch.zeros(3, 16, 5)
    bad = [
        (tiles.half(), bcol, Xb),                               # tile dtype
        (tiles[:, :16], bcol, Xb),                              # tile shape
        (tiles, bcol.long(), Xb),                               # bcol dtype
        (tiles, bcol, Xb.double()),                             # X dtype
        (tiles, bcol, Xb.transpose(1, 2).contiguous().transpose(1, 2)),   # X layout
    ]
    for args in bad:
        with pytest.raises(terrors.InvalidArgError):
            t_spmm.super_tile_spmm(*args)


# ---------------------------------------------------------------------------
# the combine at SpMM's row width R = B*N
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,N", [(8, 1), (16, 20), (24, 129)])
def test_combine_at_wide_rows_drops_the_ragged_tail(B, N):
    rng = np.random.default_rng(N)
    m, T = 5 * B - 3, 40
    brow = rng.integers(0, 5, T).astype(np.int32)
    parts = rng.integers(-5, 5, (T, B, N)).astype(np.float32)
    Y = torch.full((m, N), 2.0)
    t_combine.segment_combine(Y.view(-1), torch.from_numpy(parts).view(T, B * N),
                              torch.from_numpy(brow), B * N)
    want = np.full((5 * B, N), 2.0, np.float32)
    np.add.at(want.reshape(5, B, N), brow, parts)
    np.testing.assert_array_equal(Y.numpy(), want[:m])
    plan = t_combine.plan_combine(torch.from_numpy(brow), "cpu")
    assert plan.num_slots == T and bool((plan.passes[-1].dst >= 0).all())


# ---------------------------------------------------------------------------
# ops.cb_spmm end to end on the CPU
# ---------------------------------------------------------------------------

OPS_SCENARIOS = [tp.Scenario("banded", 8, False), tp.Scenario("power_law", 16, True),
                 tp.Scenario("block_clustered", 16, "auto"), tp.Scenario("ragged_tail", 24, True),
                 tp.Scenario("empty_rows_cols", 16, "auto")]
OPS_CASES = [(s, G, ODD_NS[(i + gi) % 4]) for gi, G in enumerate((1, 4, 16))
             for i, s in enumerate(OPS_SCENARIOS) if (i + gi) % 3 == 0]


@pytest.mark.parametrize("scn,G,N", OPS_CASES, ids=[f"{s.name}-G{g}-N{n}" for s, g, n in OPS_CASES])
def test_cb_spmm_vs_jax(scn, G, N):
    """Flat and packed streams, both impls, against Pallas interpret and the
    JAX reference; the launch accounting equal to the reference's."""
    rows, cols, vals, shape = scn.build_coo()
    jts = jstreams.tile_stream_from_cb(scn.build())
    jsup = jstreams.build_super_tile_stream(jts, G)
    tts = tstreams.tile_stream_from_cb(tp.torch_cb(scn))
    tsup = tstreams.build_super_tile_stream(tts, G)
    X = np.random.default_rng(7).standard_normal((shape[1], N)).astype(np.float32)
    Xj = jnp.asarray(X)
    y_pallas = np.asarray(jops.cb_spmm(_jax_tiles(jsup), Xj, impl="pallas", interpret=True))
    y_ref = np.asarray(jops.cb_spmm(_jax_tiles(jts), Xj, impl="reference"))
    for got in (tops.cb_spmm(tsup, X, device="cpu"),
                tops.cb_spmm(tts, X, device="cpu", group_size=G)):
        assert got.dtype == torch.float32 and tuple(got.shape) == (shape[0], N)
        np.testing.assert_allclose(got.numpy(), y_pallas, **TOL)
    np.testing.assert_allclose(tops.cb_spmm(tts, X, device="cpu", impl="reference").numpy(),
                               y_ref, **TOL)
    np.testing.assert_allclose(tops.cb_spmm(tsup, X, device="cpu", impl="reference").numpy(),
                               y_ref, **TOL)
    dense = np.zeros(shape, np.float32)
    np.add.at(dense, (rows, cols), vals.astype(np.float32))
    np.testing.assert_allclose(y_ref, dense @ X, rtol=3e-4, atol=3e-4)
    for stream, jstream in ((tts, jts), (tsup, jsup)):
        for n_cols in (None, N):
            assert (tops.spmm_launch_stats(stream, G, n_cols=n_cols)
                    == jops.spmm_launch_stats(jstream, G, n_cols=n_cols))


@pytest.mark.parametrize("B", [8, 16, 24])
def test_integer_data_bit_equal_every_grouping(B):
    """Exact sums: flat, regrouped, packed and both impls give the same bits
    as the Pallas kernel; any difference is a lost or misrouted tile."""
    rng = np.random.default_rng(B)
    m, n = 136, 120
    r, c = rng.integers(0, m, 700), rng.integers(0, n, 700)
    _, idx = np.unique(r * n + c, return_index=True)
    r, c = r[idx], c[idx]
    v = rng.integers(1, 8, len(r)).astype(np.float32)
    X = rng.integers(-4, 5, (n, 20)).astype(np.float32)
    want = np.asarray(jops.cb_spmm(_jax_tiles(jstreams.build_tile_stream(r, c, v, (m, n), B)),
                                   jnp.asarray(X), impl="pallas", interpret=True))
    ts = tstreams.build_tile_stream(r, c, v, (m, n), B)
    for G in (1, 4, 16):
        sup = tstreams.build_super_tile_stream(ts, G)
        for got in (tops.cb_spmm(sup, X, device="cpu"),
                    tops.cb_spmm(ts, X, device="cpu", group_size=G),
                    tops.cb_spmm(sup, X, device="cpu", impl="reference")):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"G={G}")
    dense = tref.cb_spmm_dense_equiv(ts)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jref.cb_spmm_dense_equiv(
        _jax_tiles(jstreams.build_tile_stream(r, c, v, (m, n), B)))))


@pytest.mark.parametrize("B", [8, 16])
def test_bfloat16_tiles_and_float64_reference(B):
    m, n = 120, 104
    r, c, v = jmatrices.pruned_weight(m, n, block_size=B, seed=9)
    ts = tstreams.build_tile_stream(r, c, v.astype(np.float32), (m, n), B)
    jts = jstreams.build_tile_stream(r, c, v.astype(np.float32), (m, n), B)
    jts.tiles = np.asarray(jnp.asarray(jts.tiles).astype(jnp.bfloat16))
    X = np.random.default_rng(3).standard_normal((n, 20)).astype(np.float32)
    want = np.asarray(jops.cb_spmm(_jax_tiles(jstreams.build_super_tile_stream(jts, 4)),
                                   jnp.asarray(X), impl="pallas", interpret=True))
    sup16 = tstreams.build_super_tile_stream(ts.to("cpu", payload_dtype=torch.bfloat16), 4)
    np.testing.assert_allclose(tops.cb_spmm(sup16, X, device="cpu").numpy(), want, **TOL)
    ts64 = ts.to("cpu", payload_dtype=torch.float64)
    assert tops.cb_spmm(ts64, X, device="cpu", impl="reference").dtype == torch.float64
    assert tops.cb_spmm(ts64, X, device="cpu").dtype == torch.float32


def test_cb_spmm_contract():
    ts = tstreams.tile_stream_from_cb(tp.torch_cb(tp.Scenario("uniform", 16)))
    sup = tstreams.build_super_tile_stream(ts, 4)
    X = np.random.default_rng(0).standard_normal((ts.n, 3)).astype(np.float32)
    plan = types.SimpleNamespace(block_size=16, group_size=4)
    want = tops.cb_spmm(sup, X, device="cpu")
    assert torch.equal(tops.cb_spmm(sup, X, device="cpu", plan=plan), want)
    assert torch.equal(tops.cb_spmm(sup, X, device="cpu"), want)       # cached route, same bits
    assert set(sup._prepared) == {None}
    tops.cb_spmm(ts, X, device="cpu", group_size=4)
    assert set(ts._prepared) == {4}
    bad = [dict(group_size=8), dict(group_size=0), dict(block_n=100), dict(impl="pallas"),
           dict(plan=types.SimpleNamespace(block_size=16, group_size=8)),
           dict(plan=types.SimpleNamespace(block_size=8, group_size=4))]
    for kw in bad:
        with pytest.raises(terrors.InvalidArgError):
            tops.cb_spmm(sup, X, device="cpu", **kw)
    with pytest.raises(terrors.InvalidArgError):
        tops.cb_spmm(sup, X[:-1], device="cpu")                         # X's rows
    assert tuple(tops.cb_spmm(sup, X[:, :0], device="cpu").shape) == (ts.m, 0)


def test_cb_spmm_runs_on_cuda_by_default():
    ts = tstreams.tile_stream_from_cb(tp.torch_cb(tp.Scenario("uniform", 8)))
    X = np.zeros((ts.n, 2), np.float32)
    if torch.cuda.is_available():
        with pytest.raises(terrors.InvalidArgError):
            tops.cb_spmm(ts, X)                    # CPU stream, CUDA call
    else:
        with pytest.raises(terrors.DeviceUnavailableError):
            tops.cb_spmm(ts, X)
        with pytest.raises(terrors.DeviceUnavailableError):
            ts.to()
