"""Port parity, kernel by kernel: the plain PyTorch version beside each CUDA
kernel against the Pallas kernel it replaces (interpret mode) and against
``repro.kernels.ref``, on the JAX package's own stream bytes.

Tolerance 1e-5 (float32 sums of at most 24 products taken in another order);
integer-valued data must agree bit for bit. On the CPU a wrapper takes its
plain version, so these tests also cover the wrappers' checks. The CUDA
kernels themselves are held against the same plain versions on the card by
``chip_smoke.py``; the tests marked ``cuda`` do so under pytest where a card
is present.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import streams as jstreams
from repro.kernels import cb_block_dense as j_dense
from repro.kernels import cb_colagg as j_panel
from repro.kernels import cb_coo as j_coo
from repro.kernels import ref as jref
from repro_torch import errors as terrors
from repro_torch.kernels import cb_block_dense as t_dense
from repro_torch.kernels import cb_colagg as t_panel
from repro_torch.kernels import cb_combine as t_combine
from repro_torch.kernels import cb_coo as t_coo
from repro_torch.kernels import ref as tref

import torch_port as tp

def _cases(fmt, extra):
    """Scenarios rich in one format: forced thresholds over B x G, plus
    natural mixes."""
    forced = [(tp.Scenario("uniform", B, colagg, forced_fmt=fmt), G)
              for B in (8, 16, 24) for colagg, G in ((True, 1), (False, 16))]
    return forced + extra


DENSE_CASES = _cases("dense", [(tp.Scenario("block_clustered", 16), 4),
                               (tp.Scenario("block_clustered", 24), 7)])
PANEL_CASES = _cases("csr", [(tp.Scenario("bucket_widths", 8, True), 4),
                             (tp.Scenario("banded", 24), 7)])
COO_CASES = _cases("coo", [(tp.Scenario("power_law", 24), 4),
                           (tp.Scenario("empty_rows_cols", 16), 7)])


def _ids(cases):
    return [f"{s.name}-G{g}" for s, g in cases]


TOL = dict(rtol=1e-5, atol=1e-5)


def _integer_valued(js):
    """The same stream with small integer payloads (every sum exact in float32)."""
    import dataclasses
    rng = np.random.default_rng(0)

    def ints(a):
        a = np.asarray(a)
        return np.where(a != 0, rng.integers(1, 8, a.shape), 0).astype(a.dtype)
    return dataclasses.replace(js, dense_tiles=ints(js.dense_tiles),
                               panel_vals=ints(js.panel_vals), coo_vals=ints(js.coo_vals))


def _streams(scn, G, integer):
    js = jstreams.build_super_streams(scn.build(), group_size=G)
    if integer:
        js = _integer_valued(js)
    rng = np.random.default_rng(4)
    x = (rng.integers(-4, 5, js.n) if integer else rng.standard_normal(js.n)).astype(np.float32)
    return js, tp.to_torch_streams(js), x


def _check(got, want, integer):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("integer", [False, True], ids=["random", "integer"])
@pytest.mark.parametrize("scn,G", DENSE_CASES, ids=_ids(DENSE_CASES))
def test_dense_plain_vs_pallas(scn, G, integer):
    js, ts, x = _streams(scn, G, integer)
    assert js.num_dense_groups
    want = j_dense.block_dense_spmv_batched(
        jnp.asarray(js.dense_tiles), jnp.asarray(x)[js.dense_xidx], interpret=True)
    xg = torch.from_numpy(x)[ts.dense_xidx.long()]
    _check(t_dense.block_dense_spmv_plain(ts.dense_tiles, xg), want, integer)
    _check(t_dense.block_dense_spmv_batched(ts.dense_tiles, xg), want, integer)


@pytest.mark.parametrize("integer", [False, True], ids=["random", "integer"])
@pytest.mark.parametrize("scn,G", PANEL_CASES, ids=_ids(PANEL_CASES))
def test_panel_plain_vs_pallas(scn, G, integer):
    js, ts, x = _streams(scn, G, integer)
    assert js.num_panel_groups
    want = j_panel.panel_spmv_batched(
        jnp.asarray(js.panel_vals), jnp.asarray(x)[js.panel_xidx], interpret=True)
    xg = torch.from_numpy(x)[ts.panel_xidx.long()]
    _check(t_panel.panel_spmv_plain(ts.panel_vals, xg), want, integer)
    _check(t_panel.panel_spmv_batched(ts.panel_vals, xg), want, integer)


@pytest.mark.parametrize("integer", [False, True], ids=["random", "integer"])
@pytest.mark.parametrize("scn,G", COO_CASES, ids=_ids(COO_CASES))
def test_coo_plain_vs_pallas(scn, G, integer):
    js, ts, x = _streams(scn, G, integer)
    assert js.num_coo_groups
    B = js.block_size
    want = j_coo.coo_spmv_batched(
        jnp.asarray(js.coo_codes), jnp.asarray(js.coo_vals),
        jnp.asarray(x)[js.coo_xidx], block_size=B, interpret=True)
    xg = torch.from_numpy(x)[ts.coo_xidx.long()]
    _check(t_coo.coo_spmv_plain(ts.coo_codes, ts.coo_vals, xg, block_size=B), want, integer)
    _check(t_coo.coo_spmv_batched(ts.coo_codes, ts.coo_vals, xg, block_size=B), want, integer)


@pytest.mark.parametrize("B", [8, 16, 24, 32])
def test_coo_row_mask_is_a_full_bit_mask(B):
    """(1 << bits) - 1, never B - 1: B = 24 has holes."""
    rows, _ = j_coo._decode(np.arange(1 << 12, dtype=np.int32), B)
    np.testing.assert_array_equal(np.arange(1 << 12) & t_coo.row_mask(B), rows)
    assert t_coo.row_mask(24) == 31


REF_CASES = tp.scenario_cut(17)[::2][:2]    # panel + COO at B = 8; all three formats at B = 24


@pytest.mark.parametrize("scn", REF_CASES, ids=tp.ids(REF_CASES))
def test_ref_oracles_match_jax_ref(scn):
    """kernels/ref.py, function by function, on flat and packed streams."""
    cb = scn.build()
    jf, jsup = jstreams.build_streams(cb), jstreams.build_super_streams(cb, group_size=4)
    tf, tsup = tp.to_torch_streams(jf), tp.to_torch_streams(jsup)
    x = np.random.default_rng(2).standard_normal(jf.n).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    mb, B = jf.mb, jf.block_size
    if jf.num_dense:
        np.testing.assert_allclose(
            tref.block_dense_spmv(tf.dense_tiles, tf.dense_brow, xt[tf.dense_xidx.long()], mb),
            jref.block_dense_spmv(jnp.asarray(jf.dense_tiles), jf.dense_brow,
                                  xj[jf.dense_xidx], mb), **TOL)
    if jf.num_panel:
        np.testing.assert_allclose(
            tref.panel_spmv(tf.panel_vals, tf.panel_brow, xt[tf.panel_xidx.long()], mb),
            jref.panel_spmv(jnp.asarray(jf.panel_vals), jf.panel_brow,
                            xj[jf.panel_xidx], mb), **TOL)
    if jf.num_coo:
        np.testing.assert_allclose(
            tref.coo_spmv(tf.coo_codes, tf.coo_vals, tf.coo_brow, xt[tf.coo_xidx.long()], mb, B),
            jref.coo_spmv(jnp.asarray(jf.coo_codes), jnp.asarray(jf.coo_vals), jf.coo_brow,
                          xj[jf.coo_xidx], mb, B), **TOL)
    np.testing.assert_allclose(tref.cb_spmv(tf, xt), jref.cb_spmv(jf.device_put(), xj), **TOL)
    np.testing.assert_allclose(tref.super_spmv(tsup, xt),
                               jref.super_spmv(jsup.device_put(), xj), **TOL)


def test_ref_accumulates_float64_payloads_in_float64():
    scn = tp.Scenario("power_law", 16, dtype="float64")
    ts = tp.to_torch_streams(jstreams.build_super_streams(scn.build()))
    assert ts.coo_vals.dtype == torch.float64
    x32 = torch.ones(ts.n)
    assert tref.super_spmv(ts, x32).dtype == torch.float64
    assert tref._acc_dtype(torch.bfloat16, torch.float32) == torch.float32
    assert tref._acc_dtype(torch.float32, torch.float64) == torch.float64


@pytest.mark.parametrize("T,mb,B", [(1, 1, 8), (50, 7, 16), (5000, 40, 24), (20000, 3, 16)])
def test_combine_plan_fixes_a_complete_order(T, mb, B):
    """Walk the plan on the host exactly as the kernel does: every slot is
    summed once, chunks never exceed CHUNK, every row ends as one chunk."""
    rng = np.random.default_rng(T)
    brow = rng.integers(0, mb, T).astype(np.int32)
    brow[: T // 2] = 0                       # one very long row: several levels
    parts = rng.integers(-5, 5, (T, B)).astype(np.float32)
    plan = t_combine.plan_combine(torch.from_numpy(brow), "cpu")
    assert plan.num_slots == T
    src, y = parts, np.zeros(mb * B, np.float32)
    for level in plan.levels:
        ptr = level.ptr.numpy()
        assert (np.diff(ptr) > 0).all() and (np.diff(ptr) <= t_combine.CHUNK).all()
        assert ptr[0] == 0 and ptr[-1] == len(src) and len(ptr) == level.nchunks + 1
        order = np.arange(len(src)) if level.perm is None else level.perm.numpy()
        assert sorted(order.tolist()) == list(range(len(src)))
        out = np.stack([src[order[ptr[c]:ptr[c + 1]]].sum(0) for c in range(level.nchunks)])
        if level.rows is not None:
            rows = level.rows.numpy()
            assert len(np.unique(rows)) == len(rows)
            y.reshape(mb, B)[rows] += out
        src = out
    assert plan.levels[-1].rows is not None
    assert all(lv.rows is None for lv in plan.levels[:-1])
    want = torch.zeros(mb * B)
    t_combine.combine_plain(want, torch.from_numpy(parts), torch.from_numpy(brow), B)
    np.testing.assert_array_equal(y, want.numpy())


def test_combine_drops_the_ragged_tail_and_accumulates():
    B, m = 8, 13                              # two block rows, the last one ragged
    parts = torch.arange(3 * B, dtype=torch.float32).reshape(3, B)
    brow = torch.tensor([1, 0, 1], dtype=torch.int32)
    y = torch.full((m,), 100.0)
    out = t_combine.segment_combine(y, parts, brow, B)
    assert out is y
    want = np.full(16, 100.0, np.float32)
    want[:8] += parts[1].numpy()
    want[8:] += (parts[0] + parts[2]).numpy()
    np.testing.assert_array_equal(y.numpy(), want[:m])


def test_wrappers_check_their_arguments():
    tiles, xg = torch.zeros((2, 32, 16)), torch.zeros((2, 2, 16))
    with pytest.raises(terrors.InvalidArgError):
        t_dense.block_dense_spmv_batched(tiles.to(torch.float16), xg)       # dtype
    with pytest.raises(terrors.InvalidArgError):
        t_dense.block_dense_spmv_batched(tiles[:, :16], xg)                # shape
    with pytest.raises(terrors.InvalidArgError):
        t_dense.block_dense_spmv_batched(tiles, xg.double())               # xg dtype
    with pytest.raises(terrors.InvalidArgError):
        t_dense.block_dense_spmv_batched(tiles.transpose(1, 2).transpose(1, 2)[:, ::1],
                                         xg, out=torch.zeros((2, 2, 16)).transpose(0, 1))
    with pytest.raises(terrors.InvalidArgError):
        t_panel.panel_spmv_batched(torch.zeros((1, 8, 12)), torch.zeros((1, 12)))   # W % 8
    with pytest.raises(terrors.InvalidArgError):
        t_coo.coo_spmv_batched(torch.zeros((1, 8), dtype=torch.int64), torch.zeros((1, 8)),
                               torch.zeros((1, 8)), block_size=8)                   # codes dtype
    with pytest.raises(terrors.InvalidArgError):
        t_combine.segment_combine(torch.zeros(8), torch.zeros((2, 4)),
                                  torch.zeros(2, dtype=torch.int32), 8)             # parts shape


def test_empty_streams_launch_nothing_and_return_empty():
    for w in (t_dense.block_dense_spmv_batched, t_panel.panel_spmv_batched,
              t_coo.coo_spmv_batched, t_combine.segment_combine):
        assert isinstance(w.launches, int)
    before = t_dense.block_dense_spmv_batched.launches
    out = t_dense.block_dense_spmv_batched(torch.zeros((0, 64, 16)), torch.zeros((0, 4, 16)))
    assert tuple(out.shape) == (0, 4, 16)
    assert tuple(t_panel.panel_spmv_batched(torch.zeros((0, 16, 0)),
                                            torch.zeros((0, 0))).shape) == (0, 0, 16)
    assert tuple(t_coo.coo_spmv_batched(torch.zeros((0, 0), dtype=torch.int32),
                                        torch.zeros((0, 0)), torch.zeros((0, 0)),
                                        block_size=16).shape) == (0, 0, 16)
    # the counters count CUDA launches only: none of this ran on a card
    assert t_dense.block_dense_spmv_batched.launches == before


CUDA_CASES = DENSE_CASES[-2:] + PANEL_CASES[-2:] + COO_CASES[-2:]


@pytest.mark.cuda
@pytest.mark.parametrize("scn,G", CUDA_CASES, ids=_ids(CUDA_CASES))
def test_cuda_kernels_vs_plain_on_the_card(scn, G):
    """The CUDA kernels against their plain versions (needs a CUDA device and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(run `python3 chip_smoke.py` on the GPU machine)")
    _, ts, x = _streams(scn, G, integer=True)
    s, x = ts.to("cuda"), torch.from_numpy(x).cuda()
    B = s.block_size
    if s.num_dense_groups:
        xg = x[s.dense_xidx.long()]
        assert torch.equal(t_dense.block_dense_spmv_batched(s.dense_tiles, xg),
                           t_dense.block_dense_spmv_plain(s.dense_tiles, xg))
    if s.num_panel_groups:
        xg = x[s.panel_xidx.long()]
        assert torch.equal(t_panel.panel_spmv_batched(s.panel_vals, xg),
                           t_panel.panel_spmv_plain(s.panel_vals, xg))
    if s.num_coo_groups:
        xg = x[s.coo_xidx.long()]
        assert torch.equal(
            t_coo.coo_spmv_batched(s.coo_codes, s.coo_vals, xg, block_size=B),
            t_coo.coo_spmv_plain(s.coo_codes, s.coo_vals, xg, block_size=B))
