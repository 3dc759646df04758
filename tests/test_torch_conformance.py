"""The conformance files of ``tests/conformance`` run on the port.

The checks of ``test_invariants.py`` (gather indices fold the column
aggregation, padding is inert, the Alg. 2 permutation is only a schedule),
``test_storage.py`` (``nbytes_structure`` accounts every byte, ``stats()``
is consistent — and equal to the JAX package's), ``test_planned.py``
(planned execution exact, bit-equal after a plan-cache round trip,
deterministic) and ``test_updated.py`` (value rewrites bit-identical to
fresh builds, shapes and padded work invariant) over the port's builds of
the scenarios of ``tests/conformance/scenarios.py``.
"""
import dataclasses
import zlib

import numpy as np
import pytest
import torch
from proptest import forall, integers, sampled_from

from conformance.scenarios import (
    GROUP_SIZES, STRUCTURES, Scenario, batched_ids, planned_scenarios, scenario_ids,
)
from repro_torch.autotune import Plan, PlanCache, SearchSettings, plan_search
from repro_torch.core import CBMatrix, balance, dense_oracle
from repro_torch.core.aggregation import coord_bits
from repro_torch.core.blocking import partition_coo
from repro_torch.core.formats import FMT_COO, FMT_CSR, FMT_DENSE
from repro_torch.core.streams import (
    build_streams, build_super_streams, build_transposed_super_streams,
    super_stream_updater, super_tile_stream_from_cb, super_tile_updater,
    transposed_super_stream_updater,
)
from repro_torch.kernels import ops

import torch_port as tp

pytestmark = pytest.mark.conformance

DETERMINISTIC = SearchSettings(mode="heuristic")

# -- test_invariants.py ---------------------------------------------------------

INVARIANT_SCENARIOS = [
    Scenario(structure, B, colagg)
    for structure in ("uniform", "power_law", "empty_rows_cols", "single_element",
                      "ragged_tail")
    for B in (8, 16, 24)
    for colagg in (True, False)
]


@pytest.mark.parametrize("scn", INVARIANT_SCENARIOS, ids=scenario_ids(INVARIANT_SCENARIOS))
def test_stream_invariants(scn):
    """xidx folds restore_cols, coo codes decode, padding is inert."""
    cb = tp.torch_cb(scn)
    s = build_streams(cb)
    bits = coord_bits(cb.block_size)
    mask = (1 << bits) - 1
    dx, px, cx, codes_all = (s.dense_xidx.numpy(), s.panel_xidx.numpy(), s.coo_xidx.numpy(),
                             s.coo_codes.numpy())
    di = pi = ci = 0
    for brow, bcol, fmt, r, c, v in cb.iter_blocks():
        gidx = cb.global_x_index(brow, bcol, c)
        if fmt == FMT_DENSE:
            assert int(s.dense_brow[di]) == brow
            np.testing.assert_array_equal(dx[di][c], gidx)
            di += 1
        elif fmt == FMT_CSR:
            assert int(s.panel_brow[pi]) == brow
            ucols, rank = np.unique(c, return_inverse=True)
            np.testing.assert_array_equal(px[pi][rank], gidx)
            assert np.all(s.panel_vals[pi].numpy()[:, len(ucols):] == 0)
            pi += 1
        elif fmt == FMT_COO:
            assert int(s.coo_brow[ci]) == brow
            codes = codes_all[ci][: len(c)]
            np.testing.assert_array_equal(codes & mask, r)
            np.testing.assert_array_equal(codes >> bits, c)
            np.testing.assert_array_equal(cx[ci][: len(c)], gidx)
            assert np.all(s.coo_vals[ci].numpy()[len(v):] == 0)
            ci += 1
    assert (di, pi, ci) == (s.num_dense, s.num_panel, s.num_coo)


@pytest.mark.parametrize("scn", INVARIANT_SCENARIOS, ids=scenario_ids(INVARIANT_SCENARIOS))
def test_balance_slot_permutation_preserves_nnz_multiset(scn):
    rows, cols, vals, shape = scn.build_coo()
    cb = tp.torch_cb(scn)
    agg_cols = cb.colagg.new_cols if cb.colagg.applied else cols
    part = partition_coo(rows, agg_cols, vals, shape, cb.block_size)
    real = cb.nnz_per_blk[cb.nnz_per_blk > 0]
    assert sorted(real.tolist()) == sorted(part.nnz_per_blk.tolist())
    assert int(real.sum()) == part.nnz == cb.nnz
    res = cb.balance_result
    assert len(cb.blk_row_idx) == res.num_groups * res.group_size
    placed = res.slots[res.slots >= 0]
    assert sorted(placed.tolist()) == list(range(part.num_blocks))
    for g in range(res.num_groups):
        slot = res.slots[g * res.group_size: (g + 1) * res.group_size]
        assert int(part.nnz_per_blk[slot[slot >= 0]].sum()) == int(res.group_loads[g])
    if part.num_blocks:
        bound = part.nnz_per_blk.sum() / res.num_groups + part.nnz_per_blk.max()
        assert res.group_loads.max() <= bound


def test_apply_balance_pads_with_sentinels():
    res = balance.tb_load_balance(np.array([5, 3, 1]), warps_per_tb=4)
    brow, fmtcode = balance.apply_balance(res, np.array([7, 8, 9]),
                                          np.array([0, 1, 2], np.uint8), pad_values=(0, FMT_COO))
    assert len(brow) == 4
    pad = res.slots < 0
    assert np.all(fmtcode[pad] == FMT_COO) and sorted(brow[~pad].tolist()) == [7, 8, 9]


# -- test_storage.py ------------------------------------------------------------

STORAGE_SCENARIOS = [
    Scenario(structure, B, colagg, dtype=dtype)
    for structure in ("uniform", "power_law", "banded", "empty_rows_cols", "single_element")
    for B in (8, 16, 24)
    for colagg, dtype in (("auto", "float32"), (True, "float32"), (False, "float64"))
]


@pytest.mark.parametrize("scn", STORAGE_SCENARIOS, ids=scenario_ids(STORAGE_SCENARIOS))
def test_storage_accounting_and_stats(scn):
    cb = tp.torch_cb(scn)
    sizes = cb.nbytes_structure()
    meta = (cb.blk_row_idx.nbytes + cb.blk_col_idx.nbytes + cb.nnz_per_blk.nbytes
            + cb.type_per_blk.nbytes + cb.vp_per_blk.nbytes)
    assert sizes["high_level_metadata"] == meta
    assert sizes["packed_data"] == cb.packed.nbytes >= cb.nnz * cb.val_dtype.itemsize
    assert sizes["column_agg_maps"] == ((cb.colagg.restore_cols.nbytes
                                         + cb.colagg.cols_offset.nbytes)
                                        if cb.colagg.applied else 0)
    assert sizes["total"] == (sizes["high_level_metadata"] + sizes["column_agg_maps"]
                              + sizes["packed_data"])
    real = cb.nnz_per_blk > 0
    assert np.all((cb.vp_per_blk[real] >= 0) & (cb.vp_per_blk[real] < max(1, cb.packed.nbytes)))

    st = cb.stats()
    assert st["nnz"] == cb.nnz > 0 and st["num_blocks"] == cb.num_blocks
    assert st["fmt_coo"] + st["fmt_csr"] + st["fmt_dense"] == st["num_blocks"]
    for key, code in (("fmt_coo", FMT_COO), ("fmt_csr", FMT_CSR), ("fmt_dense", FMT_DENSE)):
        assert st[key] == int(np.sum(cb.type_per_blk[real] == code))
    assert 0.0 <= st["super_sparse_fraction"] <= 1.0 and st["tb_load_imbalance"] >= 1.0
    if isinstance(scn.colagg, bool):
        assert st["column_aggregated"] == scn.colagg
    jcb = scn.build()
    assert st == jcb.stats() and sizes == jcb.nbytes_structure()


# -- test_planned.py ------------------------------------------------------------

PLANNED = planned_scenarios()


def _planned_spmv(plan, rows, cols, vals, shape, x) -> torch.Tensor:
    cb = CBMatrix.from_plan(rows, cols, vals, shape, plan)
    return ops.cb_spmv(build_super_streams(cb, group_size=plan.group_size), x, device="cpu")


@pytest.mark.parametrize("scn", PLANNED, ids=scenario_ids(PLANNED))
def test_planned_agreement_and_cache_bit_equality(scn, tmp_path):
    rows, cols, vals, shape = scn.build_coo()
    vals = vals.astype(np.float32)
    x = np.random.default_rng(7).standard_normal(shape[1]).astype(np.float32)
    cache = PlanCache(tmp_path / "plans")
    plan = plan_search(rows, cols, vals, shape, cache=cache, settings=DETERMINISTIC)
    y_planned = _planned_spmv(plan, rows, cols, vals, shape, x)
    cb = CBMatrix.from_plan(rows, cols, vals, shape, plan)
    y_ref = ops.cb_spmv(build_streams(cb), x, impl="reference", device="cpu")
    np.testing.assert_allclose(y_planned.numpy(), y_ref.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y_ref.numpy(), dense_oracle(rows, cols, vals, shape, x),
                               rtol=3e-4, atol=3e-4)
    loaded = Plan.load(cache.path_for(plan.structure_hash))
    assert loaded == plan
    assert torch.equal(_planned_spmv(loaded, rows, cols, vals, shape, x), y_planned)
    assert plan_search(rows, cols, vals, shape, cache=cache, settings=DETERMINISTIC) == plan
    assert cache.hits >= 1
    p2 = plan_search(rows, cols, vals, shape, settings=DETERMINISTIC)
    assert p2 == plan and p2.mode == "heuristic" and p2.t_spmv is None


# -- test_updated.py ------------------------------------------------------------

def _updated_scenarios():
    grid = []
    for G in GROUP_SIZES:
        for structure in STRUCTURES:
            grid.append((Scenario(structure, 16, "auto"), G))
        for fmt in ("coo", "csr", "dense"):
            for colagg in (True, False):
                grid.append((Scenario("uniform", 16, colagg, forced_fmt=fmt), G))
        grid.append((Scenario("power_law", 24, "auto"), G))
        grid.append((Scenario("bucket_widths", 8, True), G))
    return grid


UPDATED = _updated_scenarios()


def _fresh_values(cb, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    count = cb.value_layout().count
    mag = rng.uniform(0.5, 2.0, count)
    sign = np.where(rng.random(count) < 0.5, -1.0, 1.0)
    return (mag * sign).astype(cb.val_dtype)


def _rebuild(cb, scn, new_vals):
    rows, cols, _ = cb.to_coo()
    th = scn.thresholds()
    return CBMatrix.from_coo(rows, cols, new_vals, cb.shape, block_size=scn.block_size,
                             val_dtype=np.dtype(scn.dtype),
                             thresholds=tp.TorchThresholds(th0=th.th0, th1=th.th1, th2=th.th2),
                             use_column_aggregation=scn.colagg)


def _same_stream(a, b) -> bool:
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or not torch.equal(x, y):
                return False
        elif x != y:
            return False
    return True


@pytest.mark.parametrize("scn,G", UPDATED, ids=batched_ids(UPDATED))
def test_update_bit_identical_to_fresh_build(scn, G):
    cb = tp.torch_cb(scn)
    new_vals = _fresh_values(cb, seed=zlib.crc32(f"{scn.name}-{G}".encode()))
    cb_up, cb_fresh = cb.update_values(new_vals), _rebuild(cb, scn, new_vals)
    for f in ("packed", "nnz_per_blk", "vp_per_blk", "type_per_blk"):
        assert np.array_equal(getattr(cb_up, f), getattr(cb_fresh, f)), f
    assert _same_stream(super_stream_updater(cb, group_size=G).apply(new_vals),
                        build_super_streams(cb_fresh, group_size=G))
    assert _same_stream(super_tile_updater(cb, group_size=G).apply(new_vals),
                        super_tile_stream_from_cb(cb_fresh, group_size=G))


@pytest.mark.parametrize("scn,G", [(Scenario("power_law", 16, "auto"), 4),
                                   (Scenario("uniform", 16, True, forced_fmt="coo"), 4),
                                   (Scenario("banded", 8, "auto"), 1)],
                         ids=["power_law-B16-G4", "force_coo-B16-G4", "banded-B8-G1"])
def test_updated_spmv_spmm_execute_identically(scn, G):
    cb = tp.torch_cb(scn)
    new_vals = _fresh_values(cb, seed=7)
    cb_fresh = _rebuild(cb, scn, new_vals)
    x = np.random.default_rng(1).standard_normal(cb.shape[1]).astype(np.float32)
    X = np.random.default_rng(2).standard_normal((cb.shape[1], 8)).astype(np.float32)
    y = np.random.default_rng(3).standard_normal(cb.shape[0]).astype(np.float32)
    for impl in ("cuda", "reference"):
        kw = dict(impl=impl, device="cpu")
        assert torch.equal(
            ops.cb_spmv(super_stream_updater(cb, group_size=G).apply(new_vals), x, **kw),
            ops.cb_spmv(build_super_streams(cb_fresh, group_size=G), x, **kw))
        assert torch.equal(
            ops.cb_spmm(super_tile_updater(cb, group_size=G).apply(new_vals), X, **kw),
            ops.cb_spmm(super_tile_stream_from_cb(cb_fresh, group_size=G), X, **kw))
        assert torch.equal(
            ops.cb_spmv(transposed_super_stream_updater(cb, group_size=G).apply(new_vals),
                        y, **kw),
            ops.cb_spmv(build_transposed_super_streams(cb_fresh, group_size=G), y, **kw))


def _shapes(s):
    return [tuple(getattr(s, f.name).shape) for f in dataclasses.fields(s)
            if isinstance(getattr(s, f.name), torch.Tensor)]


@forall(integers(0, 2**31 - 1), sampled_from([8, 16, 24]), sampled_from(list(STRUCTURES)),
        examples=12, seed=5)
def test_value_rewrite_never_changes_shapes_or_padded_work(seed, B, structure):
    scn = Scenario(structure, B, "auto", seed=seed % 7)
    cb = tp.torch_cb(scn)
    cb_up = cb.update_values(_fresh_values(cb, seed))
    s0, s1 = build_super_streams(cb), build_super_streams(cb_up)
    assert s0.padded_work() == s1.padded_work() and _shapes(s0) == _shapes(s1)
    t0, t1 = super_tile_stream_from_cb(cb), super_tile_stream_from_cb(cb_up)
    assert t0.padded_work() == t1.padded_work() and _shapes(t0) == _shapes(t1)
