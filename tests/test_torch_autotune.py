"""The port's autotuner (``repro_torch.autotune``) against the JAX package's.

Same seeded numpy triplets into both packages:

- features, cost estimates, the candidate grid and the ranking equal;
- ``structure_hash``, ``value_hash``, the content hashes and the plan
  files' ``payload_checksum`` bit-equal, so a plan written by either
  package is a hit in the other's ``PlanCache``, and a ``cb-plan/v1`` file
  migrates in the port as in the reference;
- heuristic ``plan_search`` gives the reference's ``Plan`` field for field
  on every matrix of ``matrices.corpus("small")``;
- ``mode="timed"`` refuses the CPU (the plain versions' wall time says
  nothing about the card), ``"auto"`` is heuristic there;
- ``CBMatrix.plan_for`` / ``from_plan`` and ``CBLinearOperator.from_cb(plan=)``
  give the reference's streams, and results within 1e-5.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import autotune as jtune
from repro.core import CBMatrix as JaxCBMatrix
from repro.core import streams as jstreams
from repro.data import matrices as jmatrices
from repro.kernels import ops as jops
from repro.solvers import CBLinearOperator as JaxOperator
from repro_torch import autotune as ttune
from repro_torch import errors as terrors
from repro_torch.autotune import search as tsearch
from repro_torch.core import CBMatrix
from repro_torch.core import streams as tstreams
from repro_torch.kernels import ops as tops
from repro_torch.solvers import CBLinearOperator

import torch_port as tp

TOL = dict(rtol=1e-5, atol=1e-5)
J_HEURISTIC = jtune.SearchSettings(mode="heuristic")
T_HEURISTIC = ttune.SearchSettings(mode="heuristic")
CORPUS = jmatrices.corpus("small")


def _coo(seed=0, m=160, n=144):
    r, c, v = jmatrices.power_law(m, n, seed=seed)
    return r, c, v.astype(np.float32), (m, n)


def _cfg(c):
    return (c.block_size, c.thresholds.th0, c.thresholds.th1, c.thresholds.th2, c.colagg,
            c.group_size)


def _mini(pkg, **overrides):
    kw = dict(
        structure_hash="0" * 64, shape=(16, 16), nnz=4, val_dtype="float32",
        block_size=16, th0=0.15, th1=4, th2=32, colagg=False, group_size=4,
        mode="heuristic", predicted_padded_elems=100, predicted_steps=2,
        measured_padded_elems=90, measured_steps=2,
    )
    kw.update(overrides)
    return pkg.Plan(**kw)


def test_public_names_and_constants_match_repro():
    assert {k for k in vars(ttune) if not k.startswith("_")} == \
        {k for k in vars(jtune) if not k.startswith("_")}
    assert ttune.CANDIDATE_BLOCK_SIZES == jtune.CANDIDATE_BLOCK_SIZES
    assert (ttune.PLAN_SCHEMA, ttune.PLAN_SCHEMA_V1) == (jtune.PLAN_SCHEMA, jtune.PLAN_SCHEMA_V1)
    from repro.autotune import cost as jcost
    from repro_torch.autotune import cost as tcost
    assert (tcost.STEP_OVERHEAD_ELEMS, tcost.SCATTER_ROW_ELEMS) == \
        (jcost.STEP_OVERHEAD_ELEMS, jcost.SCATTER_ROW_ELEMS)
    for B in (8, 16, 24, 32, 64):
        assert tstreams.auto_group_size(B) == jstreams.auto_group_size(B)
    assert [_cfg(c) for c in ttune.default_candidates()] == \
        [_cfg(c) for c in jtune.default_candidates()]
    assert ttune.SearchSettings() == ttune.DEFAULT_SETTINGS
    assert dataclasses.asdict(ttune.DEFAULT_SETTINGS) == dataclasses.asdict(jtune.DEFAULT_SETTINGS)


# ---------------------------------------------------------------------------
# features and the cost model
# ---------------------------------------------------------------------------

def _same_features(tf, jf):
    assert (tf.shape, tf.nnz, tf.row_nnz_max, tf.bandwidth_max) == \
        (jf.shape, jf.nnz, jf.row_nnz_max, jf.bandwidth_max)
    assert ttune.feature_vector(tf) == jtune.feature_vector(jf)
    assert sorted(tf.profiles) == sorted(jf.profiles)
    for B, tp_ in tf.profiles.items():
        jp = jf.profiles[B]
        for f in dataclasses.fields(jp):
            a, b = getattr(tp_, f.name), getattr(jp, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, (B, f.name)


@pytest.mark.parametrize("seed", range(3))
def test_features_estimates_and_ranking_equal_to_repro(seed):
    r, c, v, shape = _coo(seed=seed, m=200 + 40 * seed, n=176)
    tf, jf = ttune.extract_features(r, c, v, shape), jtune.extract_features(r, c, v, shape)
    _same_features(tf, jf)
    tcands, jcands = ttune.default_candidates(), jtune.default_candidates()
    for tc, jc in zip(tcands, jcands):
        assert dataclasses.asdict(ttune.estimate(tf, tc)) == dataclasses.asdict(
            jtune.estimate(jf, jc))
    tr, jr = ttune.rank(tf, tcands), jtune.rank(jf, jcands)
    assert [_cfg(c) for c, _ in tr] == [_cfg(c) for c, _ in jr]
    assert all(a[1].score <= b[1].score for a, b in zip(tr, tr[1:]))


def test_features_from_cb_and_handmade_profile():
    r, c, v, shape = _coo(seed=8)
    kw = dict(block_size=16, val_dtype=np.float32, use_column_aggregation=True)
    _same_features(ttune.features_from_cb(CBMatrix.from_coo(r, c, v, shape, **kw)),
                   jtune.features_from_cb(JaxCBMatrix.from_coo(r, c, v, shape, **kw)))
    f = ttune.extract_features(np.array([0, 1, 2, 9]), np.array([0, 0, 3, 10]),
                               np.ones(4, np.float32), (16, 16), block_sizes=(8,))
    p = f.profile(8)
    assert p.num_blocks == 2 and p.super_sparse_fraction == 1.0
    np.testing.assert_array_equal(np.sort(p.cols_per_block), [1, 2])
    with pytest.raises(KeyError, match="no block profile"):
        f.profile(16)


def test_group_size_tradeoff_visible_to_model():
    f = ttune.extract_features(*_coo(seed=2, m=512, n=512))
    small_g = ttune.estimate(f, ttune.CandidateConfig(group_size=1))
    auto_g = ttune.estimate(f, ttune.CandidateConfig())
    assert small_g.steps > auto_g.steps and small_g.score > auto_g.score


# ---------------------------------------------------------------------------
# hashes and plan files
# ---------------------------------------------------------------------------

def _aliased():
    """Duplicates, an explicit zero and float32 values whose duplicate sums
    round: the canonical triplets' summation order decides their bits."""
    rng = np.random.default_rng(4)
    rows = np.r_[rng.integers(0, 40, 300), [0, 0, 5, 5]]
    cols = np.r_[rng.integers(0, 36, 300), [1, 1, 4, 4]]
    vals = np.r_[rng.standard_normal(300) * 1e3, [1.0, -1.0, 2.0, 1e-4]]
    return rows, cols, vals, (40, 36)


@pytest.mark.parametrize("val_dtype", [np.float32, np.float64])
def test_hashes_bit_equal_to_repro(val_dtype):
    r, c, v, shape = _aliased()
    for fn in ("structure_hash", "value_hash", "matrix_content_hash", "legacy_content_hash"):
        assert getattr(ttune, fn)(r, c, v, shape, val_dtype) == \
            getattr(jtune, fn)(r, c, v, shape, val_dtype), fn
    th, jh = ttune.matrix_hashes(r, c, v, shape, val_dtype), \
        jtune.matrix_hashes(r, c, v, shape, val_dtype)
    assert tuple(th) == tuple(jh)
    for a, b in zip(ttune.canonical_triplets(r, c, v, shape, val_dtype),
                    jtune.canonical_triplets(r, c, v, shape, val_dtype)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    perm = np.random.default_rng(0).permutation(len(r))
    assert ttune.matrix_hashes(r[perm], c[perm], v[perm], shape, val_dtype).structure == th.structure
    # the CB round trip (zeros dropped, duplicates merged) lands on the same hashes
    cb = CBMatrix.from_coo(r, c, v, shape, block_size=8, val_dtype=val_dtype)
    assert ttune.matrix_hashes(*cb.to_coo(), shape, val_dtype) == th


def test_plan_json_and_checksum_equal_to_repro(tmp_path):
    for kw in (dict(), dict(t_spmv=1.5e-4, th1=None, th2=None, value_hash="ab" * 32)):
        tplan, jplan = _mini(ttune, **kw), _mini(jtune, **kw)
        assert tplan.to_json() == jplan.to_json()
        assert tplan._payload_digest() == jplan._payload_digest()
        tplan.save(tmp_path / "t.json")
        jplan.save(tmp_path / "j.json")
        assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
        assert ttune.Plan.load(tmp_path / "j.json") == tplan
    assert hash(_mini(ttune)) == hash(_mini(ttune))
    d = _mini(ttune).to_json()
    d["schema"] = "cb-plan/v0"
    with pytest.raises(terrors.InvalidArgError, match="neither"):
        ttune.Plan.from_json(d)
    d = _mini(ttune).to_json()
    d["block_size"] = 8                                # edited after save
    assert "checksum" in ttune.Plan.from_json(d).check_valid()


def test_plan_check_valid_reasons_equal_to_repro():
    for kw in (dict(), dict(shape=(0, 4)), dict(block_size=0), dict(group_size=0),
               dict(th1=100, th2=50)):
        assert (_mini(ttune, **kw).check_valid() is None) == \
            (_mini(jtune, **kw).check_valid() is None), kw
    assert "plan was made for shape" in _mini(ttune).check_valid(shape=(99, 99))
    assert "nnz" in _mini(ttune).check_valid(shape=(16, 16), nnz=5)


def test_plans_of_either_package_hit_in_the_other(tmp_path):
    r, c, v, shape = _coo(seed=3)
    jcache, tcache = jtune.PlanCache(tmp_path / "j"), ttune.PlanCache(tmp_path / "t")
    jplan = jtune.plan_search(r, c, v, shape, cache=jcache, settings=J_HEURISTIC)
    tplan = ttune.plan_search(r, c, v, shape, cache=tcache, settings=T_HEURISTIC)
    assert (tmp_path / "j" / f"{jplan.structure_hash}.plan.json").read_bytes() == \
        (tmp_path / "t" / f"{tplan.structure_hash}.plan.json").read_bytes()
    # each package reads the other's directory: one hit, no search
    t_on_j, j_on_t = ttune.PlanCache(tmp_path / "j"), jtune.PlanCache(tmp_path / "t")
    assert ttune.plan_search(r, c, v, shape, cache=t_on_j, settings=T_HEURISTIC) == tplan
    assert j_on_t.get(tplan.structure_hash, shape=shape, nnz=tplan.nnz).to_json() == \
        jplan.to_json()
    assert (t_on_j.hits, t_on_j.misses, j_on_t.hits, j_on_t.misses) == (1, 0, 1, 0)
    assert len([f for f in os.listdir(tmp_path / "t") if f.endswith(".plan.json")]) == 1


def test_plan_cache_miss_stale_and_v1_migration(tmp_path):
    cache = ttune.PlanCache(tmp_path / "plans")
    plan = _mini(ttune, structure_hash="a" * 64)
    assert cache.get(plan.structure_hash) is None
    cache.put(plan)
    assert cache.get(plan.structure_hash) == plan and cache.hit_rate == 0.5
    (tmp_path / "plans" / ("b" * 64 + ".plan.json")).write_text("{ not json")
    assert cache.get("b" * 64) is None
    assert cache.get("a" * 64, shape=(32, 32)) is None               # stale
    assert (cache.hits, cache.misses, cache.stale) == (1, 3, 1)
    # a v1 file, as the JAX package's v1 processes wrote it: one hit, re-keyed
    d = _mini(jtune, structure_hash="e" * 64).to_json()
    d["schema"] = jtune.PLAN_SCHEMA_V1
    d["matrix_hash"] = d.pop("structure_hash")
    d.pop("value_hash")
    with open(cache.path_for("e" * 64), "w") as f:
        json.dump(d, f)
    got = cache.get("f" * 64, legacy_hash="e" * 64, shape=(16, 16), nnz=4)
    assert got.structure_hash == "f" * 64 and got.value_hash is None
    with open(cache.path_for("f" * 64)) as f:
        assert json.load(f)["schema"] == "cb-plan/v2"
    jcache = jtune.PlanCache(tmp_path / "plans")                      # the reference agrees
    assert jcache.get("f" * 64, shape=(16, 16), nnz=4).to_json() == got.to_json()


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(CORPUS)), ids=[s.name for s, *_ in CORPUS])
def test_heuristic_plan_equal_to_repro_on_the_corpus(i):
    _, r, c, v, shape = CORPUS[i]
    v = v.astype(np.float32)
    tplan = ttune.plan_search(r, c, v, shape, settings=T_HEURISTIC)
    jplan = jtune.plan_search(r, c, v, shape, settings=J_HEURISTIC)
    assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
    assert tplan.mode == "heuristic" and tplan.t_spmv is None
    assert tplan == ttune.plan_search(r, c, v, shape, settings=T_HEURISTIC)   # deterministic


def test_search_modes_and_devices():
    r, c, v, shape = _coo(seed=1)
    with pytest.raises(terrors.InvalidArgError, match="timed"):
        ttune.plan_search(r, c, v, shape, settings=ttune.SearchSettings(mode="timed"),
                          device="cpu")
    with pytest.raises(terrors.InvalidArgError, match="unknown search mode"):
        ttune.plan_search(r, c, v, shape, settings=ttune.SearchSettings(mode="warp-speed"))
    assert tsearch.resolve_mode("auto", "cpu") == "heuristic"
    assert tsearch.resolve_mode("heuristic") == "heuristic"
    plan = CBMatrix.plan_for(r, c, v, shape, device="cpu")          # default settings: auto
    assert plan.mode == "heuristic" and plan.t_spmv is None
    if torch.cuda.is_available():
        assert tsearch.resolve_mode("auto") == "timed"
    else:
        with pytest.raises(terrors.DeviceUnavailableError):
            tsearch.resolve_mode("auto")
        with pytest.raises(terrors.DeviceUnavailableError):
            ttune.plan_search(r, c, v, shape, settings=ttune.SearchSettings(mode="timed"))
    only_default = ttune.SearchSettings(candidates=(ttune.DEFAULT_CONFIG,), top_k=1,
                                        mode="heuristic")
    plan = ttune.plan_search(r, c, v, shape, settings=only_default)
    assert (plan.block_size, plan.group_size) == (16, tstreams.group_size_for(16))


def test_search_never_regresses_padded_work_and_single_element():
    for seed in range(3):
        r, c, v, shape = _coo(seed=seed)
        plan = ttune.plan_search(r, c, v, shape, settings=T_HEURISTIC)
        cb = CBMatrix.from_coo(r, c, v, shape, block_size=16, val_dtype=np.float32)
        assert plan.measured_padded_elems <= sum(
            tstreams.build_super_streams(cb).padded_work().values())
    rows, cols, vals = np.array([5]), np.array([3]), np.array([2.5], np.float32)
    plan = ttune.plan_search(rows, cols, vals, (9, 7), settings=T_HEURISTIC)
    assert CBMatrix.from_plan(rows, cols, vals, (9, 7), plan).to_dense()[5, 3] == 2.5


def test_search_builds_colagg_twins_once(monkeypatch):
    """The shortlist's ``colagg="auto"`` candidate and its explicit twin share
    one ``from_coo``, and the plan is still the reference's."""
    r, c, v, shape = _coo(seed=5, m=400, n=400)
    builds = []
    real = tsearch.CBMatrix.from_coo
    monkeypatch.setattr(tsearch.CBMatrix, "from_coo", lambda *a, **kw: builds.append(
        kw["use_column_aggregation"]) or real(*a, **kw))
    plan = ttune.plan_search(r, c, v, shape, settings=T_HEURISTIC)
    shortlist = [cfg for cfg, _ in ttune.rank(ttune.extract_features(r, c, v, shape),
                                              ttune.default_candidates())[:3]]
    assert any(cfg.colagg == "auto" for cfg in shortlist) and \
        any(cfg.colagg is True for cfg in shortlist)
    assert len(builds) < len({(cfg.block_size, cfg.thresholds, cfg.colagg)
                              for cfg in shortlist + [ttune.DEFAULT_CONFIG]})
    assert plan.to_json() == jtune.plan_search(r, c, v, shape, settings=J_HEURISTIC).to_json()


def test_time_min_on_the_host():
    calls = []
    best = ttune.timing.time_min(lambda a: calls.append(a) or torch.zeros(1), 7, reps=4)
    assert calls == [7] * 6 and 0.0 <= best < 1.0
    assert ttune.timing.geomean([1.0, 4.0]) == pytest.approx(2.0)


# ---------------------------------------------------------------------------
# the entry points that use plans
# ---------------------------------------------------------------------------

def _planned(seed=11):
    r, c, v, shape = _coo(seed=seed)
    return r, c, v, shape, ttune.plan_search(r, c, v, shape, settings=T_HEURISTIC)


def test_from_plan_bit_equal_to_repro_and_validates():
    r, c, v, shape, plan = _planned()
    jplan = jtune.plan_search(r, c, v, shape, settings=J_HEURISTIC)
    tcb, jcb = CBMatrix.from_plan(r, c, v, shape, plan), JaxCBMatrix.from_plan(r, c, v, shape,
                                                                               jplan)
    np.testing.assert_array_equal(tcb.packed, jcb.packed)
    tp.assert_streams_equal(jstreams.build_super_streams(jcb, group_size=jplan.group_size),
                            tstreams.build_super_streams(tcb, group_size=plan.group_size))
    with pytest.raises(terrors.PlanStaleError):
        CBMatrix.from_plan(r, c, v, (shape[0] + 1, shape[1]), plan)
    with pytest.raises(terrors.PlanStaleError):
        CBMatrix.from_plan(r, c, v, shape, dataclasses.replace(plan, th1=500, th2=50))


def test_cb_spmv_and_spmm_plan_equals_group_size():
    r, c, v, shape, plan = _planned()
    cb = CBMatrix.from_plan(r, c, v, shape, plan)
    flat = tstreams.build_streams(cb)
    x = np.random.default_rng(0).standard_normal(shape[1]).astype(np.float32)
    for impl in ("cuda", "reference"):
        assert torch.equal(tops.cb_spmv(flat, x, impl=impl, plan=plan, device="cpu"),
                           tops.cb_spmv(flat, x, impl=impl, group_size=plan.group_size,
                                        device="cpu"))
    with pytest.raises(terrors.InvalidArgError, match="conflicting"):
        tops.cb_spmv(flat, x, plan=plan, group_size=plan.group_size + 1, device="cpu")
    other = CBMatrix.from_coo(r, c, v, shape, block_size=8 if plan.block_size != 8 else 16)
    with pytest.raises(terrors.InvalidArgError, match="block_size"):
        tops.cb_spmv(tstreams.build_streams(other), x, plan=plan, device="cpu")
    ts = tstreams.tile_stream_from_cb(cb)
    X = np.random.default_rng(1).standard_normal((shape[1], 8)).astype(np.float32)
    assert torch.equal(tops.cb_spmm(ts, X, plan=plan, device="cpu"),
                       tops.cb_spmm(ts, X, group_size=plan.group_size, device="cpu"))


def test_operator_plans_match_repro(tmp_path):
    r, c, v, shape = _coo(seed=12)
    kw = dict(block_size=16, val_dtype=np.float32)
    tcb, jcb = CBMatrix.from_coo(r, c, v, shape, **kw), JaxCBMatrix.from_coo(r, c, v, shape, **kw)
    cache = ttune.PlanCache(tmp_path / "plans")
    top = CBLinearOperator.from_cb(tcb, plan="auto", plan_cache=cache, with_rmatvec=True,
                                   device="cpu")
    jop = JaxOperator.from_cb(jcb, plan="auto", plan_settings=J_HEURISTIC, with_rmatvec=True)
    assert top.plan.to_json() == jop.plan.to_json() and cache.misses == 1
    assert (top.block_size, top.group_size) == (top.plan.block_size, top.plan.group_size)
    tp.assert_streams_equal(jop.streams, top.streams)
    tp.assert_streams_equal(jop.streams_T, top.streams_T)
    x = np.random.default_rng(2).standard_normal(shape[1]).astype(np.float32)
    want = np.asarray(jop.matvec(jnp.asarray(x), impl="reference"))
    for impl in ("cuda", "reference"):
        np.testing.assert_allclose(top.matvec(torch.from_numpy(x), impl=impl).numpy(), want,
                                   **TOL)
    np.testing.assert_allclose(
        top.matvec(torch.from_numpy(x)).numpy(),
        np.asarray(jops.cb_spmv(jop.streams, jnp.asarray(x), impl="pallas", interpret=True)),
        **TOL)
    # a Plan object gives the same operator; the cache hit does too
    by_plan = CBLinearOperator.from_cb(tcb, plan=top.plan, device="cpu")
    again = CBLinearOperator.from_cb(tcb, plan="auto", plan_cache=cache, device="cpu")
    assert cache.hits == 1
    for op in (by_plan, again):
        assert torch.equal(op.matvec(torch.from_numpy(x)), top.matvec(torch.from_numpy(x)))
    with pytest.raises(terrors.InvalidArgError, match="not both"):
        CBLinearOperator.from_cb(tcb, plan="auto", group_size=4, device="cpu")
    with pytest.raises(terrors.InvalidArgError, match="unknown plan mode"):
        CBLinearOperator.from_cb(tcb, plan="bogus", device="cpu")
