"""The port's telemetry (``repro_torch.obs``) against the JAX package's.

The instruments, buckets, percentiles, snapshots, spans, Chrome trace,
injectable clock and ``MirroredCounter`` of ``tests/test_obs.py``, each
recorded the same way in both packages and compared snapshot for
snapshot; then the instrumented paths: ``ops`` launch accounting (the
port's snapshot equals the reference's after mapping ``impl="pallas"`` to
``"cuda"``, on the same streams, the reference run in interpret mode),
``cb_spmv`` bit-identical with obs on and off, the planned matvec's
measured-vs-predicted pair, ``PlanCache``'s mirrored counters and
``robust_solve``'s attempt telemetry on the same seeded system.
"""
import json
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.autotune import SearchSettings as JaxSettings
from repro.core.cb_matrix import CBMatrix as JaxCBMatrix
from repro.core import streams as jstreams
from repro.data import matrices as jmatrices
from repro.kernels import ops as jops
from repro.solvers import CBLinearOperator as JaxOperator, robust_solve as j_robust
from repro_torch import errors as terrors
from repro_torch import obs as tobs
from repro_torch.autotune import PlanCache, SearchSettings
from repro_torch.core import CBMatrix
from repro_torch.core import streams as tstreams
from repro_torch.kernels import ops as tops
from repro_torch.obs import metrics as tmetrics
from repro_torch.solvers import CBLinearOperator, robust_solve
from torch_port import PORT_ONLY_LAUNCHES, shared_snapshot, shared_spans

BOTH = (jobs, tobs)
HEURISTIC = SearchSettings(mode="heuristic")


@pytest.fixture(autouse=True)
def _clean_obs():
    """Every test starts enabled on the real clock with empty stores."""
    for o in BOTH:
        o.configure(enabled=True, clock=time.monotonic)
        o.reset()
    yield
    for o in BOTH:
        o.configure(enabled=True, clock=time.monotonic)
        o.reset()


class FakeClock:
    def __init__(self, step=1.0):
        self.t = 0.0
        self.step = step

    def __call__(self):
        t, self.t = self.t, self.t + self.step
        return t


def _pallas_as_cuda(snap: dict) -> dict:
    """The JAX package's snapshot with its kernel engine named as the port's."""
    return json.loads(json.dumps(snap).replace('"impl": "pallas"', '"impl": "cuda"'))


# -- instruments: the same recordings give the same snapshots -----------------

def _record_instruments(o):
    ctr = o.counter("t.count")
    ctr.inc()
    ctr.inc(2, solver="cg")
    ctr.inc(3, solver="cg")
    ctr.inc(5, solver="gmres")
    o.counter("t.b").inc(2, z="1", a="2")
    o.gauge("t.g").set(3)
    o.gauge("t.g").set(7)
    h = o.histogram("t.hist")
    for v in (0.3, 0.4, 0.6, 0.9, 100.0, 0.0, 2.0 ** 40):
        h.observe(v)
    return ctr, h


def test_instruments_snapshot_equal_to_repro():
    (jctr, jh), (tctr, th) = (_record_instruments(o) for o in BOTH)
    assert tobs.snapshot() == jobs.snapshot()
    assert tobs.registry().to_json() == jobs.registry().to_json()
    assert (tctr.value(), tctr.value(solver="cg"), tctr.total()) == (1, 5, 11)
    assert th.summary() == jh.summary()
    assert (th.summary()["p50"], th.summary()["p99"]) == (1.0, 2.0 ** 40)
    assert list(tobs.snapshot()) == sorted(tobs.snapshot())
    assert json.loads(json.dumps(tobs.snapshot())) == tobs.snapshot()


def test_bucket_edges_and_percentiles_equal_to_repro():
    assert tmetrics.BUCKET_EDGES == jobs.BUCKET_EDGES
    for v in (0.0, -5.0, 2.0 ** -31, 0.125, 1.0, 1.0001, 3.0, 2.0 ** 31, 2.0 ** 40):
        assert tmetrics.bucket_index(v) == jobs.bucket_index(v)
    h = tobs.histogram("t.order")
    for v in (100.0, 0.9, 0.3, 0.6, 0.4):
        h.observe(v)
    h2 = tobs.histogram("t.order2")
    for v in (0.3, 0.4, 0.6, 0.9, 100.0):
        h2.observe(v)
    assert h.summary() == h2.summary() and h.summary()["p50"] == 1.0
    assert tobs.histogram("t.empty").summary()["count"] == 0


def test_counter_contract_and_registry_kinds():
    with pytest.raises(terrors.InvalidArgError, match="negative"):
        tobs.counter("t.neg").inc(-1)
    tobs.counter("t.kind")
    with pytest.raises(TypeError, match="already registered"):
        tobs.gauge("t.kind")
    ctr = tobs.counter("t.reset")
    ctr.inc(4)
    tobs.reset()
    assert ctr.value() == 0 and tobs.counter("t.reset") is ctr
    assert "t.reset" not in tobs.snapshot()


def test_disabled_mode_is_a_noop():
    tobs.configure(enabled=False)
    tobs.counter("t.off").inc(5)
    tobs.gauge("t.off.g").set(1)
    tobs.histogram("t.off.h").observe(2.0)
    with tobs.span("t.off.span") as sp:
        sp.set(k=1)
    assert tobs.snapshot() == {} and tobs.tracer().records() == ()
    tobs.configure(enabled=True)
    tobs.counter("t.off").inc()
    assert tobs.counter("t.off").value() == 1


def test_batch_records_what_its_inc_and_set_calls_would():
    def direct(o):
        o.counter("t.calls").inc(impl="cuda")
        o.counter("t.steps").inc(7, format="coo")
        o.counter("t.steps").inc(2, format="panel")
        o.gauge("t.g").set(16)
    direct(jobs)
    direct(jobs)
    batch = (tobs.Batch().inc("t.calls", impl="cuda").inc("t.steps", 7, format="coo")
             .inc("t.steps", 2, format="panel").set("t.g", 16))
    assert tobs.snapshot() == {}                      # building records nothing
    batch.record()
    batch.record()
    assert tobs.snapshot() == jobs.snapshot()
    tobs.reset()                                      # the batch outlives a reset
    tobs.configure(enabled=False)
    batch.record()
    assert tobs.snapshot() == {}
    tobs.configure(enabled=True)
    batch.record()
    assert tobs.counter("t.steps").value(format="coo") == 7
    with pytest.raises(terrors.InvalidArgError, match="negative"):
        tobs.Batch().inc("t.neg", -1)


# -- spans -----------------------------------------------------------------

def _traced(o):
    o.reset()
    o.configure(clock=FakeClock())
    with o.span("outer", phase="a"):
        with o.span("inner") as sp:
            sp.set(status="ok")
    with pytest.raises(RuntimeError):
        with o.span("boom", n=3):
            raise RuntimeError("x")
    return o.chrome_trace()


def test_spans_and_chrome_trace_equal_to_repro(tmp_path):
    jt, tt = (_traced(o) for o in BOTH)
    assert tt == jt
    assert tt == _traced(tobs)                     # the injectable clock is deterministic
    recs = {r.name: r for r in tobs.tracer().records()}
    assert (recs["outer"].depth, recs["inner"].depth) == (0, 1)
    assert recs["inner"].attrs == {"status": "ok"}
    assert recs["boom"].attrs["error"] == "RuntimeError"
    assert tobs.tracer().summary() == jobs.tracer().summary()
    with open(tobs.export_chrome_trace(tmp_path / "t.trace.json")) as f:
        trace = json.load(f)
    ev = trace["traceEvents"][-1]
    assert (ev["ph"], ev["name"], ev["args"]) == ("X", "boom", {"n": 3, "error": "RuntimeError",
                                                                "depth": 0})


def test_tracer_bounded_buffer_counts_drops():
    t = tobs.Tracer(max_spans=2)
    for _ in range(4):
        with t.span("s"):
            pass
    assert len(t.records()) == 2 and t.dropped == 2


def test_mirrored_counter_feeds_registry_and_stays_local():
    mc = tobs.MirroredCounter(metric="t.mirror", label="site")
    mc["cg"] += 1
    mc["cg"] += 1
    mc["gmres"] += 1
    assert dict(mc) == {"cg": 2, "gmres": 1}
    assert tobs.counter("t.mirror").value(site="cg") == 2
    tobs.reset()
    mc["cg"] += 1
    assert mc["cg"] == 3 and tobs.counter("t.mirror").value(site="cg") == 1
    tobs.configure(enabled=False)
    mc["cg"] += 1
    assert mc["cg"] == 4
    tobs.configure(enabled=True)
    assert tobs.counter("t.mirror").value(site="cg") == 1


# -- ops launch accounting ---------------------------------------------------

def _small_pair(d=64, seed=2):
    r, c, v = jmatrices.banded(d, d, bandwidth=5, fill=0.8, seed=seed)
    v = v.astype(np.float32)
    kw = dict(block_size=16, val_dtype=np.float32)
    return JaxCBMatrix.from_coo(r, c, v, (d, d), **kw), CBMatrix.from_coo(r, c, v, (d, d), **kw)


def _x(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def test_ops_accounting_equal_to_repro_after_the_impl_mapping():
    """cb_spmv (packed and flat + group_size), cb_spmv_into and cb_spmm,
    each impl: the port's snapshot is the reference's with pallas -> cuda."""
    jcb, tcb = _small_pair()
    x = _x(64)
    X = np.random.default_rng(1).standard_normal((64, 3)).astype(np.float32)
    jp, tp = jstreams.build_super_streams(jcb, group_size=2), \
        tstreams.build_super_streams(tcb, group_size=2)
    jf, tf = jstreams.build_streams(jcb), tstreams.build_streams(tcb)
    jt, tt = jstreams.super_tile_stream_from_cb(jcb, group_size=4), \
        tstreams.super_tile_stream_from_cb(tcb, group_size=4)
    for jimpl, timpl in (("pallas", "cuda"), ("reference", "reference")):
        jops.cb_spmv(jp.device_put(), jnp.asarray(x), impl=jimpl, interpret=True)
        tops.cb_spmv(tp, x, impl=timpl, device="cpu")
        jops.cb_spmv(jf.device_put(), jnp.asarray(x), impl=jimpl, interpret=True, group_size=4)
        tops.cb_spmv(tf, x, impl=timpl, device="cpu", group_size=4)
        jops.cb_spmv_into(jnp.zeros(64, jnp.float32), jp.device_put(), jnp.asarray(x),
                          impl=jimpl, interpret=True)
        tops.cb_spmv_into(torch.zeros(64), tp, x, impl=timpl, device="cpu")
        jops.cb_spmm(jt, jnp.asarray(X), impl=jimpl, interpret=True)
        tops.cb_spmm(tt, X, impl=timpl, device="cpu")
    snap = tobs.snapshot()
    assert shared_snapshot(snap) == shared_snapshot(_pallas_as_cuda(jobs.snapshot()))
    assert {s["labels"]["format"] for s in snap["repro.ops.spmv.launches"]["series"]} \
        >= PORT_ONLY_LAUNCHES and "repro.ops.spmv.group_size" not in snap
    stats = tops.spmv_launch_stats(tp)
    steps = {s["labels"]["format"]: s["value"] for s in snap["repro.ops.spmv_into.steps"]["series"]}
    assert steps == {f: n for f, n in stats["steps"].items() if n}
    assert {s["labels"]["impl"]: s["value"] for s in snap["repro.ops.spmv.calls"]["series"]} == \
        {"cuda": 2, "reference": 2}


def test_launch_stats_are_cached_with_the_prepared_stream():
    _, tcb = _small_pair()
    flat = tstreams.build_streams(tcb)
    for G in (1, 2, 4):
        assert tops.spmv_launch_stats(flat, G)["padded"] == \
            tops.spmv_launch_stats(tops._regroup(flat, G))["padded"]
        tops.cb_spmv(flat, _x(64), device="cpu", group_size=G)
        tops.cb_spmv(flat, _x(64), device="cpu", group_size=G)
        assert flat._prepared[G].stats == tops.spmv_launch_stats(flat, G)
        assert len(flat._prepared[G].records) == 1     # one batch, recorded twice
    steps = {s["labels"]["format"]: s["value"]
             for s in tobs.snapshot()["repro.ops.spmv.steps"]["series"]}
    assert steps == {f: 2 * sum(tops.spmv_launch_stats(flat, G)["steps"][f] for G in (1, 2, 4))
                     for f in steps}
    packed = tstreams.build_super_streams(tcb, group_size=2)
    assert tops.spmv_launch_stats(packed)["padded_total"] == sum(packed.padded_work().values())


@pytest.mark.parametrize("impl", ["cuda", "reference"])
def test_cb_spmv_bit_identical_with_obs_on_and_off(impl):
    _, tcb = _small_pair()
    s = tstreams.build_super_streams(tcb, group_size=2)
    x = _x(64)
    y_on = tops.cb_spmv(s, x, impl=impl, device="cpu")
    tobs.configure(enabled=False)
    y_off = tops.cb_spmv(s, x, impl=impl, device="cpu")
    assert torch.equal(y_on, y_off)
    assert tobs.snapshot()["repro.ops.spmv.calls"]["series"][0]["value"] == 1


def test_plan_without_a_structure_hash_records_no_plan_series():
    _, tcb = _small_pair()
    s = tstreams.build_super_streams(tcb, group_size=2)
    tops.cb_spmv(s, _x(64), device="cpu",
                 plan=types.SimpleNamespace(block_size=16, group_size=2))
    assert not any(k.startswith("repro.autotune") for k in tobs.snapshot())


def _spd_coo(d=96, seed=3):
    r, c, v = jmatrices.spd_banded(d, bandwidth=7, seed=seed)
    return r, c, v.astype(np.float32), (d, d)


def test_planned_matvec_records_measured_vs_predicted_like_repro():
    r, c, v, shape = _spd_coo()
    kw = dict(block_size=16, val_dtype=np.float32)
    jop = JaxOperator.from_cb(JaxCBMatrix.from_coo(r, c, v, shape, **kw), plan="auto",
                              plan_settings=JaxSettings(mode="heuristic"))
    top = CBLinearOperator.from_cb(CBMatrix.from_coo(r, c, v, shape, **kw), plan="auto",
                                   device="cpu")
    assert top.plan.to_json() == jop.plan.to_json() and top.plan.mode == "heuristic"
    jop.matvec(jnp.zeros(96, jnp.float32), interpret=True)
    top.matvec(torch.zeros(96))
    snap = tobs.snapshot()
    exec_keys = [k for k in snap if k.startswith("repro.autotune.exec")]
    assert exec_keys and {k: snap[k] for k in exec_keys} == \
        {k: jobs.snapshot()[k] for k in exec_keys}
    label = top.plan.structure_hash[:12]
    padded = {(s["labels"]["kind"], s["labels"]["plan"]): s["value"]
              for s in snap["repro.autotune.exec.padded_elems"]["series"]}
    assert padded[("measured", label)] == tops.spmv_launch_stats(top.streams)["padded_total"]
    assert padded[("predicted", label)] == top.plan.predicted_padded_elems


def test_plan_cache_counters_mirror_to_registry(tmp_path):
    cache = PlanCache(tmp_path)
    r, c, v, shape = _spd_coo()
    for _ in range(2):
        CBMatrix.plan_for(r, c, v, shape, cache=cache, settings=HEURISTIC)
    assert (cache.hits, cache.misses, cache.stale) == (1, 1, 0)
    ctr = tobs.counter("repro.autotune.plan_cache.lookups")
    assert (ctr.value(outcome="hit"), ctr.value(outcome="miss")) == (1, 1)


# -- robust_solve's attempt telemetry ------------------------------------------

def _nonsym(d=96, seed=5):
    """The solver tests' nonsymmetric system: CG's attempt fails, BiCGStab's converges."""
    r, c, v = jmatrices.banded(d, d, bandwidth=7, fill=0.8, seed=seed)
    diag = np.arange(d)
    r, c = np.concatenate([r, diag]), np.concatenate([c, diag])
    v = np.concatenate([v, np.full(d, 8.0)]).astype(np.float32)
    kw = dict(block_size=16, val_dtype=np.float32)
    return (JaxOperator.from_cb(JaxCBMatrix.from_coo(r, c, v, (d, d), **kw)),
            CBLinearOperator.from_cb(CBMatrix.from_coo(r, c, v, (d, d), **kw), device="cpu"))


def _counters(snap, prefix="repro.solvers.robust."):
    return {k: {tuple(sorted(s["labels"].items())): s["value"] for s in v["series"]}
            for k, v in snap.items() if k.startswith(prefix)}


@pytest.mark.parametrize("impl", ["cuda", "reference"])
def test_robust_solve_counters_and_spans_match_repro(impl):
    jop, top = _nonsym()
    b = _x(96, 2)
    x0 = np.full(96, np.nan, np.float32)              # a poisoned warm start is sanitized
    jres = j_robust(jop, jnp.asarray(b), x0=jnp.asarray(x0), tol=1e-6, maxiter=300,
                    impl="reference")
    tres = robust_solve(top, b, x0=x0, tol=1e-6, maxiter=300, impl=impl)
    assert tres.converged and tres.sanitized_x0 and len(tres.attempts) >= 2
    tc, jc = _counters(tobs.snapshot()), _counters(jobs.snapshot())
    its_t, its_j = tc.pop("repro.solvers.robust.iterations"), \
        jc.pop("repro.solvers.robust.iterations")
    assert tc == jc                     # calls, sanitized_x0, attempts{solver,reason}, outcome
    assert its_t == {(("solver", a.solver),): a.iterations for a in tres.attempts}
    assert its_t.keys() == its_j.keys()
    assert all(abs(its_t[k] - its_j[k]) <= 2 for k in its_t)   # the solver tests' margin
    assert tobs.counter("repro.solvers.robust.attempts").total() == len(tres.attempts)
    names = shared_spans(r.name for r in tobs.tracer().records())
    assert names == [r.name for r in jobs.tracer().records()]
    assert names[-1] == "robust_solve" and f"solve:{tres.solver}" in names
    root = tobs.tracer().records()[-1]
    assert root.attrs["outcome"] == "converged" and root.attrs["attempts"] == len(tres.attempts)
