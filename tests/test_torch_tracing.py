"""The port's spans and launch counters on the benchmarked path, on the CPU.

- the host build records ``cb.from_coo`` with one child span per step
  (``cb.partition`` twice where column aggregation applies), then
  ``streams.build_super`` and ``streams.to``;
- each ``cb_spmv`` / ``cb_spmv_into`` call records exactly one span of its
  own name, none with obs disabled, and the same bits either way;
- under a recording ``torch.profiler`` every span is also a
  ``user_annotation`` of the exported trace that encloses the call's aten
  ops; with no profiler recording no ``record_function`` is entered;
- each ``build_super_streams`` sets ``repro.streams.nnz{format}``, the
  non-zeros each format holds, and no call sets it;
- ``repro.ops.{spmv,spmv_into}.launches`` counts, per call, every kernel
  the engine runs (``gather``, ``combine``, ``fill`` beside the formats;
  ``gather`` only for dense and panel groups, and as a 0 series where there
  are none: the COO kernel reads x itself);
  the ``group_size`` gauge is gone;
- ``repro_torch.obs`` imports and records with torch absent.

The card's side (the registry's launches against the profiler's kernels,
a two-pass combine) is ``tests/test_torch_card.py``.
"""
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import CBMatrix
from repro_torch.core import streams as tstreams
from repro_torch.core.formats import FormatThresholds
from repro_torch.data import matrices
from repro_torch.kernels import cb_combine, ops

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.configure(enabled=True, clock=time.monotonic)
    obs.reset()
    yield
    obs.configure(enabled=True, clock=time.monotonic)
    obs.reset()


def _clustered():
    """Triplets with dense, panel and COO blocks (all three formats)."""
    r, c, v = matrices.block_clustered(144, 120, seed=11)
    return r, c, v.astype(np.float32), (144, 120)


def _streams(colagg="auto"):
    r, c, v, shape = _clustered()
    cb = CBMatrix.from_coo(r, c, v, shape, block_size=16, use_column_aggregation=colagg)
    return tstreams.build_super_streams(cb)


def _x(n=120, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(n).astype(np.float32))


def _call(entry, s, x, impl="cuda"):
    if entry == "spmv":
        return ops.cb_spmv(s, x, impl=impl, device="cpu")
    return ops.cb_spmv_into(torch.zeros(s.m), s, x, impl=impl, device="cpu")


# -- the host build -------------------------------------------------------------

@pytest.mark.parametrize("colagg", [True, False])
def test_build_records_its_phases_nested(colagg):
    r, c, v, shape = _clustered()
    cb = CBMatrix.from_coo(r, c, v, shape, block_size=16, use_column_aggregation=colagg)
    s = tstreams.build_super_streams(cb).to("cpu")
    recs = obs.tracer().records()
    steps = ["cb.partition", "cb.colagg"] + (["cb.partition"] if colagg else [])
    assert [r.name for r in recs] == steps + ["cb.formats", "cb.balance", "cb.from_coo",
                                              "streams.build_super", "streams.to"]
    root = recs[-3]
    for rec in recs[:-3]:
        assert rec.depth == 1 and rec.tid == root.tid
        assert root.start <= rec.start and rec.start + rec.duration <= root.start + root.duration
    assert [r.depth for r in recs[-3:]] == [0, 0, 0]
    assert root.attrs == {"nnz": len(v), "blocks": cb.num_blocks, "colagg": colagg}
    assert recs[-2].attrs == {"blocks": cb.num_blocks, "group_size": s.group_size}
    assert {r.name: r.attrs.get("colagg") for r in recs}["cb.colagg"] is colagg


def test_build_records_nothing_with_obs_disabled():
    obs.configure(enabled=False)
    _streams().to("cpu")
    assert obs.tracer().records() == ()


# -- the non-zeros each format holds --------------------------------------------

def _series(name):
    metric = obs.snapshot().get(name, {"series": []})
    return {d["labels"]["format"]: d["value"] for d in metric["series"]}


@pytest.mark.parametrize("kind", ["banded", "power_law", "block_clustered"])
def test_each_build_records_the_nonzeros_each_format_holds(kind):
    """``repro.streams.nnz{format}`` sums to the matrix's non-zeros, and a
    call's ``padded_elems`` holds at least as many slots; calls leave it be."""
    r, c, v = getattr(matrices, kind)(192, 192, seed=3)
    cb = CBMatrix.from_coo(r, c, v.astype(np.float32), (192, 192), block_size=16)
    s = tstreams.build_super_streams(cb)
    nnz = _series("repro.streams.nnz")
    assert set(nnz) == {"dense", "panel", "coo"} and sum(nnz.values()) == cb.nnz == len(v)
    assert nnz["panel"] > 0 and nnz["coo"] > 0
    assert (nnz["dense"] > 0) == (kind == "block_clustered")
    obs.reset()
    ops.cb_spmv(s, _x(192), device="cpu")
    padded = _series("repro.ops.spmv.padded_elems")
    assert all(n <= padded[f] for f, n in nnz.items() if n)
    assert "repro.streams.nnz" not in obs.snapshot()          # set by the build alone


def test_a_build_with_obs_disabled_sets_no_gauge():
    obs.configure(enabled=False)
    s = _streams()
    obs.configure(enabled=True)
    assert obs.snapshot() == {}
    ops.cb_spmv(s, _x(), device="cpu")
    assert "repro.streams.nnz" not in obs.snapshot()


# -- one span a call ------------------------------------------------------------

@pytest.mark.parametrize("impl", ["cuda", "reference"])
@pytest.mark.parametrize("entry", ["spmv", "spmv_into"])
def test_each_call_records_one_span_and_none_when_disabled(entry, impl):
    s = _streams()
    x = _x()
    obs.reset()
    on = [_call(entry, s, x, impl) for _ in range(3)]
    recs = obs.tracer().records()
    assert [(r.name, r.depth, r.attrs) for r in recs] == [(f"cb_{entry}", 0, {})] * 3
    obs.configure(enabled=False)
    off = [_call(entry, s, x, impl) for _ in range(3)]
    assert obs.tracer().records() == recs
    assert all(torch.equal(a, b) for a, b in zip(on, off))


def test_a_refused_call_still_closes_its_span():
    s = _streams()
    obs.reset()
    with pytest.raises(Exception, match="x has shape"):
        ops.cb_spmv(s, torch.zeros(3), device="cpu")
    (rec,) = obs.tracer().records()
    assert (rec.name, rec.attrs["error"]) == ("cb_spmv", "InvalidArgError")
    with obs.span("next"):
        pass
    assert obs.tracer().records()[-1].depth == 0


# -- the profiler's clock -------------------------------------------------------

def test_profiler_trace_holds_the_call_as_a_user_annotation(tmp_path):
    s = _streams()
    x = _x()
    ops.cb_spmv(s, x, device="cpu")                  # prepared before the profiled call
    obs.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        y = ops.cb_spmv(s, x, device="cpu")
    assert torch.equal(y, ops.cb_spmv(s, x, device="cpu"))
    path = tmp_path / "call.trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    (ann,) = [e for e in events if e["name"] == "cb_spmv" and e.get("cat") == "user_annotation"]
    t0, t1 = ann["ts"], ann["ts"] + ann["dur"]
    aten = [e for e in events if e.get("cat") == "cpu_op" and e["tid"] == ann["tid"]]
    assert {"aten::zeros", "aten::index_select", "aten::index_add_"} <= {e["name"] for e in aten}
    assert all(t0 <= e["ts"] and e["ts"] + e["dur"] <= t1 for e in aten)
    assert [r.name for r in obs.tracer().records()] == ["cb_spmv", "cb_spmv"]


def test_no_record_function_without_a_recording_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def spy(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    s = _streams()
    x = _x()
    for entry in ("spmv", "spmv_into"):
        _call(entry, s, x)
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for entry in ("spmv", "spmv_into"):
            _call(entry, s, x)
    assert entered == ["cb_spmv", "cb_spmv_into"]


# -- every kernel a call launches ------------------------------------------------

@pytest.mark.parametrize("entry", ["spmv", "spmv_into"])
def test_launch_series_per_call_count_the_engine(entry):
    s = _streams()
    x = _x()
    calls = 4
    for _ in range(calls):
        _call(entry, s, x)
    snap = obs.snapshot()
    got = {d["labels"]["format"]: d["value"] / calls
           for d in snap[f"repro.ops.{entry}.launches"]["series"]}
    stats = ops.spmv_launch_stats(s)
    assert stats["launches"] == {"dense": 1, "panel": 1, "coo": 1}
    want = {"dense": 1, "panel": 1, "coo": 1, "gather": 2, "combine": 1}
    if entry == "spmv":
        want["fill"] = 1
    assert got == want == {**stats["launches"], **ops._prepare(s, None).engine[entry]}
    assert not [k for k in snap if k.endswith(".group_size")]


def test_engine_counts_the_combine_plans_passes():
    """A block row of more slots than a chunk takes the combine's second pass;
    the count is the plan's, as the card runs it."""
    s = _streams()
    stats = ops.spmv_launch_stats(s)
    for rows, passes in ((list(range(40)) + [0] * 40, 2), (list(range(80)), 1)):
        plan = cb_combine.plan_combine(torch.tensor(rows, dtype=torch.int32), "cpu")
        assert len(plan.passes) == passes
        engine = ops._engine_launches(stats, plan, len(rows), s.m)
        assert engine == {"spmv": {"gather": 2, "combine": passes, "fill": 1},
                          "spmv_into": {"gather": 2, "combine": passes}}
    assert ops._engine_launches(stats, None, 0, 0)["spmv"] == {"gather": 2, "combine": 0,
                                                             "fill": 0}


def _coo_hub_streams():
    """Every block COO: a hub row over every fourth column (its block row is
    longer than one combine chunk) and the diagonal."""
    m, n = 256, 1024
    rows = np.concatenate([np.zeros(n // 4, np.int64), np.arange(1, m)])
    cols = np.concatenate([np.arange(0, n, 4), np.arange(1, m)])
    vals = np.random.default_rng(5).standard_normal(len(rows)).astype(np.float32)
    cb = CBMatrix.from_coo(rows, cols, vals, (m, n), block_size=16,
                           thresholds=FormatThresholds(th1=256, th2=256))
    return tstreams.build_super_streams(cb)


def test_a_coo_only_call_gathers_nothing_and_says_so():
    """A COO-only stream: ``gather`` is a series that reads 0, and the call
    counts 4 launches where the combine takes two passes, as on the card
    (the CPU path's combine is one ``index_add_``)."""
    s = _coo_hub_streams()
    stats = ops.spmv_launch_stats(s)
    assert stats["launches"] == {"dense": 0, "panel": 0, "coo": 1}
    x = _x(1024, seed=2)
    y = _call("spmv", s, x)
    got = {d["labels"]["format"]: d["value"]
           for d in obs.snapshot()["repro.ops.spmv.launches"]["series"]}
    assert got == {"coo": 1, "gather": 0, "combine": 1, "fill": 1}
    prep = ops._prepare(s, None)
    plan = cb_combine.plan_combine(prep.brow, "cpu")
    assert len(plan.passes) == 2
    engine = ops._engine_launches(stats, plan, prep.brow.numel(), s.m)["spmv"]
    assert engine == {"gather": 0, "combine": 2, "fill": 1}
    assert sum(engine.values()) + sum(stats["launches"].values()) == 4
    torch.testing.assert_close(y, _call("spmv", s, x, impl="reference"), rtol=1e-5, atol=1e-5)


def test_spmm_records_no_group_size_gauge():
    r, c, v, shape = _clustered()
    cb = CBMatrix.from_coo(r, c, v, shape, block_size=16)
    ts = tstreams.super_tile_stream_from_cb(cb, group_size=4)
    ops.cb_spmm(ts, torch.ones(120, 3), device="cpu")
    snap = obs.snapshot()
    assert snap["repro.ops.spmm.launches"]["series"] and \
        not [k for k in snap if k.endswith(".group_size")]


# -- the span system itself ------------------------------------------------------

def test_obs_imports_and_records_without_torch():
    code = ("import sys\n"
            "from repro_torch import obs\n"
            "with obs.span('outer', n=1):\n"
            "    with obs.span('inner'):\n"
            "        pass\n"
            "recs = obs.tracer().records()\n"
            "assert [(r.name, r.depth) for r in recs] == [('inner', 1), ('outer', 0)], recs\n"
            "assert 'torch' not in sys.modules, 'obs imported torch'\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_span_depth_recovers_after_an_exception_and_is_per_thread():
    with pytest.raises(RuntimeError):
        with obs.span("a"):
            with obs.span("b"):
                raise RuntimeError("x")
    with obs.span("c"):
        worker = threading.Thread(target=lambda: obs.span("t").__enter__().__exit__(
            None, None, None))
        worker.start()
        worker.join(timeout=30)
    assert not worker.is_alive()
    recs = {r.name: r for r in obs.tracer().records()}
    assert {n: r.depth for n, r in recs.items()} == {"b": 1, "a": 0, "t": 0, "c": 0}
    assert recs["t"].tid != recs["c"].tid == recs["a"].tid
    assert recs["a"].attrs == recs["b"].attrs == {"error": "RuntimeError"}


def test_span_records_are_slotted_and_keep_their_attrs():
    with obs.span("s", n=2) as sp:
        sp.set(status="ok")
    sp.set(late=True)                                  # after the record was taken
    with obs.span("bare"):
        pass
    rec, bare = obs.tracer().records()
    assert not hasattr(rec, "__dict__")
    assert rec.attrs == {"n": 2, "status": "ok"} and bare.attrs == {}
    with pytest.raises(AttributeError):
        rec.name = "other"
    assert obs.tracer().summary()[0]["count"] == 1
