"""The readers of what the program records of itself, with no card: the six
``build.*_s`` spans, ``host_self_us`` from the profiler's annotations of
``cb_spmv`` and ``launches_per_call`` from the launch counters. Each runs on
a synthetic run (a hand-built Chrome trace, a tracer holding known records);
a missing span or an empty sub-window reads None, never 0."""
import json
import time
import types

import numpy as np
import pytest
import torch

import pb_common
from pb_common import SEED, TINY
from harness import runner, spec, trace
from repro_torch import obs
from repro_torch.core import CBMatrix
from repro_torch.core import streams as tstreams
from repro_torch.kernels import ops

BENCH = pb_common.bench()
BUILD = {"build.partition_s": "cb.partition", "build.colagg_s": "cb.colagg",
         "build.formats_s": "cb.formats", "build.balance_s": "cb.balance",
         "build.pack_s": "streams.build_super", "build.to_device_s": "streams.to"}
NEW = [*BUILD, "host_self_us", "launches_per_call"]


def read(name, run):
    return spec.module("metrics", name).read(run)


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.configure(enabled=True, clock=time.monotonic)
    obs.reset()
    yield
    obs.configure(enabled=True, clock=time.monotonic)
    obs.reset()


def _scripted_clock(times):
    it = iter(times)
    return lambda: next(it)


def test_the_eight_entries_are_in_the_benchmark():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["workloads"] == ["g500s20-spmv"] and m["better"] == "lower"
        assert m["source"] == ("program_counter" if name == "launches_per_call"
                               else "program_span")
        assert (m["layer"], m["moves"]) == (("host build", "setup_s") if name in BUILD
                                            else ("entry", "spmv_gflops"))


# -- the build's spans -------------------------------------------------------------

def test_build_readers_sum_their_spans_records():
    # the tracer's epoch, then each span's start and end
    obs.configure(clock=_scripted_clock([0.0, 1.0, 1.5, 2.0, 2.25, 3.0, 7.0, 8.0, 8.5]))
    with obs.span("cb.partition"):
        pass
    with obs.span("cb.partition"):
        pass
    with obs.span("streams.build_super"):
        with obs.span("cb.other"):
            pass
    run = types.SimpleNamespace(trace=None)
    assert read("build.partition_s", run) == pytest.approx(0.75)
    assert read("build.pack_s", run) == pytest.approx(5.5)
    for name in ("build.colagg_s", "build.formats_s", "build.balance_s", "build.to_device_s"):
        assert read(name, run) is None


def test_build_readers_read_none_without_records():
    run = types.SimpleNamespace(trace=None)
    assert all(read(name, run) is None for name in BUILD)


def test_build_readers_on_a_real_build():
    rng = np.random.default_rng(0)
    r, c = rng.integers(0, 96, 400), rng.integers(0, 80, 400)
    keys = np.unique(r * 80 + c)
    cb = CBMatrix.from_coo(keys // 80, keys % 80, np.ones(len(keys), np.float32), (96, 80),
                           use_column_aggregation=True)
    tstreams.build_super_streams(cb).to("cpu")
    run = types.SimpleNamespace(trace=None)
    recs = {}
    for rec in obs.tracer().records():
        recs[rec.name] = recs.get(rec.name, 0.0) + rec.duration
    for name, span in BUILD.items():
        assert read(name, run) == pytest.approx(recs[span]) and read(name, run) > 0
    assert sum(read(name, run) for name in BUILD) <= recs["cb.from_coo"] + \
        recs["streams.build_super"] + recs["streams.to"]


# -- host_self_us from a hand-built trace --------------------------------------------

def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def _trace(tmp_path, events, units=2):
    path = tmp_path / "hand.trace.json"
    sub = _x(trace.SUBWINDOW, "user_annotation", 1000.0, 1000.0)
    path.write_text(json.dumps({"traceEvents": [sub, *events]}))
    return types.SimpleNamespace(trace=trace.reduce(path, units=units))


def test_host_self_us_subtracts_the_runtime_calls_inside_each_call(tmp_path):
    run = _trace(tmp_path, [
        _x("cb_spmv", "user_annotation", 1100.0, 100.0),
        _x("aten::index_select", "cpu_op", 1105.0, 40.0),       # the program's own: kept
        _x("cudaLaunchKernel", "cuda_runtime", 1120.0, 30.0),
        _x("cuLaunchKernel", "cuda_driver", 1125.0, 10.0),       # inside the one above
        _x("cudaLaunchKernel", "cuda_runtime", 1160.0, 20.0),
        _x("cb_spmv", "user_annotation", 1400.0, 80.0),
        _x("cudaMemsetAsync", "cuda_runtime", 1410.0, 10.0),
        _x("cudaLaunchKernel", "cuda_runtime", 1475.0, 20.0),     # crosses the call's end
        _x("cb_spmv", "user_annotation", 900.0, 150.0),           # starts before the window
        _x("cb_spmv", "user_annotation", 1600.0, 50.0, tid=2),    # another thread
        _x("cb_coo_kernel", "kernel", 1130.0, 200.0, tid=7),
    ])
    assert read("host_self_us", run) == pytest.approx(((100 - 50) + (80 - 10)) / 2)


def test_host_self_us_reads_none_on_an_empty_sub_window(tmp_path):
    run = _trace(tmp_path, [_x("aten::add", "cpu_op", 1100.0, 10.0),
                            _x("cb_spmv", "user_annotation", 2100.0, 10.0)], units=0)
    assert read("host_self_us", run) is None
    assert read("host_self_us", types.SimpleNamespace(trace=None)) is None


# -- launches_per_call from the counters ---------------------------------------------

def test_launches_per_call_totals_every_series_over_the_cuda_calls():
    launches = obs.counter("repro.ops.spmv.launches")
    run = types.SimpleNamespace(trace=None)
    assert read("launches_per_call", run) is None
    obs.counter("repro.ops.spmv.calls").inc(4, impl="cuda")
    obs.counter("repro.ops.spmv.calls").inc(9, impl="reference")
    launches.inc(4, format="coo")
    assert read("launches_per_call", run) is None      # no gather counted: not every kernel
    for fmt, n in (("gather", 4), ("combine", 8), ("fill", 4)):
        launches.inc(n, format=fmt)
    assert read("launches_per_call", run) == 5.0


def test_launches_per_call_equals_the_engines_count_on_the_cpu():
    rng = np.random.default_rng(1)
    r, c = rng.integers(0, 64, 300), rng.integers(0, 64, 300)
    keys = np.unique(r * 64 + c)
    cb = CBMatrix.from_coo(keys // 64, keys % 64, np.ones(len(keys), np.float32), (64, 64))
    s = tstreams.build_super_streams(cb)
    for _ in range(3):
        ops.cb_spmv(s, torch.ones(64), device="cpu")
    want = sum(ops.spmv_launch_stats(s)["launches"].values()) + \
        sum(ops._prepare(s, None).engine["spmv"].values())
    assert read("launches_per_call", types.SimpleNamespace(trace=None)) == want


# -- a traced run ---------------------------------------------------------------------

def test_a_traced_cpu_run_reports_the_eight_metrics():
    line = runner.run_cell("g500s20-spmv", SEED, 1.5, True, device="cpu",
                           config_override=TINY["g500s20-spmv"], bench=BENCH)
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(NEW) <= set(metrics) and all(metrics[k] > 0 for k in NEW)
    assert sum(metrics[k] for k in BUILD) <= metrics["build_s"]
    # per present format a gather and a kernel, then the combine (one pass here) and y's fill
    assert (metrics["launches_per_call"] - 2) / 2 in (1, 2, 3)
