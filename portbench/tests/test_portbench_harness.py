"""The harness on the CPU at tiny sizes: the result line, the metrics'
arithmetic over the whole window, the byte floor, the control and the
faults that the check has to catch."""
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import pb_common
from pb_common import SEED, TINY
from harness import runner, spec

CELLS = list(TINY)


BENCH = pb_common.bench()


def run(cell, trace=False, seconds=0.6, seed=SEED):
    return runner.run_cell(cell, seed, seconds, trace, device="cpu", config_override=TINY[cell],
                           bench=BENCH)


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_keys_and_correct(cell):
    line = run(cell)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    names = {m["name"] for m in spec.Cell(BENCH, cell).end_to_end()}
    assert set(line["metrics"]) == names and "setup_s" in names and len(names) >= 2
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(line)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line_has_per_layer_metrics_and_breakdown(cell):
    line = run(cell, trace=True, seconds=1.5)
    assert list(line)[-1] == "checks" and "breakdown" in line
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert line["device"]["window_s"] > 0
    per_layer = {m["name"] for m in spec.Cell(BENCH, cell).per_layer()}
    assert set(line["metrics"]) <= per_layer and "build_s" in line["metrics"]
    # the CPU has no device trace: the device metrics are left out, never 0
    assert not {"device_idle.spmv", "spmv_roofline"} & set(line["metrics"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


class _Stall:
    """Wraps an entry's Program so that unit ``at`` sleeps ``seconds`` first."""

    def __init__(self, monkeypatch, cell, at, seconds, every=None):
        entry = spec.Cell(BENCH, cell).entry
        step = entry.Program.step

        def stalled(prog, i):
            if i == at or (every and i % every == 0 and i):
                time.sleep(seconds)
            return step(prog, i)
        monkeypatch.setattr(entry.Program, "step", stalled)


def _metric_run(cell, seconds):
    """run_cell with the Run object captured."""
    captured = {}
    orig = runner._window

    def window(r, prog, cell_, t0):
        orig(r, prog, cell_, t0)
        captured["run"] = r
    runner._window = window
    try:
        line = run(cell, seconds=seconds)
    finally:
        runner._window = orig
    return line, captured["run"]


def test_spmv_gflops_counts_every_call_over_the_whole_window():
    line, r = _metric_run("g500s20-spmv", 0.5)
    nnz = r.matrix["rows"].size
    assert line["attempted"] == r.units
    assert line["metrics"]["spmv_gflops"]["value"] == pytest.approx(
        2 * nnz * r.units / r.window_s / 1e9)
    assert r.window_s >= 0.5


def test_a_stall_in_the_window_moves_spmv_gflops(monkeypatch):
    base, rb = _metric_run("g500s20-spmv", 0.6)
    _Stall(monkeypatch, "g500s20-spmv", at=5, seconds=0.4)
    stalled, rs = _metric_run("g500s20-spmv", 0.6)
    assert rs.window_s >= 0.6
    rate = lambda r: r.units / r.window_s  # noqa: E731
    assert stalled["metrics"]["spmv_gflops"]["value"] < 0.85 * base["metrics"]["spmv_gflops"]["value"]
    assert rate(rs) < 0.85 * rate(rb)


def test_byte_floor_counts_values_x_and_y_once():
    floor = spec.module("metrics", "spmv_roofline").floor_bytes
    n = 2 ** 20
    assert floor(31_406_324, n, n) == 4 * 31_406_324 + 8 * 1_048_576 == 134_013_904
    assert floor(10, 3, 5) == 40 + 12 + 20


def test_per_layer_selection_follows_the_benchmark():
    bench = BENCH
    for w in bench["workloads"]:
        cell = spec.Cell(bench, w["name"])
        e2e = {m["name"] for m in cell.end_to_end()}
        for m in cell.per_layer():
            assert m["moves"] in e2e
        for m in bench["end_to_end"] + bench["per_layer"]:
            assert (spec.BENCH / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit(cell):
    import control
    nums = control.control_numbers(cell, SEED, "cpu", TINY[cell], bench=BENCH)
    limits = spec.Cell(BENCH, cell).limits
    assert any(v > float(limits[k]["limit"]) for k, v in nums.items()), nums


def test_y_err_holds_each_row_to_its_own_scale():
    """An ordinary row rounded to bfloat16 fails the limit, though a hub row's
    |A| |x| is thousands of times larger; the exact product passes."""
    from reference.sparse import of_matrix
    cell = spec.Cell(BENCH, "g500s20-spmv", TINY["g500s20-spmv"])
    matrix = cell.matrix_gen.generate(cell.config["params"], SEED)
    inputs = cell.entry.make_inputs(matrix, cell.config, cell.traffic, SEED, torch.device("cpu"))
    A = of_matrix(matrix, "cpu")
    x = inputs["X"][0]
    y = A.matvec(x).to(torch.float32)
    scale = A.matvec(x, absolute=True)
    deg = np.bincount(matrix["rows"], minlength=y.numel())
    row = int(np.flatnonzero(deg == 1)[0])
    assert float(scale.max()) > 1000 * float(scale[row])
    limit = float(cell.limits["y_err"]["limit"])
    assert cell.entry.check(matrix, inputs, [(0, y)], cell.traffic, "cpu")["y_err"] < limit
    bad = y.clone()
    bad[row] = (y[row] * (1 + 2**-8)).to(torch.bfloat16).to(torch.float32)
    assert cell.entry.check(matrix, inputs, [(0, bad)], cell.traffic, "cpu")["y_err"] > limit
    empty = int(np.flatnonzero(deg == 0)[0])
    bad = y.clone()
    bad[empty] = 1e-30
    assert cell.entry.check(matrix, inputs, [(0, bad)], cell.traffic, "cpu")["y_err"] > limit


def _fault_answer_altered(monkeypatch):
    from repro_torch.kernels import ops
    real = ops.cb_spmv

    def altered(*a, **k):
        y = real(*a, **k)
        y[y.numel() // 3] += 1.0
        return y
    monkeypatch.setattr(ops, "cb_spmv", altered)


def _fault_half_left_out(monkeypatch):
    from repro_torch.kernels import ops
    real = ops.cb_spmv

    def half(*a, **k):
        y = real(*a, **k)
        y[y.numel() // 2:] = 0
        return y
    monkeypatch.setattr(ops, "cb_spmv", half)


FAULTS = {"answer_altered": _fault_answer_altered, "half_left_out": _fault_half_left_out}
CASES = [(c, f) for c in CELLS for f in FAULTS]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    line = run(cell, seconds=0.4)
    assert line["correct"] is False, line["checks"]


def test_run_py_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; tested by test_run_py_on_the_card")
    proc = subprocess.run([sys.executable, str(spec.BENCH / "run.py"), "--workload",
                           "g500s20-spmv", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=spec.ROOT, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    assert "repro_torch" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert runner.forbidden_modules() == ["repro"]


@pytest.mark.cuda
def test_run_py_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cmd = [sys.executable, "portbench/run.py", "--workload", "g500s20-spmv", "--seed", "3",
           "--seconds", "2", "--trace", "0"]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=spec.ROOT, timeout=360)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    # a directory with only BENCHMARK.json and the benchmark's files has no program
    import shutil
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("out"))
    bare = subprocess.run(cmd, capture_output=True, text=True, cwd=tmp_path, timeout=360)
    assert bare.returncode != 0 and not bare.stdout.strip()
