"""One run of one cell: set-up, the measured window, the reading of the
traced sub-window, the check against the reference, the result line."""
from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time

import numpy as np
import torch

from harness import device as dev_info
from harness import spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # compared as whole top-level names


@dataclasses.dataclass
class Run:
    """What a metric reader may read of one run."""

    cell: spec.Cell
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    matrix: dict
    nnz: int
    program: object = None
    setup_s: float = 0.0
    build_s: float = 0.0
    window_s: float = 0.0
    units: int = 0
    unit_s: list = dataclasses.field(default_factory=list)   # per blocking unit
    results: dict = dataclasses.field(default_factory=dict)
    trace: trace.Trace | None = None
    peaks: dict = dataclasses.field(default_factory=dict)
    marks: list = dataclasses.field(default_factory=list)    # units done at each second
    host: dict = dataclasses.field(default_factory=dict)     # the window's CPU time


def forbidden_modules() -> list[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def read_metric(run: Run, metric: dict):
    value = spec.module("metrics", metric["name"]).read(run)
    return None if value is None else float(value)


class _SubWindow:
    """The profiled stretch of a traced run's window."""

    def __init__(self, run: Run, prog, cell: spec.Cell, first_unit: int):
        self.run, self.prog, self.cell, self.first = run, prog, cell, first_unit
        prog.sync()
        self.prof = torch.profiler.profile(activities=trace.activities(run.device))
        self.prof.__enter__()
        self.span = torch.profiler.record_function(trace.SUBWINDOW)
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def close(self, next_unit: int) -> None:
        self.prog.sync()
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        spec.OUT.mkdir(parents=True, exist_ok=True)
        path = spec.OUT / f"{self.cell.name}.trace.json"
        self.prof.export_chrome_trace(str(path))
        self.run.trace = trace.reduce(path, units=next_unit - self.first)


def warm_profiler(device: torch.device) -> None:
    """Start and stop the profiler once, so that its first start (CUPTI's
    set-up) is not paid inside the window."""
    with torch.profiler.profile(activities=trace.activities(device)):
        torch.zeros(1, device=device).add_(1)


def _window(run: Run, prog, cell: spec.Cell, t_setup0: float) -> None:
    """Dispatch units until ``seconds`` have passed; in a traced run profile
    a steady sub-window from a third of the way in."""
    blocking = cell.entry.BLOCKING
    sub_s = float(cell.traffic.get("trace_subwindow_s", 1.0))
    sub, done = None, False
    run.setup_s = time.perf_counter() - t_setup0
    cpu0 = time.process_time()
    t_start = time.perf_counter()
    i, next_mark = 0, 1.0
    while True:
        if run.traced and not done and sub is None \
                and time.perf_counter() - t_start >= run.seconds / 3:
            sub = _SubWindow(run, prog, cell, i)
        t0 = time.perf_counter()
        prog.step(i)
        if blocking:
            run.unit_s.append(time.perf_counter() - t0)
        i += 1
        if sub is not None and time.perf_counter() - sub.t0 >= sub_s:
            sub.close(i)
            sub, done = None, True
        elapsed = time.perf_counter() - t_start
        if elapsed >= next_mark:
            run.marks.append(i)
            next_mark += 1.0
        if elapsed >= run.seconds:
            break
    if sub is not None:
        sub.close(i)
    prog.sync()
    run.window_s = time.perf_counter() - t_start
    run.units = i
    run.host = {"cpu_s": time.process_time() - cpu0}


def _reserve(device: torch.device, nbytes: int) -> int:
    """Grow the caching allocator by what the window's kept outputs will
    hold, so that keeping them calls no ``cudaMalloc`` inside the window.
    Returns the peak so far; the window's peak is counted afresh after it."""
    peak = dev_info.memory_peak(device)
    if device.type == "cuda" and nbytes > 0:
        buf = torch.empty(int(nbytes), dtype=torch.uint8, device=device)
        del buf
        dev_info.reset_peak(device)
    return peak


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool, *, device="cuda",
             t_start: float | None = None, config_override: dict | None = None,
             bench: dict | None = None, log=print) -> dict:
    """Run one cell; return the result line as a dict (``checks`` last)."""
    t_setup0 = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    bench = spec.benchmark() if bench is None else bench
    cell = spec.Cell(bench, cell_name, config_override)
    seed = int(seed) % (1 << 63)
    phases = {"to_generate_s": time.perf_counter() - t_setup0}
    matrix = cell.matrix_gen.generate(cell.config["params"], seed)
    phases["generate_s"] = time.perf_counter() - t_setup0 - phases["to_generate_s"]
    run = Run(cell=cell, seed=seed, seconds=float(seconds), traced=traced, device=device,
              matrix=matrix, nnz=int(matrix["rows"].size))
    run.peaks = spec.load_json(spec.BENCH / "peaks.json")
    t0 = time.perf_counter()
    inputs = cell.entry.make_inputs(matrix, cell.config, cell.traffic, seed, device)
    phases["inputs_s"] = time.perf_counter() - t0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    dev_info.sync(device)
    dev_info.reset_peak(device)
    prog = cell.entry.Program(matrix, cell.config, cell.traffic, inputs, seed, device)
    run.program = prog
    run.build_s = prog.build_s
    t0 = time.perf_counter()
    per_unit = prog.warm_up()
    phases.update(build_s=prog.build_s, warm_up_s=time.perf_counter() - t0, per_unit_s=per_unit)
    if traced:
        warm_profiler(device)
    expected = int(seconds / max(per_unit, 1e-6))
    prog.plan_keep(expected)
    setup_peak = _reserve(device, prog.kept_bytes(expected * 3 // 2))
    _window(run, prog, cell, t_setup0)
    print("# setup phases " + json.dumps(phases), file=sys.stderr)
    diag = {"units_by_second": np.diff([0] + run.marks).tolist(), **run.host}
    if run.unit_s:
        diag["unit_ms_quartiles"] = (np.percentile(run.unit_s, [25, 50, 75]) * 1e3).tolist()
    print("# window " + json.dumps(diag), file=sys.stderr)
    peak = max(setup_peak, dev_info.memory_peak(device))
    run.results = prog.results()
    failed = int(run.results.get("failed", 0))

    metrics = {}
    chosen = cell.per_layer() if traced else cell.end_to_end()
    for m in chosen:
        value = read_metric(run, m)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    extra = cell.entry.extra(run) if traced and hasattr(cell.entry, "extra") else None
    if extra:
        log("# " + json.dumps(extra))
    outputs = prog.outputs()
    prog.free()
    run.program = prog = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = cell.entry.check(matrix, inputs, outputs, cell.traffic, device)
    checks, correct = {}, True
    for name, value in numbers.items():
        limit = float(cell.limits[name]["limit"])
        ok = bool(np.isfinite(value)) and value <= limit
        correct &= ok
        checks[name] = {"value": value, "limit": limit}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": dev_info.name(device), "count": 1, "memory_peak_bytes": peak}
    if traced:
        tr = run.trace
        device_info["busy_s"] = tr.busy_us * 1e-6 if tr else 0.0
        device_info["window_s"] = tr.window_us * 1e-6 if tr else 0.0
    line = {"correct": bool(correct), "attempted": run.units, "failed": failed,
            "metrics": metrics, "device": device_info}
    if traced and run.trace is not None:
        line["breakdown"] = trace.breakdown(run.trace)
    line["checks"] = checks
    return line
