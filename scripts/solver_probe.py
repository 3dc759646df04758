#!/usr/bin/env python3
"""Time the port's solver loops on one NVIDIA GPU: what the host costs them.

    python3 scripts/solver_probe.py        # about 3 minutes on an H100

Builds ``chip_smoke.py``'s solve matrices at full size (seed 0):
``spd_banded(2097152, bandwidth=9)`` with block-Jacobi for ``cg`` and
``power_iteration``, ``banded(2097152, bandwidth=7, fill=0.8) + 8 I`` for
``bicgstab`` and ``gmres(20)``, and ``power_law(262144, 262144, avg_deg=8)``'s
edges for ``pagerank``; all through ``CBLinearOperator.from_cb`` on the card,
float32, B = 16. Then, per solver:

- ``sweep``: the whole solve (CUDA events around it, warm, median of 3) with
  the loop's read interval ``_loop.SYNC_EVERY`` set to each of ``SWEEP`` in
  turn, with the iterations, the loop steps run (iterations plus the masked
  ones) and the host's reads of the stop flag;
- ``device_iter_ms``: one iteration's device time with no host in the way:
  the solver with ``maxiter`` 1 and ``1 + D`` (no read of the flag in either)
  each captured in a CUDA graph and replayed between CUDA events, the
  difference over ``D``; ``enqueue_iter_ms``: the host's time to enqueue
  one iteration, from the same two runs enqueued directly;
- ``profile``: ``torch.profiler`` over one solve: the kernels' device time
  summed against the wall time, the device's idle share.

GMRES reads its flag after every restart cycle (``krylov.GMRES_SYNC_EVERY``)
and its least-squares SVD waits for the device, so it is timed but not swept
or captured. The read interval is changed here only to measure it. Prints one
JSON line per solver; exits non-zero without a GPU.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import solvers  # noqa: E402
from repro_torch.core import CBMatrix  # noqa: E402
from repro_torch.data import matrices  # noqa: E402
from repro_torch.solvers import _loop  # noqa: E402

SWEEP = (1, 2, 4, 8, 16)
D = 8                                  # extra iterations in the graph difference
DEV = torch.device("cuda")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def events_ms(fn) -> float:
    """CUDA events around one ``fn()``; warm; median of 3."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        runs.append(a.elapsed_time(b))
    return statistics.median(runs)


def graph_ms(fn) -> float:
    """Device time of one ``fn()`` captured in a CUDA graph and replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return events_ms(graph.replay)


def enqueue_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3


def profile(fn) -> dict:
    """Summed kernel time against wall time over one ``fn()``."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = 0.0
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        busy += dev / 1e3
    return dict(wall_ms=wall, device_busy_ms=busy,
                idle_share=None if wall <= 0 else max(0.0, 1.0 - busy / wall))


def probe(name, run, maxiter):
    """``run(maxiter)`` solves once; returns the solver's result."""
    out = dict(solver=name)
    sweep = {}
    keep = _loop.SYNC_EVERY
    try:
        for k in SWEEP:
            _loop.SYNC_EVERY = k
            _loop.HOST_SYNCS.clear()
            res = run(maxiter)
            torch.cuda.synchronize()
            syncs = sum(_loop.HOST_SYNCS.values())
            its = int(res.iterations)
            steps = maxiter if its >= maxiter else syncs * k   # a read stopped it
            sweep[k] = dict(solve_ms=events_ms(lambda: run(maxiter)), iterations=its,
                            host_syncs=syncs, loop_steps=steps)
        _loop.SYNC_EVERY = 1 + D
        e1, eD = enqueue_ms(lambda: run(1)), enqueue_ms(lambda: run(1 + D))
        out.update(sweep=sweep, enqueue_iter_ms=(eD - e1) / D)
        try:
            t1, tD = graph_ms(lambda: run(1)), graph_ms(lambda: run(1 + D))
            out.update(device_iter_ms=(tD - t1) / D, device_setup_and_one_ms=t1)
        except RuntimeError as e:             # a capture the solver does not allow
            out["device_iter_ms"] = f"not measured: {e}"
    finally:
        _loop.SYNC_EVERY = keep
    try:
        out["profile"] = profile(lambda: run(maxiter))
    except RuntimeError as e:
        out["profile"] = f"not measured: {e}"
    print(json.dumps(out), flush=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        print("solver_probe: no CUDA device", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi()
    B, n = 16, 2_097_152
    rows, cols, vals = matrices.spd_banded(n, bandwidth=9, seed=3)
    cb = CBMatrix.from_coo(rows, cols, vals.astype(np.float32), (n, n), block_size=B,
                           val_dtype=np.float32)
    spd, M = solvers.CBLinearOperator.from_cb(cb), solvers.block_jacobi(cb)
    del cb, rows, cols, vals
    rng = np.random.default_rng(13)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(DEV)
    lines = [probe("cg", lambda it: solvers.cg(spd, b, M, tol=1e-6, maxiter=it), 500),
             probe("power", lambda it: solvers.power_iteration(spd, b, maxiter=it), 100)]
    del spd, M
    rows, cols, vals = matrices.banded(n, n, bandwidth=7, fill=0.8, seed=5)
    diag = np.arange(n)
    cb = CBMatrix.from_coo(np.concatenate([rows, diag]), np.concatenate([cols, diag]),
                           np.concatenate([vals, np.full(n, 8.0)]).astype(np.float32),
                           (n, n), block_size=B, val_dtype=np.float32)
    nonsym = solvers.CBLinearOperator.from_cb(cb)
    del cb, rows, cols, vals
    lines.append(probe("bicgstab", lambda it: solvers.bicgstab(nonsym, b, tol=1e-6,
                                                               maxiter=it), 500))
    res = solvers.gmres(nonsym, b, tol=1e-6, restart=20, maxiter=50)
    lines.append(dict(solver="gmres", iterations=int(res.iterations), restart=20,
                      solve_ms=events_ms(lambda: solvers.gmres(nonsym, b, tol=1e-6, restart=20,
                                                               maxiter=50))))
    del nonsym
    g = 262_144
    src, dst, _ = matrices.power_law(g, g, avg_deg=8, seed=2)
    pr, dangling = solvers.pagerank_operator(src, dst, g)
    lines.append(probe("pagerank", lambda it: solvers.pagerank(pr, dangling, tol=1e-7,
                                                               maxiter=it), 200))
    print(json.dumps(lines[-2]), flush=True)      # gmres; the probes printed their own
    print(card, flush=True)


if __name__ == "__main__":
    main()
