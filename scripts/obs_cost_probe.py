#!/usr/bin/env python3
"""What the port's telemetry (``repro_torch.obs``) costs the host.

    python3 scripts/obs_cost_probe.py [--scale 20] [--device cuda] [--src DIR]

Prints one JSON line:

- ``span_us``: one ``obs.span`` entered and exited, 100,000 of them into a
  fresh tracer with the garbage collector on, the median (and the least)
  of 9 such runs; ``span_off_us`` the same with obs disabled;
- ``call_us``: the host time of one ``ops.cb_spmv`` call three ways, obs
  off, obs on, and obs on under a recording ``torch.profiler`` (CPU and
  CUDA activity), each timed as the benchmark's ``enqueue_us``: after a
  synchronise, the host clock over 32 calls, batches repeated until 0.3 s
  is summed, over the calls. The three take turns for 5 rounds; medians.

The matrix is the benchmark's Graph500 Kronecker graph
(``portbench/matrices/kronecker.py``, ``portbench/configs/graph500-s20.json``)
at ``--scale`` (the cell's is 20), built as the benchmark builds it.
``--src`` imports ``repro_torch`` from another checkout's ``src`` (to compare
two versions in one process each). ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCH, TOTAL_S = 32, 0.3


def span_us(obs, runs: int = 9, n: int = 100_000) -> list[float]:
    out = []
    for _ in range(runs):
        obs.reset()
        t0 = time.perf_counter()
        for _ in range(n):
            with obs.span("cb_spmv"):
                pass
        out.append((time.perf_counter() - t0) / n * 1e6)
    obs.reset()
    return out


def call_us(call, sync) -> float:
    spent, calls = 0.0, 0
    while spent < TOTAL_S:
        sync()
        t0 = time.perf_counter()
        for i in range(BATCH):
            call(i)
        spent += time.perf_counter() - t0
        calls += BATCH
    sync()
    return spent / calls * 1e6


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT / "portbench"))
    import numpy as np
    import torch

    from harness import spec
    from repro_torch import obs
    from repro_torch.core.cb_matrix import CBMatrix
    from repro_torch.core.streams import build_super_streams
    from repro_torch.kernels import ops

    dev = torch.device(args.device)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "src": args.src, "scale": args.scale}
    spans = span_us(obs)
    obs.configure(enabled=False)
    out["span_off_us"] = statistics.median(span_us(obs, runs=3))
    obs.configure(enabled=True)
    out["span_us"] = {"median": statistics.median(spans), "least": min(spans)}

    cfg = spec.load_json(spec.BENCH / "configs" / "graph500-s20.json")
    m = spec.module("matrices", cfg["matrix"]).generate(dict(cfg["params"], scale=args.scale),
                                                        args.seed)
    t0 = time.perf_counter()
    cb = CBMatrix.from_coo(m["rows"], m["cols"], m["vals"], m["shape"],
                           block_size=int(cfg["block_size"]),
                           val_dtype=np.dtype(cfg["value_dtype"]))
    streams = build_super_streams(cb).to(dev)
    del cb
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    sync()
    out["build_s"] = time.perf_counter() - t0
    out["nnz"] = int(m["rows"].size)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    X = torch.rand((32, m["shape"][1]), generator=g, device=dev) * 2 - 1

    def call(i):
        return ops.cb_spmv(streams, X[i % 32], device=dev)

    for i in range(16):
        call(i)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):        # CUPTI's first start, not timed
        call(0)
        sync()
    ways = {"off": [], "on": [], "profiled": []}
    for _ in range(5):
        obs.configure(enabled=False)
        ways["off"].append(call_us(call, sync))
        obs.configure(enabled=True)
        ways["on"].append(call_us(call, sync))
        with torch.profiler.profile(activities=acts):
            ways["profiled"].append(call_us(call, sync))
    out["call_us"] = {k: statistics.median(v) for k, v in ways.items()}
    out["call_us_runs"] = ways
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
