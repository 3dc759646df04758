#!/usr/bin/env python
"""Run a tiny traced workload and render the obs subsystem's exports.

    PYTHONPATH=src python scripts/obs_report_torch.py [--out PATH.trace.json]
                                                      [--device cuda|cpu]

The port of ``scripts/obs_report.py``. Drives one ``robust_solve`` on an SPD
corpus matrix plus a few serving ticks on a toy model — both under the
default tracer, on the card unless ``--device cpu`` (there ``plan="auto"``
times its candidates through the CUDA kernels, as the port's autotuner does
on CUDA; on the CPU it takes the heuristic) — then:

  * writes the spans as Chrome ``trace_event`` JSON (load the file in
    ``chrome://tracing`` / Perfetto);
  * prints a per-span-name summary table (count / total / mean / max);
  * prints the metrics snapshot's headline counters, including the
    per-plan measured-vs-predicted launch accounting so cost-model
    fidelity is visible at a glance.

``main`` returns the payload dict (trace path, chrome trace object,
snapshot, span summary, locality, and the solve, operator and engine health
behind them) so a test can validate the export schema without re-parsing
stdout. The reference's ``repro.solvers.traces`` line has no counterpart:
the port's solver loop runs eagerly and traces nothing.
"""
from __future__ import annotations

import argparse
import sys


def _build_workload(device):
    """One robust_solve + a short serving run, all under obs."""
    import numpy as np
    import torch

    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.cb_matrix import CBMatrix
    from repro_torch.data import matrices
    from repro_torch.models.model import Model
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.solvers import CBLinearOperator, robust_solve

    d = 96
    r, c, v = matrices.spd_banded(d, bandwidth=7, seed=3)
    cb = CBMatrix.from_coo(r, c, v.astype(np.float32), (d, d),
                           block_size=16, val_dtype=np.float32)
    op = CBLinearOperator.from_cb(cb, plan="auto", device=device)
    locality = _locality_stats(op, int(cb.nnz))
    b = torch.from_numpy(
        np.random.default_rng(0).standard_normal(d).astype(np.float32)).to(op.device)
    res = robust_solve(op, b, tol=1e-6, maxiter=300)

    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=32,
                      num_heads=2, num_kv_heads=1, d_ff=64, vocab_size=128,
                      attn_chunk=32, remat="none", dtype="float32")
    model = Model(cfg, device=device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    eng = ServingEngine(model, params, slots=2, max_len=64)
    for i in range(2):
        eng.submit(Request(uid=i, prompt=np.array([i + 1], np.int32),
                           max_new_tokens=2))
    eng.run_until_done(max_ticks=16)
    return res, eng, locality, op


def _locality_stats(op, nnz: int) -> dict:
    """Modeled cache traffic of the operator's planned super-streams."""
    from repro_torch.obs import locality as loc

    return loc.stream_stats(loc.access_stream_super(op.streams), nnz=nnz)


def _counter_rows(snap: dict, name: str) -> list[tuple[str, float]]:
    entry = snap.get(name)
    if not entry:
        return []
    return [
        (",".join(f"{k}={v}" for k, v in sorted(s["labels"].items())) or "-",
         s["value"])
        for s in entry["series"]
    ]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="obs_demo.trace.json",
                    help="Chrome trace output path (default %(default)s)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch import obs
    from repro_torch.core.streams import resolve_device

    device = resolve_device(args.device)
    obs.configure(enabled=True)
    obs.reset()
    res, eng, locality, op = _build_workload(device)

    trace_path = obs.export_chrome_trace(args.out)
    trace = obs.chrome_trace()
    snap = obs.snapshot()

    print(f"solve: converged={res.converged} solver={res.solver} "
          f"attempts={len(res.attempts)}; "
          f"serving: ticks={eng.health()['ticks']} "
          f"completed={eng.health()['completed']}")
    print(f"\n[chrome trace: {trace_path} — "
          f"{len(trace['traceEvents'])} events]")

    print(f"\n{'span':<24}{'count':>7}{'total_ms':>10}"
          f"{'mean_ms':>9}{'max_ms':>9}")
    for row in obs.tracer().summary():
        print(f"{row['name']:<24}{row['count']:>7}"
              f"{row['total_s'] * 1e3:>10.2f}"
              f"{row['mean_s'] * 1e3:>9.2f}{row['max_s'] * 1e3:>9.2f}")

    print(f"\n{'metric / labels':<58}{'value':>10}")
    headline = (
        "repro.ops.spmv.calls",
        "repro.ops.spmv.launches",
        "repro.ops.spmv.steps",
        "repro.ops.spmv.padded_elems",
        "repro.solvers.robust.attempts",
        "repro.solvers.robust.outcome",
        "repro.serving.ticks",
        "repro.serving.completed",
    )
    for name in headline:
        for labels, value in _counter_rows(snap, name):
            print(f"{name + '{' + labels + '}':<58}{value:>10g}")

    print("\nplan accounting (measured vs predicted, per structure hash):")
    for metric in ("repro.autotune.exec.padded_elems",
                   "repro.autotune.exec.steps"):
        rows = dict(_counter_rows(snap, metric))
        plans = sorted({lab.split(",")[1] for lab in rows})
        for plan in plans:
            meas = rows.get(f"kind=measured,{plan}", 0)
            pred = rows.get(f"kind=predicted,{plan}", 0)
            ratio = meas / pred if pred else float("nan")
            print(f"  {metric.split('.')[-1]:<14}{plan:<24}"
                  f"measured={meas:<10g}predicted={pred:<10g}"
                  f"ratio={ratio:.3f}")

    print("\nmodeled locality (planned super-streams, LRU line model):")
    print(f"  l1_hit={locality['l1_hit_rate']:.3f} "
          f"l2_hit={locality['l2_hit_rate']:.3f} "
          f"l1miss/nnz={locality['l1_misses_per_nnz']:.4f} "
          f"l2miss/nnz={locality['l2_misses_per_nnz']:.4f} "
          f"lines={locality['unique_lines']} "
          f"bytes_moved={locality['bytes_moved']} "
          f"AI={locality['arith_intensity']:.2f}")

    return {"trace_path": trace_path, "trace": trace, "snapshot": snap,
            "summary": obs.tracer().summary(), "locality": locality,
            "solve": {"converged": res.converged, "solver": res.solver,
                      "attempts": len(res.attempts), "x": res.x},
            "operator": op, "health": eng.health()}


if __name__ == "__main__":
    main()
    sys.exit(0)
