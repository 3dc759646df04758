"""Run one cell several times and report each metric's spread.

    python3 portbench/spread.py --workload <name> --seeds 11 12 13 --sets 2 --seconds 10

Each run is its own process of ``run.py``, as a check makes it. For every
metric the script prints each set's median and its spread: the distance
between the first and third quartile (``statistics.quantiles(n=4)``) over
the median. All result lines go to ``--out`` as JSON.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, str(HERE / "run.py"), "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=HERE.parent)
    out = {"seed": seed, "rc": proc.returncode, "wall_s": time.perf_counter() - t0,
           "stderr_tail": proc.stderr[-2000:]}
    lines = proc.stdout.strip().splitlines()
    out["extra"] = [ln for ln in lines[:-1] if ln.startswith("# ")]
    try:
        out["line"] = json.loads(lines[-1]) if proc.returncode == 0 else None
    except (IndexError, json.JSONDecodeError):
        out["line"] = None
    return out


def spread(values: list[float]) -> tuple[float, float]:
    med = statistics.median(values)
    if len(values) < 2 or med == 0:
        return med, 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / abs(med)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out) if args.out else HERE / "out" / f"spread-{args.workload}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    runs = []
    for s in range(args.sets):
        for seed in args.seeds:
            r = one_run(args.workload, seed, args.seconds, args.trace)
            r["set"] = s
            runs.append(r)
            line = r["line"]
            print(json.dumps({"set": s, "seed": seed, "rc": r["rc"], "wall_s": round(r["wall_s"], 1),
                              "correct": line and line["correct"],
                              "attempted": line and line["attempted"],
                              "failed": line and line["failed"],
                              "metrics": line and {k: v["value"] for k, v in line["metrics"].items()},
                              "checks": line and line["checks"],
                              "peak": line and line["device"]["memory_peak_bytes"]}), flush=True)
            if r["line"] is None:
                print(r["stderr_tail"], flush=True)
            out.write_text(json.dumps({"args": vars(args), "runs": runs}, indent=1))
    names = sorted({k for r in runs if r["line"] for k in r["line"]["metrics"]})
    summary = {}
    for name in names:
        per_set = []
        for s in range(args.sets):
            vals = [r["line"]["metrics"][name]["value"] for r in runs
                    if r["set"] == s and r["line"] and name in r["line"]["metrics"]]
            if vals:
                med, sp = spread(vals)
                per_set.append({"median": med, "spread": sp, "n": len(vals)})
        summary[name] = per_set
        print(f"{name}: " + "; ".join(f"median {p['median']:.6g} spread {p['spread']:.4%} (n {p['n']})"
                                      for p in per_set), flush=True)
    out.write_text(json.dumps({"args": vars(args), "summary": summary, "runs": runs}, indent=1))
    return 0 if all(r["line"] and r["line"]["correct"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
