"""The benchmark of the PyTorch/CUDA port (repro_torch): one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Finds the cell in BENCHMARK.json, makes its matrix and vectors from the
seed, builds the program, warms it up, measures for ``--seconds`` and
prints one JSON line last on stdout: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics read from a
profiled sub-window. The numbers compared with the reference are printed
last on stderr, each beside its limit. Exits non-zero, printing no result,
without enough CUDA devices, or if JAX or the JAX package was imported.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT / "src"))
    import torch

    from harness import runner, spec

    bench = spec.benchmark()
    chips = int(spec.by_name(bench["workloads"], args.workload, "workload")["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = runner.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=T_START, bench=bench)
    found = runner.forbidden_modules()
    if found:
        print(f"portbench: the run imported {found}; the benchmark measures repro_torch alone",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
