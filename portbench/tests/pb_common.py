"""Shared by the benchmark's CPU tests: paths and a tiny stand-in of each cell."""
from __future__ import annotations

import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

KRON = {"scale": 9, "edgefactor": 16, "A": 0.57, "B": 0.19, "C": 0.19, "structure_seed": 1}
TINY = {
    "g500s20-spmv": {"params": KRON},
}
SEED = 2**31 + 12345


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())
