#!/usr/bin/env python3
"""Run the ``examples`` phase of ``chip_smoke.py`` alone.

    python3 scripts/examples_probe.py     # about two minutes on an H100

The port's five examples (``examples_torch/``) and two tools
(``scripts/explain_torch.py``, ``scripts/obs_report_torch.py``) at their
default arguments, each checked as ``chip_smoke.py`` checks it
(``chip_smoke.run_examples``): an ``example`` line each, the kernels held
against their plain versions at the shapes the examples launch. Prints one
JSON object a line, the card's name and power limit as ``nvidia-smi`` gives
them, and exits non-zero without a GPU or on any failed check.
"""
from __future__ import annotations

import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("examples_probe: no CUDA device", file=sys.stderr)
        return 1
    print(cs.smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False      # as chip_smoke.py runs
    torch.backends.cudnn.allow_tf32 = False
    info = cs._build.build_info()
    cs.emit("build", seconds=info["seconds"], rebuilt=bool(info["log"]))
    launches = {k: 0 for k in cs.WRAPPERS}
    per_kernel = {k: [] for k in cs.WRAPPERS}
    example_launches = {}
    cs.run_examples(per_kernel, launches, example_launches)
    cs.emit("example_kernels", launches=launches, per_example=example_launches,
            worst_err=dict(cs.worst_err),
            rows={k: [{f: r[f] for f in ("matrix", "shape", "ms", "enqueue_ms", "plain_ms",
                                         "bound_ms", "bound_by", "library_ms")}
                      for r in rows] for k, rows in per_kernel.items()})
    print(cs.smi(), flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
