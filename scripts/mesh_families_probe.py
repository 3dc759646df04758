#!/usr/bin/env python3
"""Run the mesh_serve, mesh_family and dryrun_mesh lines of ``chip_smoke.py`` alone.

    python3 scripts/mesh_families_probe.py     # a few minutes on an H100

1. the ``serve`` line (``chip_smoke.run_serve``): cb-paper served through
   ``ServingEngine``, the reference of ``mesh_serve`` 1x1;
2. ``chip_smoke.run_mesh_families``: ``mesh_serve`` 1x1 (one NCCL rank, the
   serve line's tokens bit for bit), ``mesh_family`` 1x1 (mamba2, zamba2,
   whisper at full config, 2 steps bit-equal to a local run), then two gloo
   ranks sharing the card (1x2, 2 layers) against one rank;
3. ``chip_smoke.run_dryrun_mesh``: cb-paper train_4k / decode_32k and mixtral
   train_4k on the 16x16 production mesh beside one rank.

Each line is checked as ``chip_smoke.py`` checks it. Prints one JSON object a
line, the card's name and power limit as ``nvidia-smi`` gives them, and
exits non-zero without a GPU or on any failed check.
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
        print("mesh_families_probe: no CUDA device", file=sys.stderr)
        return 1
    print(cs.smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False      # as chip_smoke.py runs
    torch.backends.cudnn.allow_tf32 = False
    launches = {k: 0 for k in cs.WRAPPERS}
    per_kernel = {k: [] for k in cs.WRAPPERS}
    mesh_launches = {}
    serve_line = cs.run_serve(0, per_kernel, launches)
    torch.cuda.empty_cache()
    cs.run_mesh_families(0, serve_line, per_kernel, launches, mesh_launches)
    torch.cuda.empty_cache()
    cs.run_dryrun_mesh()
    cs.emit("mesh_launches", launches=launches, per_run=mesh_launches,
            worst_err=dict(cs.worst_err))
    print(cs.smi(), flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
