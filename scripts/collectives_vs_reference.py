#!/usr/bin/env python3
"""The collectives of the smoke cells on a 2x2 mesh: the JAX package's against the port's.

    PYTHONPATH=src python scripts/collectives_vs_reference.py [--kinds train decode]

For each smoke config (granite-8b, mixtral-8x7b, mamba2-130m, zamba2-2.7b,
whisper-small, cb-paper) and cell kind (a train step of 4 x 32 tokens, one
decode step of batch 4 against a 32-deep cache), on a (data 2, model 2) mesh
under ``rules_for``:

* the reference: ``repro.launch.dryrun.build_cell`` lowered and compiled by
  XLA on 4 of the host devices (in a subprocess: the reference's dry run
  asks for 512 at import), its collectives by ``parse_collectives`` of the
  compiled HLO (per-device operand bytes; GSPMD picks its own collectives);
* the port: ``repro_torch.launch.dryrun.mesh_cell`` under the ``"fake"``
  process group, the c10d collectives the step dispatches.

Prints a markdown table (count and bytes per kind, both packages) and the
JSON of both. CPU only; about a minute.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
ARCHS = ("granite-8b", "mixtral-8x7b", "mamba2-130m", "zamba2-2.7b", "whisper-small", "cb-paper")
SHAPES = {"train": ("train", 32, 4), "decode": ("decode", 32, 4)}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

JAX_SIDE = r"""
import json, sys
import jax
from repro import compat
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.launch import dryrun
out = {}
mesh = compat.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
for arch in json.loads(sys.argv[1]):
    for name, (kind, seq, batch) in json.loads(sys.argv[2]).items():
        lower, _ = dryrun.build_cell(get_smoke_config(arch), ShapeConfig(name, kind, seq, batch),
                                     mesh)
        out[f"{arch}/{name}"] = dryrun.parse_collectives(lower().compile().as_text())
print(json.dumps(out))
"""


def port_side(archs, shapes) -> dict:
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    out = {}
    for arch in archs:
        for name, (kind, seq, batch) in shapes.items():
            cell = dryrun.mesh_cell(arch, name, get_smoke_config(arch), "2x2",
                                    shape=ShapeConfig(name, kind, seq, batch))
            if cell["status"] != "ok":
                raise SystemExit(f"{arch} {name}: {cell.get('error')}")
            out[f"{arch}/{name}"] = cell["collectives"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kinds", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    args = ap.parse_args(argv)
    shapes = {k: SHAPES[k] for k in args.kinds}
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "-c", JAX_SIDE, json.dumps(ARCHS), json.dumps(shapes)],
                         env=env, capture_output=True, text=True, check=True)
    reference = json.loads(ref.stdout.strip().splitlines()[-1])
    port = port_side(ARCHS, shapes)
    print("| cell | " + " | ".join(f"{k} (JAX / port)" for k in KINDS[:3]) + " | total bytes |")
    print("|---|" + "---|" * 4)
    for cell in reference:
        r, p = reference[cell], port[cell]
        cols = [f"{r[k]['count']} / {p[k]['count']}: {r[k]['bytes']:,} / {p[k]['bytes']:,}"
                for k in KINDS[:3]]
        print(f"| {cell} | " + " | ".join(cols) +
              f" | {r['total_bytes']:,} / {p['total_bytes']:,} |")
    print(json.dumps({"reference": reference, "port": port}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
