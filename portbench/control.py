"""The control of a cell's check: the reference put in the program's place
in the nearest precision below the configuration's (TF32 for float32), at
the cell's own size, on several seeds. Its numbers have to fail the cell's
limits; they set the upper reading of each limit (limits/<cell>.json).

    python3 portbench/control.py --workload <name> --seeds 101 102 103

Not run by the benchmark's own runs.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent


def control_numbers(cell_name: str, seed: int, device: str = "cuda",
                    config_override: dict | None = None, bench: dict | None = None) -> dict:
    import torch

    from harness import spec
    cell = spec.Cell(bench or spec.benchmark(), cell_name, config_override)
    dev = torch.device(device)
    matrix = cell.matrix_gen.generate(cell.config["params"], seed)
    inputs = cell.entry.make_inputs(matrix, cell.config, cell.traffic, seed, dev)
    outputs = cell.entry.control(matrix, inputs, cell.traffic, dev)
    return cell.entry.check(matrix, inputs, outputs, cell.traffic, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(HERE.parent / "src"))
    from harness import spec
    limits = spec.Cell(spec.benchmark(), args.workload).limits
    failed_all = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums = control_numbers(args.workload, seed, args.device)
        fails = {k: v > float(limits[k]["limit"]) for k, v in nums.items()}
        failed_all &= any(fails.values())
        print(json.dumps({"workload": args.workload, "seed": seed, "control": nums,
                          "fails_limit": fails, "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
