"""Roofline report: aggregate the dry-run JSONs into tables.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--dir experiments/dryrun_torch]

The reference's report (``src/repro/launch/roofline.py``) unchanged, over the
port's cells (``launch.dryrun``: the production mesh ``16x16`` by default,
``--mesh 2x16x16`` or ``--mesh 1`` for the others; the H100's rates); the
cell JSONs share the reference's layout, so either report reads either
package's cells.
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load_cells(d: str) -> list[dict]:
    cells = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        cells.append(json.load(open(f)))
    return cells


def fmt_table(cells: list[dict], mesh: str) -> str:
    rows = [
        "| arch | shape | compute s | memory s | collective s | bound | "
        "MODEL_FLOPS | useful | peak roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    for c in sorted(
        [c for c in cells if c["mesh"] == mesh],
        key=lambda c: (c["arch"], order.get(c["shape"], 9)),
    ):
        if c["status"] == "skipped":
            rows.append(f"| {c['arch']} | {c['shape']} | — | — | — | "
                        f"skipped | — | — | {c['reason'][:46]} |")
            continue
        if c["status"] != "ok":
            rows.append(f"| {c['arch']} | {c['shape']} | FAILED: "
                        f"{c.get('error', '')[:60]} | | | | | | |")
            continue
        r = c["roofline"]
        dom = max(r["compute_s"], r["memory_s"], r["collective_s"])
        frac = r["compute_s"] / dom if dom > 0 else 0.0
        rows.append(
            f"| {c['arch']} | {c['shape']} | {r['compute_s']:.2e} | "
            f"{r['memory_s']:.2e} | {r['collective_s']:.2e} | "
            f"{r['bottleneck']} | {r['model_flops']:.2e} | "
            f"{r['useful_flops_ratio']:.2f} | {frac:.3f} |"
        )
    return "\n".join(rows)


def summarize(cells: list[dict]) -> dict:
    ok = [c for c in cells if c["status"] == "ok"]
    skipped = [c for c in cells if c["status"] == "skipped"]
    failed = [c for c in cells if c["status"] == "FAILED"]
    by_bound: dict[str, int] = {}
    worst = None
    most_coll = None
    for c in ok:
        r = c["roofline"]
        by_bound[r["bottleneck"]] = by_bound.get(r["bottleneck"], 0) + 1
        dom = max(r["compute_s"], r["memory_s"], r["collective_s"])
        frac = r["compute_s"] / dom if dom else 0
        if c["shape"] != "long_500k":  # ignore degenerate batch-1 cells
            if worst is None or frac < worst[0]:
                worst = (frac, c["arch"], c["shape"], c["mesh"])
        coll_share = r["collective_s"] / dom if dom else 0
        if most_coll is None or coll_share > most_coll[0]:
            most_coll = (coll_share, c["arch"], c["shape"], c["mesh"])
    return {
        "ok": len(ok), "skipped": len(skipped), "failed": len(failed),
        "bounds": by_bound, "worst_frac": worst, "most_collective": most_coll,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    cells = load_cells(args.dir)
    print(fmt_table(cells, args.mesh))
    print()
    print(json.dumps(summarize(cells), indent=1, default=str))


if __name__ == "__main__":
    main()
