#!/usr/bin/env python
"""Explain one matrix end to end: plan decision, modeled traffic, roofline.

    PYTHONPATH=src python scripts/explain_torch.py [--matrix NAME]
                                                   [--scale small|bench]
                                                   [--top-k K] [--json PATH]
                                                   [--device cuda|cpu]

The port of ``scripts/explain.py``. For one corpus matrix this renders the
whole decision chain the engine takes and what it buys:

  * the feature vector the planner saw (``autotune.feature_vector``),
  * the cost model's top-k candidate ranking and the plan it produced
    (heuristic mode — bit-deterministic, no wall clock),
  * modeled cache traffic of the planned super-block pipeline, its streams
    placed on the device (CUDA unless ``--device cpu``), vs the flat
    CSR/BSR/TileSpMV baselines (``repro_torch.obs.locality``: L1/L2 hit
    rates, misses/nnz, bytes moved),
  * the roofline position: arithmetic intensity (flops per DRAM byte,
    where DRAM traffic = modeled L2-miss bytes) against the machine balance
    of an H100 SXM (NVIDIA data sheet: 67 TFLOP/s float32 outside the
    tensor cores, 3.35 TB/s of HBM3) — SpMV lives deep in the memory-bound
    regime, which is why the padded-bytes-streamed cost model ranks plans
    by traffic, not FLOPs.

``main(argv)`` returns the report as a dict (schema ``cb-explain/v1``)
so tests validate the payload without parsing stdout; ``--json`` dumps
the same dict.
"""
from __future__ import annotations

import argparse
import json

EXPLAIN_SCHEMA = "cb-explain/v1"

# H100 SXM peaks (NVIDIA data sheet): the *position* relative to the ridge
# is the point, as with the cache sizes in the locality model.
PEAK_FLOPS = 67e12    # f32 FLOP/s outside the tensor cores
PEAK_BW = 3.35e12     # HBM3 bytes/s


def _build_report(name: str, scale: str, top_k: int, device) -> dict:
    import numpy as np

    from repro_torch.autotune import (SearchSettings, cost, extract_features,
                                      feature_vector)
    from repro_torch.core import CBMatrix
    from repro_torch.core.streams import build_super_streams, resolve_device
    from repro_torch.data import matrices
    from repro_torch.obs import _flat_streams as F
    from repro_torch.obs import locality as loc

    device = resolve_device(device)
    corpus = {spec.name: (spec, r, c, v, shape)
              for spec, r, c, v, shape in matrices.corpus(scale)}
    if name is None:
        name = next(iter(corpus))
    if name not in corpus:
        raise SystemExit(
            f"explain: unknown matrix {name!r}; corpus({scale}) has: "
            + ", ".join(corpus))
    spec, r, c, v, shape = corpus[name]
    nnz = len(v)
    v32 = v.astype(np.float32)

    # -- decision: features + cost-model ranking + the chosen plan -------
    features = extract_features(r, c, v32, shape)
    ranked = cost.rank(features, cost.default_candidates())
    decision = [{
        "rank": i,
        "block_size": cand.block_size,
        "colagg": str(cand.colagg),
        "group_size": cand.resolved_group_size(),
        "score": est.score,
        "predicted_padded_elems": est.padded_elems,
        "predicted_steps": est.steps,
        "colagg_applied": est.colagg_applied,
    } for i, (cand, est) in enumerate(ranked[:top_k])]

    plan = CBMatrix.plan_for(r, c, v32, shape,
                             settings=SearchSettings(mode="heuristic"), device=device)
    cb = CBMatrix.from_plan(r, c, v32, shape, plan)
    streams = build_super_streams(cb, group_size=plan.group_size).to(device)

    # -- modeled traffic: planned pipeline vs flat baselines -------------
    locality = {"cb": loc.stream_stats(
        loc.access_stream_super(streams), nnz=nnz)}
    for fmt, gen in (("csr", F.access_stream_csr),
                     ("bsr", F.access_stream_bsr),
                     ("tile", F.access_stream_tile)):
        lines, _ = gen(r, c, v, shape, vbytes=4)
        locality[fmt] = loc.stream_stats(np.asarray(lines), nnz=nnz)

    flops = loc.FLOPS_PER_NNZ * nnz
    bytes_moved = locality["cb"]["bytes_moved"]
    ai = locality["cb"]["arith_intensity"]
    balance = PEAK_FLOPS / PEAK_BW
    roofline = {
        "flops": flops,
        "bytes_moved": bytes_moved,
        "arith_intensity": ai,
        "machine_balance": balance,
        "bound": "memory" if ai < balance else "compute",
        "attainable_fraction_of_peak": min(1.0, ai / balance),
    }

    return {
        "schema": EXPLAIN_SCHEMA,
        "matrix": spec.name,
        "family": spec.family,
        "shape": list(shape),
        "nnz": nnz,
        "features": feature_vector(features),
        "decision": decision,
        "plan": plan.to_json(),
        "locality": locality,
        "roofline": roofline,
    }


def _render(rep: dict) -> None:
    print(f"== {rep['matrix']} ({rep['family']}) "
          f"{rep['shape'][0]}x{rep['shape'][1]}, nnz={rep['nnz']} ==")

    plan = rep["plan"]
    print(f"\nplan {plan['structure_hash'][:12]}: B={plan['block_size']} "
          f"group={plan['group_size']} colagg={plan['colagg']} "
          f"th=({plan['th0']},{plan['th1']},{plan['th2']}) "
          f"mode={plan['mode']}")
    print(f"  predicted padded_elems={plan['predicted_padded_elems']} "
          f"steps={plan['predicted_steps']}; "
          f"measured padded_elems={plan['measured_padded_elems']} "
          f"steps={plan['measured_steps']}")

    print("\ncost-model ranking (lower score wins):")
    print(f"  {'rank':<5}{'B':>3}{'group':>6}{'colagg':>7}"
          f"{'padded':>10}{'steps':>7}{'score':>12}")
    for d in rep["decision"]:
        print(f"  {d['rank']:<5}{d['block_size']:>3}{d['group_size']:>6}"
              f"{str(d['colagg_applied']):>7}"
              f"{d['predicted_padded_elems']:>10}{d['predicted_steps']:>7}"
              f"{d['score']:>12.1f}")

    print("\nkey features:")
    feats = rep["features"]
    for key in ("density", "row_nnz_mean", "row_nnz_cv", "bandwidth_mean",
                f"b{plan['block_size']}_block_fill_mean",
                f"b{plan['block_size']}_super_sparse_fraction"):
        if key in feats:
            print(f"  {key:<32}{feats[key]:.4g}")

    print("\nmodeled locality (LRU line model, planned CB vs flat):")
    print(f"  {'format':<8}{'l1_hit':>8}{'l2_hit':>8}{'l1miss/nnz':>12}"
          f"{'l2miss/nnz':>12}{'lines':>8}{'MB moved':>10}")
    for fmt, st in rep["locality"].items():
        print(f"  {fmt:<8}{st['l1_hit_rate']:>8.3f}{st['l2_hit_rate']:>8.3f}"
              f"{st['l1_misses_per_nnz']:>12.4f}"
              f"{st['l2_misses_per_nnz']:>12.4f}"
              f"{st['unique_lines']:>8}"
              f"{st['bytes_moved'] / 1e6:>10.3f}")

    roof = rep["roofline"]
    print(f"\nroofline: {roof['flops']:.3g} flops / "
          f"{roof['bytes_moved']:.3g} bytes = "
          f"AI {roof['arith_intensity']:.2f} flop/B vs machine balance "
          f"{roof['machine_balance']:.1f} -> {roof['bound']}-bound "
          f"({roof['attainable_fraction_of_peak'] * 100:.2f}% of peak "
          f"attainable)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--matrix", default=None,
                    help="corpus matrix name (default: first of the corpus)")
    ap.add_argument("--scale", default="small", choices=["small", "bench"])
    ap.add_argument("--top-k", type=int, default=5)
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also dump the report dict as JSON")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    rep = _build_report(args.matrix, args.scale, args.top_k, args.device)
    _render(rep)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=1, sort_keys=True)
        print(f"\n[wrote {args.json}]")
    return rep


if __name__ == "__main__":
    main()
