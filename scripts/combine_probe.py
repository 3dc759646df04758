#!/usr/bin/env python3
"""Check and time the port's combine kernel alone, on one NVIDIA GPU.

    python3 scripts/combine_probe.py               # checks + times, about a minute
    python3 scripts/combine_probe.py --sweep       # also times other unrolls, block
                                                   # sizes and chunk lengths
    python3 scripts/combine_probe.py --count-rows  # host only, no GPU: slots per block
                                                   # row of chip_smoke.py's matrices

A quicker loop than ``chip_smoke.py`` for work on ``csrc/cb_combine.cu``.
It builds combine plans from synthetic ``brow`` arrays with the slot
counts and row-length profiles of the main path's combines, seeded:

- ``block_clustered``: 4,575,345 slots over 16,384 block rows, block row 0
  with 35,000 (the packer's padding), the rest spread around 277, R = 16;
- ``banded``: 695,596 slots over 131,072 rows, row 0 with 1,692, the rest
  4-6, R = 16;
- ``power_law``: 599,386 slots over 16,384 rows, row 0 with 3,490 and a
  Pareto tail up to 7,194, R = 16;
- ``matmat``: 393,216 slots over 131,072 rows of about 3, R = 256 (B = 16,
  N = 16);
- ``mlp_forward`` and ``mlp_dX``: 896 slots over 112 or 32 rows, R =
  524,288 (the MLP's 128 x 4096).

Slots are shuffled, so the partials are read in the worst order; the real
streams are partly sorted, and ``block_clustered_in_order`` reads the same
rows in order, which shows what the access pattern costs. Each profile: the
kernel against ``combine_plain`` (integer data bit for bit, normal data within
1e-4 of the largest value), two runs bit-equal, then the kernel, the plain
version and ``index_add_`` timed on the device alone (20 calls accumulating
into one y, captured in one CUDA graph, replayed between CUDA events, median
of 3), the kernel also as ``chip_smoke.py`` times it (``loop_ms``: 20 calls
enqueued back to back, which the host's enqueue sets once a call is short),
beside the bound: the partials, one int32 a slot and y twice, over 3.35 TB/s.
``--sweep`` compiles copies of ``cb_combine.cu`` at other ``COMBINE_UNROLL``
and ``COMBINE_THREADS`` values into separate libraries and times every
profile at each (unroll, threads a block, fewest and most chunk steps) of
``SWEEP``, plans rebuilt to match; those copies are used nowhere else.
Prints one JSON line; exits non-zero if a check fails.

``--count-rows`` builds ``chip_smoke.py``'s ``banded`` and ``power_law``
streams on the host (seed 0) and prints their slots per block row, where the
two profiles' row 0 and tails come from.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build, cb_combine  # noqa: E402

DEV = torch.device("cuda")
TOL = 1e-4
# --sweep: (COMBINE_UNROLL, COMBINE_THREADS, MIN_STEPS, MAX_STEPS) of the kernel
# copies and plans timed
SWEEP = [(4, 256, 4, 16), (4, 256, 16, 16), (4, 256, 4, 32), (4, 128, 4, 16), (4, 512, 4, 16),
         (8, 256, 4, 16), (2, 256, 4, 16)]
HBM_BYTES_PER_S = 3.35e12


def time_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    batches = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        batches.append(a.elapsed_time(b) / reps)
    return statistics.median(batches)


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn()`` with no host in the way: ``reps`` calls
    captured in one CUDA graph, replayed between two events; median of 3."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, 1) / reps


def profiles(rng) -> dict:
    """name -> (slot counts per block row, R)."""
    def fill(first, rest, total):
        lengths = np.r_[first, rest].astype(np.int64)
        lengths[1:] += np.bincount(rng.integers(0, len(rest), total - lengths.sum()),
                                   minlength=len(rest))        # make the slot count exact
        return lengths

    tail = np.minimum(7194, (rng.pareto(1.2, 16383) * 8).astype(np.int64))
    return {
        "block_clustered": (fill(35000, rng.gamma(4.0, 277 / 4.0 * 0.9, 16383).astype(np.int64),
                                 4575345), 16),
        "banded": (fill(1692, rng.integers(4, 6, 131071), 695596), 16),
        "power_law": (fill(3490, tail, 599386), 16),
        "matmat": (fill(8, np.full(131071, 2), 393216), 256),
        "mlp_forward": (fill(8, np.full(111, 7), 896), 128 * 4096),
        "mlp_dX": (fill(28, np.full(31, 25), 896), 128 * 4096),
    }


def brow_for(lengths, gen, shuffle: bool = True) -> torch.Tensor:
    brow = torch.repeat_interleave(torch.arange(len(lengths)), torch.from_numpy(lengths))
    if shuffle:
        brow = brow[torch.randperm(len(brow), generator=gen)]
    return brow.to(torch.int32).to(DEV)


def run(lib, y, parts, plan, R):
    """segment_combine's launches through ``lib`` (a variant library or the built one)."""
    scratch = (torch.empty((plan.num_scratch, R), device=DEV) if plan.num_scratch else None)
    src = parts
    for p in plan.passes:
        code = lib.cb_segment_sum(
            src.data_ptr(), None if p.perm is None else p.perm.data_ptr(), p.bounds.data_ptr(),
            p.dst.data_ptr(), y.data_ptr(), None if scratch is None else scratch.data_ptr(),
            p.nchunks, R, y.shape[0], cb_combine.launch_positions(p.positions, R),
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise SystemExit(f"combine_probe: CUDA error {code}")
        src = scratch
    return y


def check(brow, R, dgen) -> tuple[int, float]:
    """Kernel vs plain, integer and normal data, and two runs; (failures, worst rel err)."""
    T, m = brow.numel(), (int(brow.max()) + 1) * R - 3
    plan = cb_combine.plan_combine(brow, DEV)
    fails, worst = 0, 0.0
    for integer in (True, False):
        parts = (torch.randint(-4, 5, (T, R), generator=dgen, device=DEV).float() if integer
                 else torch.randn((T, R), generator=dgen, device=DEV))
        runs = [cb_combine.segment_combine(torch.zeros(m, device=DEV), parts, brow, R, plan)
                for _ in range(2)]
        want = cb_combine.combine_plain(torch.zeros(m, device=DEV), parts, brow, R)
        err = ((runs[0] - want).abs().max() / max(1.0, want.abs().max().item())).item()
        worst = max(worst, err)
        if not torch.equal(runs[0], runs[1]) or (
                not torch.equal(runs[0], want) if integer else err > TOL):
            fails += 1
            print(f"FAIL R={R} T={T} integer={integer} err={err:.3e}", flush=True)
    return fails, worst


def timed(lib, brow, R, with_plain: bool) -> dict:
    T, m = brow.numel(), (int(brow.max()) + 1) * R
    plan = cb_combine.plan_combine(brow, DEV)
    parts = torch.randn((T, R), device=DEV)
    y = torch.zeros(m, device=DEV)
    nbytes = T * R * 4 + 4 * T + 2 * 4 * m
    res = {"ms": graph_ms(lambda: run(lib, y, parts, plan, R)),
           "loop_ms": time_ms(lambda: run(lib, y, parts, plan, R)),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "passes": len(plan.passes),
           "chunk": plan.chunk, "positions": [p.positions for p in plan.passes],
           "chunks": [p.nchunks for p in plan.passes]}
    res["share_of_bound"] = res["bound_ms"] / res["ms"]
    if with_plain:
        y2d = torch.zeros((m // R, R), device=DEV)
        b64 = brow.long()

        def library():
            y2d.zero_().index_add_(0, b64, parts)
            y.add_(y2d.view(-1))
        res["plain_ms"] = graph_ms(lambda: cb_combine.combine_plain(y, parts, brow, R), 5)
        res["library_ms"] = graph_ms(library)
    return res


def variant_lib(unroll: int, threads: int):
    """A copy of cb_combine.cu alone with COMBINE_UNROLL and COMBINE_THREADS set."""
    work = _build.BUILD_DIR / "variants"             # beside the built library, ignored by git
    work.mkdir(parents=True, exist_ok=True)
    tag = f"combine_u{unroll}_t{threads}"
    so, cu = work / f"{tag}.so", work / f"{tag}.cu"
    text = (_build.CSRC / "cb_combine.cu").read_text()
    for old, new in (('#include "cb_common.cuh"', f'#include "{_build.CSRC}/cb_common.cuh"'),
                     ("COMBINE_UNROLL = 4;", f"COMBINE_UNROLL = {unroll};"),
                     ("COMBINE_THREADS = 256;", f"COMBINE_THREADS = {threads};")):
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    cu.write_text(text)
    out = subprocess.run([_build._find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"combine_probe: nvcc failed for {tag}:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cb_segment_sum.argtypes = [p, p, p, p, p, p, i64, i32, i64, i32, p]
    lib.cb_segment_sum.restype = i32
    return lib, ptxas_report(out.stdout + out.stderr)


def ptxas_report(log: str) -> dict:
    """Registers and spills of each combine kernel, from ``-Xptxas -v``."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if m:
            name = m.group(1)
        elif name and "combine" in name and ("spill" in ln or "Used" in ln):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return {k: " | ".join(v) for k, v in out.items()}


def count_rows() -> dict:
    """Slots per block row of chip_smoke.py's banded and power_law streams."""
    from repro_torch.core import CBMatrix
    from repro_torch.core.streams import build_super_streams
    from repro_torch.data import matrices

    out = {}
    for name, n, make in (
            ("banded", 2097152, lambda n: matrices.banded(n, n, bandwidth=9, seed=1)),
            ("power_law", 262144, lambda n: matrices.power_law(n, n, avg_deg=8, seed=2))):
        rows, cols, vals = make(n)
        s = build_super_streams(CBMatrix.from_coo(rows, cols, vals, (n, n), block_size=16,
                                                  val_dtype=np.float32))
        brow = np.concatenate([np.asarray(b).reshape(-1)
                               for b in (s.dense_brow, s.panel_brow, s.coo_brow)])
        counts = np.bincount(brow)
        out[name] = {"slots": int(len(brow)), "block_rows": int(len(counts)),
                     "row_0": int(counts[0]), "longest_other": int(counts[1:].max()),
                     "p50_p90_p99": np.percentile(counts, [50, 90, 99]).tolist()}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--count-rows", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.count_rows:
        print(json.dumps(count_rows()), flush=True)
        return
    if not torch.cuda.is_available():
        raise SystemExit("combine_probe: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    info = _build.build_info()
    lib = _build.library()
    gen = torch.Generator().manual_seed(args.seed)
    dgen = torch.Generator(device=DEV).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    fails, worst, res = 0, 0.0, {}
    brows = {}
    for name, (lengths, R) in profiles(rng).items():
        brows[name] = (brow_for(lengths, gen), R)
        if name == "block_clustered":           # the same rows read in order: the access pattern's cost
            brows[name + "_in_order"] = (brow_for(lengths, gen, shuffle=False), R)
    for name in brows:
        f, w = check(*brows[name], dgen)
        fails, worst = fails + f, max(worst, w)
        res[name] = timed(lib, *brows[name], with_plain=True)
        torch.cuda.empty_cache()
    out = {"card": card, "build_s": info["seconds"], "check_failures": fails,
           "check_worst_rel": worst, "profiles": res,
           "ptxas": ptxas_report(info["log"])}
    if args.sweep:
        sweep, libs = {}, {}
        defaults = cb_combine.UNROLL, cb_combine.MIN_STEPS, cb_combine.MAX_STEPS
        for unroll, threads, lo, hi in SWEEP:
            if (unroll, threads) not in libs:
                libs[unroll, threads], sweep[f"unroll{unroll}_threads{threads}_ptxas"] = \
                    variant_lib(unroll, threads)
            cb_combine.UNROLL, cb_combine.MIN_STEPS, cb_combine.MAX_STEPS = unroll, lo, hi
            sweep[f"unroll{unroll}_threads{threads}_steps{lo}-{hi}"] = {
                name: timed(libs[unroll, threads], brow, R, with_plain=False)["ms"]
                for name, (brow, R) in brows.items()}
        cb_combine.UNROLL, cb_combine.MIN_STEPS, cb_combine.MAX_STEPS = defaults
        out["sweep_ms"] = sweep
    print(json.dumps(out), flush=True)
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
