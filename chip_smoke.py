#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # needs one CUDA device and nvcc

What it does, in order (every line it prints is one JSON object, except
the ``nvidia-smi`` line):

1. ``device``  — the card (name and power limit as ``nvidia-smi`` gives
   them), torch / CUDA / nvcc versions.
2. ``build``   — builds the kernel library from ``src/repro_torch/kernels/csrc``
   (seconds it took).
3. edge grid   — every hand-written kernel (dense, panel, coo, combine)
   against its plain PyTorch version on the card: B in {8, 16, 24}; payload
   float32, bfloat16, float64; one group and many; W = 8 and a large odd
   multiple of 8; an all-padding group; random data within a tolerance and
   integer data bit for bit.
4. ``spmv``, one line per matrix — the main path through the entry points a
   user calls: triplets from the port's seeded generators ->
   ``CBMatrix.from_coo`` -> ``build_super_streams`` -> ``.to()`` (CUDA by
   default) -> ``ops.cb_spmv`` (default ``impl``: the CUDA kernels). The
   launch counters are zeroed just before and read just after one
   ``cb_spmv`` call, so ``launches`` is per call. Then ``y`` is held
   against the float64 ``dense_oracle``, against ``impl="reference"`` on
   the card, a second run must be bit-equal, and each kernel is compared with
   its plain version and timed at this matrix's shapes. Three matrices, one
   dominated by each format, B = 16, float32, default thresholds and group
   size, each with streams larger than the card's 50 MB L2.
5. ``kernels`` — per kernel: launches on the main path (one ``cb_spmv`` call
   on each matrix, summed; ``launches_per_call`` has them apart), worst error seen,
   time, plain version's time, the bound (the least time the card could
   take: bytes moved over 3.35 TB/s against flops over 67 TFLOP/s float32),
   and a library call's time where one computes the same function.
6. the ``nvidia-smi`` name and power limit, then the verdict line.

Any failed check, a missing GPU, a build error or a launch error ends the
run with a non-zero exit code and no ``"ok": true`` line. Times are taken
with CUDA events over warm, back-to-back calls (see ``time_ms``).
``torch.sparse``, ``torch.bmm``, ``torch.einsum`` and ``index_add_`` appear
here as yardsticks only; the port's CUDA path never calls them. The sizes
are fixed: the script has no rehearsal mode, so its verdict line always
speaks of the full-size run.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.core import CBMatrix, dense_oracle  # noqa: E402
from repro_torch.core.streams import build_super_streams  # noqa: E402
from repro_torch.data import matrices  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build, cb_block_dense, cb_colagg, cb_coo, cb_combine, ops,
)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 rate outside the tensor cores
REPS = 20                      # timed calls per batch (see time_ms)
KERNEL_TOL = 1e-4              # kernel vs plain: f32 sums of <= 24 products (dense) or 8
                               # (panel, coo), or of a block row's slots (combine), taken
                               # in another order; relative to max(1, max |plain|)
ORACLE_TOL = 1e-4              # y vs float64 oracle: f32 accumulation over a row's nnz,
                               # relative to (|A| |x|)_row


def emit(tag: str, **fields) -> None:
    print(json.dumps({tag: fields}), flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args()


DEV = torch.device("cuda")
WRAPPERS = {
    "dense": cb_block_dense.block_dense_spmv_batched,
    "panel": cb_colagg.panel_spmv_batched,
    "coo": cb_coo.coo_spmv_batched,
    "combine": cb_combine.segment_combine,
}
KERNEL_INFO = {
    "dense": ("src/repro_torch/kernels/csrc/cb_block_dense.cu",
              "src/repro/kernels/cb_block_dense.py:53"),
    "panel": ("src/repro_torch/kernels/csrc/cb_colagg.cu",
              "src/repro/kernels/cb_colagg.py:57"),
    "coo": ("src/repro_torch/kernels/csrc/cb_coo.cu",
            "src/repro/kernels/cb_coo.py:71"),
    # not a TPU kernel: the XLA scatter-add around them, which CUDA must order itself
    "combine": ("src/repro_torch/kernels/csrc/cb_combine.cu",
                "src/repro/kernels/ops.py:367"),
}
worst_err = {k: 0.0 for k in WRAPPERS}       # max abs error vs plain, all comparisons
worst_rel = {k: 0.0 for k in WRAPPERS}


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS) -> float:
    """Device time of one ``fn()``: ``reps`` calls enqueued back to back between
    two CUDA events, divided by ``reps``; the median of three such batches.

    Back-to-back calls keep the device's queue full, so the figure is the
    device's time per call as long as the host enqueues faster than the
    device runs (``enqueue_ms`` says whether it does).
    """
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


def enqueue_ms(fn, reps: int = REPS) -> float:
    """Host time to enqueue one ``fn()`` (no synchronisation inside the loop)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e3


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(name: str, got: torch.Tensor, want: torch.Tensor, where: str, exact=False):
    """Hold a kernel's output against its plain version's; record the error."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{name} at {where}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
    if exact:
        if not torch.equal(got, want):
            fail(f"{name} at {where}: integer data not bit-equal to the plain version")
        return
    err = (got - want).abs().max().item() if got.numel() else 0.0
    scale = max(1.0, want.abs().max().item() if want.numel() else 0.0)
    if name in worst_err:                   # a library yardstick is checked, not recorded
        worst_err[name] = max(worst_err[name], err)
        worst_rel[name] = max(worst_rel[name], err / scale)
    if err > KERNEL_TOL * scale:
        fail(f"{name} at {where}: max abs err {err:.3e} > {KERNEL_TOL} * {scale:.3e}")


# ---------------------------------------------------------------------------
# kernel-level calls: (wrapper call, plain call) on the same device tensors
# ---------------------------------------------------------------------------

def dense_pair(tiles, xg):
    return (lambda: cb_block_dense.block_dense_spmv_batched(tiles, xg),
            lambda: cb_block_dense.block_dense_spmv_plain(tiles, xg))


def panel_pair(panels, xg):
    return (lambda: cb_colagg.panel_spmv_batched(panels, xg),
            lambda: cb_colagg.panel_spmv_plain(panels, xg))


def coo_pair(codes, vals, xg, B):
    return (lambda: cb_coo.coo_spmv_batched(codes, vals, xg, block_size=B),
            lambda: cb_coo.coo_spmv_plain(codes, vals, xg, block_size=B))


def combine_pair(m, parts, brow, B, plan=None, y=None):
    """Both add into ``y`` in place; without one, each call gets fresh zeros
    (for comparing). For timing pass a buffer: the calls then accumulate into
    it and the figure holds no allocation and no fill."""
    def run(fn, *extra):
        out = torch.zeros(m, dtype=torch.float32, device=DEV) if y is None else y
        return fn(out, parts, brow, B, *extra)
    plan = plan or cb_combine.plan_combine(brow, DEV)
    return (lambda: run(cb_combine.segment_combine, plan),
            lambda: run(cb_combine.combine_plain))


def panel_library(panels, xg):
    """One PyTorch call for the panel kernel's function: each slot's 8 lanes contracted."""
    gp, B, W = panels.shape
    return torch.einsum("grsk,gsk->gsr", panels.view(gp, B, W // 8, 8), xg.view(gp, W // 8, 8))


def edge_grid(seed: int) -> int:
    """Every kernel vs its plain version over the edge shapes; returns the case count."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    cases = 0

    def payload(shape, dtype, integer):
        if integer:
            return torch.randint(-4, 5, shape, generator=gen).to(dtype).to(DEV)
        return torch.randn(shape, generator=gen).to(dtype).to(DEV)

    for B in (8, 16, 24):
        mask_bits = cb_coo.row_mask(B).bit_length()
        for dtype in (torch.float32, torch.bfloat16, torch.float64):
            for groups in (1, 37):
                for integer in (False, True):
                    tag = f"B={B} {dtype} groups={groups}"
                    for G in (1, 16):
                        k, p = dense_pair(payload((groups, G * B, B), dtype, integer),
                                          payload((groups, G, B), torch.float32, integer))
                        compare("dense", k(), p(), f"{tag} G={G}", exact=integer)
                    for W in (8, 8 * 129):
                        xg = payload((groups, W), torch.float32, integer)
                        k, p = panel_pair(payload((groups, B, W), dtype, integer), xg)
                        compare("panel", k(), p(), f"{tag} W={W}", exact=integer)
                        rows = torch.randint(0, B, (groups, W), generator=gen)
                        cols = torch.randint(0, 1 << mask_bits, (groups, W), generator=gen)
                        codes = ((cols << mask_bits) | rows).to(torch.int32).to(DEV)
                        vals = payload((groups, W), dtype, integer)
                        vals[:, W // 2:] *= (torch.rand((groups, W - W // 2), generator=gen)
                                             .to(DEV) < 0.5)       # padding lanes: val == 0
                        k, p = coo_pair(codes, vals, xg, B)
                        compare("coo", k(), p(), f"{tag} W={W}", exact=integer)
                        cases += 3
        # an all-padding group: zero payload, brow 0, code 0
        z = torch.zeros
        compare("dense", *[f() for f in dense_pair(z((2, 4 * B, B), device=DEV),
                                                   payload((2, 4, B), torch.float32, False))],
                "all-padding", exact=True)
        compare("panel", *[f() for f in panel_pair(z((2, B, 24), device=DEV),
                                                   payload((2, 24), torch.float32, False))],
                "all-padding", exact=True)
        compare("coo", *[f() for f in coo_pair(z((2, 24), dtype=torch.int32, device=DEV),
                                               z((2, 24), device=DEV),
                                               payload((2, 24), torch.float32, False), B)],
                "all-padding", exact=True)
        # combine: short rows, one very long row (several levels), a ragged last row
        for T, mb, m in ((1, 1, B), (500, 40, 40 * B - 3), (70000, 300, 300 * B - 1)):
            for integer in (False, True):
                brow = torch.randint(0, mb, (T,), generator=gen).to(torch.int32)
                brow[: T // 2] = 0
                brow = brow.to(DEV)
                k, p = combine_pair(m, payload((T, B), torch.float32, integer), brow, B)
                compare("combine", k(), p(), f"B={B} T={T} mb={mb}", exact=integer)
                cases += 1
    return cases


# ---------------------------------------------------------------------------
# the main path, one matrix at a time
# ---------------------------------------------------------------------------

def make_matrices(seed: int):
    big, long_ = 262144, 2097152
    return [
        ("block_clustered", "dense", f"block_clustered({big}, {big})",
         lambda: matrices.block_clustered(big, big, seed=seed), (big, big)),
        ("banded", "panel", f"banded({long_}, {long_}, bandwidth=9)",
         lambda: matrices.banded(long_, long_, bandwidth=9, seed=seed + 1), (long_, long_)),
        ("power_law", "coo", f"power_law({big}, {big}, avg_deg=8)",
         lambda: matrices.power_law(big, big, avg_deg=8, seed=seed + 2), (big, big)),
    ]


def run_matrix(name, heavy, call, make, shape, seed, per_kernel, launches):
    B = 16
    t0 = time.perf_counter()
    rows, cols, vals = make()
    t_gen = time.perf_counter() - t0
    x_np = np.random.default_rng(seed + 7).standard_normal(shape[1]).astype(np.float32)

    # -- the main path, counted: zero the counters, drive it, read them -------
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    cb = CBMatrix.from_coo(rows, cols, vals, shape, block_size=B, val_dtype=np.float32)
    t_cb = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_streams = build_super_streams(cb)
    t_streams = time.perf_counter() - t0
    t0 = time.perf_counter()
    s = host_streams.to()                       # default device: CUDA
    x = torch.from_numpy(x_np).to(DEV)
    torch.cuda.synchronize()
    t_to = time.perf_counter() - t0
    t0 = time.perf_counter()
    y = ops.cb_spmv(s, x)                       # default impl: the CUDA kernels
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0          # includes the combine plan's host sort
    counted = {k: w.launches for k, w in WRAPPERS.items()}      # one cb_spmv call
    for k, n in counted.items():
        launches[k] += n
    y_again = ops.cb_spmv(s, x)                 # outside the counted run
    torch.cuda.synchronize()
    del host_streams

    # -- is y right? -----------------------------------------------------------
    stats = cb.stats()
    present = {"dense": s.num_dense_groups, "panel": s.num_panel_groups,
               "coo": s.num_coo_groups, "combine": 1}
    for k, groups in present.items():
        if groups and counted[k] < 1:
            fail(f"{name}: kernel {k} has work but was not launched by cb_spmv")
    if y.shape != (shape[0],) or y.dtype != torch.float32 or not torch.isfinite(y).all():
        fail(f"{name}: y has shape {tuple(y.shape)} dtype {y.dtype} or is not finite")
    if not torch.equal(y, y_again):
        fail(f"{name}: two runs of cb_spmv are not bit-equal")
    y64 = dense_oracle(rows, cols, vals.astype(np.float32).astype(np.float64), shape,
                       x_np.astype(np.float64))
    mag = dense_oracle(rows, cols, np.abs(vals.astype(np.float32)).astype(np.float64), shape,
                       np.abs(x_np).astype(np.float64))
    err = np.abs(y.cpu().numpy().astype(np.float64) - y64)
    oracle_rel = float((err / np.maximum(mag, 1e-30)).max())
    if not (err <= ORACLE_TOL * mag + 1e-30).all():
        fail(f"{name}: y differs from the float64 oracle by {oracle_rel:.3e} of |A||x|")
    y_ref = ops.cb_spmv(s, x, impl="reference")
    ref_err = float((y - y_ref).abs().max())
    if ref_err > KERNEL_TOL * max(1.0, float(y_ref.abs().max())):
        fail(f"{name}: impl='cuda' differs from impl='reference' by {ref_err:.3e}")
    del y_ref

    # -- each kernel against its plain version, and timed, at these shapes -----
    xg_d, xg_p, xg_c = (ops._gather(x, i) for i in (s.dense_xidx, s.panel_xidx, s.coo_xidx))
    prep = ops._prepare(s, None)
    parts = torch.empty((prep.brow.numel(), B), dtype=torch.float32, device=DEV)
    nd, npn = s.dense_brow.numel(), s.panel_brow.numel()
    pairs = {}          # kernel -> ((wrapper, plain), bytes, flops, shape, (library call, its name))
    if s.num_dense_groups:
        pairs["dense"] = (dense_pair(s.dense_tiles, xg_d), nbytes(s.dense_tiles, xg_d) + nd * B * 4,
                          2 * s.dense_tiles.numel(), tuple(s.dense_tiles.shape),
                          (lambda: torch.bmm(s.dense_tiles.view(-1, B, B), xg_d.view(-1, B, 1)),
                           "torch.bmm"))
    if s.num_panel_groups:
        pairs["panel"] = (panel_pair(s.panel_vals, xg_p), nbytes(s.panel_vals, xg_p) + npn * B * 4,
                          2 * s.panel_vals.numel(), tuple(s.panel_vals.shape),
                          (lambda: panel_library(s.panel_vals, xg_p), "torch.einsum"))
    if s.num_coo_groups:
        nco = s.coo_brow.numel()
        pairs["coo"] = (coo_pair(s.coo_codes, s.coo_vals, xg_c, B),
                        nbytes(s.coo_codes, s.coo_vals, xg_c) + nco * B * 4,
                        2 * s.coo_codes.numel(), tuple(s.coo_codes.shape),
                        (None, None))       # no single call decodes the codes and scatters
    for k, ((kern, plain), nb, fl, shp, lib) in pairs.items():
        got, want = kern(), plain()
        compare(k, got, want, f"{name} {shp}")
        if lib[0] is not None:              # the yardstick computes the same function
            compare(k + " library", lib[0]().reshape(want.shape), want, f"{name} {shp}")
        lo, hi = {"dense": (0, nd), "panel": (nd, nd + npn), "coo": (nd + npn, None)}[k]
        parts[lo:hi] = got.reshape(-1, B)
        del got, want
    brow64 = prep.brow.long()
    kc, pc = combine_pair(shape[0], parts, prep.brow, B, prep.combine)
    want = pc()
    compare("combine", kc(), want, f"{name} T={parts.shape[0]}")
    y2d = torch.empty((s.mb, B), dtype=torch.float32, device=DEV)

    def combine_library(y):
        """The same (m,) += as the kernel, by ``index_add_``: fill, scatter-add, ragged cut, add."""
        y2d.zero_().index_add_(0, brow64, parts)
        return y.add_(y2d.view(-1)[: y.shape[0]])

    compare("combine library", combine_library(torch.zeros_like(want)), want, name)
    del want
    y_acc = torch.zeros(shape[0], dtype=torch.float32, device=DEV)
    plan_bytes = sum(nbytes(*(t for t in (lv.perm, lv.ptr, lv.rows) if t is not None))
                     for lv in prep.combine.levels)
    pairs["combine"] = (combine_pair(shape[0], parts, prep.brow, B, prep.combine, y=y_acc),
                        nbytes(parts) + plan_bytes + 2 * shape[0] * 4,
                        parts.numel(), tuple(parts.shape),
                        (lambda: combine_library(y_acc), "index_add_"))
    rows_out = {}
    for k, ((kern, plain), nb, fl, shp, lib) in pairs.items():
        b_ms, b_by = bound(nb, fl)
        rows_out[k] = dict(
            matrix=name, shape=shp, bytes=nb, flops=fl, launches=counted[k],
            ms=time_ms(kern), plain_ms=time_ms(plain, max(3, REPS // 4)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=None if lib[0] is None else time_ms(lib[0]), library=lib[1])
        per_kernel[k].append(rows_out[k])
    del pairs, parts, y2d, y_acc, brow64

    # -- the whole call, timed -------------------------------------------------
    spmv_ms = time_ms(lambda: ops.cb_spmv(s, x))
    spmv_enqueue_ms = enqueue_ms(lambda: ops.cb_spmv(s, x))
    gather_ms = time_ms(lambda: [ops._gather(x, i) for i in
                                 (s.dense_xidx, s.panel_xidx, s.coo_xidx)])
    region = s.region_nbytes()
    crow = torch.from_numpy(np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=shape[0]))]))
    A = torch.sparse_csr_tensor(crow.to(DEV), torch.from_numpy(cols).to(DEV),
                                torch.from_numpy(vals.astype(np.float32)).to(DEV), size=shape)
    y_lib = A @ x
    lib_err = float((y - y_lib).abs().max())
    library_ms = time_ms(lambda: A @ x)
    emit("spmv", matrix=call, dominant_format=heavy, block_size=B,
         dtype="float32", nnz=int(cb.nnz), blocks=stats["num_blocks"],
         blocks_coo=stats["fmt_coo"], blocks_csr=stats["fmt_csr"],
         blocks_dense=stats["fmt_dense"], column_aggregated=stats["column_aggregated"],
         group_size=s.group_size, groups=ops.spmv_launch_stats(s)["steps"],
         padded_elements=s.padded_work(), slots=int(prep.brow.numel()),
         combine_levels=len(prep.combine.levels),
         host_seconds=dict(generate=t_gen, from_coo=t_cb, build_super_streams=t_streams,
                           to_device=t_to, first_call=t_first),
         stream_bytes=sum(region.values()) - region["x"] - region["y"],
         region_bytes=sum(region.values()),
         launches=counted, spmv_ms=spmv_ms, spmv_enqueue_ms=spmv_enqueue_ms, gather_ms=gather_ms,
         kernel_ms={k: v["ms"] for k, v in rows_out.items()},
         effective_GBps=sum(region.values()) / spmv_ms / 1e6,
         bound_ms=sum(region.values()) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
         library_ms=library_ms, library="torch.sparse CSR A @ x",
         err_vs_oracle_rel=oracle_rel, err_vs_reference_abs=ref_err,
         err_vs_library_abs=lib_err, runs_bit_equal=True)


def main() -> None:
    args = parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(1)
    card = smi()
    nvcc = subprocess.run([_build._find_nvcc(), "--version"], check=True, capture_output=True,
                          text=True).stdout
    release = next((ln.split("release")[1].strip() for ln in nvcc.splitlines()
                    if "release" in ln), "unknown")
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda, nvcc_release=release)

    info = _build.build_info()
    emit("build", seconds=info["seconds"], sources=list(_build.SOURCES),
         rebuilt=bool(info["log"]))
    if info["log"]:     # nvcc's report (registers, shared memory), beside the built library
        (_build.BUILD_DIR / "nvcc.log").write_text(info["log"])

    cases = edge_grid(args.seed)
    emit("edge_grid", cases=cases, tolerance=KERNEL_TOL,
         max_abs_err=dict(worst_err), max_rel_err=dict(worst_rel))

    per_kernel = {k: [] for k in WRAPPERS}
    launches = {k: 0 for k in WRAPPERS}
    for name, heavy, call, make, shape in make_matrices(args.seed):
        run_matrix(name, heavy, call, make, shape, args.seed, per_kernel, launches)
        torch.cuda.empty_cache()

    kernels = []
    for k in WRAPPERS:
        if not launches[k] or not per_kernel[k]:
            fail(f"kernel {k} was never launched on the main path")
        head = max(per_kernel[k], key=lambda r: r["bytes"])   # the matrix that loads it most
        source, replaces = KERNEL_INFO[k]
        kernels.append(dict(
            name=k, route="cuda", source=source, replaces=replaces, launches=launches[k],
            max_abs_err=worst_err[k], max_rel_err=worst_rel[k],
            ms=head["ms"], kernel_ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], library=head["library"],
            launches_per_call={r["matrix"]: r["launches"] for r in per_kernel[k]},
            at=head["matrix"], shape=head["shape"],
            per_matrix=per_kernel[k]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
