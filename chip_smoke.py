#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # needs one CUDA device and nvcc

What it does, in order (every line it prints is one JSON object, except
the ``nvidia-smi`` line):

1. ``device``  — the card (name and power limit as ``nvidia-smi`` gives
   them), torch / CUDA / nvcc versions.
2. ``build``   — builds the kernel library from ``src/repro_torch/kernels/csrc``
   (seconds it took).
3. edge grid   — every hand-written kernel (dense, panel, coo, combine,
   spmm) against its plain PyTorch version on the card: B in {8, 16, 24}
   (spmm also 64, 100 and 128, its tensor-core kernel); payload float32,
   bfloat16, float64 (spmm's X float32 and bfloat16); one group and many;
   W = 8 and a large odd multiple of 8; spmm over G in {1, 4, 16} and N in
   {1, 16, 20, 33, 100, 129, 512} (B > 32: G in {1, 2}, N in {1, 20, 100,
   127, 128, 129, 512, 1025, 2049}), and X a view one element past an aligned
   base; an all-padding group;
   the combine over the row-length profiles it meets (block row 0 with
   35,000 slots, rows at exactly one and two chunks, a row longer than a
   chunk squared, the solver's short rows, an inf slot) at R in {8, 16, 24}
   and SpMM's wide rows (R = B*N up to 524288), the last block row ragged,
   parts and y also one float past an aligned base, two runs bit-equal;
   random data within a tolerance and integer data bit for bit.
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
5. ``matmat`` — the multi-RHS product on the ``banded`` matrix of step 4:
   ``super_tile_stream_from_cb`` -> ``.to()`` -> ``ops.cb_spmm`` with 16
   float32 right-hand sides, held against scipy's float64 CSR product, against
   ``impl="reference"``, and against itself (bit-equal); ``torch.sparse`` CSR
   ``A @ X`` is the yardstick.
6. ``mlp_train`` — one training step of the cb-paper MLP at full width
   (granite-8b's d_model 4096 and d_ff 14336, B = 128, keep 0.25, 4096
   tokens): three ``CBSparseLinear`` layers, ``silu(gate(x)) * up(x)`` ->
   ``down``, mean squared error, ``backward()``, SGD. Held against the same
   step in float64 with dense masked weights, two steps bit-equal; the dense
   ``torch.matmul`` step (TF32 off and on) is the yardstick.
7. ``kernels`` — per kernel: launches on the main paths (one ``cb_spmv`` call
   on each matrix, one ``cb_spmm`` call, one training step, summed;
   ``launches_per_call`` has them apart, keyed by the counted run), worst error seen,
   time (and the host's time to enqueue one call, ``enqueue_ms``: where it
   is the larger, the row's time is the host's), plain version's time, the bound (the least time the card could
   take: bytes moved over 3.35 TB/s against flops over the rate of the
   arithmetic the kernel runs — 67 TFLOP/s float32, or 165 TFLOP/s for
   the spmm kernel's 3xTF32 tensor-core products at B > 32; the combine's
   bytes are those of any deterministic combine, ``combine_bytes``), and a
   library call's time where one computes the same function.
8. the ``nvidia-smi`` name and power limit, then the verdict line.

Any failed check, a missing GPU, a build error or a launch error ends the
run with a non-zero exit code and no ``"ok": true`` line. Times are taken
with CUDA events over warm, back-to-back calls (see ``time_ms``).
``torch.sparse``, ``torch.einsum``, ``index_add_`` and the dense
``torch.matmul`` appear here as yardsticks only, and ``torch.bmm`` as one too
except in the sparse layer's dW, which the JAX package also leaves outside
any kernel; the port's CUDA path calls none of the others. Float32 matrix
products run in full float32 (``allow_tf32`` is set False) unless a line
says otherwise. The sizes
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
import scipy.sparse
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.core import CBMatrix, dense_oracle  # noqa: E402
from repro_torch.core.streams import (  # noqa: E402
    build_super_streams, build_super_tile_stream, tile_stream_from_cb,
)
from repro_torch.data import matrices  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build, cb_block_dense, cb_colagg, cb_combine, cb_coo, cb_spmm, ops,
)
from repro_torch.sparse import linear as sparse_linear  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 rate outside the tensor cores
TF32X3_FLOPS_PER_S = 495e12 / 3  # H100 SXM dense TF32 tensor-core rate (NVIDIA data
                                 # sheet), three TF32 products per float32-grade
                                 # product: the spmm kernel's rate at B > 32
REPS = 20                      # timed calls per batch (see time_ms)
KERNEL_TOL = 1e-4              # kernel vs plain: f32 sums of <= 24 products (dense) or 8
                               # (panel, coo), <= 128 (spmm), or of a block row's slots
                               # (combine), taken in another order; relative to
                               # max(1, max |plain|)
ORACLE_TOL = 1e-4              # y vs float64 oracle: f32 accumulation over a row's nnz,
                               # relative to (|A| |x|)_row
# the cb-paper MLP (src/repro/configs/__init__.py: granite-8b widths, CB-sparse SwiGLU)
# over one 4096-token sequence of the train_4k shape
MLP = dict(d_model=4096, d_ff=14336, block_size=128, keep_fraction=0.25, tokens=4096)
TRAIN_TOL = 1e-4               # MLP step vs float64 dense: y, dX and d_tiles each within
                               # this fraction of the float64 result's largest magnitude.
                               # f32 sums of 1024 (forward, dX) or 4096 (dW) products
                               # carry ~1e-6 of that; 1e-4 leaves room for the three
                               # chained products and the silu between them


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
    "spmm": cb_spmm.super_tile_spmm,
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
    "spmm": ("src/repro_torch/kernels/csrc/cb_spmm.cu",
             "src/repro/kernels/cb_spmm.py:71"),
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


def bound(nbytes: int, flops: int, flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def combine_bytes(parts: torch.Tensor, y_len: int) -> int:
    """What any deterministic combine must move, whatever its plan: the
    partials read once, one int32 of permutation per slot, y read and written
    once."""
    return nbytes(parts) + 4 * parts.shape[0] + 2 * 4 * y_len


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


def spmm_flops_per_s(B: int) -> float:
    """The rate of the arithmetic the spmm kernel runs at block size B
    (csrc/cb_spmm.cu: 3xTF32 tensor cores above 32, float32 FMA below)."""
    return TF32X3_FLOPS_PER_S if B > 32 else F32_FLOPS_PER_S


def spmm_pair(tiles, bcol, Xb):
    return (lambda: cb_spmm.super_tile_spmm(tiles, bcol, Xb),
            lambda: cb_spmm.super_tile_spmm_plain(tiles, bcol, Xb))


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
    return cases + combine_edge_grid(gen, payload) + spmm_edge_grid(gen, payload)


def at_offset(t: torch.Tensor, off: int) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts ``off`` floats past an aligned base."""
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    buf[off:].copy_(t.reshape(-1))
    return buf[off:].view(t.shape)


def combine_case(gen, payload, R, lengths, tag, off=0, inf_row=None, chunk=None) -> int:
    """The combine at row width R over block rows of these slot counts (slots
    shuffled, last block row ragged, y not zero): random data within
    KERNEL_TOL and integer data bit-equal to the plain version, two runs
    bit-equal; ``off`` puts parts and y one float past an aligned base;
    ``inf_row`` puts an inf in one slot of that row, which must reach that
    row's element and no other; ``chunk``, the chunk length the plan must have."""
    counts = torch.tensor(lengths)
    brow = torch.repeat_interleave(torch.arange(len(lengths)), counts)
    brow = brow[torch.randperm(len(brow), generator=gen)].to(torch.int32).to(DEV)
    plan = cb_combine.plan_combine(brow, DEV)
    T, m = brow.numel(), len(lengths) * R - min(5, R - 1)
    where = f"{tag} R={R} T={T} offset={off}"
    if len(plan.passes) != 1 + bool(max(lengths) > plan.chunk) or (chunk and plan.chunk != chunk):
        fail(f"combine at {where}: {len(plan.passes)} passes for rows of at most "
             f"{max(lengths)} slots in chunks of {plan.chunk} (meant {chunk})")
    for integer in (False, True):
        parts = at_offset(payload((T, R), torch.float32, integer), off)
        y0 = payload((m,), torch.float32, integer)
        if inf_row is not None and not integer:
            slot = int(torch.nonzero(brow == inf_row)[0])
            parts[slot, R // 2] = float("inf")
        runs = [cb_combine.segment_combine(at_offset(y0, off), parts, brow, R, plan)
                for _ in range(2)]
        want = cb_combine.combine_plain(y0.clone(), parts, brow, R)
        if not torch.equal(runs[0], runs[1]):
            fail(f"combine at {where}: two runs are not bit-equal")
        if inf_row is not None and not integer:
            at = inf_row * R + R // 2
            bad = ~torch.isfinite(runs[0])
            if not (bad[at] and int(bad.sum()) == 1 and torch.equal(bad, ~torch.isfinite(want))):
                fail(f"combine at {where}: the inf of row {inf_row} did not land there alone")
            runs[0][at], want[at] = 0.0, 0.0
        compare("combine", runs[0], want, where, exact=integer)
    return 2


def combine_edge_grid(gen, payload) -> int:
    """The combine over the row-length profiles it meets and their edges:
    block row 0 with 35,000 slots (the packer's padding) beside a spread of
    rows, one row longer than a chunk squared, rows at exactly one and two
    chunks and one slot either side, the solver's short rows, one slot, an inf
    slot in a long row and in a short one; R in {8, 16, 24, 256, 3048 (B = 24,
    N = 127), 3096, 65536, 524288 (the MLP's 128 x 4096)}; parts and y at a
    4-byte offset."""
    c = cb_combine.chunk_length(cb_combine.MAX_POSITIONS, 0)  # the chunk at these slot counts
    spread = torch.randint(1, 600, (299,), generator=gen).tolist()
    cases = 0
    for R in (8, 16, 24):
        cases += combine_case(gen, payload, R, [1], "one slot")
        cases += combine_case(gen, payload, R, [250] + [6] * 39, "row 0 of 250")
        for off in (0, 1):
            cases += combine_case(gen, payload, R, [35000] + spread, "row 0 of 35,000", off)
            cases += combine_case(gen, payload, R, [c - 1, c, c + 1, 2 * c, 2 * c + 1, 3 * c],
                                  "chunk edges", off, chunk=c)
            cases += combine_case(gen, payload, R, [3] * 2000 + [40], "short rows", off)
    cases += combine_case(gen, payload, 16, [c * c + 1] + [5] * 20, "a row over chunk squared")
    cases += combine_case(gen, payload, 16, [35000] + spread, "inf in row 0", inf_row=0)
    cases += combine_case(gen, payload, 16, [35000] + spread, "inf in a short row", inf_row=7)
    for R, lengths in ((256, [3] * 5000 + [3000]), (256, [1700] + [11] * 299),
                       (3048, [3] * 300 + [70]), (24 * 129, [230] + [12] * 39),
                       (128 * 512, [100] + [33] * 6)):
        for off in (0, 1):
            cases += combine_case(gen, payload, R, lengths, "wide rows", off)
    cases += combine_case(gen, payload, 256, [3] * 500 + [8], "inf in a wide row", inf_row=9)
    cases += combine_case(gen, payload, 128 * 4096, [8] * 6 + [40], "the MLP's width", 1)
    cases += combine_case(gen, payload, 128 * 4096, [8] * 6 + [40], "the MLP's width")
    return cases


SPMM_DTYPES = [(t, x) for t in (torch.float32, torch.bfloat16, torch.float64)
               for x in (torch.float32, torch.bfloat16)]


def spmm_edge_grid(gen, payload) -> int:
    """The SpMM kernel over B x G x N, every (tile, X) dtype pair in turn, one
    group and many; an all-empty-slot group; X views one element past an
    aligned base; the combine at R = B*N."""
    cases = 0
    combos = [(B, G, N) for B in (8, 16, 24) for G in (1, 4, 16)
              for N in (1, 16, 20, 33, 100, 129, 512)]
    combos += [(B, G, N) for B in (64, 100, 128) for G in (1, 2)
               for N in (1, 20, 100, 127, 128, 129, 512, 1025, 2049)]
    for i, (B, G, N) in enumerate(combos):
        tdt, xdt = SPMM_DTYPES[i % len(SPMM_DTYPES)]
        groups, nb = (1, 3) if (i // len(SPMM_DTYPES)) % 2 else (13, 29)
        for integer in (False, True):
            bcol = torch.randint(0, nb, (groups, G), generator=gen).to(torch.int32).to(DEV)
            k, p = spmm_pair(payload((groups, G * B, B), tdt, integer), bcol,
                             payload((nb, B, N), xdt, integer))
            compare("spmm", k(), p(), f"B={B} G={G} N={N} {tdt}/{xdt} groups={groups}",
                    exact=integer)
            cases += 1
        if B in (16, 128):                       # an all-empty-slot group: exact zeros
            k, p = spmm_pair(torch.zeros((2, G * B, B), device=DEV),
                             torch.zeros((2, G), dtype=torch.int32, device=DEV),
                             payload((nb, B, N), xdt, False))
            got = k()
            compare("spmm", got, p(), f"B={B} G={G} N={N} empty slots", exact=True)
            if got.any():
                fail(f"spmm: empty slots at B={B} G={G} N={N} are not exact zeros")
            cases += 1
    # X a contiguous view one element past an aligned base: the kernels' 4-byte copies
    for B, G, N in ((16, 4, 20), (128, 2, 20)):
        for integer in (False, True):
            bcol = torch.randint(0, 29, (13, G), generator=gen).to(torch.int32).to(DEV)
            Xb = payload((29 * B * N + 1,), torch.float32, integer)[1:].view(29, B, N)
            k, p = spmm_pair(payload((13, G * B, B), torch.float32, integer), bcol, Xb)
            compare("spmm", k(), p(), f"B={B} G={G} N={N} X at a 4-byte offset", exact=integer)
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
    if counted["combine"] > 2:
        fail(f"{name}: the combine took {counted['combine']} launches, at most 2 by design")
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
    got = kc()
    compare("combine", got, want, f"{name} T={parts.shape[0]}")
    if not torch.equal(got, kc()):
        fail(f"{name}: two runs of the combine are not bit-equal")
    del got
    y2d = torch.empty((s.mb, B), dtype=torch.float32, device=DEV)

    def combine_library(y):
        """The same (m,) += as the kernel, by ``index_add_``: fill, scatter-add, ragged cut, add."""
        y2d.zero_().index_add_(0, brow64, parts)
        return y.add_(y2d.view(-1)[: y.shape[0]])

    compare("combine library", combine_library(torch.zeros_like(want)), want, name)
    del want
    y_acc = torch.zeros(shape[0], dtype=torch.float32, device=DEV)
    pairs["combine"] = (combine_pair(shape[0], parts, prep.brow, B, prep.combine, y=y_acc),
                        combine_bytes(parts, shape[0]),
                        parts.numel(), tuple(parts.shape),
                        (lambda: combine_library(y_acc), "index_add_"))
    rows_out = {}
    for k, ((kern, plain), nb, fl, shp, lib) in pairs.items():
        b_ms, b_by = bound(nb, fl)
        rows_out[k] = dict(
            matrix=name, run=name, shape=shp, bytes=nb, flops=fl, launches=counted[k],
            ms=time_ms(kern), enqueue_ms=enqueue_ms(kern),
            plain_ms=time_ms(plain, max(3, REPS // 4)), bound_ms=b_ms, bound_by=b_by,
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
         combine_passes=len(prep.combine.passes), combine_chunk=prep.combine.chunk,
         combine_positions=[p.positions for p in prep.combine.passes],
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
    return cb, (rows, cols, vals)


# ---------------------------------------------------------------------------
# the SpMM paths: the solver's multi-RHS product and the sparse MLP's step
# ---------------------------------------------------------------------------

def kernel_row(path, run, shape, nb, fl, launched, kern, plain, lib, lib_name,
               flops_per_s=F32_FLOPS_PER_S):
    """One timed row of the ``kernels`` line (kernel, plain, library call);
    ``launched`` is the kernel's launch count in the counted ``run``."""
    b_ms, b_by = bound(nb, fl, flops_per_s)
    return dict(matrix=path, run=run, shape=shape, bytes=nb, flops=fl, launches=launched,
                ms=time_ms(kern), enqueue_ms=enqueue_ms(kern),
                plain_ms=time_ms(plain, max(3, REPS // 4)), bound_ms=b_ms, bound_by=b_by,
                library_ms=None if lib is None else time_ms(lib), library=lib_name)


def spmm_rows(path, run, tiles, bcol, Xb, route, m, launched, per_kernel):
    """spmm and combine at one product's real shapes: checked, then timed.
    ``launched`` holds the launch counts of the counted ``run`` this product
    belongs to (one ``cb_spmm`` call, or a whole training step)."""
    gt, Gt = bcol.shape
    _, B, N = Xb.shape
    T = gt * Gt
    kern, plain = spmm_pair(tiles, bcol, Xb)
    got, want = kern(), plain()
    compare("spmm", got, want, f"{path} {tuple(tiles.shape)} N={N}")
    xg = Xb[bcol.reshape(-1).long()]                    # pre-gathered for the yardstick
    tiles3 = tiles.view(T, B, B).float()

    def library():
        return torch.bmm(tiles3, xg)

    compare("spmm library", library().view(want.shape), want, path)
    del want
    parts = got.view(T, B * N)
    kc, pc = combine_pair(m * N, parts, route.brow, B * N, route.combine)
    want = pc()
    got = kc()
    compare("combine", got, want, f"{path} R={B}*{N}")
    if not torch.equal(got, kc()):
        fail(f"{path}: two runs of the combine are not bit-equal")
    del want, got
    y2d = torch.empty((-(-m // B), B * N), dtype=torch.float32, device=DEV)
    brow64 = route.brow.long()

    def combine_library(y):
        y2d.zero_().index_add_(0, brow64, parts)
        return y.add_(y2d.view(-1)[: y.shape[0]])

    compare("combine library", combine_library(torch.zeros(m * N, device=DEV)), pc(), path)
    y_acc = torch.zeros(m * N, dtype=torch.float32, device=DEV)
    kc, pc = combine_pair(m * N, parts, route.brow, B * N, route.combine, y=y_acc)
    out = {
        "spmm": kernel_row(path, run, tuple(tiles.shape) + (N,),
                           nbytes(tiles, bcol, Xb) + T * B * N * 4, 2 * T * B * B * N,
                           launched["spmm"], kern, plain, library, "torch.bmm (X pre-gathered)",
                           spmm_flops_per_s(B)),
        "combine": kernel_row(path, run, tuple(parts.shape), combine_bytes(parts, m * N),
                              parts.numel(), launched["combine"], kc, pc,
                              lambda: combine_library(y_acc), "index_add_"),
    }
    for k, row in out.items():
        per_kernel[k].append(row)
    return out


def run_matmat(call, cb, coo, seed, per_kernel, launches):
    """``ops.cb_spmm`` with 16 right-hand sides on an SpMV line's matrix."""
    rows, cols, vals = coo
    m, n = cb.shape
    B, N = cb.block_size, 16
    X_np = np.random.default_rng(seed + 11).standard_normal((n, N)).astype(np.float32)

    # -- the path, counted ----------------------------------------------------
    for w in WRAPPERS.values():
        w.launches = 0
    t0 = time.perf_counter()
    tiles_host = tile_stream_from_cb(cb)
    t_tiles = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed_host = build_super_tile_stream(tiles_host)       # default group size
    t_pack = time.perf_counter() - t0
    t0 = time.perf_counter()
    s = packed_host.to()
    X = torch.from_numpy(X_np).to(DEV)
    torch.cuda.synchronize()
    t_to = time.perf_counter() - t0
    t0 = time.perf_counter()
    Y = ops.cb_spmm(s, X)                                    # default impl: the CUDA kernels
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0                      # holds the combine plan's host sort
    counted = {k: w.launches for k, w in WRAPPERS.items()}
    for k, c in counted.items():
        launches[k] += c
    for k in ("spmm", "combine"):
        if counted[k] < 1:
            fail(f"matmat: kernel {k} was not launched by cb_spmm")
    Y_again = ops.cb_spmm(s, X)
    torch.cuda.synchronize()
    num_tiles = tiles_host.num_tiles
    del tiles_host, packed_host

    # -- is Y right? -----------------------------------------------------------
    if Y.shape != (m, N) or Y.dtype != torch.float32 or not torch.isfinite(Y).all():
        fail(f"matmat: Y has shape {tuple(Y.shape)} dtype {Y.dtype} or is not finite")
    if not torch.equal(Y, Y_again):
        fail("matmat: two runs of cb_spmm are not bit-equal")
    A64 = scipy.sparse.csr_matrix((vals.astype(np.float32).astype(np.float64), (rows, cols)),
                                  shape=(m, n))
    Y64 = A64 @ X_np.astype(np.float64)
    mag = abs(A64) @ np.abs(X_np).astype(np.float64)
    err = np.abs(Y.cpu().numpy().astype(np.float64) - Y64)
    oracle_rel = float((err / np.maximum(mag, 1e-30)).max())
    if not (err <= ORACLE_TOL * mag + 1e-30).all():
        fail(f"matmat: Y differs from scipy float64 by {oracle_rel:.3e} of |A||X|")
    Y_ref = ops.cb_spmm(s, X, impl="reference")
    ref_err = float((Y - Y_ref).abs().max())
    if ref_err > KERNEL_TOL * max(1.0, float(Y_ref.abs().max())):
        fail(f"matmat: impl='cuda' differs from impl='reference' by {ref_err:.3e}")
    del Y_ref, A64, Y64, mag, err

    # -- the kernels at these shapes, and the whole call -------------------------
    _, route = ops._prepare_tiles(s, None)
    Xb = ops.x_blocks(X, s.nb, B)
    path = f"matmat {call}"
    rows_out = spmm_rows(path, path, s.tiles, s.bcol, Xb, route, m, counted, per_kernel)
    matmat_ms = time_ms(lambda: ops.cb_spmm(s, X))
    matmat_enqueue_ms = enqueue_ms(lambda: ops.cb_spmm(s, X))
    crow = torch.from_numpy(np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=m))]))
    A = torch.sparse_csr_tensor(crow.to(DEV), torch.from_numpy(cols).to(DEV),
                                torch.from_numpy(vals.astype(np.float32)).to(DEV), size=(m, n))
    lib_err = float((Y - A @ X).abs().max())
    library_ms = time_ms(lambda: A @ X)
    b_ms, b_by = bound(nbytes(s.tiles, s.bcol, s.brow, X) + m * N * 4,
                       2 * s.tiles.numel() * N)
    emit("matmat", matrix=call, block_size=B, n_rhs=N, dtype="float32", tiles=num_tiles,
         group_size=s.group_size, groups=s.num_groups, slots=s.num_groups * s.slots,
         stream_bytes=s.region_nbytes()["tiles"],
         host_seconds=dict(tile_stream_from_cb=t_tiles, build_super_tile_stream=t_pack,
                           to_device=t_to, first_call=t_first),
         launches=counted, spmm_ms=matmat_ms, spmm_enqueue_ms=matmat_enqueue_ms,
         kernel_ms={k: v["ms"] for k, v in rows_out.items()},
         bound_ms=b_ms, bound_by=b_by,
         library_ms=library_ms, library="torch.sparse CSR A @ X",
         err_vs_oracle_rel=oracle_rel, err_vs_reference_abs=ref_err,
         err_vs_library_abs=lib_err, runs_bit_equal=True)


def block_grads(W_grad, spec):
    """The (nt, B, B) tiles of dA = dW^T at the spec's blocks."""
    B = spec.block_size
    g = W_grad.T.reshape(spec.mb, B, spec.nb, B).permute(0, 2, 1, 3)
    return g[torch.from_numpy(spec.brow).long(), torch.from_numpy(spec.bcol).long()]


def run_mlp_train(seed, per_kernel, launches):
    """One training step of the cb-paper MLP (granite-8b widths) at full size."""
    d, ff, B, keep, T = (MLP[k] for k in ("d_model", "d_ff", "block_size", "keep_fraction",
                                          "tokens"))
    lr = 1e-2
    # the specs of ``repro.models.layers.build_mlp_specs`` (seeds 42, 43, 44)
    specs = {
        "gate": sparse_linear.cb_spec_random(d, ff, block_size=B, keep_fraction=keep, seed=42),
        "up": sparse_linear.cb_spec_random(d, ff, block_size=B, keep_fraction=keep, seed=43),
        "down": sparse_linear.cb_spec_random(ff, d, block_size=B, keep_fraction=keep, seed=44),
    }
    gen = torch.Generator(device=DEV).manual_seed(seed)
    layers = {k: sparse_linear.CBSparseLinear(sp, generator=gen, device=DEV)
              for k, sp in specs.items()}
    x = torch.randn((T, d), generator=gen, device=DEV)
    target = torch.randn((T, d), generator=gen, device=DEV)

    def forward(xx):
        h = torch.nn.functional.silu(layers["gate"](xx)) * layers["up"](xx)
        return layers["down"](h)

    def step(update: bool):
        xx = x.detach().requires_grad_(True)
        for layer in layers.values():
            layer.tiles.grad = None
        y = forward(xx)
        loss = ((y - target) ** 2).mean()
        loss.backward()
        if update:
            with torch.no_grad():
                for layer in layers.values():
                    layer.tiles.sub_(lr * layer.tiles.grad)
        return loss, y.detach(), xx.grad

    # -- the step, counted (no update yet: the checks below use this state) --------
    for w in WRAPPERS.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, y, dx = step(update=False)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0                 # holds the routes' host sorts
    counted = {k: w.launches for k, w in WRAPPERS.items()}
    for k, c in counted.items():
        launches[k] += c
    for k in ("spmm", "combine"):
        if counted[k] < 1:
            fail(f"mlp_train: kernel {k} was not launched by the training step")
    grads = {k: layer.tiles.grad.clone() for k, layer in layers.items()}
    _, y2, dx2 = step(update=False)
    torch.cuda.synchronize()
    bit_equal = {"y": torch.equal(y, y2), "dX": torch.equal(dx, dx2),
                 "d_tiles": all(torch.equal(grads[k], layers[k].tiles.grad) for k in layers)}
    if not all(bit_equal.values()):
        fail(f"mlp_train: two steps from the same state differ: {bit_equal}")
    del y2, dx2
    if not all(torch.isfinite(t).all() for t in (y, dx, *grads.values())):
        fail("mlp_train: non-finite y, dX or d_tiles")

    # -- the same step in float64 with dense masked weights ---------------------------
    W64 = {k: sparse_linear.dense_equivalent({"tiles": layer.tiles.detach().double()},
                                             layer.spec).requires_grad_(True)
           for k, layer in layers.items()}
    x64 = x.double().requires_grad_(True)
    y64 = (torch.nn.functional.silu(x64 @ W64["gate"]) * (x64 @ W64["up"])) @ W64["down"]
    ((y64 - target.double()) ** 2).mean().backward()

    def rel(got, want):
        return float((got.double() - want).abs().max() / want.abs().max())

    err = {"y": rel(y, y64.detach()), "dX": rel(dx, x64.grad),
           "d_tiles": {k: rel(grads[k], block_grads(W64[k].grad, layers[k].spec))
                       for k in layers}}
    worst = max(err["y"], err["dX"], *err["d_tiles"].values())
    if worst > TRAIN_TOL:
        fail(f"mlp_train: differs from the float64 dense step: {err}")
    del W64, x64, y64, y, dx, grads

    # -- timed steps (with the update) ---------------------------------------------
    def timed_step():
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xx = x.detach().requires_grad_(True)
        for layer in layers.values():
            layer.tiles.grad = None
        e0.record()
        loss = ((forward(xx) - target) ** 2).mean()
        e1.record()
        loss.backward()
        e2.record()
        with torch.no_grad():
            for layer in layers.values():
                layer.tiles.sub_(lr * layer.tiles.grad)
        enq = time.perf_counter() - t0
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, e0.elapsed_time(e1), e1.elapsed_time(e2), enq * 1e3

    timed_step()                                       # warm
    runs = [timed_step() for _ in range(5)]
    step_ms, forward_ms, backward_ms, step_enqueue_ms = (
        statistics.median(r[i] for r in runs) for i in range(4))

    # -- each part of a layer's products at its real shapes --------------------------
    parts = {}
    for name in ("gate", "down"):
        layer, spec = layers[name], specs[name]
        mm = sparse_linear._Matmul(spec, "cuda", None, DEV)
        tiles = layer.tiles.detach()
        X = (x if name == "gate" else torch.randn((T, ff), generator=gen, device=DEV)).T
        dY = torch.randn((spec.out_features, T), generator=gen, device=DEV)
        Xb = ops.x_blocks(X, spec.nb, B)
        dYb = ops.x_blocks(dY, spec.mb, B)
        tT = mm.transposed_tiles(tiles)
        fwd = spmm_rows(f"mlp_train {name} forward", "mlp_train step", tiles.view(-1, B, B),
                        mm.fwd.route.bcol, Xb, mm.fwd.route, spec.out_features, counted,
                        per_kernel)
        dxr = spmm_rows(f"mlp_train {name} dX", "mlp_train step", tT, mm.bwd.route.bcol, dYb,
                        mm.bwd.route, spec.in_features, counted, per_kernel)
        parts[name] = dict(
            spmm_forward_ms=fwd["spmm"]["ms"], spmm_dX_ms=dxr["spmm"]["ms"],
            combine_forward_ms=fwd["combine"]["ms"], combine_dX_ms=dxr["combine"]["ms"],
            dW_bmm_ms=time_ms(lambda: torch.bmm(
                torch.index_select(dYb, 0, mm.fwd.brow),
                torch.index_select(Xb, 0, mm.fwd.bcol).transpose(1, 2)), 5),
            transposed_tiles_ms=time_ms(lambda: mm.transposed_tiles(tiles)),
            x_copy_ms=time_ms(lambda: ops.x_blocks(X, spec.nb, B)),
            dY_copy_ms=time_ms(lambda: ops.x_blocks(dY, spec.mb, B)))
        del mm, Xb, dYb, tT, X, dY
        torch.cuda.empty_cache()

    # -- the dense yardstick: the same step with dense masked float32 weights ----------
    Wd = {k: sparse_linear.dense_equivalent({"tiles": layer.tiles.detach()},
                                            layer.spec).contiguous().requires_grad_(True)
          for k, layer in layers.items()}

    def dense_step():
        xx = x.detach().requires_grad_(True)
        for w in Wd.values():
            w.grad = None
        h = torch.nn.functional.silu(xx @ Wd["gate"]) * (xx @ Wd["up"])
        ((h @ Wd["down"] - target) ** 2).mean().backward()
        with torch.no_grad():
            for w in Wd.values():
                w.sub_(lr * w.grad)

    dense_ms = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        dense_ms["tf32_on" if tf32 else "tf32_off"] = time_ms(dense_step, 3)
    torch.backends.cuda.matmul.allow_tf32 = False
    del Wd

    flops = sum(3 * 2 * sp.num_tiles * B * B * T for sp in specs.values())
    tile_bytes = sum(layer.tiles.numel() * 4 for layer in layers.values())
    # the step's bound with every product at the spmm kernel's 3xTF32 rate (dW is
    # a float32 cuBLAS bmm today), and the CUDA-core float32 floor beside it
    b_ms, b_by = bound(3 * T * d * 4 + 2 * tile_bytes, flops, TF32X3_FLOPS_PER_S)
    f32_floor_ms, _ = bound(3 * T * d * 4 + 2 * tile_bytes, flops)
    emit("mlp_train", config=f"cb-paper MLP: granite-8b d_model {d}, d_ff {ff}, "
         f"CB-sparse SwiGLU, B={B}, keep {keep}", tokens=T, dtype="float32",
         layers={k: dict(in_features=sp.in_features, out_features=sp.out_features,
                         tiles=sp.num_tiles, tile_bytes=sp.num_tiles * B * B * 4)
                 for k, sp in specs.items()},
         launches=counted, first_step_s=t_first, loss=float(loss.detach()),
         step_ms=step_ms, forward_ms=forward_ms, backward_ms=backward_ms,
         step_enqueue_ms=step_enqueue_ms, step_runs_ms=[r[0] for r in runs],
         parts_ms=parts, flops=flops, achieved_TFLOPs=flops / step_ms / 1e9,
         bound_ms=b_ms, bound_by=b_by, bound_rate="3xTF32, 165 TFLOP/s",
         cuda_core_floor_ms=f32_floor_ms,
         dense_step_ms=dense_ms, dense="torch.matmul, dense masked float32 weights, "
         "4x the flops; tf32_off: allow_tf32 False, tf32_on: allow_tf32 True",
         err_vs_float64_dense=err, tolerance=TRAIN_TOL, runs_bit_equal=bit_equal)


def main() -> None:
    args = parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False      # yardsticks in full float32
    torch.backends.cudnn.allow_tf32 = False
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
        cb, coo = run_matrix(name, heavy, call, make, shape, args.seed, per_kernel, launches)
        if name == "banded":                    # the solver's multi-RHS product, same matrix
            run_matmat(call, cb, coo, args.seed, per_kernel, launches)
        del cb, coo
        torch.cuda.empty_cache()
    run_mlp_train(args.seed, per_kernel, launches)
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
            launches_per_call={r["run"]: r["launches"] for r in per_kernel[k]},
            at=head["matrix"], shape=head["shape"],
            per_matrix=per_kernel[k]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
