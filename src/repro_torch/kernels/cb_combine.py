"""The additive combine: per-slot partials -> y, in a fixed order.

Every kernel emits one partial row of width ``R`` per slot; slot ``t``
belongs to block row ``brow[t]``. The combine adds them:
``y2d[brow[t]] += parts[t]`` with ``y2d`` the ``(mb, R)`` view of a flat
``y``. For SpMV ``R = B`` and ``y`` is ``(m,)``; for SpMM ``R = B*N`` and
``y`` is the flat view of a contiguous ``(m, N)`` result, so a slot's
``(B, N)`` partial lands on its block row's ``B`` rows of Y. The JAX
package leaves this to one XLA scatter-add around its kernels
(``src/repro/kernels/ops.py``, ``_combine_into`` and ``_cb_spmm_jit``),
which is deterministic there. On CUDA ``index_add_``
and float ``atomicAdd`` are not: the order of the additions, and with it
the last bits of y, can change from run to run.

So on the card the order is fixed once per stream, on the host
(``plan_combine``): a stable sort of ``brow`` groups each block row's
slots, and each row's run is cut into chunks of at most ``chunk`` slots
(a few hundred where rows are long). ``csrc/cb_combine.cu`` sums every
chunk in one pass, spread over ``positions`` slot positions: position
``p`` adds the chunk's slots ``p, p + P, p + 2P, ...`` in stored order,
then a fixed tree adds the positions (``p`` and ``p ^ 1``, then ``p`` and
``p ^ 2``, ...). A row that is one chunk adds its sum to y in that pass;
the chunks of a longer row (block row 0, which collects the packer's empty
slots; hub rows) leave their sums in a scratch buffer, and a second pass
over those rows alone sums them in the same way and adds the result to y.
At most two launches, one where no row is longer than a chunk, and the
same bits on every run. The kernel is memory-bound: one read of the
partials, one of the sort permutation, one read and one write of y.

``segment_combine`` launches the kernel on CUDA tensors or raises; on CPU
tensors it takes ``combine_plain`` (``index_add_``, sequential and
deterministic there).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import errors

from . import _build

UNROLL = 4          # slots each lane has in flight (csrc/cb_combine.cu, COMBINE_UNROLL)
MAX_POSITIONS = 8   # most slot positions a chunk is spread over (a warp at R = 16)
# A chunk takes at most `steps` loop steps of UNROLL slots, each a round trip to
# memory, so its length bounds the pass's tail. `steps` follows the number of
# rounds the whole pass needs: ROUND_SLOTS is about what the card has in flight
# at once at R = 16 (132 SMs x 64 warps x 8 positions x UNROLL).
MIN_STEPS, MAX_STEPS = 4, 16
ROUND_SLOTS = 2**18


@dataclasses.dataclass
class CombinePass:
    """One launch: every chunk's slots summed in the fixed order (device tensors)."""

    perm: torch.Tensor | None   # (n_src,) int32 source row per position; None = identity
    bounds: torch.Tensor        # (nchunks, 2) int32 [lo, hi) into perm of each chunk
    dst: torch.Tensor           # (nchunks,) int32 y's block row, or -1 - k for scratch row k
    positions: int              # slot positions a chunk is spread over (a power of two)
    nchunks: int


@dataclasses.dataclass
class CombinePlan:
    """The fixed summation order for one stream's slots."""

    num_slots: int
    chunk: int                  # most slots in one chunk of the first pass
    passes: list[CombinePass]   # the slots; then, if any row is longer than a chunk, its sums
    num_scratch: int            # chunk sums the first pass leaves for the second


def lanes_per_slot(row_width: int) -> int:
    """Lanes that cover one slot's row, 4 columns each: a power of two, at most a warp."""
    lanes = 1
    while lanes < 32 and 4 * lanes < row_width:
        lanes *= 2
    return lanes


def launch_positions(positions: int, row_width: int) -> int:
    """The slot positions a pass planned with ``positions`` runs with at row
    width ``R``: no more than a warp holds beside the lanes of one slot."""
    return min(positions, 32 // lanes_per_slot(row_width))


def _positions(lengths: np.ndarray) -> int:
    """Slot positions for chunks of these lengths: enough that nine chunks in
    ten take one loop step of UNROLL slots a position, at most MAX_POSITIONS."""
    q = int(np.percentile(lengths, 90, method="higher"))
    p = 1
    while p < MAX_POSITIONS and p * UNROLL < q:
        p *= 2
    return p


def chunk_length(positions: int, num_slots: int) -> int:
    """Most slots in one chunk of a first pass over ``num_slots`` slots."""
    steps = MIN_STEPS
    while steps < MAX_STEPS and steps * ROUND_SLOTS < num_slots:
        steps *= 2
    return positions * UNROLL * steps


def plan_combine(brow: torch.Tensor, device) -> CombinePlan:
    """Fix the order in which slots with block rows ``brow`` are summed."""
    rows = brow.reshape(-1).cpu().numpy().astype(np.int64)  # cblint: disable=CB211 -- plan time
    n = len(rows)
    if n >= 2**31 - 1024:
        raise errors.InvalidArgError("combine indexes slots with int32")

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    if n == 0:
        return CombinePlan(num_slots=0, chunk=0, passes=[], num_scratch=0)
    perm = np.argsort(rows, kind="stable")
    srt = rows[perm]
    run_start = np.flatnonzero(np.r_[True, srt[1:] != srt[:-1]])
    run_len = np.diff(np.r_[run_start, n])
    run_row = srt[run_start]
    positions = _positions(run_len)
    chunk = chunk_length(positions, n)
    nch = -(-run_len // chunk)
    run_of = np.repeat(np.arange(len(run_len)), nch)
    within = np.arange(len(run_of)) - np.repeat(np.cumsum(nch) - nch, nch)
    lo = run_start[run_of] + within * chunk
    hi = np.minimum(lo + chunk, run_start[run_of] + run_len[run_of])
    long_ = nch[run_of] > 1
    dst = np.where(long_, -np.cumsum(long_), run_row[run_of])     # scratch row k: -1 - k
    order = np.argsort(lo - hi, kind="stable")      # longest first: the tail is short chunks
    passes = [CombinePass(perm=dev(perm), bounds=dev(np.stack([lo, hi], 1)[order]),
                          dst=dev(dst[order]), positions=positions, nchunks=len(order))]
    num_scratch = int(long_.sum())
    if num_scratch:
        counts = nch[nch > 1]
        start = np.cumsum(counts) - counts
        order = np.argsort(-counts, kind="stable")
        passes.append(CombinePass(
            perm=None, bounds=dev(np.stack([start, start + counts], 1)[order]),
            dst=dev(run_row[nch > 1][order]), positions=MAX_POSITIONS,
            nchunks=len(counts)))
    return CombinePlan(num_slots=n, chunk=chunk, passes=passes, num_scratch=num_scratch)


def combine_plain(y: torch.Tensor, parts: torch.Tensor, brow: torch.Tensor,
                  row_width: int) -> torch.Tensor:
    """Plain PyTorch version: ``y[brow[t]*R + b] += parts[t, b]`` in place.

    ``y`` is flat float32; elements of the ragged last block row past its
    end are dropped.
    """
    R = row_width
    mb = -(-y.shape[0] // R)
    y2d = torch.zeros((mb, R), dtype=torch.float32, device=y.device)
    y2d.index_add_(0, brow.reshape(-1).long(), parts.reshape(-1, R))
    return y.add_(y2d.reshape(-1)[: y.shape[0]])


def segment_combine(y: torch.Tensor, parts: torch.Tensor, brow: torch.Tensor,
                    row_width: int, plan: CombinePlan | None = None) -> torch.Tensor:
    """Add per-slot partials into ``y`` in place and return it.

    ``y`` flat float32 (``(m,)``, or ``(m*N,)`` for SpMM), ``parts``
    ``(T, R)`` float32, ``brow`` ``(T,)`` int32, ``R = row_width``. On CUDA,
    ``plan`` (from ``plan_combine(brow, device)``) fixes the order; leave it
    out to have it computed here (a host-side sort — callers that combine
    repeatedly keep the plan).
    ``segment_combine.launches`` counts kernel launches, one per pass.
    """
    R = int(row_width)
    dev = y.device
    _build.require(y, "y", dtype=torch.float32)
    T = brow.numel()
    _build.require(parts, "parts", dtype=torch.float32, shape=(T, R), device=dev)
    if T == 0 or R == 0:
        return y
    if dev.type != "cuda":
        return combine_plain(y, parts, brow, R)
    if R >= 2**31:
        raise errors.InvalidArgError(f"combine row width {R} does not fit the kernel's int")
    if plan is None:
        plan = plan_combine(brow, dev)
    if plan.num_slots != T:
        raise errors.InvalidArgError(
            f"combine plan was made for {plan.num_slots} slots, got {T}")
    lib = _build.library()
    scratch = (torch.empty((plan.num_scratch, R), dtype=torch.float32, device=dev)
               if plan.num_scratch else None)
    src = parts
    with _build.launch_on(dev) as stream:
        for p in plan.passes:
            code = lib.cb_segment_sum(
                src.data_ptr(), None if p.perm is None else p.perm.data_ptr(),
                p.bounds.data_ptr(), p.dst.data_ptr(), y.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                p.nchunks, R, y.shape[0], launch_positions(p.positions, R), stream)
            _build.check(code, "cb_segment_sum")
            segment_combine.launches += 1
            src = scratch
    return y


segment_combine.launches = 0
