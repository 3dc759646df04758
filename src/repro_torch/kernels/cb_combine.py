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
slots, and each row's run is cut into chunks of at most ``CHUNK`` slots.
``csrc/cb_combine.cu`` sums every chunk in stored order; the chunk sums
are chunked again until every row is a single chunk, which is added into
y. Rows with thousands of slots (a hub row; block row 0, which collects
the packer's empty slots) are thus summed by many threads and still give
the same bits on every run. The kernel is memory-bound: one read of the
partials, one of the sort permutation, one write of y.

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

CHUNK = 32  # most slots one thread adds up in one level


@dataclasses.dataclass
class CombineLevel:
    perm: torch.Tensor | None   # (n_src,) int32 source row per position; None = identity
    ptr: torch.Tensor           # (nchunks + 1,) int32 chunk boundaries into perm
    rows: torch.Tensor | None   # (nchunks,) int32 block row per chunk; last level only
    nchunks: int


@dataclasses.dataclass
class CombinePlan:
    """The fixed summation order for one stream's slots (device tensors)."""

    num_slots: int
    levels: list[CombineLevel]


def plan_combine(brow: torch.Tensor, device) -> CombinePlan:
    """Fix the order in which slots with block rows ``brow`` are summed."""
    rows = brow.reshape(-1).cpu().numpy().astype(np.int64)
    if len(rows) >= 2**31:
        raise errors.InvalidArgError("combine indexes slots with int32")

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    perm = np.argsort(rows, kind="stable")
    rows = rows[perm]
    levels = []
    while True:
        n = len(rows)
        run_start = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]]) if n else np.zeros(0, np.int64)
        run_len = np.diff(np.r_[run_start, n])
        within = np.arange(n) - np.repeat(run_start, run_len)
        chunk_start = np.flatnonzero(within % CHUNK == 0)
        last = len(chunk_start) == len(run_start)
        rows = rows[chunk_start]
        levels.append(CombineLevel(
            perm=None if perm is None else dev(perm), ptr=dev(np.r_[chunk_start, n]),
            rows=dev(rows) if last else None, nchunks=len(chunk_start)))
        if last:
            return CombinePlan(num_slots=len(brow.reshape(-1)), levels=levels)
        perm = None


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
    ``(T, R)`` float32, ``brow`` ``(T,)`` int32, ``R = row_width``. On CUDA, ``plan`` (from ``plan_combine(brow, device)``) fixes
    the order; leave it out to have it computed here (a host-side sort —
    callers that combine repeatedly keep the plan).
    ``segment_combine.launches`` counts kernel launches, one per level.
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
    src = parts
    for level in plan.levels:
        final = level.rows is not None
        dst = y if final else torch.empty((level.nchunks, R), dtype=torch.float32, device=dev)
        code = lib.cb_segment_sum(
            src.data_ptr(), None if level.perm is None else level.perm.data_ptr(),
            level.ptr.data_ptr(), level.rows.data_ptr() if final else None,
            dst.data_ptr(), level.nchunks, R, y.shape[0], _build.stream_ptr())
        _build.check(code, "cb_segment_sum")
        segment_combine.launches += 1
        src = dst
    return y


segment_combine.launches = 0
