"""Per-sub-block storage-format selection (paper §3.3.2).

The paper fixes a 16x16 block and thresholds th1=32, th2=128:
    nnz <  th1  -> COO     (super-sparse; warp-level atomics path on GPU)
    th1 <= nnz <= th2 -> CSR (intermediate)
    nnz >  th2  -> Dense   (MXU/Tensor-core friendly)

We keep those exact numbers for B=16 and scale them with block area for
other block sizes (the thresholds are density thresholds in disguise:
32/256 = 12.5%, 128/256 = 50%).

th0 (paper §3.3.1) gates *matrix-level* column aggregation: it is applied
iff the fraction of super-sparse sub-blocks (nnz < 2*B) is >= th0 = 0.15.
"""
from __future__ import annotations

import dataclasses

import numpy as np
from repro_torch import errors

# Format codes stored in ``type_per_blk`` (uint8).
FMT_COO = 0
FMT_CSR = 1
FMT_DENSE = 2

FMT_NAMES = {FMT_COO: "coo", FMT_CSR: "csr", FMT_DENSE: "dense"}


@dataclasses.dataclass(frozen=True)
class FormatThresholds:
    """Thresholds controlling CB-SpMV's computational adaptation."""

    th0: float = 0.15   # matrix-level column-aggregation gate
    th1: int | None = None  # COO/CSR boundary (defaults to B*B/8, =32 at B=16)
    th2: int | None = None  # CSR/Dense boundary (defaults to B*B/2, =128 at B=16)

    def resolve(self, block_size: int) -> tuple[int, int]:
        area = block_size * block_size
        th1 = self.th1 if self.th1 is not None else max(1, area // 8)
        th2 = self.th2 if self.th2 is not None else max(th1, area // 2)
        if th1 < 1:
            raise errors.InvalidArgError(
                f"th1 must be >= 1 (a block always holds at least one "
                f"element), got th1={th1} for B={block_size}"
            )
        if th2 < th1:
            raise errors.InvalidArgError(
                f"th2 must be >= th1 (the CSR band cannot be negative), "
                f"got th1={th1} > th2={th2} for B={block_size}"
            )
        if th2 > area:
            raise errors.InvalidArgError(
                f"th2 must be <= B*B={area} (no block holds more than its "
                f"area), got th2={th2} for B={block_size}"
            )
        return th1, th2


DEFAULT_THRESHOLDS = FormatThresholds()


def super_sparse_threshold(block_size: int) -> int:
    """nnz below which a block is 'super-sparse' (paper: 32 for B=16)."""
    return 2 * block_size


def super_sparse_fraction(nnz_per_blk: np.ndarray, block_size: int) -> float:
    """Fraction of non-zero sub-blocks that are super-sparse (Fig. 3)."""
    if len(nnz_per_blk) == 0:
        return 0.0
    return float(np.mean(nnz_per_blk < super_sparse_threshold(block_size)))


def should_column_aggregate(
    nnz_per_blk: np.ndarray, block_size: int, thresholds: FormatThresholds = DEFAULT_THRESHOLDS
) -> bool:
    """Matrix-level column-aggregation decision (paper §3.3.1, th0)."""
    return super_sparse_fraction(nnz_per_blk, block_size) >= thresholds.th0


def coerce_thresholds(thresholds) -> FormatThresholds:
    """Accept a ``FormatThresholds`` or anything carrying one (a ``Plan``).

    The autotune subsystem's ``Plan`` exposes its chosen thresholds as a
    ``.thresholds`` property; selectors take either the bare record or the
    plan so callers never unwrap by hand.
    """
    if isinstance(thresholds, FormatThresholds):
        return thresholds
    inner = getattr(thresholds, "thresholds", None)
    if isinstance(inner, FormatThresholds):
        return inner
    raise TypeError(
        f"expected FormatThresholds or a Plan carrying one, "
        f"got {type(thresholds).__name__}"
    )


def select_formats(
    nnz_per_blk: np.ndarray,
    block_size: int,
    thresholds: FormatThresholds = DEFAULT_THRESHOLDS,
) -> np.ndarray:
    """Vectorized per-block format selection. Returns uint8 codes.

    ``thresholds`` may be a ``FormatThresholds`` or an autotune ``Plan``
    (anything with a ``.thresholds`` property) — see ``coerce_thresholds``.
    """
    th1, th2 = coerce_thresholds(thresholds).resolve(block_size)
    nnz = np.asarray(nnz_per_blk)
    fmt = np.full(nnz.shape, FMT_CSR, dtype=np.uint8)
    fmt[nnz < th1] = FMT_COO
    fmt[nnz > th2] = FMT_DENSE
    return fmt
