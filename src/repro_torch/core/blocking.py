"""2D blocking structure (paper §3.1).

Partitions a COO matrix into uniform B x B sub-blocks and produces the
high-level block-COO metadata (blk_row_idx, blk_col_idx, nnz_per_blk) plus
per-block element slices with *block-local* coordinates.

The key property the paper exploits — and we preserve — is that after
partitioning, every sub-block is self-contained: its coordinates are
relative to the sub-block, so blocks can be stored, permuted and scheduled
independently.
"""
from __future__ import annotations

import dataclasses

import numpy as np
from repro_torch import errors


@dataclasses.dataclass
class BlockPartition:
    """Result of 2D blocking. Elements are sorted block-major.

    ``elem_*`` arrays are parallel arrays of length nnz holding every
    non-zero in block-major order (block i owns the slice
    ``blk_ptr[i]:blk_ptr[i+1]``). ``local_rows/local_cols`` are coordinates
    relative to the owning block (in ``[0, B)``).
    """

    shape: tuple[int, int]
    block_size: int
    blk_row_idx: np.ndarray   # (nblk,) int32
    blk_col_idx: np.ndarray   # (nblk,) int32
    nnz_per_blk: np.ndarray   # (nblk,) int32
    blk_ptr: np.ndarray       # (nblk+1,) int64, element offsets
    local_rows: np.ndarray    # (nnz,) int32
    local_cols: np.ndarray    # (nnz,) int32
    values: np.ndarray        # (nnz,) val dtype

    @property
    def num_blocks(self) -> int:
        return len(self.blk_row_idx)

    @property
    def nnz(self) -> int:
        return len(self.values)

    def block_elems(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        s, e = self.blk_ptr[i], self.blk_ptr[i + 1]
        return self.local_rows[s:e], self.local_cols[s:e], self.values[s:e]


def partition_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: tuple[int, int],
    block_size: int,
) -> BlockPartition:
    """Partition COO triplets into B x B sub-blocks (block-major order).

    Duplicate coordinates are summed (standard COO semantics), so the
    partition is a faithful linear-algebra representation of the input.
    """
    m, n = shape
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    if rows.size:
        if rows.min() < 0 or rows.max() >= m or cols.min() < 0 or cols.max() >= n:
            raise errors.InvalidArgError("coordinate out of bounds")

    B = int(block_size)
    nbc = -(-n // B)  # ceil
    brow = rows // B
    bcol = cols // B
    # Sort elements by (block key, row, col) so intra-block order is
    # row-major — required for CSR packing and deterministic accumulation.
    key = (brow * nbc + bcol) * (B * B) + (rows % B) * B + (cols % B)
    order = np.argsort(key, kind="stable")
    key = key[order]
    rows, cols, vals = rows[order], cols[order], vals[order]
    brow, bcol = brow[order], bcol[order]

    # Merge duplicates.
    full_key = key  # key already encodes exact (block, r, c)
    if len(full_key):
        uniq_mask = np.empty(len(full_key), dtype=bool)
        uniq_mask[0] = True
        np.not_equal(full_key[1:], full_key[:-1], out=uniq_mask[1:])
        if not uniq_mask.all():
            seg_ids = np.cumsum(uniq_mask) - 1
            summed = np.zeros(seg_ids[-1] + 1, dtype=vals.dtype)
            np.add.at(summed, seg_ids, vals)
            rows, cols, brow, bcol = (a[uniq_mask] for a in (rows, cols, brow, bcol))
            vals = summed
            key = key[uniq_mask]

    blk_key = brow * nbc + bcol
    if len(blk_key):
        blk_start = np.flatnonzero(np.r_[True, blk_key[1:] != blk_key[:-1]])
        blk_ptr = np.r_[blk_start, len(blk_key)].astype(np.int64)
        blk_row_idx = (blk_key[blk_start] // nbc).astype(np.int32)
        blk_col_idx = (blk_key[blk_start] % nbc).astype(np.int32)
        nnz_per_blk = np.diff(blk_ptr).astype(np.int32)
    else:
        blk_ptr = np.zeros(1, dtype=np.int64)
        blk_row_idx = np.zeros(0, dtype=np.int32)
        blk_col_idx = np.zeros(0, dtype=np.int32)
        nnz_per_blk = np.zeros(0, dtype=np.int32)

    return BlockPartition(
        shape=(m, n),
        block_size=B,
        blk_row_idx=blk_row_idx,
        blk_col_idx=blk_col_idx,
        nnz_per_blk=nnz_per_blk,
        blk_ptr=blk_ptr,
        local_rows=(rows % B).astype(np.int32),
        local_cols=(cols % B).astype(np.int32),
        values=vals,
    )


def block_nnz_histogram(nnz_per_blk: np.ndarray, block_size: int, bins: int = 8) -> np.ndarray:
    """Fig. 3(a): histogram of block nnz over `bins` equal ranges of [1, B*B]."""
    area = block_size * block_size
    edges = np.linspace(0, area, bins + 1)
    edges[0] = 0.5  # blocks have >= 1 nnz
    hist, _ = np.histogram(nnz_per_blk, bins=edges)
    return hist
