"""Byte-access streams of the flat baselines (CSR, BSR, TileSpMV-style).

A numpy copy of the three generators the JAX repo keeps in its benchmark
code (``benchmarks/formats.py``: ``access_stream_csr`` / ``_bsr`` /
``_tile`` with ``to_csr``, ``to_bsr`` and ``_lines``), for
``scripts/explain_torch.py``'s locality table. The same arrays, line for
line; the per-block Python loops are vectorised. Private: nothing here is
exported by ``repro_torch.obs``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import partition_coo
from repro_torch.core.streams import build_tile_stream

LINE = 128  # bytes per cache line


def _lines(base: int, offsets_bytes: np.ndarray) -> np.ndarray:
    return (base + offsets_bytes) // LINE


def to_csr(rows, cols, vals, shape):
    m, n = shape
    order = np.lexsort((cols, rows))
    r, c, v = rows[order], cols[order], vals[order]
    row_ptr = np.zeros(m + 1, np.int64)
    np.add.at(row_ptr, r + 1, 1)
    row_ptr = np.cumsum(row_ptr)
    return row_ptr.astype(np.int32), c.astype(np.int32), v


def to_bsr(rows, cols, vals, shape, B=16):
    """Dense B x B blocks incl. zeros (the BSR storage the paper critiques)."""
    return build_tile_stream(rows, cols, vals, shape, B)


def access_stream_csr(rows, cols, vals, shape, vbytes=8):
    """Interleaved (col_idx[j], val[j], x[col]) accesses, row-major —
    the paper's Fig. 1 traversal. Arrays live in separate regions."""
    m, n = shape
    row_ptr, c, v = to_csr(rows, cols, vals, shape)
    nnz = len(c)
    base_col = 0
    base_val = base_col + nnz * 4
    base_x = base_val + nnz * vbytes
    j = np.arange(nnz)
    tri = np.empty(3 * nnz, np.int64)
    tri[0::3] = _lines(base_col, j * 4)
    tri[1::3] = _lines(base_val, j * vbytes)
    tri[2::3] = _lines(base_x, c.astype(np.int64) * vbytes)
    return tri, base_x + n * vbytes


def access_stream_bsr(rows, cols, vals, shape, B=16, vbytes=8):
    """Block-dense traversal: all B*B values of every non-zero block, then
    the block's B x entries."""
    stream = to_bsr(rows, cols, vals, shape, B)
    bcol = stream.bcol.numpy().astype(np.int64)
    nblk = len(bcol)
    base_val = 0
    base_x = nblk * B * B * vbytes
    elem = np.arange(B * B, dtype=np.int64)
    xcol = np.arange(B, dtype=np.int64)
    val_lines = _lines(base_val, (np.arange(nblk, dtype=np.int64)[:, None] * B * B
                                  + elem) * vbytes)
    x_lines = _lines(base_x, (bcol[:, None] * B + xcol) * vbytes)
    out = np.concatenate([val_lines, x_lines], axis=1).reshape(-1)
    return out, base_x + shape[1] * vbytes


def access_stream_tile(rows, cols, vals, shape, B=16, vbytes=8):
    """TileSpMV-style: per-block compressed storage but coordinates and
    values in SEPARATE arrays (the locality gap CB closes). Per block: its
    (coordinate, value) pairs interleaved, then its x entries."""
    part = partition_coo(rows, cols, vals, shape, B)
    nnz = part.nnz
    base_idx = 0
    base_val = nnz * 1            # packed uint8 coords
    base_x = base_val + nnz * vbytes
    counts = np.diff(part.blk_ptr).astype(np.int64)
    start = part.blk_ptr[:-1].astype(np.int64)
    j = np.arange(nnz, dtype=np.int64)
    blk = np.repeat(np.arange(part.num_blocks), counts)
    k = j - start[blk]                              # position within its block
    out = np.empty(3 * nnz, np.int64)
    out[3 * start[blk] + 2 * k] = _lines(base_idx, j)
    out[3 * start[blk] + 2 * k + 1] = _lines(base_val, j * vbytes)
    lc = part.local_cols.astype(np.int64)
    out[3 * start[blk] + 2 * counts[blk] + k] = _lines(
        base_x, (part.blk_col_idx[blk].astype(np.int64) * B + lc) * vbytes)
    return out, base_x + shape[1] * vbytes
