"""Intra-block data aggregation (paper §3.2, Fig. 7).

All of a sub-block's data — packed coordinates and values, of different
dtypes — is serialized into ONE contiguous byte region of a single flat
uint8 buffer (``mtx_data`` in the paper). A *virtual pointer* per block
(``vp_per_blk``) records the region's start offset; on-device access is by
pointer offset only, so a block is fetched with one sequential read.

Faithful details preserved from the paper:
  * 16x16 coordinates pack into a single uint8: ``byte = col << 4 | row``
    (Alg. 3 decodes ``row = b & 15; col = b >> 4``). Larger blocks use a
    uint16 with the same ``col << bits | row`` layout.
  * Alignment padding between the coordinate section and the value section:
    ``padding = (-idx_bytes) % sizeof(val)`` (Alg. 3 lines 6-7), plus each
    block region starts on a ``sizeof(val)``-aligned boundary so that the
    value pointer arithmetic is alignment-safe (Fig. 7(b)).
  * COO / CSR / Dense intra-block layouts, selected per block.

``pack_block`` / ``unpack_block`` define the byte layout one block at a
time. ``aggregate_partition`` / ``unpack_format`` write and read the same
bytes for every block at once with array operations, so a matrix with
millions of blocks is packed without a Python loop over its blocks.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .formats import FMT_COO, FMT_CSR, FMT_DENSE
from repro_torch import errors


def coord_bits(block_size: int) -> int:
    return max(1, (block_size - 1).bit_length())


def coord_dtype(block_size: int) -> np.dtype:
    """uint8 when row+col nibbles fit (B<=16), else uint16 (B<=256)."""
    bits = coord_bits(block_size)
    if 2 * bits <= 8:
        return np.dtype(np.uint8)
    if 2 * bits <= 16:
        return np.dtype(np.uint16)
    raise errors.InvalidArgError(f"block_size {block_size} too large for packed coordinates")


def encode_coords(local_rows: np.ndarray, local_cols: np.ndarray, block_size: int) -> np.ndarray:
    bits = coord_bits(block_size)
    dt = coord_dtype(block_size)
    packed = (local_cols.astype(np.uint32) << bits) | local_rows.astype(np.uint32)
    return packed.astype(dt)


def decode_coords(packed: np.ndarray, block_size: int) -> tuple[np.ndarray, np.ndarray]:
    bits = coord_bits(block_size)
    mask = (1 << bits) - 1
    p = packed.astype(np.uint32)
    return (p & mask).astype(np.int32), (p >> bits).astype(np.int32)


def _align(offset: int, alignment: int) -> int:
    return offset + (-offset) % alignment


def _csr_rowptr_dtype(block_size: int) -> np.dtype:
    # B*B max nnz: 256 for B=16 needs uint16; 16384 for B=128 also uint16.
    return np.dtype(np.uint16) if block_size * block_size <= 0xFFFF else np.dtype(np.uint32)


def pack_block(
    fmt: int,
    local_rows: np.ndarray,
    local_cols: np.ndarray,
    values: np.ndarray,
    block_size: int,
) -> np.ndarray:
    """Serialize one sub-block into a uint8 byte string (no leading pad)."""
    B = block_size
    val = np.ascontiguousarray(values)
    vsize = val.dtype.itemsize
    if fmt == FMT_DENSE:
        tile = np.zeros((B, B), dtype=val.dtype)
        tile[local_rows, local_cols] = val
        return tile.reshape(-1).view(np.uint8).copy()
    if fmt == FMT_COO:
        idx = encode_coords(local_rows, local_cols, B)
        idx_bytes = idx.view(np.uint8)
        pad = (-len(idx_bytes)) % vsize
        return np.concatenate(
            [idx_bytes, np.zeros(pad, np.uint8), val.view(np.uint8)]
        )
    if fmt == FMT_CSR:
        # Elements arrive row-major (blocking.partition_coo guarantees it).
        rp_dt = _csr_rowptr_dtype(B)
        row_ptr = np.zeros(B + 1, dtype=np.int64)
        np.add.at(row_ptr, local_rows.astype(np.int64) + 1, 1)
        row_ptr = np.cumsum(row_ptr).astype(rp_dt)
        cols = local_cols.astype(coord_dtype(B))
        head = np.concatenate([row_ptr.view(np.uint8), cols.view(np.uint8)])
        pad = (-len(head)) % vsize
        return np.concatenate([head, np.zeros(pad, np.uint8), val.view(np.uint8)])
    raise errors.InvalidArgError(f"unknown format {fmt}")


def unpack_block(
    buf: np.ndarray,
    vp: int,
    fmt: int,
    nnz: int,
    block_size: int,
    val_dtype: np.dtype,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Inverse of pack_block: returns (local_rows, local_cols, values)."""
    B = block_size
    vsize = np.dtype(val_dtype).itemsize
    if fmt == FMT_DENSE:
        nbytes = B * B * vsize
        tile = buf[vp : vp + nbytes].view(val_dtype).reshape(B, B)
        r, c = np.nonzero(tile)
        return r.astype(np.int32), c.astype(np.int32), tile[r, c]
    if fmt == FMT_COO:
        idx_nbytes = nnz * coord_dtype(B).itemsize
        idx = buf[vp : vp + idx_nbytes].view(coord_dtype(B))
        pad = (-idx_nbytes) % vsize
        voff = vp + idx_nbytes + pad
        vals = buf[voff : voff + nnz * vsize].view(val_dtype)
        r, c = decode_coords(idx, B)
        return r, c, vals
    if fmt == FMT_CSR:
        rp_dt = _csr_rowptr_dtype(B)
        rp_nbytes = (B + 1) * rp_dt.itemsize
        row_ptr = buf[vp : vp + rp_nbytes].view(rp_dt).astype(np.int64)
        cdt = coord_dtype(B)
        coff = vp + rp_nbytes
        cols = buf[coff : coff + nnz * cdt.itemsize].view(cdt).astype(np.int32)
        head = rp_nbytes + nnz * cdt.itemsize
        pad = (-head) % vsize
        voff = vp + head + pad
        vals = buf[voff : voff + nnz * vsize].view(val_dtype)
        rows = np.repeat(np.arange(B, dtype=np.int32), np.diff(row_ptr))
        return rows, cols, vals
    raise errors.InvalidArgError(f"unknown format {fmt}")


@dataclasses.dataclass
class PackedBlocks:
    """The aggregated single-buffer representation (``mtx_data`` + VPs)."""

    packed: np.ndarray        # (total_bytes,) uint8
    vp_per_blk: np.ndarray    # (nblk,) int64 byte offsets
    nbytes_per_blk: np.ndarray  # (nblk,) int64


def aggregate_blocks(
    fmts: np.ndarray,
    block_elems: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
    block_size: int,
    val_dtype: np.dtype,
    alignment: int | None = None,
) -> PackedBlocks:
    """Pack every block back-to-back into one flat uint8 buffer.

    Each block's region starts on an ``alignment``-aligned boundary
    (default: value dtype size, min 4) — the Fig. 7(b) padding strategy.
    """
    vsize = np.dtype(val_dtype).itemsize
    align = alignment or max(vsize, 4)
    chunks: list[np.ndarray] = []
    vps = np.zeros(len(block_elems), dtype=np.int64)
    sizes = np.zeros(len(block_elems), dtype=np.int64)
    off = 0
    for i, (r, c, v) in enumerate(block_elems):
        blob = pack_block(int(fmts[i]), r, c, v.astype(val_dtype), block_size)
        start = _align(off, align)
        if start != off:
            chunks.append(np.zeros(start - off, np.uint8))
        vps[i] = start
        sizes[i] = len(blob)
        chunks.append(blob)
        off = start + len(blob)
    packed = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
    return PackedBlocks(packed=packed, vp_per_blk=vps, nbytes_per_blk=sizes)


# ---------------------------------------------------------------------------
# Whole-matrix packing and unpacking (no per-block Python loop).
# ---------------------------------------------------------------------------

def _section_sizes(fmts: np.ndarray, nnz: np.ndarray, block_size: int,
                   vsize: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-block (bytes before the value section, value-section bytes).

    The first number already includes Alg. 3's alignment padding.
    """
    B = block_size
    csz = coord_dtype(B).itemsize
    rp_nbytes = (B + 1) * _csr_rowptr_dtype(B).itemsize
    nnz = nnz.astype(np.int64)
    head = np.where(fmts == FMT_DENSE, 0,
                    np.where(fmts == FMT_COO, nnz * csz, rp_nbytes + nnz * csz))
    head = head + (-head) % vsize
    body = np.where(fmts == FMT_DENSE, B * B * vsize, nnz * vsize)
    return head, body


def typed_view(buf: np.ndarray, dtype) -> np.ndarray:
    """View the byte buffer as ``dtype`` (copying only a ragged tail)."""
    dtype = np.dtype(dtype)
    tail = (-len(buf)) % dtype.itemsize
    if tail:
        buf = np.concatenate([buf, np.zeros(tail, np.uint8)])
    return np.ascontiguousarray(buf).view(dtype)


def aggregate_partition(fmts: np.ndarray, part, val_dtype) -> PackedBlocks:
    """``aggregate_blocks`` over a whole ``BlockPartition`` at once.

    Emits byte for byte what packing block after block with
    ``pack_block`` at the default alignment emits. Every section of every
    block starts on a multiple of its own item size (regions start on
    ``max(sizeof(val), 4)``, the value section is padded to
    ``sizeof(val)``), so each section is one scatter through a typed
    view of the buffer.
    """
    B = part.block_size
    val_dtype = np.dtype(val_dtype)
    vsize = val_dtype.itemsize
    align = max(vsize, 4)
    cdt, rp_dt = coord_dtype(B), _csr_rowptr_dtype(B)
    fmts = np.asarray(fmts)
    nblk = len(fmts)
    nnz = np.diff(part.blk_ptr)
    head, body = _section_sizes(fmts, nnz, B, vsize)
    sizes = head + body
    vps = np.zeros(nblk, np.int64)
    if nblk:
        np.cumsum((sizes + (-sizes) % align)[:-1], out=vps[1:])
    total = int(vps[-1] + sizes[-1]) if nblk else 0
    buf = np.zeros(total + (-total) % 8, np.uint8)

    blk = np.repeat(np.arange(nblk), nnz)                # owning block
    k = np.arange(part.nnz, dtype=np.int64) - part.blk_ptr[blk]
    r = part.local_rows.astype(np.int64)
    c = part.local_cols.astype(np.int64)
    fmt_e = fmts[blk]

    # values: the (B, B) tile cell for dense blocks, element k otherwise
    vpos = vps[blk] + head[blk] + np.where(fmt_e == FMT_DENSE, r * B + c, k) * vsize
    buf.view(val_dtype)[vpos // vsize] = part.values.astype(val_dtype, copy=False)

    # packed coordinates of COO blocks, column indices of CSR blocks
    csz = cdt.itemsize
    rp_nbytes = (B + 1) * rp_dt.itemsize
    coo = fmt_e == FMT_COO
    buf.view(cdt)[(vps[blk[coo]] + k[coo] * csz) // csz] = encode_coords(
        part.local_rows[coo], part.local_cols[coo], B)
    csr = fmt_e == FMT_CSR
    buf.view(cdt)[(vps[blk[csr]] + rp_nbytes + k[csr] * csz) // csz] = (
        part.local_cols[csr].astype(cdt))

    # CSR row pointers: per-block row histogram, prefix-summed
    csr_blocks = np.flatnonzero(fmts == FMT_CSR)
    if len(csr_blocks):
        rank = np.full(nblk, -1, np.int64)
        rank[csr_blocks] = np.arange(len(csr_blocks))
        counts = np.bincount(rank[blk[csr]] * (B + 1) + r[csr] + 1,
                             minlength=len(csr_blocks) * (B + 1))
        row_ptr = np.cumsum(counts.reshape(-1, B + 1), axis=1).astype(rp_dt)
        pos = (vps[csr_blocks] // rp_dt.itemsize)[:, None] + np.arange(B + 1)
        buf.view(rp_dt)[pos] = row_ptr
    return PackedBlocks(packed=buf[:total], vp_per_blk=vps, nbytes_per_blk=sizes)


def unpack_format(
    buf: np.ndarray,
    vps: np.ndarray,
    nnz: np.ndarray,
    fmt: int,
    block_size: int,
    val_dtype,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``unpack_block`` for every block of ONE format at once.

    ``vps`` / ``nnz`` list the blocks (all stored as ``fmt``). Returns
    ``(blk, local_rows, local_cols, values)`` over all their elements,
    ``blk`` indexing into ``vps``; blocks appear in the order given and
    each block's elements in ``unpack_block``'s order. Dense tiles drop
    their zero cells exactly as ``unpack_block`` does.
    """
    B = block_size
    val_dtype = np.dtype(val_dtype)
    vsize = val_dtype.itemsize
    vps = np.asarray(vps, np.int64)
    nnz = np.asarray(nnz, np.int64)
    vals_view = typed_view(buf, val_dtype)
    if fmt == FMT_DENSE:
        tiles = vals_view[(vps // vsize)[:, None] + np.arange(B * B)]
        blk, r, c = np.nonzero(tiles.reshape(-1, B, B))
        return blk, r.astype(np.int32), c.astype(np.int32), tiles.reshape(-1, B, B)[blk, r, c]
    if fmt not in (FMT_COO, FMT_CSR):
        raise errors.InvalidArgError(f"unknown format {fmt}")
    cdt = coord_dtype(B)
    csz = cdt.itemsize
    head, _ = _section_sizes(np.full(len(vps), fmt), nnz, B, vsize)
    blk = np.repeat(np.arange(len(vps)), nnz)
    k = np.arange(int(nnz.sum()), dtype=np.int64) - (np.cumsum(nnz) - nnz)[blk]
    vals = vals_view[(vps[blk] + head[blk]) // vsize + k]
    if fmt == FMT_COO:
        codes = typed_view(buf, cdt)[vps[blk] // csz + k]
        r, c = decode_coords(codes, B)
        return blk, r, c, vals
    rp_dt = _csr_rowptr_dtype(B)
    rp_nbytes = (B + 1) * rp_dt.itemsize
    row_ptr = typed_view(buf, rp_dt)[(vps // rp_dt.itemsize)[:, None] + np.arange(B + 1)]
    cols = typed_view(buf, cdt)[(vps[blk] + rp_nbytes) // csz + k].astype(np.int32)
    rows = np.repeat(np.tile(np.arange(B, dtype=np.int32), len(vps)),
                     np.diff(row_ptr.astype(np.int64), axis=1).reshape(-1))
    return blk, rows, cols, vals
