"""Plain PyTorch oracles for the CB-SpMV and CB-SpMM kernels (stream-level contracts).

Each function mirrors a kernel's input contract so tests can sweep
shapes/dtypes and compare kernel against oracle. They are also the
``impl="reference"`` path of ``ops.cb_spmv`` — an independent oracle that
consumes the stream layout as given. Accumulation follows ``_acc_dtype``:
the payload's and x's promoted type, at least float32 (float64 payloads
accumulate in float64 here, whereas the kernels always emit float32).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.aggregation import coord_bits
from repro_torch.core.streams import (
    SUBLANE, SpMVStreams, SuperBlockStreams, SuperTileStream, TileStream,
)


def _acc_dtype(*dts: torch.dtype) -> torch.dtype:
    return functools.reduce(torch.promote_types, dts, torch.float32)


def _scatter_rows(part: torch.Tensor, brow: torch.Tensor, mb: int) -> torch.Tensor:
    """zeros((mb, B)).index_add(brow, part) — the additive combine."""
    out = torch.zeros((mb, part.shape[-1]), dtype=part.dtype, device=part.device)
    return out.index_add_(0, brow.reshape(-1).long(), part.reshape(-1, part.shape[-1]))


def _gather(x: torch.Tensor, xidx: torch.Tensor) -> torch.Tensor:
    return x[xidx.long()]


# ---------------------------------------------------------------------------
# SpMV stream oracles
# ---------------------------------------------------------------------------

def block_dense_spmv(tiles: torch.Tensor, brow: torch.Tensor, xg: torch.Tensor,
                     mb: int) -> torch.Tensor:
    """y_blocks = scatter_add_i( tiles[i] @ xg[i] ) — (mb, B)."""
    acc = _acc_dtype(tiles.dtype, xg.dtype)
    part = torch.einsum("brc,bc->br", tiles.to(acc), xg.to(acc))
    return _scatter_rows(part, brow, mb)


def panel_spmv(panels: torch.Tensor, brow: torch.Tensor, xg: torch.Tensor,
               mb: int) -> torch.Tensor:
    """Column-compacted micro-panel SpMV: panels (np, B, K), xg (np, K)."""
    acc = _acc_dtype(panels.dtype, xg.dtype)
    part = torch.einsum("brk,bk->br", panels.to(acc), xg.to(acc))
    return _scatter_rows(part, brow, mb)


def _coo_partials(codes, vals, xg, block_size: int, acc: torch.dtype):
    """(..., E) element lists -> (..., B) block-local row sums.

    Decode ``row = code & ((1 << bits) - 1)`` (Alg. 3's ``& 15``
    generalized — a full bit mask, since ``B - 1`` has holes for
    non-power-of-two B) and add each product into its row.
    """
    rows = codes & ((1 << coord_bits(block_size)) - 1)
    prod = vals.to(acc) * xg.to(acc)
    onehot = rows[..., None] == torch.arange(
        block_size, dtype=codes.dtype, device=codes.device)
    return torch.einsum("...e,...er->...r", prod, onehot.to(acc))


def coo_spmv(codes: torch.Tensor, vals: torch.Tensor, brow: torch.Tensor,
             xg: torch.Tensor, mb: int, block_size: int) -> torch.Tensor:
    """Element-list SpMV with the paper's packed coords (Alg. 3 semantics).

    codes/vals/xg: (nc, E); padding has vals == 0.
    """
    acc = _acc_dtype(vals.dtype, xg.dtype)
    return _scatter_rows(_coo_partials(codes, vals, xg, block_size, acc), brow, mb)


def cb_spmv(streams: SpMVStreams, x: torch.Tensor) -> torch.Tensor:
    """Full CB-SpMV over the three flat streams — the ops.py contract oracle."""
    acc = _acc_dtype(streams.dense_tiles.dtype, x.dtype)
    mb, B = streams.mb, streams.block_size
    y = torch.zeros((mb, B), dtype=acc, device=x.device)
    if streams.num_dense:
        y += block_dense_spmv(streams.dense_tiles, streams.dense_brow,
                              _gather(x, streams.dense_xidx), mb)
    if streams.num_panel:
        y += panel_spmv(streams.panel_vals, streams.panel_brow,
                        _gather(x, streams.panel_xidx), mb)
    if streams.num_coo:
        y += coo_spmv(streams.coo_codes, streams.coo_vals, streams.coo_brow,
                      _gather(x, streams.coo_xidx), mb, B)
    return y.reshape(-1)[: streams.m]


# ---------------------------------------------------------------------------
# Super-block (batched) stream oracle
# ---------------------------------------------------------------------------

def super_spmv(s: SuperBlockStreams, x: torch.Tensor) -> torch.Tensor:
    """CB-SpMV over packed super-block streams — the batched ops contract.

    Slot routing is positional (slot = lane // SUBLANE), so splitting a
    fused payload into per-slot partials is a strided reshape-sum. Empty
    slots carry zero payload and brow 0, so they add exact zeros.
    """
    B, mb = s.block_size, s.mb
    acc = _acc_dtype(s.panel_vals.dtype, x.dtype)
    parts, brows = [], []
    if s.num_dense_groups:
        gd, Gd = s.dense_brow.shape
        tiles = s.dense_tiles.reshape(gd, Gd, B, B).to(acc)
        xg = _gather(x, s.dense_xidx).to(acc)                  # (gd, Gd, B)
        parts.append(torch.einsum("gsrc,gsc->gsr", tiles, xg).reshape(-1, B))
        brows.append(s.dense_brow.reshape(-1))
    if s.num_panel_groups:
        gp, W = s.panel_xidx.shape
        S = W // SUBLANE
        xg = _gather(x, s.panel_xidx).to(acc).reshape(gp, S, SUBLANE)
        vals = s.panel_vals.to(acc).reshape(gp, B, S, SUBLANE)
        parts.append(torch.einsum("grsk,gsk->gsr", vals, xg).reshape(-1, B))
        brows.append(s.panel_brow.reshape(-1))
    if s.num_coo_groups:
        gc, W = s.coo_codes.shape
        S = W // SUBLANE
        part = _coo_partials(
            s.coo_codes.reshape(gc, S, SUBLANE),
            s.coo_vals.reshape(gc, S, SUBLANE),
            _gather(x, s.coo_xidx).reshape(gc, S, SUBLANE), B, acc)
        parts.append(part.reshape(-1, B))
        brows.append(s.coo_brow.reshape(-1))
    if not parts:
        return torch.zeros(s.m, dtype=acc, device=x.device)
    y = _scatter_rows(torch.cat(parts), torch.cat(brows), mb)
    return y.reshape(-1)[: s.m]


# ---------------------------------------------------------------------------
# SpMM tile-stream oracles
# ---------------------------------------------------------------------------

def _x_blocks(X: torch.Tensor, nb: int, block_size: int, acc: torch.dtype) -> torch.Tensor:
    """X (n, N) zero-padded to ``nb*B`` rows, as (nb, B, N) in ``acc``."""
    Xp = torch.zeros((nb * block_size, X.shape[1]), dtype=acc, device=X.device)
    Xp[: X.shape[0]] = X.to(acc)
    return Xp.view(nb, block_size, X.shape[1])


def _spmm_rows(part: torch.Tensor, brow: torch.Tensor, mb: int, m: int) -> torch.Tensor:
    """Scatter-add per-tile (B, N) partials into block rows; cut to m rows."""
    T, B, N = part.shape
    Y = torch.zeros((mb, B, N), dtype=part.dtype, device=part.device)
    Y.index_add_(0, brow.reshape(-1).long(), part)
    return Y.reshape(mb * B, N)[:m]


def cb_spmm(stream: TileStream, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X with A as a block-dense tile stream; X is (n, N)."""
    acc = _acc_dtype(stream.tiles.dtype, X.dtype)
    Xb = _x_blocks(X, stream.nb, stream.block_size, acc)
    part = torch.einsum("trc,tcn->trn", stream.tiles.to(acc), Xb[stream.bcol.long()])
    return _spmm_rows(part, stream.brow, stream.mb, stream.m)


def super_spmm(s: SuperTileStream, X: torch.Tensor) -> torch.Tensor:
    """CB-SpMM over packed super-tile groups — the batched ops contract.

    Each group slot is an independent (B, B) @ (B, N) product routed by
    the ``brow``/``bcol`` slot maps; empty slots hold zero tiles, so they
    add exact zeros. ``cb_spmm`` above stays the unbatched oracle.
    """
    B = s.block_size
    acc = _acc_dtype(s.tiles.dtype, X.dtype)
    Xb = _x_blocks(X, s.nb, B, acc)
    tiles = s.tiles.reshape(-1, B, B).to(acc)
    part = torch.einsum("trc,tcn->trn", tiles, Xb[s.bcol.reshape(-1).long()])
    return _spmm_rows(part, s.brow, s.mb, s.m)


def cb_spmm_dense_equiv(stream: TileStream) -> torch.Tensor:
    """Densify the tile stream (m, n) in its payload dtype (test utility)."""
    B = stream.block_size
    flat = torch.zeros((stream.mb * stream.nb, B, B), dtype=stream.tiles.dtype,
                       device=stream.tiles.device)
    flat.index_add_(0, (stream.brow.long() * stream.nb + stream.bcol.long()), stream.tiles)
    return flat.reshape(stream.mb, stream.nb, B, B).permute(0, 2, 1, 3).reshape(
        stream.mb * B, stream.nb * B)[: stream.m, : stream.n]
