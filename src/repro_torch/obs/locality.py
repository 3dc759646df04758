"""Vectorized locality/traffic profiler for CB access streams.

The paper's headline empirical claim is *cache behaviour* (Fig. 10): the
contiguous one-region-per-block layout touches fewer, denser cache lines
than CSR/BSR/TileSpMV. The JAX package models it as a fully-associative
LRU over the byte-access stream a format generates; this module is its
port, profile for profile, over the port's streams (which may live on
the card: their index metadata is read to the host once per call).

  * :func:`reuse_profile` — an exact, vectorized reuse-distance engine.
    For every access, the LRU *stack distance* (distinct lines touched
    since the previous access to the same line) is computed in
    O(N log^2 N) numpy passes; an access hits a cache of capacity ``C``
    lines iff its distance is ``< C``, so ONE pass prices every capacity
    (L1 and L2 come from the same distances). No per-access Python loop,
    no stream-length cap, bit-identical to the brute-force LRU
    (``tests/test_locality.py`` proves it on adversarial streams).
  * :func:`access_stream_super` / :func:`access_stream_super_tile` —
    byte-access streams derived from the **actual** kernel inputs
    (``SuperBlockStreams`` / ``SuperTileStream``): the per-group
    sequential payload reads (values + packed coords + gather indices),
    the ``*_xidx``-driven x gathers, and optionally the combine's y
    traffic. Pure shape/index metadata — results are bit-deterministic
    and identical with obs enabled or disabled.

The vectorized distance algorithm: with ``prev[i]`` / ``next[i]`` the
previous/next access of access ``i``'s line (``next = N`` when none) and
``U[i]`` the number of distinct lines seen in ``[0, i)``,

    d[i] = U[i] - (prev[i] + 1) + #{t < prev[i] : next[t] < i}

(cold accesses have no ``prev`` and infinite distance). The last term
is a "count of earlier-smaller elements" over the ``next`` array —
non-sentinel ``next`` values are distinct positions, and ``i`` is
exactly ``next[prev[i]]`` — counted by a bottom-up merge (Fenwick-style
dominance count, one ``lexsort`` per level instead of one tree update
per access). Consecutive duplicate lines are collapsed first: they are
unconditional hits at any capacity and never change the miss sequence,
which shrinks sequential payload walks by ~line/element.

The cache constants are the JAX package's (``L2_BYTES`` 4 MiB), so the
two packages' profiles compare; an H100 caller passes its 50 MB L2 as
``cache_bytes`` / ``l2_bytes``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import errors
from repro_torch.core.streams import LANE, spmm_block_n

# The cache line model shared by every stream generator and profile:
# 128-byte lines and the JAX package's L1/L2 capacities, kept for parity.
# Relative ordering between formats is the claim under test, not the
# absolute hit rates.
LINE_BYTES = 128
L1_BYTES = 128 * 1024
L2_BYTES = 4 * 1024 * 1024

# One SpMV multiply-add per stored element.
FLOPS_PER_NNZ = 2


# ---------------------------------------------------------------------------
# The reuse-distance engine.
# ---------------------------------------------------------------------------

def _count_prev_smaller(vals):
    """out[i] = #{j < i : vals[j] < vals[i]}, fully vectorized.

    Bottom-up divide and conquer: at level ``L`` every pair of adjacent
    runs of length ``L`` is value-sorted together (one ``lexsort`` over
    (pair-id, value)), and each right-run element receives the count of
    left-run elements preceding it in that order. Every (j < i) pair is
    counted at exactly one level — the first where j and i fall in
    different halves of the same pair — so the sum over levels is the
    exact dominance count, in ``ceil(log2 N)`` numpy passes.

    Ties are resolved right-run-first (strict ``<``: a tied left element
    must not count). Only reached through :func:`reuse_profile`, where
    non-sentinel values are distinct and sentinel positions are never
    read back, but the routine stays correct for arbitrary ties.
    """
    n = len(vals)
    out = np.zeros(n, np.int64)
    if n < 2:
        return out
    idx = np.arange(n)
    L = 1
    while L < n:
        pair = idx // (2 * L)
        side = (idx // L) & 1          # 0 = left run, 1 = right run
        # sort by (pair, value, right-before-left on ties)
        order = np.lexsort((-side, vals, pair))
        left = (side[order] == 0).astype(np.int64)
        seen = np.cumsum(left) - left  # left elements before, globally
        po = pair[order]
        starts = np.flatnonzero(np.r_[True, po[1:] != po[:-1]])
        base = np.repeat(seen[starts], np.diff(np.r_[starts, n]))
        right = side[order] == 1
        out[order[right]] += (seen - base)[right]
        L *= 2
    return out


def reuse_distances(line_ids):
    """LRU stack distance per access; ``-1`` marks cold (first) accesses.

    ``d[i]`` = number of *distinct* lines accessed strictly between the
    previous access to ``line_ids[i]`` and position ``i``. An access
    hits a fully-associative LRU of capacity ``C`` lines iff
    ``0 <= d[i] < C``.
    """
    lines = np.asarray(line_ids)
    if lines.ndim != 1:
        raise errors.InvalidArgError(
            f"line_ids must be 1-D, got shape {lines.shape}"
        )
    n = len(lines)
    if n == 0:
        return np.zeros(0, np.int64)

    _, codes = np.unique(lines, return_inverse=True)

    # prev[i]: previous position of the same code (-1 = first access).
    order = np.argsort(codes, kind="stable")
    sc = codes[order]
    prev_sorted = np.empty(n, np.int64)
    prev_sorted[0] = -1
    same = sc[1:] == sc[:-1]
    prev_sorted[1:] = np.where(same, order[:-1], -1)
    prev = np.empty(n, np.int64)
    prev[order] = prev_sorted

    # next[t]: the access whose prev is t (N = never reused again).
    nxt = np.full(n, n, np.int64)
    has_prev = prev >= 0
    nxt[prev[has_prev]] = np.flatnonzero(has_prev)

    first = ~has_prev
    distinct_before = np.cumsum(first) - first      # U[i]

    inv = _count_prev_smaller(nxt)                  # #{t < p : next[t] < next[p]}

    d = np.full(n, -1, np.int64)
    p = prev[has_prev]
    d[has_prev] = distinct_before[has_prev] - (p + 1) + inv[p]
    return d


@dataclasses.dataclass(frozen=True)
class ReuseProfile:
    """Reuse-distance summary of one access stream (any capacity).

    ``distances`` covers the *collapsed* stream (consecutive duplicate
    lines merged); the ``accesses - collapsed_accesses`` merged
    duplicates are unconditional hits at every capacity >= 1, so
    :meth:`hits` restores them — hit/miss counts are bit-identical to a
    brute-force LRU walk of the raw stream.
    """

    accesses: int            # raw stream length
    collapsed_accesses: int
    unique_lines: int
    distances: object        # (collapsed_accesses,) int64, -1 = cold

    def hits(self, cache_bytes: int, line_bytes: int = LINE_BYTES) -> int:
        capacity = max(1, int(cache_bytes) // int(line_bytes))
        d = self.distances
        collapsed_hits = int(np.count_nonzero((d >= 0) & (d < capacity)))
        return (self.accesses - self.collapsed_accesses) + collapsed_hits

    def misses(self, cache_bytes: int, line_bytes: int = LINE_BYTES) -> int:
        return self.accesses - self.hits(cache_bytes, line_bytes)

    def hit_rate(self, cache_bytes: int, line_bytes: int = LINE_BYTES) -> float:
        return self.hits(cache_bytes, line_bytes) / max(1, self.accesses)


def reuse_profile(line_ids) -> ReuseProfile:
    """Profile an access stream of cache-line ids (see module docstring)."""
    lines = np.asarray(line_ids)
    n = len(lines)
    if n == 0:
        return ReuseProfile(0, 0, 0, np.zeros(0, np.int64))
    keep = np.r_[True, lines[1:] != lines[:-1]]
    collapsed = lines[keep]
    return ReuseProfile(
        accesses=int(n),
        collapsed_accesses=int(len(collapsed)),
        unique_lines=int(len(np.unique(collapsed))),
        distances=reuse_distances(collapsed),
    )


def lru_hit_rate(line_ids, cache_bytes: int,
                 line_bytes: int = LINE_BYTES) -> float:
    """Hit rate of a fully-associative LRU over ``line_ids`` (exact)."""
    return reuse_profile(line_ids).hit_rate(cache_bytes, line_bytes)


def stream_stats(line_ids, *, nnz: int,
                 l1_bytes: int = L1_BYTES,
                 l2_bytes: int = L2_BYTES,
                 line_bytes: int = LINE_BYTES,
                 flops: int | None = None) -> dict:
    """The locality row every report/bench renders for one stream.

    ``misses/nnz`` is the format-comparable metric (hit *rate* alone
    rewards formats that simply make more redundant accesses per
    element); ``bytes_moved`` is L2-miss traffic (the DRAM side of the
    roofline) and ``arith_intensity`` divides ``flops`` (default
    ``FLOPS_PER_NNZ * nnz``) by it.
    """
    prof = reuse_profile(line_ids)
    nnz = max(1, int(nnz))
    flops = FLOPS_PER_NNZ * nnz if flops is None else int(flops)
    l1_miss = prof.misses(l1_bytes, line_bytes)
    l2_miss = prof.misses(l2_bytes, line_bytes)
    bytes_moved = l2_miss * line_bytes
    return {
        "accesses": prof.accesses,
        "unique_lines": prof.unique_lines,
        "l1_hit_rate": prof.hit_rate(l1_bytes, line_bytes),
        "l2_hit_rate": prof.hit_rate(l2_bytes, line_bytes),
        "l1_misses_per_nnz": l1_miss / nnz,
        "l2_misses_per_nnz": l2_miss / nnz,
        "bytes_moved": int(bytes_moved),
        "arith_intensity": flops / max(1, bytes_moved),
    }


# ---------------------------------------------------------------------------
# Access-stream generators over the REAL batched-engine inputs.
# ---------------------------------------------------------------------------

class _AddressSpace:
    """Line-aligned virtual layout: one region per device buffer."""

    def __init__(self, line_bytes: int = LINE_BYTES) -> None:
        self._line = int(line_bytes)
        self._top = 0

    def region(self, nbytes: int) -> int:
        base = self._top
        self._top += -(-int(nbytes) // self._line) * self._line
        return base


def _seq_lines(base: int, nbytes: int, line_bytes: int):
    """Line ids a sequential walk of [base, base+nbytes) touches, in order.

    One entry per line (not per element): a streaming read revisits a
    line only consecutively, and :func:`reuse_profile` collapses
    consecutive duplicates anyway — emitting lines directly is
    bit-equivalent and ~line/element smaller.
    """
    if nbytes <= 0:
        return np.zeros(0, np.int64)
    return np.arange(base // line_bytes,
                     (base + nbytes - 1) // line_bytes + 1, dtype=np.int64)


def access_stream_super(streams, *, include_output: bool = False,
                        line_bytes: int = LINE_BYTES):
    """Byte-access stream of one batched SpMV pass over ``streams``.

    ``streams`` is a ``core.streams.SuperBlockStreams`` on any device
    (only shape/index metadata is read, never values, so the result is a
    pure function of the plan's structure; the index tensors are copied
    to the host once). Emission follows the engine's execution order:
    one kernel launch per non-empty format (dense, panel, coo), and per
    group within it

      1. the gather-index row (``*_xidx``, int32) and the payload row
         (values; plus packed codes for coo) — each a single sequential
         read of that stream row,
      2. the x gathers the row's indices drive (one access per lane /
         tile column, in lane order — padding lanes really do gather
         ``x[0]``, so they are charged),
      3. with ``include_output=True``, the scatter-add partial rows
         (one access per output element; flat-format baselines carry no
         output traffic, so comparisons default to leaving it out).

    Returns an int64 array of cache-line ids for :func:`reuse_profile`.
    """
    B = int(streams.block_size)
    vb = int(streams.val_itemsize)
    ib = 4  # int32 gather indices / packed codes

    # payloads: shapes only; indices: to the host once, never per group
    dense_tiles, panel_vals, coo_codes = (
        streams.dense_tiles, streams.panel_vals, streams.coo_codes)
    dense_xidx, panel_xidx, coo_xidx = (
        streams.dense_xidx.cpu().numpy(), streams.panel_xidx.cpu().numpy(),
        streams.coo_xidx.cpu().numpy())
    if include_output:
        dense_brow, panel_brow, coo_brow = (
            streams.dense_brow.cpu().numpy(), streams.panel_brow.cpu().numpy(),
            streams.coo_brow.cpu().numpy())

    space = _AddressSpace(line_bytes)
    base = {name: space.region(nbytes)
            for name, nbytes in streams.region_nbytes().items()}
    base_dt, base_dx = base["dense_tiles"], base["dense_xidx"]
    base_pv, base_px = base["panel_vals"], base["panel_xidx"]
    base_cc, base_cv, base_cx = (base["coo_codes"], base["coo_vals"],
                                 base["coo_xidx"])
    base_x, base_y = base["x"], base["y"]

    out = []

    def x_lines(idx):
        return base_x // line_bytes + (
            idx.astype(np.int64) * vb + base_x % line_bytes) // line_bytes

    def y_lines(brow_per_slot):
        rows = (brow_per_slot.astype(np.int64)[:, None] * B
                + np.arange(B, dtype=np.int64)[None, :]).reshape(-1)
        return (base_y + rows * vb) // line_bytes

    # -- dense super-tiles ------------------------------------------------
    row_dt = dense_tiles.shape[1] * dense_tiles.shape[2] * vb if \
        dense_tiles.ndim == 3 else 0
    row_dx = dense_xidx.shape[1] * dense_xidx.shape[2] * ib if \
        dense_xidx.ndim == 3 else 0
    for g in range(streams.num_dense_groups):
        out.append(_seq_lines(base_dx + g * row_dx, row_dx, line_bytes))
        out.append(_seq_lines(base_dt + g * row_dt, row_dt, line_bytes))
        out.append(x_lines(dense_xidx[g].reshape(-1)))
        if include_output:
            out.append(y_lines(dense_brow[g]))

    # -- lane-packed panels -----------------------------------------------
    Wp = panel_vals.shape[-1]
    row_pv = panel_vals.shape[1] * Wp * vb
    row_px = Wp * ib
    for g in range(streams.num_panel_groups):
        out.append(_seq_lines(base_px + g * row_px, row_px, line_bytes))
        out.append(_seq_lines(base_pv + g * row_pv, row_pv, line_bytes))
        out.append(x_lines(panel_xidx[g]))
        if include_output:
            out.append(y_lines(panel_brow[g]))

    # -- lane-packed coo --------------------------------------------------
    Wc = coo_codes.shape[-1]
    for g in range(streams.num_coo_groups):
        out.append(_seq_lines(base_cx + g * Wc * ib, Wc * ib, line_bytes))
        out.append(_seq_lines(base_cc + g * Wc * ib, Wc * ib, line_bytes))
        out.append(_seq_lines(base_cv + g * Wc * vb, Wc * vb, line_bytes))
        out.append(x_lines(coo_xidx[g]))
        if include_output:
            out.append(y_lines(coo_brow[g]))

    if not out:
        return np.zeros(0, np.int64)
    return np.concatenate(out)


def access_stream_super_tile(ts, n_cols: int | None = None, *,
                             include_output: bool = False,
                             line_bytes: int = LINE_BYTES):
    """Byte-access stream of one batched SpMM sweep over ``ts``.

    ``ts`` is a ``core.streams.SuperTileStream``. The grid is
    (activation n-tile, group): per n-tile the whole weight super-tile
    stream is re-read (the real traffic pattern the engine pays), and
    each slot reads its X block's ``bn``-column row segments via the
    ``bcol`` slot map. ``n_cols`` defaults to one lane tile
    (``streams.LANE``); the activation tile width comes from
    ``streams.spmm_block_n``, the JAX package's 128-lane rule, so the
    profile is the reference's (the CUDA kernel itself masks N's tail).
    """
    B = int(ts.block_size)
    tiles = ts.tiles                        # shape only
    vb = int(ts.val_itemsize)
    N = LANE if n_cols is None else int(n_cols)
    bn = spmm_block_n(N)
    n_tiles = -(-N // bn)
    Np = n_tiles * bn                       # padded activation width

    space = _AddressSpace(line_bytes)
    base_w = space.region(ts.region_nbytes()["tiles"])
    base_x = space.region(int(ts.nb) * B * Np * vb)
    base_y = space.region(int(ts.mb) * B * Np * vb)

    bcol = ts.bcol.cpu().numpy()
    brow = ts.brow.cpu().numpy()
    row_w = tiles.shape[1] * tiles.shape[2] * vb if tiles.ndim == 3 else 0
    col = np.arange(bn, dtype=np.int64)

    def tile_rows(base, block_rows, j):
        """Row-segment lines: B rows per slot, bn contiguous cols each."""
        rows = (block_rows.astype(np.int64)[:, None] * B
                + np.arange(B, dtype=np.int64)[None, :]).reshape(-1)
        byte = base + (rows[:, None] * Np + j * bn + col[None, :]) * vb
        return (byte // line_bytes).reshape(-1)

    out = []
    for j in range(n_tiles):
        for g in range(ts.num_groups):
            out.append(_seq_lines(base_w + g * row_w, row_w, line_bytes))
            out.append(tile_rows(base_x, bcol[g], j))
            if include_output:
                out.append(tile_rows(base_y, brow[g], j))
    if not out:
        return np.zeros(0, np.int64)
    return np.concatenate(out)
