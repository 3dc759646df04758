"""Kernel-facing typed streams derived from the portable CB format.

The portable ``CBMatrix`` stores mixed-dtype byte-packed blocks behind
virtual pointers (paper Fig. 7). The kernels consume *typed streams*: one
stream per storage format, each a struct of uniform tensors where block
``i`` owns row ``i`` of every tensor. Contiguity — the locality mechanism
of the paper — is preserved: a block's payload occupies one contiguous
row of the stream, read with sequential loads.

Three streams mirror the paper's three intra-block formats:

  * ``dense``  — (B, B) value tiles (FMT_DENSE blocks).
  * ``panel``  — (B, K) column-compacted micro-panels (FMT_CSR blocks):
                 the block's non-zero columns are packed left, K padded to
                 a ``SUBLANE`` multiple. This is the per-block analogue of
                 the paper's column aggregation — dense math on compacted
                 data.
  * ``coo``    — element lists with the paper's packed coordinates
                 (``code = col << bits | row``), FMT_COO blocks.

Every stream carries per-block x gather indices (``*_xidx``) that already
encode the column-aggregation ``restore_cols`` mapping (or the trivial
``bcol*B + j`` mapping), so kernels never consult the restore maps at run
time — Alg. 3's ``cols_offset``/``restore_cols`` lookups resolved at
preprocessing time where they are free.

Two stream granularities share this layout:

  * ``SpMVStreams``       — one block per stream row.
  * ``SuperBlockStreams`` — ``build_super_streams``: up to ``group_size``
    blocks per stream row. Dense tiles stack vertically into a
    (G*B, B) super-tile; panel/COO payloads are width-*bucketed* (each
    block's width rounded to a ``SUBLANE`` multiple) and lane-packed side
    by side; lane -> slot routing is positional. The Alg. 2 balancer
    assigns blocks to groups so every group carries near-equal payload —
    the paper's inter-block load balancing at group granularity.

The layout is the JAX package's, array for array and bit for bit (slot
width 8, ``even_group``, ``TARGET_STEP_ELEMS``, ``MAX_GROUP_SIZE``), so
streams of the two packages can be diffed. The packing code is host-side
numpy and hold no Python loop over blocks; the only per-block loop left
is the heap of ``balance._heap_assign``. Array fields are
``torch.Tensor``; ``.to(device)`` moves a whole stream.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import errors

from . import balance as balance_mod
from . import column_agg as column_agg_mod
from .aggregation import coord_bits, typed_view
from .cb_matrix import CBMatrix
from .formats import FMT_COO, FMT_CSR, FMT_DENSE

# ---------------------------------------------------------------------------
# Padding policy — the single place payload widths get aligned.
# ---------------------------------------------------------------------------

SUBLANE = 8  # slot width: payload widths align to this many lanes


def pad_width(width: int, mult: int = SUBLANE) -> int:
    """Round a payload width up to the slot multiple.

    Zero stays zero: an empty stream allocates genuinely empty arrays
    (the dispatch layer skips the format entirely).
    """
    return -(-int(width) // mult) * mult


# Aim each group's payload at about this many elements. These are the
# *default* knob values, kept equal to the JAX package's so the two
# packages pack identical streams.
TARGET_STEP_ELEMS = 4096

# Upper bound on blocks per group.
MAX_GROUP_SIZE = 16


def group_size_for(
    block_size: int,
    target_step_elems: int = TARGET_STEP_ELEMS,
    max_group: int = MAX_GROUP_SIZE,
) -> int:
    """THE single home of the blocks-per-group occupancy rule.

    ``target_step_elems // B^2`` blocks per group, clamped to
    ``[1, max_group]``. ``build_super_streams`` routes its
    ``group_size=None`` default through here.
    """
    g = int(target_step_elems) // (int(block_size) * int(block_size))
    return int(min(max(g, 1), int(max_group)))


def even_group(count: int, group_size: int) -> tuple[int, int]:
    """(num_groups, slots per group) for ``count`` blocks at target G.

    Slots are evened across the ``ceil(count / G)`` groups so the last
    group is never mostly empty padding (count=40, G=16 -> 3 groups of
    14, not two full ones plus a third at 8/16). Shared by the host-side
    packer and ``ops._regroup`` so both agree on group geometry.
    """
    if count == 0:
        return 0, group_size
    ng = -(-count // group_size)
    return ng, -(-count // ng)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller says so.

    ``None`` means ``"cuda"``. Asking for CUDA where no CUDA device is
    present raises ``errors.DeviceUnavailableError`` — nothing quietly
    carries on on the CPU; callers that want the CPU pass
    ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise errors.DeviceUnavailableError(
            "no CUDA device is present; pass device='cpu' to run on the CPU"
        )
    return dev


_STREAM_FIELDS = (
    "dense_tiles", "dense_brow", "dense_xidx",
    "panel_vals", "panel_brow", "panel_xidx",
    "coo_codes", "coo_vals", "coo_brow", "coo_xidx",
)
_PAYLOAD_FIELDS = ("dense_tiles", "panel_vals", "coo_vals")


class _StreamOps:
    """What both stream granularities share: placement and accounting."""

    def to(self, device=None, *, payload_dtype: torch.dtype | None = None):
        """A copy on ``device`` (default: CUDA; see ``resolve_device``).

        ``payload_dtype`` re-types the three value payloads (e.g.
        ``torch.bfloat16``); indices stay int32.
        """
        dev = resolve_device(device)
        moved = {}
        for name in _STREAM_FIELDS:
            t = getattr(self, name)
            if payload_dtype is not None and name in _PAYLOAD_FIELDS:
                t = t.to(payload_dtype)
            moved[name] = t.to(dev)
        return dataclasses.replace(self, **moved)

    @property
    def device(self) -> torch.device:
        return self.dense_tiles.device

    @property
    def val_itemsize(self) -> int:
        """Bytes per value element (payload dtype width)."""
        return int(self.dense_tiles.element_size())

    def padded_work(self) -> dict:
        """Elements each kernel streams per full pass, padding included."""
        return {
            "dense": int(self.dense_tiles.numel()),
            "panel": int(self.panel_vals.numel()),
            "coo": int(self.coo_codes.numel()),
        }


@dataclasses.dataclass(eq=False)
class SpMVStreams(_StreamOps):
    """Typed per-format streams, one block per row.

    Block order within each stream is the balanced slot order of the
    source ``CBMatrix`` — the additive combine makes the result
    independent of order, so the paper's load-balanced schedule is kept
    verbatim.
    """

    # -- static ---------------------------------------------------------
    block_size: int
    m: int
    n: int
    mb: int               # number of block rows = ceil(m / B)
    colagg_applied: bool
    # -- dense tile stream ----------------------------------------------
    dense_tiles: torch.Tensor   # (nd, B, B) val
    dense_brow: torch.Tensor    # (nd,) int32
    dense_xidx: torch.Tensor    # (nd, B) int32 global x index per tile column
    # -- panel stream (CSR blocks, column-compacted) ---------------------
    panel_vals: torch.Tensor    # (np_, B, Kp) val
    panel_brow: torch.Tensor    # (np_,) int32
    panel_xidx: torch.Tensor    # (np_, Kp) int32
    # -- coo element stream ----------------------------------------------
    coo_codes: torch.Tensor     # (nc, Ep) int32 packed (col << bits | row)
    coo_vals: torch.Tensor      # (nc, Ep) val (0 on padding)
    coo_brow: torch.Tensor      # (nc,) int32
    coo_xidx: torch.Tensor      # (nc, Ep) int32

    @property
    def num_dense(self) -> int:
        return self.dense_tiles.shape[0]

    @property
    def num_panel(self) -> int:
        return self.panel_vals.shape[0]

    @property
    def num_coo(self) -> int:
        return self.coo_codes.shape[0]


@dataclasses.dataclass(eq=False)
class SuperBlockStreams(_StreamOps):
    """Typed streams with many blocks fused per stream row.

    One stream row = one group. Layouts per format:

      * dense — tiles stacked vertically: slot ``g`` of a group owns rows
        ``[g*B, (g+1)*B)`` of the ``(Gd*B, B)`` super-tile; its partial
        lands in row ``g`` of the ``(Gd, B)`` output tile.
      * panel / coo — payloads lane-packed side by side at
        ``SUBLANE``-aligned offsets (each block's width rounded up to
        ``SUBLANE`` — its width *bucket*), so a wide outlier pads only
        its own group. Lane->slot routing is **implicit**: slot =
        ``lane // SUBLANE``. A block wider than one slot occupies
        ``width / SUBLANE`` consecutive slots, each carrying the block's
        row in ``*_brow``; the pieces' partials are reunited by the
        additive combine, which is exactly why no explicit segment map
        is needed.

    Slots that the packer left empty have zero payload and ``brow`` 0:
    they add zeros into block-row 0, which is exact.
    """

    # -- static ---------------------------------------------------------
    block_size: int
    m: int
    n: int
    mb: int
    colagg_applied: bool
    group_size: int          # requested blocks per group (packer target)
    # -- dense super-tiles ----------------------------------------------
    dense_tiles: torch.Tensor   # (gd, Gd*B, B) val
    dense_brow: torch.Tensor    # (gd, Gd) int32
    dense_xidx: torch.Tensor    # (gd, Gd, B) int32
    # -- lane-packed panel groups (Sp = Wp // SUBLANE slots) -------------
    panel_vals: torch.Tensor    # (gp, B, Wp) val
    panel_brow: torch.Tensor    # (gp, Sp) int32 slot -> block row
    panel_xidx: torch.Tensor    # (gp, Wp) int32
    # -- lane-packed coo groups (Sc = Wc // SUBLANE slots) ---------------
    coo_codes: torch.Tensor     # (gc, Wc) int32 packed (col << bits | row)
    coo_vals: torch.Tensor      # (gc, Wc) val (0 on padding)
    coo_brow: torch.Tensor      # (gc, Sc) int32
    coo_xidx: torch.Tensor      # (gc, Wc) int32

    @property
    def num_dense_groups(self) -> int:
        return self.dense_tiles.shape[0]

    @property
    def num_panel_groups(self) -> int:
        return self.panel_vals.shape[0]

    @property
    def num_coo_groups(self) -> int:
        return self.coo_codes.shape[0]

    def region_nbytes(self) -> dict:
        """Byte size of every device buffer one SpMV pass reads or writes.

        Read-only shape metadata (no values are read), keyed by buffer
        name plus the ``x``/``y`` operand vectors — the least traffic a
        pass over this stream can move.
        """
        vb = self.val_itemsize
        ib = 4
        return {
            "dense_tiles": int(self.dense_tiles.numel()) * vb,
            "dense_xidx": int(self.dense_xidx.numel()) * ib,
            "panel_vals": int(self.panel_vals.numel()) * vb,
            "panel_xidx": int(self.panel_xidx.numel()) * ib,
            "coo_codes": int(self.coo_codes.numel()) * ib,
            "coo_vals": int(self.coo_vals.numel()) * vb,
            "coo_xidx": int(self.coo_xidx.numel()) * ib,
            "x": int(self.n) * vb,
            "y": int(self.m) * vb,
        }


def _as_tensor(arr) -> torch.Tensor:
    """numpy -> CPU tensor, bit for bit (bfloat16 arrays included)."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:        # e.g. a view of another framework's buffer
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":   # an ml_dtypes array: numpy has no bf16
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def streams_from_numpy(kind: str, fields: dict, meta: dict):
    """Build a stream object from plain numpy arrays.

    ``kind`` is ``"flat"`` (``SpMVStreams``) or ``"super"``
    (``SuperBlockStreams``); ``fields`` maps the ten array-field names to
    numpy arrays and ``meta`` the static fields to ints/bools. This is
    how stream bytes packed elsewhere (by the JAX package, or read from
    disk) enter the port unchanged; the tensors live on the CPU until
    ``.to(device)``.
    """
    classes = {"flat": SpMVStreams, "super": SuperBlockStreams}
    if kind not in classes:
        raise errors.InvalidArgError(
            f"unknown stream kind {kind!r}; expected 'flat' or 'super'")
    missing = [f for f in _STREAM_FIELDS if f not in fields]
    if missing:
        raise errors.InvalidArgError(f"stream fields missing: {missing}")
    tensors = {f: _as_tensor(fields[f]) for f in _STREAM_FIELDS}
    return classes[kind](**meta, **tensors)


# ---------------------------------------------------------------------------
# Typing the CB payload per format (whole matrix at a time).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _LaneBlocks:
    """The blocks of one lane-packed format (panel or coo), flattened.

    ``width[i]`` lanes of block ``i`` carry data; ``lane_blk`` /
    ``lane_pos`` name the (block, lane) of every data lane, and
    ``lane_xidx`` its x gather index.
    """

    brow: np.ndarray       # (nb,) int32 block row of each block
    width: np.ndarray      # (nb,) int64 data lanes per block
    lane_blk: np.ndarray   # (L,) block of each data lane
    lane_pos: np.ndarray   # (L,) lane within its block
    lane_xidx: np.ndarray  # (L,) int32


def _collect_blocks(cb: CBMatrix):
    """Decode the CBMatrix once, typing each format's payload for its stream.

    Returns ``(dense, panel, coo)``:
      dense — ``(brow (nd,), tiles (nd, B, B), xidx (nd, B), load (nd,))``
              with ``load`` the tile's stored non-zeros;
      panel — ``(_LaneBlocks, elem_blk, elem_row, elem_lane, elem_val)``:
              lanes are each block's distinct columns in ascending order
              (the column-compacted panel), elements name their lane;
      coo   — ``(_LaneBlocks, codes, vals)``: one lane per element.
    Blocks keep the balanced slot order within each format.
    """
    B = cb.block_size
    bits = coord_bits(B)
    n = cb.shape[1]
    brow_all = cb.blk_row_idx.astype(np.int64)
    bcol_all = cb.blk_col_idx.astype(np.int64)

    # ---- dense: the stored tile is the stream tile ----------------------
    slots = np.flatnonzero((cb.nnz_per_blk > 0) & (cb.type_per_blk == FMT_DENSE))
    vsize = cb.val_dtype.itemsize
    cells = (cb.vp_per_blk[slots] // vsize)[:, None] + np.arange(B * B)
    tiles = typed_view(cb.packed, cb.val_dtype)[cells].reshape(-1, B, B)
    d_xidx = column_agg_mod.restore_for_block(
        cb.colagg, brow_all[slots], bcol_all[slots], B, n).astype(np.int32)
    dense = (cb.blk_row_idx[slots].astype(np.int32), tiles,
             d_xidx.reshape(-1, B),
             np.count_nonzero(tiles.reshape(len(slots), B * B), axis=1))

    # ---- panel: per-block distinct columns, compacted left --------------
    slots, blk, r, c, v = cb.format_elements(FMT_CSR)
    pair, lane_of_elem = np.unique(blk.astype(np.int64) * B + c, return_inverse=True)
    u_blk, u_col = pair // B, pair % B
    width = np.bincount(u_blk, minlength=len(slots))
    first = np.cumsum(width) - width
    panel = (
        _LaneBlocks(
            brow=cb.blk_row_idx[slots].astype(np.int32), width=width,
            lane_blk=u_blk, lane_pos=np.arange(len(pair)) - first[u_blk],
            lane_xidx=cb.global_x_index(
                brow_all[slots][u_blk], bcol_all[slots][u_blk], u_col
            ).astype(np.int32),
        ),
        blk, r, lane_of_elem.reshape(-1) - first[blk], v,
    )

    # ---- coo: one lane per element, packed coordinates ------------------
    slots, blk, r, c, v = cb.format_elements(FMT_COO)
    width = np.bincount(blk, minlength=len(slots))
    first = np.cumsum(width) - width
    codes = ((c.astype(np.int64) << bits) | r.astype(np.int64)).astype(np.int32)
    coo = (
        _LaneBlocks(
            brow=cb.blk_row_idx[slots].astype(np.int32), width=width,
            lane_blk=blk, lane_pos=np.arange(len(blk)) - first[blk],
            lane_xidx=cb.global_x_index(
                brow_all[slots][blk], bcol_all[slots][blk], c
            ).astype(np.int32),
        ),
        codes, v,
    )
    return dense, panel, coo


def _stream_meta(cb: CBMatrix) -> dict:
    m, n = cb.shape
    return dict(block_size=cb.block_size, m=m, n=n, mb=-(-m // cb.block_size),
                colagg_applied=cb.colagg.applied)


def _wrap(cls, meta: dict, arrays: dict):
    return cls(**meta, **{k: torch.from_numpy(v) for k, v in arrays.items()})


def build_streams(cb: CBMatrix) -> SpMVStreams:
    """Derive the one-block-per-row streams from a CBMatrix (host-side).

    The packed-coordinate bit layout is fixed by ``aggregation.coord_bits``
    — the kernels and oracles recompute it from the block size, so it is
    deliberately not a parameter here. The tensors live on the CPU until
    ``.to(device)``.
    """
    B = cb.block_size
    vdt = cb.val_dtype
    (d_brow, d_tiles, d_xidx, _), (pl, p_blk, p_row, p_lane, p_val), \
        (cl, c_code, c_val) = _collect_blocks(cb)

    Kp = pad_width(pl.width.max(initial=0))
    p_vals = np.zeros((len(pl.brow), B, Kp), vdt)
    p_vals[p_blk, p_row, p_lane] = p_val
    p_xidx = np.zeros((len(pl.brow), Kp), np.int32)
    p_xidx[pl.lane_blk, pl.lane_pos] = pl.lane_xidx

    Ep = pad_width(cl.width.max(initial=0))
    c_codes = np.zeros((len(cl.brow), Ep), np.int32)
    c_vals = np.zeros((len(cl.brow), Ep), vdt)
    c_xidx = np.zeros((len(cl.brow), Ep), np.int32)
    c_codes[cl.lane_blk, cl.lane_pos] = c_code
    c_vals[cl.lane_blk, cl.lane_pos] = c_val
    c_xidx[cl.lane_blk, cl.lane_pos] = cl.lane_xidx

    return _wrap(SpMVStreams, _stream_meta(cb), dict(
        dense_tiles=np.ascontiguousarray(d_tiles), dense_brow=d_brow,
        dense_xidx=d_xidx,
        panel_vals=p_vals, panel_brow=pl.brow, panel_xidx=p_xidx,
        coo_codes=c_codes, coo_vals=c_vals, coo_brow=cl.brow, coo_xidx=c_xidx,
    ))


# ---------------------------------------------------------------------------
# Super-block streams: the batched execution engine's input format.
# ---------------------------------------------------------------------------

def _pack_lanes(lanes: _LaneBlocks, G: int):
    """Assign blocks to groups by bucketed width and lay out their lanes.

    Each block's bucketed width is ``pad_width(width)``. The Alg. 2
    balancer fills ``even_group`` slots per group; members sit side by
    side in slot order. Returns ``(ng, W, blk_group, blk_off, brow)``:
    the balanced width ``W = max_g sum(widths)``, each block's group and
    first lane, and the ``(ng, W // SUBLANE)`` per-slot block-row array
    (a block ``w`` lanes wide owns ``w // SUBLANE`` consecutive slots,
    every one pointing at the block's row).
    """
    bucket = -(-lanes.width // SUBLANE) * SUBLANE
    _, Gs = even_group(len(bucket), G)
    bal = balance_mod.grid_group_balance(bucket, Gs)
    ng = bal.num_groups
    slot_map = bal.slots.reshape(ng, Gs)
    member_w = np.where(slot_map >= 0, bucket[slot_map], 0)
    W = int(member_w.sum(axis=1).max())      # one array operation, all groups
    member_off = np.cumsum(member_w, axis=1) - member_w
    taken = slot_map >= 0
    blk_group = np.empty(len(bucket), np.int64)
    blk_off = np.empty(len(bucket), np.int64)
    blk_group[slot_map[taken]] = np.nonzero(taken)[0]
    blk_off[slot_map[taken]] = member_off[taken]

    brow = np.zeros((ng, W // SUBLANE), np.int32)
    nslots = bucket // SUBLANE
    owner = np.repeat(np.arange(len(bucket)), nslots)
    piece = np.arange(len(owner)) - (np.cumsum(nslots) - nslots)[owner]
    brow[blk_group[owner], blk_off[owner] // SUBLANE + piece] = lanes.brow[owner]
    return ng, W, blk_group, blk_off, brow


def build_super_streams(
    cb: CBMatrix, group_size: int | None = None
) -> SuperBlockStreams:
    """Pack CB blocks into balanced super-block groups (host-side).

    ``group_size=None`` picks ``group_size_for(B)`` — the occupancy
    heuristic targeting ~``TARGET_STEP_ELEMS`` payload elements per
    group. Group assignment reuses the paper's Alg. 2 heap balancer
    (``balance.grid_group_balance``): dense groups balance nnz across
    uniform-shape super-tiles; panel/COO groups balance *bucketed width*
    so the shared array width ``W = max_g sum(widths)`` — the padded
    payload every group stores — is as small and as equal as the block
    mix allows. The tensors live on the CPU until ``.to(device)``.
    """
    B = cb.block_size
    vdt = cb.val_dtype
    G = group_size_for(B) if group_size is None else int(group_size)
    if G < 1:
        raise errors.InvalidArgError(f"group_size must be >= 1, got {G}")

    (d_brow_b, d_tiles_b, d_xidx_b, d_load), \
        (pl, p_blk, p_row, p_lane, p_val), (cl, c_code, c_val) = _collect_blocks(cb)

    # ---- dense: nnz-balanced tiles, evened slots per super-tile ---------
    nd = len(d_brow_b)
    if nd:
        _, Gd = even_group(nd, G)
        bal = balance_mod.grid_group_balance(d_load, Gd)
        gd = bal.num_groups
        at = np.flatnonzero(bal.slots >= 0)      # flat (group, slot) position
        blk = bal.slots[at]
        d_tiles = np.zeros((gd, Gd * B, B), vdt)
        d_brow = np.zeros((gd, Gd), np.int32)
        d_xidx = np.zeros((gd, Gd, B), np.int32)
        d_tiles.reshape(gd * Gd, B, B)[at] = d_tiles_b[blk]
        d_brow.reshape(-1)[at] = d_brow_b[blk]
        d_xidx.reshape(gd * Gd, B)[at] = d_xidx_b[blk]
    else:
        d_tiles = np.zeros((0, G * B, B), vdt)
        d_brow = np.zeros((0, G), np.int32)
        d_xidx = np.zeros((0, G, B), np.int32)

    # ---- panel / coo: lane-packed, width-balanced -----------------------
    if len(pl.brow):
        gp, W, grp, off, p_brow = _pack_lanes(pl, G)
        p_vals = np.zeros((gp, B, W), vdt)
        p_xidx = np.zeros((gp, W), np.int32)
        p_vals[grp[p_blk], p_row, off[p_blk] + p_lane] = p_val
        p_xidx[grp[pl.lane_blk], off[pl.lane_blk] + pl.lane_pos] = pl.lane_xidx
    else:
        p_vals = np.zeros((0, B, 0), vdt)
        p_brow = np.zeros((0, 0), np.int32)
        p_xidx = np.zeros((0, 0), np.int32)

    if len(cl.brow):
        gc, W, grp, off, c_brow = _pack_lanes(cl, G)
        at = (grp[cl.lane_blk], off[cl.lane_blk] + cl.lane_pos)
        c_codes = np.zeros((gc, W), np.int32)
        c_vals = np.zeros((gc, W), vdt)
        c_xidx = np.zeros((gc, W), np.int32)
        c_codes[at] = c_code
        c_vals[at] = c_val
        c_xidx[at] = cl.lane_xidx
    else:
        c_codes = np.zeros((0, 0), np.int32)
        c_vals = np.zeros((0, 0), vdt)
        c_brow = np.zeros((0, 0), np.int32)
        c_xidx = np.zeros((0, 0), np.int32)

    return _wrap(SuperBlockStreams, dict(_stream_meta(cb), group_size=G), dict(
        dense_tiles=d_tiles, dense_brow=d_brow, dense_xidx=d_xidx,
        panel_vals=p_vals, panel_brow=p_brow, panel_xidx=p_xidx,
        coo_codes=c_codes, coo_vals=c_vals, coo_brow=c_brow, coo_xidx=c_xidx,
    ))
