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

The SpMM path has its own two: ``TileStream`` (every block densified to
a ``(B, B)`` tile, canonical ``(brow, bcol)`` order) and
``SuperTileStream`` (``Gt`` tiles stacked per group, nnz-balanced).

The layout is the JAX package's, array for array and bit for bit (slot
width 8, ``even_group``, ``TARGET_STEP_ELEMS``, ``MAX_GROUP_SIZE``), so
streams of the two packages can be diffed. The packing code is host-side
numpy and hold no Python loop over blocks; the only per-block loop left
is the heap of ``balance._heap_assign``. Array fields are
``torch.Tensor``; ``.to(device)`` moves a whole stream.

``build_super_streams`` runs under the ``obs`` span ``streams.build_super``
and a stream's ``.to()`` under ``streams.to``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import errors, obs

from . import balance as balance_mod
from . import column_agg as column_agg_mod
from .aggregation import aggregate_partition, coord_bits, typed_view
from .blocking import BlockPartition, partition_coo
from .cb_matrix import CBMatrix
from .formats import FMT_COO, FMT_CSR, FMT_DENSE

# ---------------------------------------------------------------------------
# Padding policy — the single place payload widths get aligned.
# ---------------------------------------------------------------------------

SUBLANE = 8  # slot width: payload widths align to this many lanes

LANE = 128  # the JAX package's SpMM activation-tile width multiple


def pad_width(width: int, mult: int = SUBLANE) -> int:
    """Round a payload width up to the slot multiple.

    Zero stays zero: an empty stream allocates genuinely empty arrays
    (the dispatch layer skips the format entirely).
    """
    return -(-int(width) // mult) * mult


def spmm_block_n(n_cols: int, block_n: int = LANE) -> int:
    """The JAX package's SpMM activation-tile width: ``N`` rounded up to a
    ``LANE`` multiple, capped at ``block_n`` (itself a ``LANE`` multiple).

    The 128-lane rule is the TPU compiler's. The port keeps it for the
    launch accounting (``ops.spmm_launch_stats``) and for validating
    ``block_n``; its CUDA kernel takes N as it is and masks the tail.
    """
    if block_n % LANE:
        raise errors.InvalidArgError(
            f"block_n must be a multiple of {LANE} lanes, got {block_n}")
    return min(block_n, pad_width(max(int(n_cols), 1), LANE))


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


def auto_group_size(block_size: int) -> int:
    """Occupancy heuristic at the default knobs (see ``group_size_for``)."""
    return group_size_for(block_size)


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
        with obs.span("streams.to"):
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


_TILE_FIELDS = ("tiles", "brow", "bcol")


class _TileOps:
    """What both SpMM tile-stream granularities share."""

    def to(self, device=None, *, payload_dtype: torch.dtype | None = None):
        """A copy on ``device`` (default: CUDA; see ``resolve_device``).

        ``payload_dtype`` re-types the tiles; ``brow``/``bcol`` stay int32.
        """
        dev = resolve_device(device)
        tiles = self.tiles if payload_dtype is None else self.tiles.to(payload_dtype)
        return dataclasses.replace(self, tiles=tiles.to(dev), brow=self.brow.to(dev),
                                   bcol=self.bcol.to(dev))

    @property
    def device(self) -> torch.device:
        return self.tiles.device

    @property
    def val_itemsize(self) -> int:
        """Bytes per weight element (payload dtype width)."""
        return int(self.tiles.element_size())

    def padded_work(self) -> dict:
        """Weight elements one full sweep streams, padding included."""
        return {"tiles": int(self.tiles.numel())}

    def region_nbytes(self) -> dict:
        """Byte size of the weight buffer one SpMM sweep streams."""
        return {"tiles": int(self.tiles.numel()) * self.val_itemsize}


@dataclasses.dataclass(eq=False)
class TileStream(_TileOps):
    """Block-dense (BSR-like) stream for CB-SpMM, one tile per row.

    Tiles are in canonical ``(brow, bcol)`` order, and every block row owns
    at least one (possibly all-zero) tile; both builders
    (``build_tile_stream`` from COO, ``tile_stream_from_cb`` from a
    CBMatrix) emit the same stream for the same matrix.
    """

    block_size: int
    m: int
    n: int
    mb: int
    nb: int
    tiles: torch.Tensor   # (nt, B, B)
    brow: torch.Tensor    # (nt,) int32, ascending
    bcol: torch.Tensor    # (nt,) int32, ascending within each block row

    @property
    def num_tiles(self) -> int:
        return self.tiles.shape[0]


@dataclasses.dataclass(eq=False)
class SuperTileStream(_TileOps):
    """Tile stream with ``Gt`` tiles stacked per group.

    Slot ``g`` of group ``i`` owns rows ``[g*B, (g+1)*B)`` of the
    ``(Gt*B, B)`` super-tile; its partial goes to output block row
    ``brow[i, g]`` and it multiplies X block row ``bcol[i, g]``. Slots the
    packer left empty hold a zero tile with ``brow``/``bcol`` 0 and add
    exact zeros into output row 0.
    """

    block_size: int
    m: int
    n: int
    mb: int
    nb: int
    group_size: int       # requested tiles per group (packer target)
    tiles: torch.Tensor   # (gt, Gt*B, B)
    brow: torch.Tensor    # (gt, Gt) int32
    bcol: torch.Tensor    # (gt, Gt) int32

    @property
    def num_groups(self) -> int:
        return self.tiles.shape[0]

    @property
    def slots(self) -> int:
        return self.brow.shape[1]


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

    ``kind`` is ``"flat"`` (``SpMVStreams``), ``"super"``
    (``SuperBlockStreams``), ``"tile"`` (``TileStream``) or
    ``"super_tile"`` (``SuperTileStream``); ``fields`` maps the array-field
    names (ten for the SpMV streams, ``tiles``/``brow``/``bcol`` for the
    tile streams) to numpy arrays and ``meta`` the static fields to
    ints/bools. This is how stream bytes packed elsewhere (by the JAX
    package, or read from disk) enter the port unchanged; the tensors
    live on the CPU until ``.to(device)``.
    """
    classes = {"flat": (SpMVStreams, _STREAM_FIELDS),
               "super": (SuperBlockStreams, _STREAM_FIELDS),
               "tile": (TileStream, _TILE_FIELDS),
               "super_tile": (SuperTileStream, _TILE_FIELDS)}
    if kind not in classes:
        raise errors.InvalidArgError(
            f"unknown stream kind {kind!r}; expected one of {sorted(classes)}")
    cls, names = classes[kind]
    missing = [f for f in names if f not in fields]
    if missing:
        raise errors.InvalidArgError(f"stream fields missing: {missing}")
    tensors = {f: _as_tensor(fields[f]) for f in names}
    return cls(**meta, **tensors)


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
    Each build sets the gauge ``repro.streams.nnz{format}`` (dense, panel,
    coo) to the non-zeros that format holds, which a call's
    ``repro.ops.spmv.padded_elems`` pads to its stored slots.
    """
    G = group_size_for(cb.block_size) if group_size is None else int(group_size)
    if G < 1:
        raise errors.InvalidArgError(f"group_size must be >= 1, got {G}")
    with obs.span("streams.build_super", blocks=cb.num_blocks, group_size=G):
        return _pack_super_streams(cb, G)


def _pack_super_streams(cb: CBMatrix, G: int) -> SuperBlockStreams:
    """``build_super_streams``'s packing at group size ``G``."""
    B = cb.block_size
    vdt = cb.val_dtype
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

    nnz = obs.gauge("repro.streams.nnz")
    for fmt, n in (("dense", int(d_load.sum())), ("panel", len(p_val)), ("coo", len(c_val))):
        nnz.set(n, format=fmt)
    return _wrap(SuperBlockStreams, dict(_stream_meta(cb), group_size=G), dict(
        dense_tiles=d_tiles, dense_brow=d_brow, dense_xidx=d_xidx,
        panel_vals=p_vals, panel_brow=p_brow, panel_xidx=p_xidx,
        coo_codes=c_codes, coo_vals=c_vals, coo_brow=c_brow, coo_xidx=c_xidx,
    ))


# ---------------------------------------------------------------------------
# Transposed streams: the solver subsystem's rmatvec path.
# ---------------------------------------------------------------------------

def transpose_cb(cb: CBMatrix) -> CBMatrix:
    """Rebuild the full CB pipeline for ``A^T`` (host-side, plan time).

    The transpose gets its *own* CB structure: the matrix's triplets in
    original global coordinates (one whole-matrix decode,
    ``global_elements``), swapped, sorted row-major in transposed
    coordinates with one ``lexsort``, then the whole preprocessing
    pipeline again — block formats, column aggregation and balance are
    re-decided for A^T's structure. Coordinates are unique, so the sort
    fixes the order completely and the result is bit-identical to the JAX
    package's block-by-block collection, and to ``CBMatrix.from_coo`` on
    the transposed triplets directly.
    """
    r_all, c_all, v_all = cb.global_elements()
    order = np.lexsort((r_all, c_all))  # row-major in transposed coords
    return CBMatrix.from_coo(
        c_all[order], r_all[order], v_all[order], (cb.shape[1], cb.shape[0]),
        block_size=cb.block_size, val_dtype=cb.val_dtype, thresholds=cb.thresholds,
    )


def build_transposed_super_streams(
    cb: CBMatrix, group_size: int | None = None
) -> SuperBlockStreams:
    """Batched super-block streams for ``A^T`` (see :func:`transpose_cb`)."""
    return build_super_streams(transpose_cb(cb), group_size=group_size)


# ---------------------------------------------------------------------------
# SpMM tile streams: block-dense weights for the multi-RHS / training path.
# ---------------------------------------------------------------------------

def _canonical_tiles(tiles, brow, bcol, mb: int, block_size: int, dtype):
    """Add a zero coverage tile (bcol 0) for every block row without one,
    then sort tiles into canonical ``(brow, bcol)`` order."""
    B = block_size
    missing = np.setdiff1d(np.arange(mb, dtype=np.int32), brow)
    if len(missing):
        tiles = np.concatenate([tiles, np.zeros((len(missing), B, B), dtype)])
        brow = np.concatenate([brow, missing])
        bcol = np.concatenate([bcol, np.zeros(len(missing), np.int32)])
    order = np.lexsort((bcol, brow))
    return tiles[order], brow[order], bcol[order]


def build_tile_stream(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                      shape: tuple[int, int], block_size: int) -> TileStream:
    """Build the block-dense stream directly from COO triplets (host-side).

    Duplicates are summed (``partition_coo``); every block becomes one
    ``(B, B)`` tile, scattered in one array operation.
    """
    m, n = shape
    B = int(block_size)
    mb, nb = -(-m // B), -(-n // B)
    part = partition_coo(rows, cols, vals, shape, B)
    tiles = np.zeros((part.num_blocks, B, B), part.values.dtype)
    blk = np.repeat(np.arange(part.num_blocks), part.nnz_per_blk)
    tiles[blk, part.local_rows, part.local_cols] = part.values
    tiles, brow, bcol = _canonical_tiles(
        tiles, part.blk_row_idx.astype(np.int32), part.blk_col_idx.astype(np.int32),
        mb, B, np.asarray(vals).dtype)
    return _wrap(TileStream, dict(block_size=B, m=m, n=n, mb=mb, nb=nb),
                 dict(tiles=tiles, brow=brow, bcol=bcol))


def tile_stream_from_cb(cb: CBMatrix) -> TileStream:
    """Densify every CB block into the tile stream (all formats -> tiles).

    Column aggregation is folded back to original coordinates, so the
    stream is position-faithful and bit-equal to ``build_tile_stream`` on
    the same triplets.
    """
    B = cb.block_size
    m, n = cb.shape
    mb, nb = -(-m // B), -(-n // B)
    r, gc, v = cb.global_elements()
    key = (r // B) * nb + gc // B          # ascending unique keys = (brow, bcol)
    ukeys, inv = np.unique(key, return_inverse=True)
    tiles = np.zeros((len(ukeys), B, B), cb.val_dtype)
    tiles[inv.reshape(-1), r % B, gc % B] = v
    # every (row, col) is stored once, so this equals adding into zeros,
    # except that a stored -0.0 must come out +0.0 as it does there
    tiles += tiles.dtype.type(0)
    tiles, brow, bcol = _canonical_tiles(
        tiles, (ukeys // nb).astype(np.int32), (ukeys % nb).astype(np.int32),
        mb, B, cb.val_dtype)
    return _wrap(TileStream, dict(block_size=B, m=m, n=n, mb=mb, nb=nb),
                 dict(tiles=tiles, brow=brow, bcol=bcol))


def build_super_tile_stream(ts: TileStream, group_size: int | None = None) -> SuperTileStream:
    """Pack SpMM tiles into nnz-balanced super-tile groups (host-side).

    ``group_size=None`` picks ``group_size_for(B)``. Tiles are assigned to
    groups by the Alg. 2 heap balancer on per-tile nnz, with slots evened
    by ``even_group``; the balanced slot order is kept as it is (the
    combine makes the result independent of slot order). The tensors live
    on the CPU until ``.to(device)``.
    """
    B = ts.block_size
    G = group_size_for(B) if group_size is None else int(group_size)
    if G < 1:
        raise errors.InvalidArgError(f"group_size must be >= 1, got {G}")
    tiles = ts.tiles.cpu()
    nt = tiles.shape[0]
    if nt:
        _, Gt = even_group(nt, G)
        load = torch.count_nonzero(tiles, dim=(1, 2)).numpy().astype(np.int64)
        bal = balance_mod.grid_group_balance(load, Gt)
        gt = bal.num_groups
        at = torch.from_numpy(np.flatnonzero(bal.slots >= 0))   # flat (group, slot)
        blk = torch.from_numpy(bal.slots[at.numpy()])
        s_tiles = torch.zeros((gt, Gt * B, B), dtype=tiles.dtype)
        s_brow = torch.zeros((gt, Gt), dtype=torch.int32)
        s_bcol = torch.zeros((gt, Gt), dtype=torch.int32)
        s_tiles.view(gt * Gt, B, B)[at] = tiles[blk]
        s_brow.view(-1)[at] = ts.brow.cpu()[blk]
        s_bcol.view(-1)[at] = ts.bcol.cpu()[blk]
    else:
        s_tiles = torch.zeros((0, G * B, B), dtype=tiles.dtype)
        s_brow = torch.zeros((0, G), dtype=torch.int32)
        s_bcol = torch.zeros((0, G), dtype=torch.int32)
    return SuperTileStream(block_size=B, m=ts.m, n=ts.n, mb=ts.mb, nb=ts.nb, group_size=G,
                           tiles=s_tiles, brow=s_brow, bcol=s_bcol)


def super_tile_stream_from_cb(cb: CBMatrix, group_size: int | None = None) -> SuperTileStream:
    """Full CB pipeline -> densified tiles -> balanced super-tile groups."""
    return build_super_tile_stream(tile_stream_from_cb(cb), group_size=group_size)


# ---------------------------------------------------------------------------
# Stream updaters: the dynamic-sparsity fast path at stream granularity.
#
# Every stream function above permutes values (balanced slot order, lane
# packing, tile stacking) but decides the permutation from the sparsity
# pattern alone. The updaters record that permutation ONCE — by building
# the stream from a "shadow" CBMatrix whose payload values are canonical
# indices — and afterwards re-materialize a stream for fresh values with
# a single scatter on the stream's device, never re-running the packing.
# ---------------------------------------------------------------------------


def _index_cb(cb: CBMatrix) -> CBMatrix:
    """A shadow of ``cb`` whose payload values are ``canonical_rank + 1``.

    Same blocking / colagg / format / balance metadata; int64 values, all
    nonzero — so every value-sensitive step inside the stream packers
    (dense-tile nonzero recovery, nnz balancing, ``count_nonzero`` on
    densified tiles) sees the structure an all-nonzero real build would,
    and the packers carry int64 payloads through untouched. Building any
    stream from the shadow therefore yields payload arrays holding
    ``src_index + 1`` at exactly the positions the real packing would
    place canonical value ``src_index``.

    One whole-matrix decode per format and one ``aggregate_partition``
    over the real slots in slot order: the same bytes as the JAX
    package's block-by-block repack, with no Python loop over blocks.
    """
    layout = cb.value_layout()
    B = cb.block_size
    n = cb.shape[1]
    slot_l, fmt_l, count_l, eslot_l, r_l, c_l, rank_l = [], [], [], [], [], [], []
    for fmt in (FMT_COO, FMT_CSR, FMT_DENSE):
        slots, blk, r, c, _v = cb.format_elements(fmt)
        brow = cb.blk_row_idx[slots].astype(np.int64)[blk]
        bcol = cb.blk_col_idx[slots].astype(np.int64)[blk]
        key = (brow * B + r.astype(np.int64)) * n + cb.global_x_index(brow, bcol, c)
        slot_l.append(slots)
        fmt_l.append(np.full(len(slots), fmt, np.uint8))
        count_l.append(np.bincount(blk, minlength=len(slots)))
        eslot_l.append(slots[blk])
        r_l.append(r)
        c_l.append(c)
        rank_l.append(np.searchsorted(layout.keys, key) + 1)
    slots = np.concatenate(slot_l)
    by_slot = np.argsort(slots, kind="stable")
    slots = slots[by_slot]
    counts = np.concatenate(count_l)[by_slot].astype(np.int64)
    # elements grouped by slot, each block's elements in decode order
    e_order = np.argsort(np.concatenate(eslot_l), kind="stable")
    brows = cb.blk_row_idx[slots]
    part = BlockPartition(
        shape=cb.shape, block_size=B, blk_row_idx=brows,
        blk_col_idx=cb.blk_col_idx[slots], nnz_per_blk=counts.astype(np.int32),
        blk_ptr=np.concatenate([[0], np.cumsum(counts)]).astype(np.int64),
        local_rows=np.concatenate(r_l)[e_order], local_cols=np.concatenate(c_l)[e_order],
        values=np.concatenate(rank_l)[e_order].astype(np.int64),
    )
    packed = aggregate_partition(np.concatenate(fmt_l)[by_slot], part, np.int64)
    vp = np.zeros_like(cb.vp_per_blk)
    nnzb = np.zeros_like(cb.nnz_per_blk)
    vp[slots] = packed.vp_per_blk
    nnzb[slots] = counts
    return dataclasses.replace(
        cb, val_dtype=np.dtype(np.int64), nnz_per_blk=nnzb,
        vp_per_blk=vp, packed=packed.packed,
    )


def _scatter_from_index(arr) -> tuple[np.ndarray, np.ndarray]:
    """(flat positions, canonical source index) of a shadow payload array."""
    flat = np.asarray(arr).reshape(-1)
    pos = np.flatnonzero(flat)
    return pos, (flat[pos] - 1).astype(np.int64)


def _place(template: torch.Tensor, pos: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Zeros shaped and typed like ``template`` with ``values`` at flat ``pos``."""
    out = torch.zeros(template.numel(), dtype=template.dtype, device=template.device)
    if pos.numel():
        out[pos] = values.to(template.dtype)
    return out.view(template.shape)


def _scatter_payload(template: torch.Tensor, pos: torch.Tensor, src: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """Zeros shaped and typed like ``template`` with ``vals[src]`` at flat
    ``pos`` — one gather and one scatter on ``template``'s device."""
    return _place(template, pos, vals[src])


def _values_on(canonical_vals, val_dtype: np.dtype, device: torch.device) -> torch.Tensor:
    """Canonical values as a tensor on ``device``: numpy is cast to the
    matrix's value dtype first (as the JAX package casts before it
    gathers), a tensor only moved."""
    if isinstance(canonical_vals, torch.Tensor):
        return canonical_vals.to(device)
    return _as_tensor(np.ascontiguousarray(canonical_vals, val_dtype)).to(device)


def _index_tensors(*arrays) -> list[torch.Tensor]:
    return [torch.from_numpy(np.ascontiguousarray(a, np.int64)) for a in arrays]


@dataclasses.dataclass(eq=False)
class SuperStreamUpdater:
    """Value-scatter index for a ``SuperBlockStreams`` layout.

    ``apply(canonical_vals)`` returns a stream bit-identical to
    ``build_super_streams`` on the same structure with those values
    (values in the canonical ``to_coo`` order), at the cost of one scatter
    per payload on the template's device, and one more of the gathered
    panel values into the panels' bitmap encoding
    (``cb_colagg.compact_panels``), whose mask and value places the
    structure fixes: the new stream's CUDA calls read it and derive none. ``.to(device)`` moves the template and the index tensors;
    ``eq=False`` keeps the object identity-hashable.
    """

    template: SuperBlockStreams   # real metadata, zeroed payloads
    val_dtype: np.dtype
    dense_pos: torch.Tensor       # (k,) int64 flat positions / canonical sources
    dense_src: torch.Tensor
    panel_pos: torch.Tensor
    panel_src: torch.Tensor
    coo_pos: torch.Tensor
    coo_src: torch.Tensor
    cvals_pos: torch.Tensor       # (k,) int64: where panel_src's values sit in panel_cvals
    panel_mask: torch.Tensor      # (gp, B, W // 8) uint8: the encoding's lane mask
    panel_cvals: torch.Tensor     # (gp, B, E) zeros: the encoding's values, as the payloads

    def to(self, device=None) -> "SuperStreamUpdater":
        """A copy whose template and index tensors live on ``device``."""
        dev = resolve_device(device)
        idx = {f.name: getattr(self, f.name).to(dev) for f in dataclasses.fields(self)
               if f.name.endswith(("_pos", "_src", "_mask", "_cvals"))}
        return dataclasses.replace(self, template=self.template.to(dev), **idx)

    def apply(self, canonical_vals) -> SuperBlockStreams:
        """The stream for fresh values: numpy or a tensor, scattered on the
        template's device. The new stream shares the template's block rows
        and combine plan (they depend on the structure only), so its first
        product sorts nothing on the host, and its panels' bitmap encoding."""
        from repro_torch.kernels import cb_colagg, ops

        t = self.template
        vals = _values_on(canonical_vals, self.val_dtype, t.device)
        panel = vals[self.panel_src]                # gathered once, placed twice
        new = dataclasses.replace(
            t,
            dense_tiles=_scatter_payload(t.dense_tiles, self.dense_pos, self.dense_src, vals),
            panel_vals=_place(t.panel_vals, self.panel_pos, panel),
            coo_vals=_scatter_payload(t.coo_vals, self.coo_pos, self.coo_src, vals),
        )
        cvals = _place(self.panel_cvals, self.cvals_pos, panel)
        ops.share_prepared(t, new, cb_colagg.CompactPanels(cvals, self.panel_mask))
        return new


def _super_updater_from_shadow(shadow: SuperBlockStreams, vdt: np.dtype) -> SuperStreamUpdater:
    from repro_torch.kernels import cb_colagg

    idx = {}
    for name, field in (("dense", "dense_tiles"), ("panel", "panel_vals"), ("coo", "coo_vals")):
        idx[f"{name}_pos"], idx[f"{name}_src"] = _index_tensors(
            *_scatter_from_index(getattr(shadow, field).numpy()))
    # compaction keeps the panels' values in flat order, so the k-th value of
    # the encoding is the k-th of the panels, from panel_src[k]
    enc = cb_colagg.compact_panels(shadow.panel_vals, itemsize=vdt.itemsize)
    (idx["cvals_pos"],) = _index_tensors(np.flatnonzero(enc.cvals.numpy()))
    template = dataclasses.replace(
        shadow, **{f: torch.from_numpy(np.zeros(tuple(getattr(shadow, f).shape), vdt))
                   for f in _PAYLOAD_FIELDS})
    return SuperStreamUpdater(
        template=template, val_dtype=vdt, panel_mask=enc.mask,
        panel_cvals=torch.from_numpy(np.zeros(tuple(enc.cvals.shape), vdt)), **idx)


def super_stream_updater(cb: CBMatrix, group_size: int | None = None) -> SuperStreamUpdater:
    """Record ``build_super_streams``'s value permutation once.

    The returned updater's ``apply`` matches a fresh
    ``build_super_streams(cb.update_values(v), group_size)`` bit for bit
    whenever the new values are nonzero (an exact 0.0 would change which
    elements a dense tile recovers — structure drift, not an update).
    The updater lives on the CPU until ``.to(device)``.
    """
    shadow = build_super_streams(_index_cb(cb), group_size=group_size)
    return _super_updater_from_shadow(shadow, np.dtype(cb.val_dtype))


def transposed_super_stream_updater(
    cb: CBMatrix, group_size: int | None = None
) -> SuperStreamUpdater:
    """Value-scatter index for the ``A^T`` stream, in **forward** order.

    ``transpose_cb`` re-runs the whole CB pipeline on swapped triplets
    but carries values through untouched, so transposing the shadow
    matrix lands forward canonical indices at the transposed stream's
    payload positions: one ``apply(forward_canonical_vals)`` updates the
    rmatvec path with no transposed-order bookkeeping anywhere.
    """
    shadow = build_super_streams(transpose_cb(_index_cb(cb)), group_size=group_size)
    return _super_updater_from_shadow(shadow, np.dtype(cb.val_dtype))


@dataclasses.dataclass(eq=False)
class SuperTileUpdater:
    """Value-scatter index for a ``SuperTileStream`` layout (SpMM path)."""

    template: SuperTileStream     # real slot maps, zeroed tiles
    val_dtype: np.dtype
    pos: torch.Tensor             # (k,) int64
    src: torch.Tensor             # (k,) int64

    def to(self, device=None) -> "SuperTileUpdater":
        """A copy whose template and index tensors live on ``device``."""
        dev = resolve_device(device)
        return dataclasses.replace(self, template=self.template.to(dev),
                                   pos=self.pos.to(dev), src=self.src.to(dev))

    def apply(self, canonical_vals) -> SuperTileStream:
        """The tile stream for fresh values (see ``SuperStreamUpdater.apply``)."""
        from repro_torch.kernels import ops

        t = self.template
        vals = _values_on(canonical_vals, self.val_dtype, t.device)
        new = dataclasses.replace(t, tiles=_scatter_payload(t.tiles, self.pos, self.src, vals))
        ops.share_prepared(t, new)
        return new


def super_tile_updater(cb: CBMatrix, group_size: int | None = None) -> SuperTileUpdater:
    """Record ``super_tile_stream_from_cb``'s value permutation once."""
    shadow = super_tile_stream_from_cb(_index_cb(cb), group_size=group_size)
    vdt = np.dtype(cb.val_dtype)
    pos, src = _index_tensors(*_scatter_from_index(shadow.tiles.numpy()))
    template = dataclasses.replace(
        shadow, tiles=torch.from_numpy(np.zeros(tuple(shadow.tiles.shape), vdt)))
    return SuperTileUpdater(template=template, val_dtype=vdt, pos=pos, src=src)
