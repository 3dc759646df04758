"""Column-compacted micro-panel CB-SpMV partials (batched): CUDA kernel + plain version.

FMT_CSR blocks (intermediate sparsity) become dense (B, k) panels after
per-block column compaction — the per-block form of the paper's
block-aware column aggregation (§3.3.1): all-zero columns are dropped at
preprocessing time so every lane that loads data does useful work.

One stream row = one *panel group*: many panels lane-packed side by side
into a fused ``(B, W)`` slab. Lane->slot routing is positional — slot =
``lane // SUBLANE`` — because the packer rounds every panel's width to a
SUBLANE multiple and lays panels at aligned offsets. A panel wider than
one slot owns several consecutive slots whose partials the additive
combine reunites. The group reduces with

    tmp = slab * xg                 elementwise,   (B, W)
    out = tmp.reshape(B, S, SUBLANE).sum(lanes)    (B, S) -> (S, B)

The CSR row_ptr of the portable format is *dissolved* at preprocessing:
rows are materialized into the panel's row axis, so the kernel needs no
row decoding at all.

``panel_spmv_batched`` replaces the TPU kernel of the same name in the
JAX package (``src/repro/kernels/cb_colagg.py``). On a CUDA tensor it
launches ``csrc/cb_colagg.cu`` (memory-bound: one pass over the panels;
see the note at the top of that file) or raises; on a CPU tensor it takes
``panel_spmv_plain``. Both read the payload in its stored dtype and
accumulate and emit float32.

Most of a sparse stream's panel slots hold padding zeros (a 27-point
stencil's, five lanes in six). ``compact_panels`` derives, from the panels
themselves, an encoding without them: each row's non-zeros in lane order
(``cvals``) and an 8-bit lane mask per slot (``mask``).
``panel_spmv_bitmap`` runs the same product on it, partials bit-equal to
``panel_spmv_batched``'s for finite x. It skips the padding lanes, so where x
holds an inf or a NaN at a lane a row's group holds but the row does not, its
partial stays finite where the padded kernel's is NaN (0 * inf).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import errors
from repro_torch.core.streams import SUBLANE

from . import _build


def panel_spmv_plain(panels: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (gp, B, W) x (gp, W) -> (gp, W // SUBLANE, B) float32."""
    gp, B, W = panels.shape
    tmp = panels.float() * xg.float()[:, None, :]
    return tmp.reshape(gp, B, W // SUBLANE, SUBLANE).sum(dim=3).transpose(1, 2).contiguous()


def panel_spmv_batched(
    panels: torch.Tensor,  # (gp, B, W) lane-packed panel groups, W % SUBLANE == 0
    xg: torch.Tensor,      # (gp, W) float32 pre-gathered x values
    *,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-slot partial y tiles — (gp, W // SUBLANE, B) float32.

    ``out`` (optional) is a contiguous float32 buffer of that shape to
    write into. ``panel_spmv_batched.launches`` counts kernel launches;
    an empty stream launches nothing.
    """
    gp, B, W = panels.shape
    if W % SUBLANE:
        raise errors.InvalidArgError(f"packed width {W} not a multiple of {SUBLANE}")
    S = W // SUBLANE
    dev = panels.device
    _build.require(panels, "panels", dtype=tuple(_build.DTYPE_CODES), align=16)
    _build.require(xg, "xg", dtype=torch.float32, shape=(gp, W), device=dev, align=16)
    if out is None:
        out = torch.empty((gp, S, B), dtype=torch.float32, device=dev)
    _build.require(out, "out", dtype=torch.float32, shape=(gp, S, B), device=dev)
    if gp == 0 or W == 0:
        return out
    if dev.type != "cuda":
        return out.copy_(panel_spmv_plain(panels, xg))
    lib = _build.library()
    with _build.launch_on(dev) as stream:
        code = lib.cb_panel_spmv(
            panels.data_ptr(), xg.data_ptr(), out.data_ptr(), gp, B, W,
            _build.DTYPE_CODES[panels.dtype], stream)
    _build.check(code, "cb_panel_spmv")
    panel_spmv_batched.launches += 1
    return out


panel_spmv_batched.launches = 0


# ---------------------------------------------------------------------------
# The bitmap-compacted encoding of the same panels, and its kernel.
# ---------------------------------------------------------------------------

_LANE_BITS = tuple(1 << k for k in range(SUBLANE))


@dataclasses.dataclass(frozen=True)
class CompactPanels:
    """A panel stream without its padding (``compact_panels``)."""

    cvals: torch.Tensor   # (gp, B, E) payload dtype: row (g, r)'s non-zeros in lane order, 0-padded
    mask: torch.Tensor    # (gp, B, W // SUBLANE) uint8: bit k of [g, r, s] <=> panels[g, r, 8s+k] != 0

    @property
    def elems(self) -> int:
        """Value slots one product reads: gp * B * E."""
        return self.cvals.numel()

    @property
    def nbytes(self) -> int:
        return self.cvals.numel() * self.cvals.element_size() + self.mask.numel()


def compact_panels(panels: torch.Tensor, *, itemsize: int | None = None,
                   chunk_elems: int = 1 << 25) -> CompactPanels:
    """The bitmap encoding of ``panels`` (gp, B, W), on their device.

    Structure is read off the values: a lane is in the mask iff its value is
    not 0 (an exact 0.0 is padding, as ``super_stream_updater`` takes it).
    E is the largest row count, rounded up so that a row of ``itemsize``-byte
    values (by default the panels' own) is a multiple of 16 bytes. Works
    through ``chunk_elems`` panel values at a time, so the transient memory
    stays near ``10 * chunk_elems`` bytes, and reads one number back to the
    host (E).
    """
    gp, B, W = panels.shape
    if W % SUBLANE:
        raise errors.InvalidArgError(f"packed width {W} not a multiple of {SUBLANE}")
    S, dev = W // SUBLANE, panels.device
    rows = panels.reshape(gp * B, W)
    step = max(1, chunk_elems // max(W, 1))
    chunks = [slice(r0, r0 + step) for r0 in range(0, gp * B, step)]
    counts = [(rows[c] != 0).sum(1).max() for c in chunks]
    most = int(torch.stack(counts).max()) if counts else 0  # cblint: disable=CB211 -- E, once
    unit = 16 // (itemsize or panels.element_size())
    E = -(-most // unit) * unit
    cvals = torch.empty((gp * B, E), dtype=panels.dtype, device=dev)
    mask = torch.empty((gp * B, S), dtype=torch.uint8, device=dev)
    bits = torch.tensor(_LANE_BITS, dtype=torch.uint8, device=dev)
    for c in chunks:
        block = rows[c]
        nz = block != 0
        mask[c] = (nz.view(-1, S, SUBLANE) * bits).sum(2, dtype=torch.uint8)
        place = nz.cumsum(1).sub_(1).masked_fill_(~nz, E)   # padding lanes land in column E
        spill = torch.zeros((block.shape[0], E + 1), dtype=panels.dtype, device=dev)
        cvals[c] = spill.scatter_(1, place, block)[:, :E]
    return CompactPanels(cvals.view(gp, B, E), mask.view(gp, B, S))


def panel_decode(cvals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The padded panels (gp, B, 8 * S) that ``cvals`` and ``mask`` encode."""
    gp, B, S = mask.shape
    bits = torch.tensor(_LANE_BITS, dtype=torch.uint8, device=mask.device)
    nz = (mask.unsqueeze(-1) & bits).ne(0).reshape(gp, B, S * SUBLANE)
    place = nz.cumsum(2) - 1
    out = torch.zeros((gp, B, S * SUBLANE), dtype=cvals.dtype, device=cvals.device)
    g, r, lane = nz.nonzero(as_tuple=True)
    out[g, r, lane] = cvals[g, r, place[g, r, lane]]
    return out


def panel_spmv_bitmap_plain(cvals: torch.Tensor, mask: torch.Tensor,
                            xg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``panel_spmv_bitmap``: the panels decoded,
    then ``panel_spmv_plain``."""
    return panel_spmv_plain(panel_decode(cvals, mask), xg)


def panel_spmv_bitmap(
    cvals: torch.Tensor,   # (gp, B, E) each row's non-zeros in lane order (compact_panels)
    mask: torch.Tensor,    # (gp, B, S) uint8 lane mask per slot
    xg: torch.Tensor,      # (gp, 8 * S) float32 pre-gathered x values
    *,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """``panel_spmv_batched``'s partials, (gp, S, B) float32, from the
    bitmap encoding of the panels (``csrc/cb_colagg.cu``,
    ``cb_panel_kernel_bitmap``); on a CPU tensor ``panel_spmv_bitmap_plain``.

    ``mask`` and ``cvals`` start 16-byte aligned and a row of ``cvals`` is a
    multiple of 16 bytes, as ``compact_panels`` makes them. The kernel stops
    (``__trap``) on a row whose mask holds more lanes than E. ``out`` as in
    ``panel_spmv_batched``; ``panel_spmv_bitmap.launches`` counts kernel
    launches, and an empty stream launches nothing.
    """
    gp, B, S = mask.shape
    W, E = S * SUBLANE, cvals.shape[2]
    dev = mask.device
    _build.require(mask, "mask", dtype=torch.uint8, align=16)
    _build.require(cvals, "cvals", dtype=tuple(_build.DTYPE_CODES), shape=(gp, B, E),
                   device=dev, align=16)
    if (E * cvals.element_size()) % 16:
        raise errors.InvalidArgError(f"cvals: a row of {E} values is not a multiple of 16 bytes")
    _build.require(xg, "xg", dtype=torch.float32, shape=(gp, W), device=dev, align=16)
    if out is None:
        out = torch.empty((gp, S, B), dtype=torch.float32, device=dev)
    _build.require(out, "out", dtype=torch.float32, shape=(gp, S, B), device=dev)
    if gp == 0 or W == 0:
        return out
    if dev.type != "cuda":
        return out.copy_(panel_spmv_bitmap_plain(cvals, mask, xg))
    lib = _build.library()
    with _build.launch_on(dev) as stream:
        code = lib.cb_panel_spmv_bitmap(
            cvals.data_ptr(), mask.data_ptr(), xg.data_ptr(), out.data_ptr(), gp, B, W, E,
            _build.DTYPE_CODES[cvals.dtype], stream)
    _build.check(code, "cb_panel_spmv_bitmap")
    panel_spmv_bitmap.launches += 1
    return out


panel_spmv_bitmap.launches = 0
