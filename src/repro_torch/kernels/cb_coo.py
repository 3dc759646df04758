"""Block-COO CB-SpMV partials (paper Alg. 3, batched): CUDA kernel + plain version.

FMT_COO blocks (super-sparse) ship as element lists with the paper's
*packed coordinates*: ``code = col << bits | row`` (Alg. 3 decodes
``row = b & 15; col = b >> 4``; the mask is generalized to the block
size). One stream row is one *element group*: many blocks' element lists
lane-packed into a single ``(W,)`` payload at SUBLANE-aligned offsets, so
lane->slot routing is positional (slot = ``lane // SUBLANE``; a block with
many elements owns several consecutive slots, whose partial tiles the
additive combine reunites). Every lane adds ``val * x`` into row
``code & mask`` of its slot's B-vector; padding lanes carry ``val == 0``
and contribute nothing whatever their decoded coordinates.

``coo_spmv_batched`` replaces the TPU kernel of the same name in the JAX
package (``src/repro/kernels/cb_coo.py``). On a CUDA tensor it launches
``csrc/cb_coo.cu`` (memory-bound, and mostly by the partials it writes;
see the note at the top of that file) or raises; on a CPU tensor it takes
``coo_spmv_plain``. Both read the values in their stored dtype and
accumulate and emit float32.
"""
from __future__ import annotations

import torch

from repro_torch import errors
from repro_torch.core.aggregation import coord_bits
from repro_torch.core.streams import SUBLANE

from . import _build


def row_mask(block_size: int) -> int:
    """Alg. 3's row mask, generalized: ``(1 << bits) - 1``.

    NOT ``B - 1``: for non-power-of-two block sizes (e.g. B=24, bits=5)
    ``B - 1`` has holes and corrupts rows.
    """
    return (1 << coord_bits(block_size)) - 1


def coo_spmv_plain(codes: torch.Tensor, vals: torch.Tensor, xg: torch.Tensor,
                   *, block_size: int) -> torch.Tensor:
    """Plain PyTorch version: three (gc, W) arrays -> (gc, W // SUBLANE, B) float32.

    The one-hot form: ``(val * x) * onehot(row)`` summed over each slot's
    lanes in lane order.
    """
    gc, W = codes.shape
    B = block_size
    rows = (codes & row_mask(B)).reshape(gc, W // SUBLANE, SUBLANE)
    prod = (vals.float() * xg.float()).reshape(gc, W // SUBLANE, SUBLANE)
    onehot = rows[..., None] == torch.arange(B, dtype=codes.dtype, device=codes.device)
    return (prod[..., None] * onehot.float()).sum(dim=2)


def coo_spmv_batched(
    codes: torch.Tensor,  # (gc, W) int32 lane-packed coordinates
    vals: torch.Tensor,   # (gc, W) values (0 on padding lanes)
    xg: torch.Tensor,     # (gc, W) float32 pre-gathered x values
    *,
    block_size: int,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-slot partial y tiles — (gc, W // SUBLANE, B) float32.

    ``out`` (optional) is a contiguous float32 buffer of that shape to
    write into. ``coo_spmv_batched.launches`` counts kernel launches; an
    empty stream launches nothing.
    """
    gc, W = codes.shape
    if W % SUBLANE:
        raise errors.InvalidArgError(f"packed width {W} not a multiple of {SUBLANE}")
    S, B = W // SUBLANE, int(block_size)
    dev = codes.device
    _build.require(codes, "codes", dtype=torch.int32, align=16)
    _build.require(vals, "vals", dtype=tuple(_build.DTYPE_CODES), shape=(gc, W),
                   device=dev, align=16)
    _build.require(xg, "xg", dtype=torch.float32, shape=(gc, W), device=dev, align=16)
    if out is None:
        out = torch.empty((gc, S, B), dtype=torch.float32, device=dev)
    _build.require(out, "out", dtype=torch.float32, shape=(gc, S, B), device=dev)
    if gc == 0 or W == 0:
        return out
    if dev.type != "cuda":
        return out.copy_(coo_spmv_plain(codes, vals, xg, block_size=B))
    lib = _build.library()
    with _build.launch_on(dev) as stream:
        code = lib.cb_coo_spmv(
            codes.data_ptr(), vals.data_ptr(), xg.data_ptr(), out.data_ptr(), gc * S, B,
            row_mask(B), _build.DTYPE_CODES[vals.dtype], stream)
    _build.check(code, "cb_coo_spmv")
    coo_spmv_batched.launches += 1
    return out


coo_spmv_batched.launches = 0
