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
package (``src/repro/kernels/cb_coo.py``), which takes x pre-gathered
through ``xidx``; this one takes ``xidx`` and x and reads ``x[xidx]``
inside the kernel, so the gathered stream is never written. On a CUDA
tensor it launches ``csrc/cb_coo.cu`` (memory-bound by its streams; see
the note at the top of that file) or raises; on a CPU tensor it takes
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


def coo_spmv_plain(codes: torch.Tensor, vals: torch.Tensor, xidx: torch.Tensor,
                   x: torch.Tensor, *, block_size: int) -> torch.Tensor:
    """Plain PyTorch version: (gc, W) codes, values and x indices and the (n,)
    x -> (gc, W // SUBLANE, B) float32.

    The one-hot form: ``(val * x[xidx]) * onehot(row)`` summed over each
    slot's lanes in lane order.
    """
    gc, W = codes.shape
    B = block_size
    rows = (codes & row_mask(B)).reshape(gc, W // SUBLANE, SUBLANE)
    xg = x.float()[xidx.long()]
    prod = (vals.float() * xg).reshape(gc, W // SUBLANE, SUBLANE)
    onehot = rows[..., None] == torch.arange(B, dtype=codes.dtype, device=codes.device)
    return (prod[..., None] * onehot.float()).sum(dim=2)


def coo_spmv_batched(
    codes: torch.Tensor,  # (gc, W) int32 lane-packed coordinates
    vals: torch.Tensor,   # (gc, W) values (0 on padding lanes)
    xidx: torch.Tensor,   # (gc, W) int32 indices into x (0 on padding lanes)
    x: torch.Tensor,      # (n,) float32
    *,
    block_size: int,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-slot partial y tiles — (gc, W // SUBLANE, B) float32.

    ``out`` (optional) is a contiguous float32 buffer of that shape to
    write into. ``coo_spmv_batched.launches`` counts kernel launches; an
    empty stream launches nothing. Every index must lie in ``[0, n)``: the
    kernel stops the device on one that does not (the plain version raises).
    """
    gc, W = codes.shape
    if W % SUBLANE:
        raise errors.InvalidArgError(f"packed width {W} not a multiple of {SUBLANE}")
    S, B = W // SUBLANE, int(block_size)
    dev = codes.device
    _build.require(codes, "codes", dtype=torch.int32, align=16)
    _build.require(vals, "vals", dtype=tuple(_build.DTYPE_CODES), shape=(gc, W),
                   device=dev, align=16)
    _build.require(xidx, "xidx", dtype=torch.int32, shape=(gc, W), device=dev, align=16)
    _build.require(x, "x", dtype=torch.float32, device=dev)
    if x.ndim != 1:
        raise errors.InvalidArgError(f"x: shape {tuple(x.shape)}, expected (n,)")
    if out is None:
        out = torch.empty((gc, S, B), dtype=torch.float32, device=dev)
    _build.require(out, "out", dtype=torch.float32, shape=(gc, S, B), device=dev)
    if gc == 0 or W == 0:
        return out
    if x.numel() == 0:
        raise errors.InvalidArgError("x is empty but the stream has lanes to read it")
    if dev.type != "cuda":
        return out.copy_(coo_spmv_plain(codes, vals, xidx, x, block_size=B))
    lib = _build.library()
    with _build.launch_on(dev) as stream:
        code = lib.cb_coo_spmv(
            codes.data_ptr(), vals.data_ptr(), xidx.data_ptr(), x.data_ptr(), out.data_ptr(),
            gc * S, x.numel(), B, row_mask(B), _build.DTYPE_CODES[vals.dtype], stream)
    _build.check(code, "cb_coo_spmv")
    coo_spmv_batched.launches += 1
    return out


coo_spmv_batched.launches = 0
