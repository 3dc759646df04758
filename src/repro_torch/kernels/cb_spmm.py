"""CB-SpMM per-slot partials (super-tile groups): CUDA kernel + plain version.

One stream row is a super-tile: ``Gt`` ``(B, B)`` weight tiles stacked
into a ``(Gt*B, B)`` slab. Slot ``g`` of group ``i`` multiplies its tile
by the X block ``Xb[bcol[i, g]]`` and yields one ``(B, N)`` partial;
``ops.cb_spmm`` adds the partials into Y by block row.

``super_tile_spmm`` replaces the TPU kernel of the same name in the JAX
package (``src/repro/kernels/cb_spmm.py``). On CUDA tensors it launches
``csrc/cb_spmm.cu`` or raises: for B > 32 a tensor-core kernel whose
products are 3xTF32 (each operand split into two TF32 halves, three
``mma.sync`` products summed in float32, float32-grade error), for
B <= 32 a float32 FMA kernel with one warp per slot; the note at the top
of that file has the design. On CPU tensors it takes
``super_tile_spmm_plain``, the same function in plain PyTorch. Both read
the tiles in their stored dtype (float32, bfloat16, float64) and X as
float32 or bfloat16, and accumulate and emit float32. Unlike the Pallas
kernel, N needs no padding to a 128-lane multiple: the kernel masks the
tail.
"""
from __future__ import annotations

import torch

from repro_torch import errors

from . import _build

X_DTYPES = (torch.float32, torch.bfloat16)
MAX_BLOCK = 128   # rows the tensor-core kernel's tile covers (csrc/cb_spmm.cu)


def super_tile_spmm_plain(tiles: torch.Tensor, bcol: torch.Tensor,
                          Xb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: -> (gt, Gt, B, N) float32."""
    gt, Gt = bcol.shape
    _, B, N = Xb.shape
    xs = Xb[bcol.reshape(-1).long()].float()                  # (gt*Gt, B, N)
    part = torch.einsum("trc,tcn->trn", tiles.reshape(gt * Gt, B, B).float(), xs)
    return part.reshape(gt, Gt, B, N)


def super_tile_spmm(
    tiles: torch.Tensor,   # (gt, Gt*B, B) stacked super-tiles
    bcol: torch.Tensor,    # (gt, Gt) int32 slot -> X block row
    Xb: torch.Tensor,      # (nb, B, N) X cut into B-row blocks
    *,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-slot partial Y tiles — (gt, Gt, B, N) float32.

    ``out`` (optional) is a contiguous float32 buffer of that shape to
    write into. ``super_tile_spmm.launches`` counts kernel launches; an
    empty stream (or N = 0) launches nothing. ``bcol`` must index blocks
    of ``Xb`` (the stream builders guarantee it; it is not read back).
    """
    gt, Gt = bcol.shape
    nb, B, N = Xb.shape
    dev = tiles.device
    _build.require(tiles, "tiles", dtype=tuple(_build.DTYPE_CODES), shape=(gt, Gt * B, B))
    _build.require(bcol, "bcol", dtype=torch.int32, device=dev)
    _build.require(Xb, "Xb", dtype=X_DTYPES, device=dev)
    if out is None:
        out = torch.empty((gt, Gt, B, N), dtype=torch.float32, device=dev)
    _build.require(out, "out", dtype=torch.float32, shape=(gt, Gt, B, N), device=dev)
    if out.numel() == 0:
        return out
    if dev.type != "cuda":
        return out.copy_(super_tile_spmm_plain(tiles, bcol, Xb))
    if B > MAX_BLOCK:
        raise errors.InvalidArgError(f"block size {B} > {MAX_BLOCK}: the kernel does not take it")
    lib = _build.library()
    with _build.launch_on(dev) as stream:
        code = lib.cb_spmm(
            tiles.data_ptr(), bcol.data_ptr(), Xb.data_ptr(), out.data_ptr(), gt * Gt, B, N,
            _build.DTYPE_CODES[tiles.dtype], _build.DTYPE_CODES[Xb.dtype], stream)
    _build.check(code, "cb_spmm")
    super_tile_spmm.launches += 1
    return out


super_tile_spmm.launches = 0
