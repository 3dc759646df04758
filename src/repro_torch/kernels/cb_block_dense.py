"""Dense-tile CB-SpMV partials (paper Alg. 4, batched): CUDA kernel + plain version.

One stream row is a *super-tile*: ``G`` FMT_DENSE sub-blocks stacked
vertically into a ``(G*B, B)`` value slab, each multiplied by its own
pre-gathered ``(B,)`` slice of x, producing a ``(G, B)`` stack of partial
result tiles. ``ops.cb_spmv`` adds the partials into y.

``block_dense_spmv_batched`` replaces the TPU kernel of the same name in
the JAX package (``src/repro/kernels/cb_block_dense.py``). On a CUDA
tensor it launches ``csrc/cb_block_dense.cu`` (memory-bound: one pass over
the tiles; see the note at the top of that file) or raises; on a CPU
tensor it takes ``block_dense_spmv_plain``, the same arithmetic in plain
PyTorch. Both read the payload in its stored dtype (float32, bfloat16,
float64) and accumulate and emit float32.
"""
from __future__ import annotations

import torch

from . import _build


def block_dense_spmv_plain(tiles: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (gd, G*B, B) x (gd, G, B) -> (gd, G, B) float32."""
    gd, G, B = xg.shape
    return torch.einsum("gsrc,gsc->gsr",
                        tiles.reshape(gd, G, B, B).float(), xg.float())


def block_dense_spmv_batched(
    tiles: torch.Tensor,   # (gd, G*B, B) stacked super-tiles
    xg: torch.Tensor,      # (gd, G, B) float32 pre-gathered x values per slot
    *,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-slot partials for every super-tile — (gd, G, B) float32.

    ``out`` (optional) is a contiguous float32 buffer of that shape to
    write into. ``block_dense_spmv_batched.launches`` counts kernel
    launches; an empty stream launches nothing.
    """
    gd, G, B = xg.shape
    dev = tiles.device
    _build.require(tiles, "tiles", dtype=tuple(_build.DTYPE_CODES), shape=(gd, G * B, B))
    _build.require(xg, "xg", dtype=torch.float32, device=dev)
    if out is None:
        out = torch.empty((gd, G, B), dtype=torch.float32, device=dev)
    _build.require(out, "out", dtype=torch.float32, shape=(gd, G, B), device=dev)
    if gd == 0:
        return out
    if dev.type != "cuda":
        return out.copy_(block_dense_spmv_plain(tiles, xg))
    lib = _build.library()
    code = lib.cb_dense_spmv(
        tiles.data_ptr(), xg.data_ptr(), out.data_ptr(), gd * G * B, B,
        _build.DTYPE_CODES[tiles.dtype], _build.stream_ptr())
    _build.check(code, "cb_dense_spmv")
    block_dense_spmv_batched.launches += 1
    return out


block_dense_spmv_batched.launches = 0
