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
"""
from __future__ import annotations

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
    code = lib.cb_panel_spmv(
        panels.data_ptr(), xg.data_ptr(), out.data_ptr(), gp, B, W,
        _build.DTYPE_CODES[panels.dtype], _build.stream_ptr())
    _build.check(code, "cb_panel_spmv")
    panel_spmv_batched.launches += 1
    return out


panel_spmv_batched.launches = 0
