"""HPCG's SpMV on its 27-point stencil in plain PyTorch, from the grid alone.

x is laid out as HPCG lays it, row iz*nx*ny + iy*nx + ix, so it reshapes to
(nz, ny, nx). y is 26 x minus the sum of each point's in-grid neighbours of
its 3 x 3 x 3 box: 27 shifted slices of x padded with one layer of zeros,
in float64. It reads no triplets, so it checks the benchmark's generator as
well as its COO reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

DIAGONAL = 26.0


def matvec(x: torch.Tensor, nx: int, ny: int, nz: int) -> torch.Tensor:
    """y = A x for HPCG's stencil on an nx x ny x nz grid, in float64."""
    g = x.to(torch.float64).reshape(nz, ny, nx)
    p = F.pad(g, (1, 1, 1, 1, 1, 1))
    box = torch.zeros_like(g)
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                box += p[dz:dz + nz, dy:dy + ny, dx:dx + nx]
    return ((DIAGONAL + 1.0) * g - box).reshape(-1)
