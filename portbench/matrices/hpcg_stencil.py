"""HPCG's 27-point stencil (HPCG 3.1, GenerateProblem_ref.cpp) on one
nx x ny x nz local grid.

Grid point (ix, iy, iz) is row iz*nx*ny + iy*nx + ix. Its row holds 26 on
the diagonal and -1 for every neighbour of its 3 x 3 x 3 box that lies in
the grid, so an interior row has 27 entries and a corner row 8. The matrix
is symmetric, float32, with (3nx-2)(3ny-2)(3nz-2) non-zeros, and does not
depend on the seed, as HPCG's does not: the run's seed draws only x.
"""
from __future__ import annotations

import numpy as np

DIAGONAL, OFF_DIAGONAL = 26.0, -1.0
OFFSETS = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def _in_grid(n: int, d: int) -> np.ndarray:
    """Which of the n points along one axis have a neighbour at offset d."""
    i = np.arange(n)
    return (i + d >= 0) & (i + d < n)


def generate(params: dict, seed: int) -> dict:
    """The triplets sorted by (row, col): the offsets are taken in (dz, dy, dx)
    order, in which a row's columns rise."""
    nx, ny, nz = (int(params[k]) for k in ("nx", "ny", "nz"))
    n = nx * ny * nz
    row = np.arange(n, dtype=np.int64)
    cols = np.empty((n, len(OFFSETS)), np.int64)
    keep = np.empty((n, len(OFFSETS)), bool)
    for k, (dz, dy, dx) in enumerate(OFFSETS):
        inside = (_in_grid(nz, dz)[:, None, None] & _in_grid(ny, dy)[None, :, None]
                  & _in_grid(nx, dx)[None, None, :])
        keep[:, k] = inside.reshape(-1)
        np.add(row, dz * nx * ny + dy * nx + dx, out=cols[:, k])
    rows = np.repeat(row, keep.sum(axis=1))
    cols = cols[keep]
    vals = np.where(cols == rows, np.float32(DIAGONAL), np.float32(OFF_DIAGONAL))
    return {"rows": rows, "cols": cols, "vals": vals, "shape": (n, n)}
