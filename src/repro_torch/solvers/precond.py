"""Preconditioners extracted from the CB block structure (plan time).

The CB format already materializes the diagonal sub-blocks as tiles —
block-Jacobi preconditioning is therefore free structure reuse: decode the
matrix once at plan time (``CBMatrix.global_elements``), keep every entry
whose *global* column lands inside its own block-row's diagonal window,
and invert the resulting (B, B) diagonal blocks with numpy in float64.
The apply path is one batched (mb, B, B) x (mb, B) product per iteration
on the device.

Rows whose diagonal block row is entirely zero get an identity row so the
block stays invertible (any nonsingular M is a valid preconditioner; for
those rows M acts as the identity).

Each preconditioner lives on one device (``device=None`` means CUDA, as
everywhere in the port); ``from_numpy`` takes the JAX package's arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.cb_matrix import CBMatrix
from repro_torch.core.streams import resolve_device


def _tensor(arr, device) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, np.float32)).to(resolve_device(device))


@dataclasses.dataclass
class IdentityPreconditioner:
    """M = I — the no-preconditioning baseline."""

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return r


@dataclasses.dataclass
class JacobiPreconditioner:
    """M^-1 = diag(A)^-1 (point Jacobi)."""

    inv_diag: torch.Tensor  # (m,)

    @classmethod
    def from_numpy(cls, inv_diag, *, device=None) -> "JacobiPreconditioner":
        return cls(inv_diag=_tensor(inv_diag, device))

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return self.inv_diag * r


@dataclasses.dataclass
class BlockJacobiPreconditioner:
    """M^-1 = blockdiag(A)^-1 at the CB block size."""

    m: int
    block_size: int
    inv_blocks: torch.Tensor  # (mb, B, B)

    @classmethod
    def from_numpy(cls, m: int, block_size: int, inv_blocks, *,
                   device=None) -> "BlockJacobiPreconditioner":
        return cls(m=int(m), block_size=int(block_size),
                   inv_blocks=_tensor(inv_blocks, device))

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        B = self.block_size
        mb = self.inv_blocks.shape[0]
        rp = torch.nn.functional.pad(r, (0, mb * B - r.shape[0])).view(mb, B, 1)
        y = torch.bmm(self.inv_blocks.to(rp.dtype), rp)
        return y.view(-1)[: self.m]


def _diag_blocks(cb: CBMatrix) -> np.ndarray:
    """The (mb, B, B) float64 block-diagonal of A, from one whole-matrix decode.

    Works in *global* column coordinates, so the extraction is right
    whether or not column aggregation moved the diagonal entries into
    other compacted block columns. Coordinates are unique, so placing the
    entries equals the JAX package's ``np.add.at`` into zeros; the final
    ``+= 0.0`` turns a stored -0.0 into +0.0 as that addition does.
    """
    B = cb.block_size
    mb = -(-cb.shape[0] // B)
    D = np.zeros((mb, B, B), np.float64)
    r, c, v = cb.global_elements()
    brow = r // B
    lo = brow * B
    sel = (c >= lo) & (c < lo + B)
    D[brow[sel], (r - lo)[sel], (c - lo)[sel]] = v[sel].astype(np.float64)
    D += 0.0
    return D


def _jacobi_from_diag(D: np.ndarray, m: int, device) -> JacobiPreconditioner:
    diag = np.einsum("bii->bi", D).reshape(-1)[:m]
    inv = np.where(diag != 0.0, 1.0 / np.where(diag != 0.0, diag, 1.0), 1.0)
    return JacobiPreconditioner.from_numpy(inv, device=device)


def _block_jacobi_from_diag(D: np.ndarray, m: int, block_size: int,
                            device) -> BlockJacobiPreconditioner:
    # Identity rows where the block row is entirely zero (incl. the ragged
    # padding rows of the last block) keep every block invertible.
    D = D.copy()
    dead = ~np.any(D != 0.0, axis=2)  # (mb, B)
    bidx, ridx = np.nonzero(dead)
    D[bidx, ridx, ridx] = 1.0
    try:
        inv = np.linalg.inv(D)
    except np.linalg.LinAlgError:
        inv = np.stack([np.linalg.pinv(blk) for blk in D])
    return BlockJacobiPreconditioner.from_numpy(m, block_size, inv, device=device)


def jacobi(cb: CBMatrix, *, device=None) -> JacobiPreconditioner:
    """Point-Jacobi from the CB diagonal (zero diagonals act as identity)."""
    return _jacobi_from_diag(_diag_blocks(cb), cb.shape[0], device)


def block_jacobi(cb: CBMatrix, *, device=None) -> BlockJacobiPreconditioner:
    """Block-Jacobi from the materialized CB diagonal tiles."""
    return _block_jacobi_from_diag(_diag_blocks(cb), cb.shape[0], cb.block_size, device)


# ---------------------------------------------------------------------------
# Dynamic-sparsity path: re-invert only the diagonal payloads.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class DiagScatter:
    """Pattern-derived map: canonical values -> (mb, B, B) block diagonal.

    Which canonical elements land in the block diagonal — and where — is
    pure structure, so it is recorded once (``diag_scatter``) and a value
    update only scatters fresh payloads and re-inverts: no decode
    re-runs. ``jacobi``/``block_jacobi`` on the updated values are
    bit-identical to rebuilding the preconditioner from
    ``cb.update_values(vals)``.
    """

    m: int
    block_size: int
    mb: int
    val_dtype: np.dtype
    flat_idx: np.ndarray   # (k,) int64 — flat index into (mb, B, B)
    src: np.ndarray        # (k,) int64 — canonical value index

    def _diag(self, canonical_vals) -> np.ndarray:
        B = self.block_size
        vals = np.ascontiguousarray(canonical_vals, self.val_dtype)
        D = np.zeros((self.mb, B, B), np.float64)
        D.reshape(-1)[self.flat_idx] = vals[self.src].astype(np.float64)
        return D

    def jacobi(self, canonical_vals, *, device=None) -> JacobiPreconditioner:
        """Point-Jacobi for fresh canonical values (structure reused)."""
        return _jacobi_from_diag(self._diag(canonical_vals), self.m, device)

    def block_jacobi(self, canonical_vals, *, device=None) -> BlockJacobiPreconditioner:
        """Block-Jacobi for fresh canonical values (re-inversion only)."""
        return _block_jacobi_from_diag(self._diag(canonical_vals), self.m,
                                       self.block_size, device)


def diag_scatter(cb: CBMatrix) -> DiagScatter:
    """Record once which canonical elements feed the block diagonal.

    Derived straight from the value layout's global (row, col) keys —
    coordinates are unique after CB canonicalization, so the scatter is
    a plain assignment.
    """
    layout = cb.value_layout()
    B = cb.block_size
    m, n = cb.shape
    mb = -(-m // B)
    r_g = layout.keys // n
    c_g = layout.keys % n
    brow = r_g // B
    lo = brow * B
    sel = (c_g >= lo) & (c_g < lo + B)
    src = np.flatnonzero(sel)
    flat = ((brow[sel] * B + (r_g[sel] - lo[sel])) * B + (c_g[sel] - lo[sel]))
    return DiagScatter(
        m=m, block_size=B, mb=mb, val_dtype=np.dtype(cb.val_dtype),
        flat_idx=flat.astype(np.int64), src=src.astype(np.int64),
    )
