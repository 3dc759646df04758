"""Cheap per-matrix feature extraction for the autotune cost model.

The paper's adaptivity levers — block size, th1/th2 format thresholds,
the th0 column-aggregation gate, and the batched engines' group size —
all key off *block-granular* statistics of the sparsity pattern. One
pass of vectorized numpy over the COO triplets yields, for every
candidate block size at once:

  * the per-block nnz distribution (drives format selection and the
    Alg. 2 balance story),
  * the per-block distinct-column count (the compacted panel width a
    FMT_CSR block would stream — exact, because ``_collect_blocks``
    packs exactly the unique columns),
  * per-panel (block-row) nonzero-column counts and nnz (the column-
    aggregation win estimate: a compacted panel spans
    ``ceil(cols / B)`` blocks instead of ``ceil(n / B)``),
  * the super-sparse fraction (the th0 gate input, paper Fig. 3).

Matrix-level scalars (nnz/row moments, bandwidth) ride along for
diagnostics and future learned selectors (PAPERS.md: the nonlinear-hash
SpMV work conditions on exactly these). Everything here is
O(nnz log nnz) host-side numpy — no kernels, no device, no wall clock,
so features (and everything derived from them in heuristic mode) are
bit-deterministic for a given matrix. The port of
``repro.autotune.features``, feature for feature.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.formats import super_sparse_fraction

# The block sizes the planner considers: the paper's 16 plus the
# neighbors the conformance grid already certifies.
CANDIDATE_BLOCK_SIZES = (8, 16, 24)


@dataclasses.dataclass
class BlockProfile:
    """Block-granular statistics of one matrix at one block size."""

    block_size: int
    num_blocks: int                 # nonzero B x B blocks
    nnz_per_block: np.ndarray       # (num_blocks,) int64
    cols_per_block: np.ndarray      # (num_blocks,) int64 distinct columns
    panel_nnz: np.ndarray           # (num_panels,) int64, nonempty panels
    panel_cols: np.ndarray          # (num_panels,) int64 distinct nonzero cols
    super_sparse_fraction: float    # th0 gate input


@dataclasses.dataclass
class MatrixFeatures:
    """Everything the cost model needs to rank candidate plans."""

    shape: tuple[int, int]
    nnz: int
    density: float
    row_nnz_mean: float
    row_nnz_cv: float               # std/mean — load-imbalance proxy (Fig. 4)
    row_nnz_max: int
    bandwidth_mean: float           # mean |r - c| — locality proxy
    bandwidth_max: int
    profiles: dict[int, BlockProfile]

    def profile(self, block_size: int) -> BlockProfile:
        prof = self.profiles.get(int(block_size))
        if prof is None:
            raise KeyError(
                f"no block profile for B={block_size}; extracted sizes: "
                f"{sorted(self.profiles)}"
            )
        return prof


def _block_profile(rows, cols, shape, block_size: int) -> BlockProfile:
    B = block_size
    nb = -(-shape[1] // B)
    bkey = (rows // B) * np.int64(nb) + cols // B

    ukeys, counts = np.unique(bkey, return_counts=True)
    # distinct columns per block: unique (block, col) pairs, counted per block
    ckey = bkey * np.int64(shape[1]) + cols
    ublocks_of_cols = np.unique(ckey) // np.int64(shape[1])
    _, col_counts = np.unique(ublocks_of_cols, return_counts=True)

    # per-panel (block-row) nnz and distinct nonzero columns
    prow = rows // B
    upanels, pnnz = np.unique(prow, return_counts=True)
    pckey = prow * np.int64(shape[1]) + cols
    upanel_of_cols = np.unique(pckey) // np.int64(shape[1])
    _, pcols = np.unique(upanel_of_cols, return_counts=True)

    return BlockProfile(
        block_size=B,
        num_blocks=len(ukeys),
        nnz_per_block=counts.astype(np.int64),
        cols_per_block=col_counts.astype(np.int64),
        panel_nnz=pnnz.astype(np.int64),
        panel_cols=pcols.astype(np.int64),
        super_sparse_fraction=super_sparse_fraction(counts, B),
    )


def extract_features(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: tuple[int, int],
    block_sizes: tuple[int, ...] = CANDIDATE_BLOCK_SIZES,
) -> MatrixFeatures:
    """One vectorized pass -> features at every candidate block size."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    m, n = int(shape[0]), int(shape[1])
    nnz = len(rows)

    if nnz:
        row_counts = np.bincount(rows, minlength=m).astype(np.int64)
        nz_rows = row_counts[row_counts > 0]
        band = np.abs(rows - cols)
        row_mean = float(nz_rows.mean())
        row_cv = float(nz_rows.std() / max(row_mean, 1e-12))
        row_max = int(nz_rows.max())
        band_mean, band_max = float(band.mean()), int(band.max())
    else:
        row_mean = row_cv = band_mean = 0.0
        row_max = band_max = 0

    return MatrixFeatures(
        shape=(m, n),
        nnz=nnz,
        density=nnz / max(1, m * n),
        row_nnz_mean=row_mean,
        row_nnz_cv=row_cv,
        row_nnz_max=row_max,
        bandwidth_mean=band_mean,
        bandwidth_max=band_max,
        profiles={int(B): _block_profile(rows, cols, (m, n), int(B))
                  for B in block_sizes},
    )


def feature_vector(features: MatrixFeatures) -> dict:
    """Flatten ``MatrixFeatures`` to an ordered ``{name: scalar}`` dict.

    The stable, named scalar view (the "why this plan" report of the
    JAX package's ``scripts/explain.py``, and the input row of a
    learned selector): matrix-level moments first, then per
    candidate block size the distribution summaries of the block
    profile. Deterministic for a given matrix — pure arithmetic over
    :func:`extract_features` output, no wall clock.
    """
    m, n = features.shape
    out = {
        "m": float(m),
        "n": float(n),
        "nnz": float(features.nnz),
        "density": float(features.density),
        "row_nnz_mean": float(features.row_nnz_mean),
        "row_nnz_cv": float(features.row_nnz_cv),
        "row_nnz_max": float(features.row_nnz_max),
        "bandwidth_mean": float(features.bandwidth_mean),
        "bandwidth_max": float(features.bandwidth_max),
    }
    for B in sorted(features.profiles):
        prof = features.profiles[B]
        tag = f"b{B}"
        nnz_blk = prof.nnz_per_block
        cols_blk = prof.cols_per_block
        out[f"{tag}_num_blocks"] = float(prof.num_blocks)
        out[f"{tag}_nnz_per_block_mean"] = (
            float(nnz_blk.mean()) if len(nnz_blk) else 0.0)
        out[f"{tag}_nnz_per_block_max"] = (
            float(nnz_blk.max()) if len(nnz_blk) else 0.0)
        out[f"{tag}_block_fill_mean"] = (
            float(nnz_blk.mean()) / (B * B) if len(nnz_blk) else 0.0)
        out[f"{tag}_cols_per_block_mean"] = (
            float(cols_blk.mean()) if len(cols_blk) else 0.0)
        out[f"{tag}_num_panels"] = float(len(prof.panel_nnz))
        out[f"{tag}_panel_cols_mean"] = (
            float(prof.panel_cols.mean()) if len(prof.panel_cols) else 0.0)
        out[f"{tag}_super_sparse_fraction"] = float(
            prof.super_sparse_fraction)
    return out


def features_from_cb(cb) -> MatrixFeatures:
    """Features of an already-built ``CBMatrix`` (original coordinates).

    Folds column aggregation back via ``CBMatrix.to_coo`` so the planner
    sees the same matrix ``from_coo`` was given, then profiles every
    candidate block size — the plan may well move away from the build's
    current one.
    """
    rows, cols, vals = cb.to_coo()
    return extract_features(rows, cols, vals, cb.shape)
