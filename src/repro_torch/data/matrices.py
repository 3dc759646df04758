"""Synthetic sparse-matrix corpus generator.

The paper evaluates on 2,843 SuiteSparse matrices. Offline we reproduce the
*structural families* that collection spans — uniform random, power-law
(graph-like), banded/FEM-like, block-clustered, and diagonal-dominant —
so every benchmark sweeps matrices whose block-nnz distributions match the
paper's Fig. 3 regimes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import errors


@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    name: str
    family: str
    m: int
    n: int
    params: tuple = ()


def _dedup(rows, cols, m, n, rng, vals=None):
    key = rows.astype(np.int64) * n + cols
    _, idx = np.unique(key, return_index=True)
    rows, cols = rows[idx], cols[idx]
    if vals is None:
        vals = rng.standard_normal(len(rows)).astype(np.float64)
    else:
        vals = vals[idx]
    return rows.astype(np.int64), cols.astype(np.int64), vals


def uniform_random(m, n, density, seed=0):
    """Uniformly scattered non-zeros — the super-sparse COO regime."""
    rng = np.random.default_rng(seed)
    nnz = max(1, int(m * n * density))
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    return _dedup(rows, cols, m, n, rng)


def power_law(m, n, avg_deg=8, alpha=2.1, seed=0):
    """Graph-like rows: degree ~ Zipf; hub rows create dense blocks +
    extreme TB load imbalance (the Fig. 4 regime)."""
    rng = np.random.default_rng(seed)
    deg = rng.zipf(alpha, size=m).astype(np.int64)
    deg = np.minimum(deg * avg_deg // 2 + 1, n)
    rows = np.repeat(np.arange(m, dtype=np.int64), deg)
    # column popularity is itself power-law (preferential attachment)
    popularity = (1.0 / np.arange(1, n + 1)) ** 0.7
    popularity /= popularity.sum()
    cols = rng.choice(n, size=len(rows), p=popularity)
    return _dedup(rows, cols, m, n, rng)


def banded(m, n, bandwidth=9, fill=0.7, seed=0):
    """FEM/stencil-like band matrix — contiguous blocks, CSR/Dense regime."""
    rng = np.random.default_rng(seed)
    offs = np.arange(-(bandwidth // 2), bandwidth // 2 + 1)
    rows = np.repeat(np.arange(m, dtype=np.int64), len(offs))
    cols = rows + np.tile(offs, m)
    keep = (cols >= 0) & (cols < n) & (rng.random(len(rows)) < fill)
    return _dedup(rows[keep], cols[keep], m, n, rng)


def block_clustered(m, n, cluster=48, clusters_per_row=3, density=0.85, seed=0):
    """Dense clusters scattered on a sparse background (mixed regimes —
    the torso1/exdata_1 style matrices the paper's ablation highlights)."""
    rng = np.random.default_rng(seed)
    rows_l, cols_l = [], []
    n_row_clusters = max(1, m // cluster)
    for rc in range(n_row_clusters):
        r0 = rc * cluster
        for _ in range(clusters_per_row):
            c0 = int(rng.integers(0, max(1, n - cluster)))
            mask = rng.random((min(cluster, m - r0), cluster)) < density
            rr, cc = np.nonzero(mask)
            rows_l.append(r0 + rr)
            cols_l.append(c0 + cc)
    # sparse background
    bg = max(1, int(0.0005 * m * n))
    rows_l.append(rng.integers(0, m, bg))
    cols_l.append(rng.integers(0, n, bg))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    return _dedup(rows, cols, m, n, rng)


def diagonal_dominant(m, n, extra_density=0.001, seed=0):
    rng = np.random.default_rng(seed)
    d = min(m, n)
    rows = [np.arange(d, dtype=np.int64)]
    cols = [np.arange(d, dtype=np.int64)]
    nnz = max(1, int(m * n * extra_density))
    rows.append(rng.integers(0, m, nnz))
    cols.append(rng.integers(0, n, nnz))
    return _dedup(np.concatenate(rows), np.concatenate(cols), m, n, rng)


def pruned_weight(m, n, block_size=16, block_sparsity=0.85, seed=0):
    """Magnitude-pruned NN weight style: whole blocks zeroed, survivors
    dense-ish — the regime a block-sparse linear layer sees."""
    rng = np.random.default_rng(seed)
    mb, nb = -(-m // block_size), -(-n // block_size)
    alive = rng.random((mb, nb)) > block_sparsity
    rr, cc = np.nonzero(alive)
    rows_l, cols_l = [], []
    for r0, c0 in zip(rr, cc):
        h = min(block_size, m - r0 * block_size)
        w = min(block_size, n - c0 * block_size)
        mask = rng.random((h, w)) < 0.6
        lr, lc = np.nonzero(mask)
        rows_l.append(r0 * block_size + lr)
        cols_l.append(c0 * block_size + lc)
    if not rows_l:
        rows_l, cols_l = [np.zeros(1, np.int64)], [np.zeros(1, np.int64)]
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    return _dedup(rows, cols, m, n, rng)


# ---------------------------------------------------------------------------
# MatrixMarket ingestion — real SuiteSparse matrices alongside the
# synthetic corpus.
# ---------------------------------------------------------------------------

_MM_FIELDS = {"real", "integer", "pattern"}
_MM_SYMMETRIES = {"general", "symmetric", "skew-symmetric"}


def load_matrix_market(path):
    """Parse a MatrixMarket ``.mtx`` file into ``(rows, cols, vals, shape)``.

    Supports the ``matrix coordinate`` object/format with ``real`` /
    ``integer`` / ``pattern`` fields (pattern entries get unit values) and
    ``general`` / ``symmetric`` / ``skew-symmetric`` storage — symmetric
    variants are expanded to the full element set (off-diagonal entries
    mirrored; negated for skew). Indices come back 0-based int64, values
    float64 — ready for ``CBMatrix.from_coo``. ``complex`` fields and
    ``array`` (dense) format raise ``errors.IngestError`` (a
    ``ValueError``), as do truncated/malformed entry lines, absurd size
    lines, and non-finite values. Duplicate coordinates are merged by
    summation — the same canonicalization ``CBMatrix.from_coo`` applies.
    """
    def bad(msg):
        return errors.IngestError(
            errors.reason(errors.INGEST_INVALID, f"{path}: {msg}"))

    with open(path) as f:
        header = f.readline().split()
        if len(header) != 5 or header[0] != "%%MatrixMarket":
            raise bad("not a MatrixMarket file")
        obj, fmt, field, symmetry = (tok.lower() for tok in header[1:])
        if obj != "matrix" or fmt != "coordinate":
            raise bad(f"only 'matrix coordinate' supported, got '{obj} {fmt}'")
        if field not in _MM_FIELDS:
            raise bad(f"unsupported field '{field}'")
        if symmetry not in _MM_SYMMETRIES:
            raise bad(f"unsupported symmetry '{symmetry}'")
        line = f.readline()
        while line and line.lstrip().startswith("%"):
            line = f.readline()
        dims = line.split()
        if len(dims) != 3:
            raise bad(f"malformed size line {line!r}")
        try:
            m, n, nnz = (int(t) for t in dims)
        except ValueError:
            raise bad(f"malformed size line {line!r} (non-integer dims)")
        if m < 1 or n < 1 or nnz < 0:
            raise bad(f"malformed size line {line!r} (absurd dimensions)")
        try:
            data = np.loadtxt(f, ndmin=2, dtype=np.float64)
        except ValueError as e:
            raise bad(f"malformed entry line ({e})")
    if data.size == 0:
        data = np.zeros((0, 2 if field == "pattern" else 3))
    if len(data) != nnz:
        raise bad(f"header promises {nnz} entries, found {len(data)}")
    rows = data[:, 0].astype(np.int64) - 1
    cols = data[:, 1].astype(np.int64) - 1
    if field == "pattern":
        vals = np.ones(len(rows), np.float64)
    else:
        if data.shape[1] < 3:
            raise bad(f"'{field}' entries need a value column")
        vals = data[:, 2]
    if not np.all(np.isfinite(vals)):
        raise bad("non-finite value entries (NaN/Inf)")
    if rows.size and (
        rows.min() < 0 or rows.max() >= m or cols.min() < 0 or cols.max() >= n
    ):
        raise bad(f"coordinate out of bounds for {m}x{n}")
    if symmetry != "general":
        off = rows != cols
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        rows, cols, vals = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, sign * vals[off]]),
        )
    key = rows * n + cols
    uniq, inv = np.unique(key, return_inverse=True)
    if len(uniq) != len(key):
        # dedup-sum, preserving nothing but the canonical (row, col) order
        # — only taken when duplicates actually exist, so duplicate-free
        # files keep their on-disk entry order.
        summed = np.zeros(len(uniq), vals.dtype)
        np.add.at(summed, inv, vals)
        rows, cols, vals = uniq // n, uniq % n, summed
    return rows, cols, vals, (m, n)


FAMILIES = {
    "uniform": uniform_random,
    "power_law": power_law,
    "banded": banded,
    "block_clustered": block_clustered,
    "diag": diagonal_dominant,
    "pruned": pruned_weight,
}


def corpus(scale: str = "small", seed: int = 0):
    """Yield (MatrixSpec, rows, cols, vals, shape) across all families.

    scale='small' keeps preprocessing CPU-cheap for tests; 'bench' matches
    the paper's >=1e5-nnz representative-matrix regime.
    """
    if scale == "small":
        sizes = [(256, 256), (400, 320), (1024, 1024)]
    elif scale == "bench":
        sizes = [(4096, 4096), (8192, 8192), (16384, 16384)]
    else:
        raise errors.InvalidArgError(scale)
    out = []
    i = 0
    for m, n in sizes:
        for fam, fn in FAMILIES.items():
            if fam == "uniform":
                r, c, v = fn(m, n, density=0.002, seed=seed + i)
            else:
                r, c, v = fn(m, n, seed=seed + i)
            out.append((MatrixSpec(f"{fam}_{m}x{n}", fam, m, n), r, c, v, (m, n)))
            i += 1
    return out
