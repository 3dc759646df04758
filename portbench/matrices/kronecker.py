"""Graph500's Kronecker graph (kronecker_generator.m), symmetrised and weighted.

SCALE levels of the 2 x 2 initiator [[A, B], [C, 1 - A - B - C]] draw
edgefactor * 2**SCALE directed edges; the vertex labels are permuted. Here
self-loops are dropped, each edge is stored in both directions and
duplicates are collapsed, so the matrix is the symmetric adjacency matrix.
Each undirected edge gets one weight, uniform in [0, 1), as Graph500's SSSP
kernel draws them. The edge set is drawn from the configuration's structure
seed; the run's seed draws the labels' permutation and the weights, so every
seed gives the same sizes in another order.
"""
from __future__ import annotations

import numpy as np


def edges(scale: int, edgefactor: int, A: float, B: float, C: float,
          rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """The generator's directed edge list (start, end), before any relabelling.

    Each level picks one quadrant of the initiator for every edge: (0, 0)
    with probability A, (0, 1) with B, (1, 0) with C, (1, 1) with the rest.
    The reference draws the row bit and then the column bit given it; one
    uniform per level and edge gives the same joint distribution. The
    level loop reuses its buffers: a fresh array per level costs more in
    page faults than in arithmetic.
    """
    M = edgefactor << scale
    idx = np.int32 if scale < 31 else np.int64
    i = np.zeros(M, dtype=idx)
    j = np.zeros(M, dtype=idx)
    u = np.empty(M, dtype=np.float32)
    bit = np.empty(M, dtype=bool)
    jbit = np.empty(M, dtype=bool)
    t = np.empty(M, dtype=idx)
    a, ab, abc = np.float32(A), np.float32(A + B), np.float32(A + B + C)
    for level in range(scale):
        rng.random(dtype=np.float32, out=u)
        np.greater_equal(u, ab, out=bit)              # row bit: quadrant (1, *)
        np.copyto(t, bit, casting="unsafe")
        np.left_shift(t, level, out=t)
        np.bitwise_or(i, t, out=i)
        # column bit: u in [A, A+B) or u >= A+B+C, i.e. [u>=A] ^ [u>=A+B] ^ [u>=A+B+C]
        np.greater_equal(u, a, out=jbit)
        np.bitwise_xor(jbit, bit, out=jbit)
        np.greater_equal(u, abc, out=bit)
        np.bitwise_xor(jbit, bit, out=jbit)
        np.copyto(t, jbit, casting="unsafe")
        np.left_shift(t, level, out=t)
        np.bitwise_or(j, t, out=j)
    return i, j


def generate(params: dict, seed: int) -> dict:
    """The graph's edges come from ``params["structure_seed"]``, the same in
    every run, as Graph500's reference generator fixes its seed; the run's
    seed draws the vertex labels' permutation and the weights."""
    scale = int(params["scale"])
    N = 1 << scale
    i, j = edges(scale, int(params["edgefactor"]), float(params["A"]), float(params["B"]),
                 float(params["C"]), np.random.default_rng(int(params["structure_seed"])))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(N)
    keep = i != j
    i, j = perm[i[keep]], perm[j[keep]]
    lo = np.minimum(i, j)
    hi = np.maximum(i, j)
    key = np.unique(lo * N + hi)
    lo, hi = key // N, key % N
    w = rng.random(key.size, dtype=np.float32)
    rows = np.concatenate([lo, hi])
    cols = np.concatenate([hi, lo])
    vals = np.concatenate([w, w])
    return {"rows": rows, "cols": cols, "vals": vals, "shape": (N, N)}
