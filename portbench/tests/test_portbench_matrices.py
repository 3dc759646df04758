"""The benchmark's own matrix generator: Graph500's Kronecker graph."""
import numpy as np
import pytest

import pb_common  # noqa: F401
from harness import spec

kronecker = spec.module("matrices", "kronecker")


PARAMS = {"scale": 10, "edgefactor": 16, "A": 0.57, "B": 0.19, "C": 0.19, "structure_seed": 1}


def test_kronecker_same_seed_same_graph():
    a = kronecker.generate(PARAMS, seed=2**31 + 5)
    b = kronecker.generate(PARAMS, seed=2**31 + 5)
    assert all(np.array_equal(a[k], b[k]) for k in ("rows", "cols", "vals"))


def _degrees(g):
    return np.sort(np.bincount(g["rows"], minlength=g["shape"][0]))


def test_kronecker_seeds_relabel_one_graph():
    """Another run seed: the same edge set under other labels, other weights."""
    a = kronecker.generate(PARAMS, seed=2**31 + 5)
    c = kronecker.generate(PARAMS, seed=2**31 + 6)
    assert a["rows"].size == c["rows"].size
    assert np.array_equal(_degrees(a), _degrees(c))
    assert not np.array_equal(a["rows"], c["rows"])
    d = kronecker.generate({**PARAMS, "structure_seed": 2}, seed=2**31 + 5)
    assert not np.array_equal(_degrees(a), _degrees(d))


def test_kronecker_symmetric_no_self_loops_no_duplicates():
    g = kronecker.generate(PARAMS, seed=7)
    r, c, v = g["rows"], g["cols"], g["vals"]
    N = 1 << PARAMS["scale"]
    assert g["shape"] == (N, N)
    assert not np.any(r == c)
    key = r * N + c
    assert np.unique(key).size == key.size
    fwd = dict(zip(key.tolist(), v.tolist()))
    assert all(fwd[cc * N + rr] == vv for rr, cc, vv in zip(r.tolist(), c.tolist(), v.tolist()))
    assert v.dtype == np.float32 and v.min() >= 0.0 and v.max() < 1.0
    # edgefactor 16: about 16 N undirected edges drawn, fewer after collapsing
    assert 8 * N < r.size < 32 * N


def test_kronecker_degrees_are_skewed():
    g = kronecker.generate(PARAMS, seed=3)
    deg = np.bincount(g["rows"], minlength=1 << PARAMS["scale"])
    assert deg.max() > 20 * deg.mean()


def test_kronecker_quadrants_follow_the_initiator():
    rng = np.random.default_rng(11)
    i, j = kronecker.edges(1, 200_000, 0.57, 0.19, 0.19, rng)
    freq = np.sort(np.bincount(i * 2 + j, minlength=4) / i.size)[::-1]
    np.testing.assert_allclose(freq, [0.57, 0.19, 0.19, 0.05], atol=0.005)
