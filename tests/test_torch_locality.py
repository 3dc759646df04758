"""The port's locality profiler (``repro_torch.obs.locality``) against the
JAX package's (``repro.obs.locality``).

The reuse-distance engine on the adversarial streams of
``tests/test_locality.py`` (equal distances, and hits equal to a brute-force
LRU), then the access streams the port derives from its own super-block and
super-tile streams over the conformance scenarios: the same line ids, the
same reuse profiles and the same ``stream_stats`` at the JAX package's cache
sizes and at the H100's 50 MB L2.
"""
from collections import OrderedDict

import numpy as np
import pytest

from repro.core import streams as jstreams
from repro.obs import locality as jloc
from repro_torch import errors as terrors
from repro_torch.core import streams as tstreams
from repro_torch.obs import locality as tloc

import torch_port as tp

H100_L2_BYTES = 50 * 1024 * 1024


def brute_lru_hits(stream, capacity: int) -> int:
    cache: OrderedDict = OrderedDict()
    hits = 0
    for line in stream:
        if line in cache:
            cache.move_to_end(line)
            hits += 1
        else:
            cache[line] = None
            if len(cache) > capacity:
                cache.popitem(last=False)
    return hits


def _adversarial():
    rng = np.random.default_rng(7)
    C = 64
    return {
        "streaming": np.arange(500),
        "cyclic_fits": np.tile(np.arange(C - 1), 6),
        "cyclic_thrash": np.tile(np.arange(C + 1), 6),
        "blocked": np.repeat(np.arange(40), 9),
        "boundary_hit": np.r_[np.arange(C), 0],
        "boundary_miss": np.r_[np.arange(C + 1), 0],
        "random_small": rng.integers(0, 10, 400),
        "random_wide": rng.integers(0, 5000, 3000),
        "zipf": rng.zipf(1.5, 2000) % 499,
        "single": np.zeros(100, np.int64),
        "one": np.array([42]),
        "interleave": np.arange(600) % 3 * 1000 + np.arange(600) // 3,
    }


ADVERSARIAL = _adversarial()


@pytest.mark.parametrize("name", sorted(ADVERSARIAL))
def test_engine_equal_to_repro_and_brute_force(name):
    stream = ADVERSARIAL[name]
    np.testing.assert_array_equal(tloc.reuse_distances(stream), jloc.reuse_distances(stream))
    prof, jprof = tloc.reuse_profile(stream), jloc.reuse_profile(stream)
    assert (prof.accesses, prof.collapsed_accesses, prof.unique_lines) == \
        (jprof.accesses, jprof.collapsed_accesses, jprof.unique_lines)
    for cap in (1, 2, 7, 64, 1000):
        assert prof.hits(cap * tloc.LINE_BYTES) == brute_lru_hits(stream.tolist(), cap)
    assert tloc.stream_stats(stream, nnz=len(stream)) == \
        jloc.stream_stats(stream, nnz=len(stream))


def test_constants_and_degenerate_streams():
    assert (tloc.LINE_BYTES, tloc.L1_BYTES, tloc.L2_BYTES, tloc.FLOPS_PER_NNZ) == \
        (jloc.LINE_BYTES, jloc.L1_BYTES, jloc.L2_BYTES, jloc.FLOPS_PER_NNZ)
    assert tloc.reuse_distances(np.array([900, -3, 900])).tolist() == [-1, -1, 1]
    prof = tloc.reuse_profile(np.zeros(0, np.int64))
    assert prof.accesses == 0 and tloc.lru_hit_rate(np.zeros(0, np.int64), tloc.L1_BYTES) == 0.0
    with pytest.raises(terrors.InvalidArgError):
        tloc.reuse_distances(np.zeros((2, 2), np.int64))


# every 4th conformance scenario (every structure and block size, forced
# formats, float64) at one group size each
SCENARIOS = tp.scenario_cut(4)
CASES = [(s, (1, 4, 16)[i % 3]) for i, s in enumerate(SCENARIOS)]


def _same_profile(got, want):
    for cache in (jloc.L1_BYTES, jloc.L2_BYTES, H100_L2_BYTES):
        assert tloc.reuse_profile(got).hits(cache) == jloc.reuse_profile(want).hits(cache)


@pytest.mark.parametrize("scn,G", CASES, ids=[f"{s.name}-G{g}" for s, g in CASES])
def test_super_stream_profile_equal_to_repro(scn, G):
    js = jstreams.build_super_streams(scn.build(), group_size=G)
    ts = tstreams.build_super_streams(tp.torch_cb(scn), group_size=G)
    nnz = int(scn.build().nnz)
    for include_output in (False, True):
        got = tloc.access_stream_super(ts, include_output=include_output)
        want = jloc.access_stream_super(js, include_output=include_output)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        _same_profile(got, want)
        assert tloc.stream_stats(got, nnz=nnz, l2_bytes=H100_L2_BYTES) == \
            jloc.stream_stats(want, nnz=nnz, l2_bytes=H100_L2_BYTES)


@pytest.mark.parametrize("scn", SCENARIOS[::3], ids=tp.ids(SCENARIOS[::3]))
def test_super_tile_profile_equal_to_repro(scn):
    jt = jstreams.super_tile_stream_from_cb(scn.build())
    tt = tstreams.super_tile_stream_from_cb(tp.torch_cb(scn))
    for n_cols, include_output in ((None, False), (16, True), (300, False)):
        got = tloc.access_stream_super_tile(tt, n_cols, include_output=include_output)
        want = jloc.access_stream_super_tile(jt, n_cols, include_output=include_output)
        np.testing.assert_array_equal(got, want)
        _same_profile(got, want)
