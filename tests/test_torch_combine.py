"""The combine's fixed summation order, emulated on the CPU.

``csrc/cb_combine.cu`` adds every slot's partial row into its block row of
y in an order that ``plan_combine`` fixes on the host: slots sorted by
block row (stably), each row cut into chunks of at most ``plan.chunk``
slots, each chunk spread over P slot positions (position ``p`` adds the
chunk's slots ``p, p + P, ...`` in float32, in order), the positions then
added by a fixed butterfly (``p`` and ``p ^ 1``, then ``p ^ 2``, ...). A
row that is one chunk adds its sum to y in the first pass; the chunk sums
of a longer row wait in scratch and a second pass adds them in the same
way. The CUDA kernel cannot run here, so this file repeats that arithmetic
in numpy float32 (``emulate``) and holds it against ``combine_plain``
(``index_add_``) and the JAX package's scatter-add (``y2d.at[brow].add``):

- bit-equal on integer data (every sum exact in float32);
- within 1e-5 of the largest |sum| on random floats (another order of
  float32 additions);
- an inf or NaN in one slot reaches its row and no other;
- every slot is summed exactly once, every row is added to y once;
- rows that fit one chunk finish in the first pass, and a plan needs a
  second pass only for rows longer than a chunk;
- a ragged last block row at R = 16, 24 and 256 drops its tail.

The tests marked ``cuda`` hold the kernel itself against ``emulate`` bit for
bit on the card, with ``parts`` and ``y`` at a 4-byte offset too.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cb_combine as t_combine

REL_TOL = 1e-5


def emulate(y: np.ndarray, parts: np.ndarray, brow: np.ndarray, R: int,
            plan: t_combine.CombinePlan | None = None) -> np.ndarray:
    """``y`` plus the partials, summed as the kernel sums them (float32)."""
    plan = plan or t_combine.plan_combine(torch.from_numpy(brow), "cpu")
    m = len(y)
    y2d = np.zeros((-(-m // R), R), np.float32)
    y2d.reshape(-1)[:m] = y
    src = parts.astype(np.float32).reshape(-1, R)
    scratch = np.zeros((plan.num_scratch, R), np.float32)
    for p in plan.passes:
        P = t_combine.launch_positions(p.positions, R)
        perm = np.arange(len(src)) if p.perm is None else p.perm.cpu().numpy()
        for (lo, hi), d in zip(p.bounds.cpu().numpy(), p.dst.cpu().numpy()):
            acc = np.zeros((P, R), np.float32)
            for base in range(lo, hi, P):               # positions 0.. of one loop step
                rows = perm[base:min(base + P, hi)]
                acc[:len(rows)] += src[rows]
            o = 1
            while o < P:                                 # the butterfly over positions
                acc = acc + acc[np.arange(P) ^ o]
                o *= 2
            if d >= 0:
                y2d[d] += acc[0]
            else:
                scratch[-1 - d] = acc[0]
        src = scratch
    return y2d.reshape(-1)[:m]


def plain(y: np.ndarray, parts: np.ndarray, brow: np.ndarray, R: int) -> np.ndarray:
    out = torch.from_numpy(y.copy())
    t_combine.combine_plain(out, torch.from_numpy(parts), torch.from_numpy(brow), R)
    return out.numpy()


def brow_of(lengths, seed: int = 0) -> np.ndarray:
    """Slots of block row i repeated lengths[i] times, in a shuffled order."""
    brow = np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)
    return np.random.default_rng(seed).permutation(brow)


def draw(shape, seed: int, integer: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if integer:
        return rng.integers(-4, 5, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


# (name, row lengths, R): one row of 35,000 slots beside short ones (block row 0
# collecting the packer's padding); a power-law tail; the solver's short rows;
# rows at the chunk length and one past it; wide and odd widths
PROFILES = [
    ("padding-row0", [35000] + [300] * 40, 16),
    ("power-law", list(np.minimum(7000, (np.random.default_rng(1).pareto(1.2, 300) * 20
                                         ).astype(int) + 1)), 16),
    ("solver-rows", [3] * 500 + [8], 256),
    ("chunk-edges", [511, 512, 513, 1024, 1025, 2000], 16),
    ("narrow-8", [70, 1, 200, 33], 8),
    ("odd-24", [600, 5, 90], 24),
    ("odd-3048", [30, 2, 7], 3048),
    ("r-not-a-multiple-of-4", [40, 9, 1], 13),
]
PROFILE_IDS = [p[0] for p in PROFILES]


@pytest.mark.parametrize("name,lengths,R", PROFILES, ids=PROFILE_IDS)
def test_integer_data_is_bit_equal_to_the_plain_version(name, lengths, R):
    brow = brow_of(lengths)
    parts = draw((len(brow), R), 1, True)
    y = draw(len(lengths) * R - 3, 2, True)
    np.testing.assert_array_equal(emulate(y, parts, brow, R), plain(y, parts, brow, R))


@pytest.mark.parametrize("name,lengths,R", PROFILES, ids=PROFILE_IDS)
def test_random_floats_agree_within_tolerance(name, lengths, R):
    brow = brow_of(lengths, 3)
    parts = draw((len(brow), R), 4, False)
    y = draw(len(lengths) * R, 5, False)
    want = plain(y, parts, brow, R)
    got = emulate(y, parts, brow, R)
    assert np.abs(got - want).max() <= REL_TOL * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("R", [16, 256])
def test_agrees_with_the_jax_scatter_add(R):
    """The JAX package's combine is one ``y2d.at[brow].add(parts)``."""
    import jax.numpy as jnp

    brow = brow_of([2000, 3, 40, 700], 6)
    for integer in (True, False):
        parts = draw((len(brow), R), 7, integer)
        want = np.asarray(jnp.zeros((4, R), jnp.float32).at[brow].add(parts)).reshape(-1)
        got = emulate(np.zeros(4 * R, np.float32), parts, brow, R)
        if integer:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= REL_TOL * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("value", [np.inf, -np.inf, np.nan])
@pytest.mark.parametrize("row", [0, 2])
def test_a_non_finite_slot_reaches_its_row_only(value, row):
    """Row 0 is long (two passes), row 2 short (one)."""
    R, lengths = 16, [3000, 5, 7, 40]
    brow = brow_of(lengths, 8)
    parts = draw((len(brow), R), 9, False)
    hit = np.flatnonzero(brow == row)[len(np.flatnonzero(brow == row)) // 2]
    parts[hit, 5] = value
    got = emulate(np.zeros(len(lengths) * R, np.float32), parts, brow, R).reshape(-1, R)
    want = plain(np.zeros(len(lengths) * R, np.float32), parts, brow, R).reshape(-1, R)
    bad = ~np.isfinite(got)
    assert bad[row, 5] and bad.sum() == 1
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.abs(got[~bad] - want[~bad]).max() <= REL_TOL * max(1.0, np.abs(want[~bad]).max())


@pytest.mark.parametrize("name,lengths,R", PROFILES, ids=PROFILE_IDS)
def test_every_slot_is_summed_exactly_once(name, lengths, R):
    brow = brow_of(lengths, 10)
    plan = t_combine.plan_combine(torch.from_numpy(brow), "cpu")
    first = plan.passes[0]
    perm = first.perm.numpy()
    assert sorted(perm.tolist()) == list(range(len(brow)))
    covered = np.zeros(len(brow), np.int64)
    for lo, hi in first.bounds.numpy():
        assert 0 < hi - lo <= plan.chunk
        covered[lo:hi] += 1
        assert len(np.unique(brow[perm[lo:hi]])) == 1          # a chunk is one row's
    assert (covered == 1).all()
    dst = first.dst.numpy()
    assert sorted((-1 - dst[dst < 0]).tolist()) == list(range(plan.num_scratch))
    direct = dst[dst >= 0].tolist()
    if plan.num_scratch:
        second = plan.passes[1]
        assert second.perm is None
        covered = np.zeros(plan.num_scratch, np.int64)
        for lo, hi in second.bounds.numpy():
            covered[lo:hi] += 1
        assert (covered == 1).all()
        direct += second.dst.numpy().tolist()
    assert sorted(direct) == sorted(set(brow.tolist()))        # each row reaches y once


@pytest.mark.parametrize("name,lengths,R", PROFILES, ids=PROFILE_IDS)
def test_rows_that_fit_one_chunk_finish_in_the_first_pass(name, lengths, R):
    brow = brow_of(lengths, 11)
    plan = t_combine.plan_combine(torch.from_numpy(brow), "cpu")
    lengths = np.asarray(lengths)
    fits = np.flatnonzero(lengths <= plan.chunk)
    first = plan.passes[0]
    dst = first.dst.numpy()
    assert set(fits.tolist()) <= set(dst[dst >= 0].tolist())
    assert len(plan.passes) == (1 if (lengths <= plan.chunk).all() else 2)
    if len(plan.passes) == 2:
        assert sorted(plan.passes[1].dst.numpy().tolist()) == \
            np.flatnonzero(lengths > plan.chunk).tolist()
    assert plan.chunk == t_combine.chunk_length(first.positions, len(brow))


def test_chunks_grow_with_the_pass():
    """A chunk's serial steps follow the rounds the whole pass needs."""
    U, P = t_combine.UNROLL, t_combine.MAX_POSITIONS
    assert t_combine.chunk_length(P, 1000) == P * U * t_combine.MIN_STEPS
    assert t_combine.chunk_length(P, 5_000_000) == P * U * t_combine.MAX_STEPS
    assert t_combine.chunk_length(1, 3 * t_combine.ROUND_SLOTS * t_combine.MIN_STEPS // 2) == \
        U * 2 * t_combine.MIN_STEPS


def test_positions_follow_the_row_lengths():
    """Short rows take narrow groups, long rows a whole warp's positions."""
    short = t_combine.plan_combine(torch.from_numpy(brow_of([3] * 200)), "cpu")
    long_ = t_combine.plan_combine(torch.from_numpy(brow_of([300] * 20)), "cpu")
    assert short.passes[0].positions == 1 and long_.passes[0].positions == t_combine.MAX_POSITIONS
    assert [t_combine.lanes_per_slot(R) for R in (1, 4, 8, 16, 24, 32, 48, 128, 3048)] == \
        [1, 1, 2, 4, 8, 8, 16, 32, 32]
    assert t_combine.launch_positions(8, 16) == 8 and t_combine.launch_positions(8, 24) == 4
    assert t_combine.launch_positions(8, 256) == 1


@pytest.mark.parametrize("R", [16, 24, 256])
def test_a_ragged_last_block_row_drops_its_tail(R):
    lengths = [900, 4, 60, 2000]
    brow = brow_of(lengths, 12)
    m = len(lengths) * R - 5
    for integer in (True, False):
        parts = draw((len(brow), R), 13, integer)
        y = draw(m, 14, integer)
        got, want = emulate(y, parts, brow, R), plain(y, parts, brow, R)
        assert got.shape == (m,)
        if integer:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= REL_TOL * max(1.0, np.abs(want).max())


def test_segment_combine_on_the_cpu_is_the_plain_version():
    R, brow = 16, brow_of([700, 3, 9])
    parts = draw((len(brow), R), 15, False)
    y = draw(3 * R - 1, 16, False)
    out = torch.from_numpy(y.copy())
    before = t_combine.segment_combine.launches
    t_combine.segment_combine(out, torch.from_numpy(parts), torch.from_numpy(brow), R)
    np.testing.assert_array_equal(out.numpy(), plain(y, parts, brow, R))
    assert t_combine.segment_combine.launches == before


# ---------------------------------------------------------------------------
# on the card: the kernel against the emulation, bit for bit
# ---------------------------------------------------------------------------

CUDA_CASES = [(name, lengths, R, off) for name, lengths, R in PROFILES for off in (0, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,lengths,R,off", CUDA_CASES,
                         ids=[f"{c[0]}-off{c[3]}" for c in CUDA_CASES])
def test_cuda_kernel_is_the_emulated_order(name, lengths, R, off):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    brow = brow_of(lengths, 17)
    m = len(lengths) * R - 3
    plan = t_combine.plan_combine(torch.from_numpy(brow).cuda(), "cuda")
    for integer in (False, True):
        parts = draw((len(brow), R), 18, integer)
        y = draw(m, 19, integer)
        p_dev = torch.from_numpy(np.r_[np.zeros(off, np.float32), parts.ravel()]).cuda()[off:]
        outs = []
        for _ in range(2):
            y_dev = torch.from_numpy(np.r_[np.zeros(off, np.float32), y]).cuda()[off:]
            t_combine.segment_combine(y_dev, p_dev.view(-1, R), torch.from_numpy(brow).cuda(),
                                      R, plan)
            outs.append(y_dev.cpu())
        assert torch.equal(outs[0], outs[1])
        np.testing.assert_array_equal(outs[0].numpy(), emulate(y, parts, brow, R, plan))
