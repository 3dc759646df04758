"""Distribution on the port, held against the JAX package on the CPU.

- ``balance.device_load_balance`` / ``tb_load_stddev``: equal to
  ``repro.core.balance``'s, ties included;
- ``shard_streams``: stacked arrays, ``device_nnz`` and ``load_imbalance``
  bit-equal to ``repro.core.distributed.shard_streams`` over
  ``matrices.corpus`` x D {1, 2, 3, 4} x B {8, 16, 24}, forced formats too;
- ``distributed_spmv`` on gloo ranks (1, 2 and 4 processes, both combines,
  ``impl="reference"`` and the batched engine's plain kernel versions): each
  rank's y within 1e-5 max|y| of the per-shard sum of the reference's
  ``cb_spmv(impl="reference")``, within 3e-4 of ``dense_oracle``, the
  ``Shard(0)`` placement where D divides m, and once against the JAX
  package's own ``distributed_spmv`` on 4 host devices;
- ``compressed_cross_pod_sum``: bit-equal to the reference's at 2 and 4
  pods, with different grads on every pod;
- ``pipeline_forward``: bit-equal to the stages applied one after another,
  and within 1e-6 of the reference's GPipe at S {2, 4} x M {4, 8}.

The ranks are processes of ``tests/torch_dist_ranks.py`` (a few seconds to
start, no JAX in them); the JAX package's multi-device side runs in one
subprocess with ``--xla_force_host_platform_device_count=4``, as
``tests/test_distributed.py`` runs it. Both are bounded by ``TIMEOUT``.
"""
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from conformance.scenarios import spmv_scenarios
from repro.core import balance as jbalance
from repro.core import distributed as jdist
from repro.core.cb_matrix import CBMatrix as JCB
from repro.core.spmv_ref import dense_oracle
from repro.data import matrices as jmatrices
from repro.kernels import ops as jops
from repro_torch import errors
from repro_torch.core import balance as tbalance
from repro_torch.core import distributed as tdist
from repro_torch.core.cb_matrix import CBMatrix as TCB
from repro_torch.kernels import cb_combine as tcombine
from repro_torch.kernels import ops as tops
from repro_torch.training.grad_compression import compressed_cross_pod_sum
from torch_port import assert_streams_equal, torch_cb

TIMEOUT = 120          # seconds for every job of ranks, and for the JAX subprocess
WORLDS = (1, 2, 4)

# the JAX package's side at 4 host devices: distributed_spmv, the cross-pod
# sum at 2 and 4 pods (grads stacked on a leading pod axis), GPipe
JAX_SIDE = r"""
import sys
from functools import partial
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core.cb_matrix import CBMatrix
from repro.core import distributed as dist
from repro.data import matrices
from repro.runtime.pipeline import pipeline_forward
from repro.training.grad_compression import compressed_cross_pod_sum
import torch_dist_ranks as R

out = {}
mesh = compat.make_mesh((4,), ("model",))
for m, n in R.SPMV_SHAPES:
    r, c, v = matrices.power_law(m, n, seed=7)
    cb = CBMatrix.from_coo(r, c, v.astype(np.float32), (m, n), block_size=16,
                           val_dtype=np.float32)
    sh = dist.shard_streams(cb, 4)
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    for combine in R.COMBINES:
        y = dist.distributed_spmv(sh, jnp.asarray(x), mesh, impl="reference", combine=combine)
        out[f"spmv/{m}x{n}/{combine}"] = np.asarray(y)
for pods in (2, 4):
    pmesh = compat.make_mesh((pods,), ("pod",), devices=jax.devices()[:pods])
    gs = [R.pod_grads(p) for p in range(pods)]
    g = {k: jnp.stack([gp[k] for gp, _ in gs]) for k in gs[0][0]}
    e = {k: jnp.stack([ep[k] for _, ep in gs]) for k in gs[0][1]}

    @partial(compat.shard_map, mesh=pmesh, in_specs=(P("pod"), P("pod")),
             out_specs=(P(), P("pod")), check_vma=False)
    def run(g, e):
        s, ne = compressed_cross_pod_sum(jax.tree_util.tree_map(lambda a: a[0], g),
                                         jax.tree_util.tree_map(lambda a: a[0], e), "pod")
        return s, jax.tree_util.tree_map(lambda a: a[None], ne)

    s, ne = run(g, e)
    for k in s:
        out[f"compressed/{pods}/summed/{k}"] = np.asarray(s[k])
        out[f"compressed/{pods}/new_ef/{k}"] = np.asarray(ne[k])
for S in (2, 4):
    smesh = compat.make_mesh((S,), ("pod",), devices=jax.devices()[:S])
    for M in R.PIPE_MICROBATCHES:
        ws, mbs = R.pipe_inputs(S, M)
        run = pipeline_forward(lambda w, h: jnp.tanh(h @ w), smesh, axis="pod")
        out[f"pipeline/{S}/{M}"] = np.asarray(run(jnp.asarray(ws), jnp.asarray(mbs)))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job of ranks and the JAX subprocess, started together."""
    base = tmp_path_factory.mktemp("dist")
    jobs = {D: R.Ranks(["spmv"] + (["compressed", "pipeline"] if D > 1 else []), D,
                       base / f"world{D}") for D in WORLDS}
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(R.SRC), str(pathlib.Path(__file__).parent)]))
    jax_out = base / "jax.npz"
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_SIDE, str(jax_out)], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        log, _ = jax_proc.communicate(timeout=TIMEOUT)
        ranks = {D: job.wait(TIMEOUT) for D, job in jobs.items()}
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
        for job in jobs.values():            # none left behind if one job failed
            job.kill()
    assert jax_proc.returncode == 0, log[-3000:]
    return ranks, dict(np.load(jax_out))


# ---------------------------------------------------------------------------
# the balancer at device level, and the host half of distribution
# ---------------------------------------------------------------------------

BALANCE_CASES = {
    "ties": np.array([5, 5, 5, 5, 3, 3, 1, 1, 1], np.int32),
    "skewed": np.r_[1000, np.arange(1, 40)].astype(np.int32),
    "random": np.random.default_rng(3).integers(1, 257, 101).astype(np.int32),
    "one": np.array([7], np.int32),
}


@pytest.mark.parametrize("D", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("case", list(BALANCE_CASES))
def test_device_load_balance_equals_the_reference(case, D):
    nnz = BALANCE_CASES[case]
    want, got = jbalance.device_load_balance(nnz, D), tbalance.device_load_balance(nnz, D)
    np.testing.assert_array_equal(got.slots, want.slots)
    np.testing.assert_array_equal(got.group_loads, want.group_loads)
    assert (got.num_groups, got.group_size) == (want.num_groups, want.group_size)
    assert got.load_imbalance == want.load_imbalance


@pytest.mark.parametrize("warps", [1, 8, 32])
@pytest.mark.parametrize("case", list(BALANCE_CASES))
def test_tb_load_stddev_equals_the_reference(case, warps):
    nnz = BALANCE_CASES[case]
    assert tbalance.tb_load_stddev(nnz, None, warps) == jbalance.tb_load_stddev(nnz, None, warps)
    assert tbalance.tb_load_stddev(np.zeros(0, np.int32)) == (0.0, 0.0)


CORPUS = jmatrices.corpus("small")


@pytest.mark.parametrize("B", [8, 16, 24])
@pytest.mark.parametrize("item", CORPUS, ids=[spec.name for spec, *_ in CORPUS])
def test_shard_streams_bit_equal_to_the_reference(item, B):
    _, r, c, v, shape = item
    v32 = v.astype(np.float32)
    jcb = JCB.from_coo(r, c, v32, shape, block_size=B, val_dtype=np.float32)
    tcb = TCB.from_coo(r, c, v32, shape, block_size=B, val_dtype=np.float32)
    for D in (1, 2, 3, 4):
        want, got = jdist.shard_streams(jcb, D), tdist.shard_streams(tcb, D)
        assert got.num_devices == want.num_devices == D
        assert_streams_equal(want.streams, got.streams, f"D={D}")
        np.testing.assert_array_equal(got.device_nnz, want.device_nnz)
        assert got.load_imbalance == want.load_imbalance


FORCED = [s for s in spmv_scenarios() if s.forced_fmt is not None][::3]


@pytest.mark.parametrize("scn", FORCED, ids=[s.name for s in FORCED])
def test_shard_streams_bit_equal_with_forced_formats(scn):
    jcb = scn.build()
    tcb = torch_cb(scn)
    for D in (2, 3):
        assert_streams_equal(jdist.shard_streams(jcb, D).streams,
                             tdist.shard_streams(tcb, D).streams, f"{scn.name} D={D}")


def test_a_rank_shard_counts_its_own_blocks_and_keeps_the_payload():
    r, c, v = jmatrices.power_law(400, 320, seed=2)
    cb = TCB.from_coo(r, c, v.astype(np.float32), (400, 320), block_size=16,
                      val_dtype=np.float32)
    sh = tdist.shard_streams(cb, 3)
    assert sh.streams.num_coo == 3                   # the stacked axis, not blocks
    for d in range(3):
        s = sh.shard(d)
        assert s.num_coo == sh.streams.coo_codes.shape[1]
        assert s.m == cb.shape[0] and s.n == cb.shape[1]
    sub = tdist._sub_matrix(cb, np.arange(0, len(cb.nnz_per_blk), 2))
    assert sub.packed is cb.packed and sub.nnz == int(cb.nnz_per_blk[::2].sum())
    # the shards' y add up to A @ x (padding blocks add exact zeros)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(320).astype(np.float32))
    y = sum(tops.cb_spmv(sh.shard(d), x, impl="reference", device="cpu") for d in range(3))
    want = dense_oracle(r, c, v.astype(np.float32), (400, 320), x.numpy())
    np.testing.assert_allclose(y.numpy(), want, rtol=3e-4, atol=3e-4)


def test_block_row_0_run_of_a_shard_is_chunked_by_the_combine():
    """Every padding block of a shard names block row 0 (the reference's
    layout), so row 0's run in the combine grows with the padding, on top of
    a hub row's own blocks (here rows 0-7 full). The combine's plan cuts the
    run into chunks and a second pass adds them; that order sums to the
    plain combine's y."""
    from test_torch_combine import emulate

    m, n, B = 1024, 4096, 8
    r, c, _ = jmatrices.power_law(m, n, seed=4)
    key = np.unique(np.r_[r * n + c, np.repeat(np.arange(B), n) * n + np.tile(np.arange(n), B)])
    r, c = key // n, key % n
    v = np.random.default_rng(0).standard_normal(len(r)).astype(np.float32)
    cb = TCB.from_coo(r, c, v, (m, n), block_size=B, val_dtype=np.float32)
    sh = tdist.shard_streams(cb, 4)
    for d in range(4):
        local = sh.shard(d)
        prep = tops._prepare(local, 1)
        brow = prep.brow.numpy()
        plan = tcombine.plan_combine(prep.brow, "cpu")
        assert (brow == 0).sum() > plan.chunk and len(plan.passes) == 2
        parts = np.random.default_rng(5 + d).standard_normal((len(brow), B)).astype(np.float32)
        want = torch.zeros(local.m)
        tcombine.combine_plain(want, torch.from_numpy(parts), prep.brow, B)
        got = emulate(np.zeros(local.m, np.float32), parts, brow, B, plan)
        np.testing.assert_allclose(got, want.numpy(), rtol=0,
                                   atol=1e-5 * float(np.abs(want.numpy()).max()))


def test_shard_streams_and_distributed_spmv_check_their_arguments():
    r, c, v = jmatrices.power_law(64, 64, seed=1)
    cb = TCB.from_coo(r, c, v.astype(np.float32), (64, 64), block_size=16,
                      val_dtype=np.float32)
    with pytest.raises(errors.InvalidArgError):
        tdist.shard_streams(cb, 0)
    sh = tdist.shard_streams(cb, 2)
    with pytest.raises(errors.InvalidArgError, match="combine"):
        tdist.distributed_spmv(sh, torch.zeros(64), None, combine="bogus")
    with pytest.raises(errors.InvalidArgError, match="mesh"):
        compressed_cross_pod_sum([torch.zeros(3)], [torch.zeros(3)])
    mesh = types.SimpleNamespace(mesh_dim_names=("model",), size=lambda dim: 2)
    with pytest.raises(errors.InvalidArgError, match="axis"):
        tdist.distributed_spmv(sh, torch.zeros(64), mesh, axis="data")
    with pytest.raises(errors.InvalidArgError, match="sharded 3 ways"):
        tdist.distributed_spmv(tdist.shard_streams(cb, 3), torch.zeros(64), mesh)
    if not torch.cuda.is_available():          # the default device is the card
        with pytest.raises(errors.DeviceUnavailableError):
            tdist.distributed_spmv(sh, torch.zeros(64), mesh)


# ---------------------------------------------------------------------------
# the multi-rank paths
# ---------------------------------------------------------------------------

def _jax_shard_sum(shape, D):
    """The per-shard sum of the reference's cb_spmv(impl="reference")."""
    r, c, v = jmatrices.power_law(*shape, seed=7)
    x = np.random.default_rng(0).standard_normal(shape[1]).astype(np.float32)   # the ranks' x
    cb = JCB.from_coo(r, c, v.astype(np.float32), shape, block_size=16, val_dtype=np.float32)
    sh = jdist.shard_streams(cb, D)
    ys = [np.asarray(jops.cb_spmv(jax.tree_util.tree_map(lambda a, d=d: a[d], sh.streams),
                                  jnp.asarray(x), impl="reference")) for d in range(D)]
    return np.sum(np.stack(ys).astype(np.float64), axis=0), (r, c, v.astype(np.float32), x)


@pytest.mark.parametrize("impl", ["reference", "cuda"])
@pytest.mark.parametrize("combine", R.COMBINES)
@pytest.mark.parametrize("shape", R.SPMV_SHAPES, ids=[f"{m}x{n}" for m, n in R.SPMV_SHAPES])
@pytest.mark.parametrize("D", WORLDS)
def test_distributed_spmv_on_gloo_ranks(runs, D, shape, combine, impl):
    ranks, _ = runs
    want, (r, c, v, x) = _jax_shard_sum(shape, D)
    oracle = dense_oracle(r, c, v, shape, x)
    m = shape[0]
    key = f"{shape[0]}x{shape[1]}/{combine}/{impl}"
    for rank, res in enumerate(ranks[D]):
        got = res["spmv"][key]
        y = got["full"].numpy()
        assert y.shape == (m,) and got["bit_equal_rerun"]
        np.testing.assert_allclose(y, want, rtol=0, atol=1e-5 * np.abs(want).max())
        np.testing.assert_allclose(y, oracle, rtol=3e-4, atol=3e-4)
        sharded = combine == "psum_scatter" and m % D == 0
        assert got["dtensor"] == sharded
        if sharded:
            assert got["placements"] == ["S(0)"]
            np.testing.assert_array_equal(got["local"].numpy(),
                                          y[rank * m // D:(rank + 1) * m // D])
        else:
            np.testing.assert_array_equal(got["local"].numpy(), y)
    if D > 1:
        sh = jdist.shard_streams(JCB.from_coo(r, c, v, shape, block_size=16,
                                              val_dtype=np.float32), D)
        assert ranks[D][0]["spmv"][key]["device_nnz"] == sh.device_nnz.tolist()


@pytest.mark.parametrize("combine", R.COMBINES)
@pytest.mark.parametrize("shape", R.SPMV_SHAPES, ids=[f"{m}x{n}" for m, n in R.SPMV_SHAPES])
def test_distributed_spmv_equals_the_reference_distributed_spmv(runs, shape, combine):
    ranks, jax_side = runs
    want = jax_side[f"spmv/{shape[0]}x{shape[1]}/{combine}"]
    for res in ranks[4]:
        got = res["spmv"][f"{shape[0]}x{shape[1]}/{combine}/reference"]["full"].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("pods", [2, 4])
def test_compressed_cross_pod_sum_bit_equal_to_the_reference(runs, pods):
    ranks, jax_side = runs
    for pod, res in enumerate(ranks[pods]):
        got = res["compressed"]
        assert got["active_mesh_same"]
        for k in ("w", "b"):
            np.testing.assert_array_equal(got["summed"][k].numpy(),
                                          jax_side[f"compressed/{pods}/summed/{k}"])
            np.testing.assert_array_equal(got["new_ef"][k].numpy(),
                                          jax_side[f"compressed/{pods}/new_ef/{k}"][pod])


@pytest.mark.parametrize("M", R.PIPE_MICROBATCHES)
@pytest.mark.parametrize("S", [2, 4])
def test_pipeline_forward_equals_the_stages_in_sequence(runs, S, M):
    ranks, jax_side = runs
    for res in ranks[S]:
        got = res["pipeline"][M]
        assert torch.equal(got["outputs"], got["sequential"])
        np.testing.assert_allclose(got["outputs"].numpy(), jax_side[f"pipeline/{S}/{M}"],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("S,M", [(1, 4), (2, 4), (4, 8), (4, 16)])
def test_bubble_fraction_equals_the_reference(S, M):
    from repro.runtime.pipeline import bubble_fraction as jbubble
    from repro_torch.runtime import bubble_fraction

    assert bubble_fraction(S, M) == jbubble(S, M)
