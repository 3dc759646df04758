"""The LM's training step on a (data, model) mesh, held against the JAX package.

- **The JAX package's own sharded case**
  (``tests/test_distributed.py::test_sharded_train_step_matches_single_device``:
  dense, 2 layers, d 32, 4 heads / 2 KV heads, d_ff 64, vocab 256, float32),
  the CB-sparse MLP (cb-paper-smoke's geometry, float32) and the MoE family
  (mixtral-smoke, float32, 4 experts sharded over ``model`` 2), from the
  JAX arrays (``train_state_from_numpy(model=)``): three AdamW steps of the
  reference's test on gloo ranks at 2x2 (and 1x2 for the CB MLP) against the
  JAX package's single-device and sharded steps. Each step's loss within
  1e-4 and grad norm within 1e-4 relative; after the first step (the
  reference test's one step; it runs at lr 0, so the moments hold the
  gradient) every parameter and moment within rtol 1e-4 / atol 1e-5. The
  weights the second step moves are held through the third step's loss:
  AdamW turns a gradient below its eps into a step of the learning rate's
  size, and such an element's gradient is a cancellation at 1e-8 whose bits
  no two summation orders share (CB case, ``embed[183, 38]``: the port's one
  rank and the JAX package's single device differ by 1.9e-5 after step 1,
  the JAX package's own single-device and sharded steps by 3.2e-6). The CB
  tiles stay bit-equal on every rank; the MoE routing counts equal a
  one-rank run's;
- ``clip_by_global_norm`` and the int8-EF quantization of the same gradients
  sharded at 2x2: the norm equal on every rank and to one rank's, the codes
  and scales bit-equal to one rank's;
- a checkpoint saved at 2x2, restored at 2x2 (sharded like the example), at
  one rank and by ``repro.checkpoint``, bit-equal each way;
- a one-rank mesh computes the local model's ops: losses and parameters
  bit-equal; ``cb_linear_apply`` of a ``DTensor``; ``expert_shard`` with a
  mesh raises (the SSM, hybrid and encoder-decoder families and decoding on
  a mesh are ``test_torch_mesh_families.py`` and ``test_torch_mesh_decode.py``);
- ``python -m repro_torch.launch.train`` on 2 gloo ranks, then ``--resume``.

The ranks are processes of ``tests/torch_dist_ranks.py`` (no JAX in them);
the JAX package's sharded side runs in one subprocess with
``--xla_force_host_platform_device_count=4``, as ``tests/test_distributed.py``
runs it. Both are bounded by ``TIMEOUT``.
"""
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_ranks as R
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_smoke_config as jsmoke
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import Model as JModel
from repro.training import OPTIMIZERS as JOPTIMIZERS
from repro.training import TrainState as JTrainState
from repro_torch import errors
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model, moe
from repro_torch.models import sharding as S
from repro_torch.models.model import param_tree
from repro_torch.sparse.linear import cb_linear_apply
from repro_torch.training import OPTIMIZERS, TrainState
from repro_torch.training import grad_compression as gc
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import _leaf_groups
from repro_torch.training.train_state import (
    leaves_with_names, train_state_from_numpy, train_state_to_numpy,
)

TIMEOUT = 300           # seconds for every job of ranks, and for the JAX subprocess
LOSS_TOL = 1e-4
RTOL, ATOL = 1e-4, 1e-5
NORM_RTOL = 1e-6        # a norm summed in another order
GRADS_SEED = 7
DENSE = dict(name="t", family="dense", num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
             d_ff=64, vocab_size=256, attn_chunk=32, remat="none", dtype="float32")
CASES = {"dense": dict(config=DENSE, shapes=[[2, 2]]),
         "cb": dict(arch="cb-paper", shapes=[[1, 2], [2, 2]]),
         "moe": dict(arch="mixtral-8x7b", shapes=[[2, 2]])}
BATCH = (4, 32)

# the JAX package's side: each case's two steps on one device and on each mesh
JAX_SIDE = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.configs import get_smoke_config
from repro.configs.base import ModelConfig
from repro.models import Model, axis_rules, logical_to_sharding
from repro.models.sharding import sanitize_shardings
from repro.training import build_train_step, TrainState, OPTIMIZERS, warmup_cosine
from repro.training.optimizer import AdamWState

def unflat(d):
    tree = {}
    for key, v in d.items():
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(v)
    return tree

out = {}
for case in json.loads(sys.argv[2]):
    cfg = (ModelConfig(**case["config"]) if "config" in case
           else get_smoke_config(case["arch"]).scaled(dtype="float32"))
    model = Model(cfg)
    _, axes = model.init(jax.random.PRNGKey(0))
    params = unflat(dict(np.load(case["init"])))
    batch = {k: jnp.asarray(v) for k, v in np.load(case["batch"]).items()}
    opt = OPTIMIZERS["adamw"]()
    step = build_train_step(model, opt, warmup_cosine(1e-3, 2, 100))

    def run(f, tag):
        state = TrainState.create(params, opt)
        for i in range(int(sys.argv[3])):
            state, m = f(state, batch)
            out[f"{tag}/loss{i}"] = np.asarray(m["loss"])
            out[f"{tag}/grad_norm{i}"] = np.asarray(m["grad_norm"])
            if i:
                continue
            for part, tree in (("params", state.params), ("mu", state.opt_state.mu),
                               ("nu", state.opt_state.nu)):
                for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
                    name = "/".join(str(k.key) for k in path)
                    out[f"{tag}/{part}/{name}"] = np.asarray(leaf)

    run(jax.jit(step), f"{case['name']}/single")
    for shape in case["shapes"]:
        n = shape[0] * shape[1]
        mesh = compat.make_mesh(tuple(shape), ("data", "model"), devices=jax.devices()[:n])
        with axis_rules(mesh):
            psh = sanitize_shardings(jax.eval_shape(lambda: params),
                                     logical_to_sharding(axes, mesh), mesh)
            rep = NamedSharding(mesh, P())
            ssh = TrainState(step=rep, params=psh,
                             opt_state=AdamWState(mu=psh, nu=psh, count=rep), ef_buffers=None)
            bsh = {k: NamedSharding(mesh, P("data", None)) for k in batch}
            f = jax.jit(step, in_shardings=(ssh, bsh), out_shardings=(ssh, None))
            run(f, f"{case['name']}/{shape[0]}x{shape[1]}")
np.savez(sys.argv[1], **out)
"""


def jax_config(case: dict):
    if "config" in case:
        return JModelConfig(**case["config"])
    return jsmoke(case["arch"]).scaled(dtype="float32")


def write_inputs(base: pathlib.Path) -> dict:
    """Each case's initial weights (the JAX package's ``init`` of key 0) and
    batch, as npz files the JAX side and the ranks both read."""
    cases = {}
    for name, case in CASES.items():
        cfg = jax_config(case)
        params, _ = JModel(cfg).init(jax.random.PRNGKey(0))
        init = base / f"{name}_init.npz"
        np.savez(init, **{k: np.asarray(v) for k, v in R.flat(params).items()})
        toks = np.random.default_rng(1).integers(0, cfg.vocab_size, BATCH).astype(np.int32)
        batch = base / f"{name}_batch.npz"
        np.savez(batch, tokens=toks, targets=toks)
        cases[name] = dict(case, name=name, init=str(init), batch=str(batch))
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX side and every job of ranks, started together."""
    base = tmp_path_factory.mktemp("mesh")
    cases = write_inputs(base)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(R.SRC))
    jax_out = base / "jax.npz"
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, str(jax_out), json.dumps(list(cases.values())),
         str(R.TRAIN_STEPS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ckpt = base / "ckpt"
    jobs = {
        "2x2": R.Ranks(["mesh_train"], 4, base / "w4", params={"mesh_train": dict(
            shape=[2, 2], cases=list(cases.values()), grads_seed=GRADS_SEED,
            ckpt_dir=str(ckpt))}),
        "1x2": R.Ranks(["mesh_train"], 2, base / "w2", params={"mesh_train": dict(
            shape=[1, 2], cases=[cases["cb"]])}),
    }
    try:
        log, _ = jax_proc.communicate(timeout=TIMEOUT)
        ranks = {k: [r["mesh_train"] for r in job.wait(TIMEOUT)] for k, job in jobs.items()}
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
        for job in jobs.values():
            job.kill()
    assert jax_proc.returncode == 0, log[-3000:]
    return dict(ranks=ranks, jax=dict(np.load(jax_out)), cases=cases, ckpt=str(ckpt))


def _jax_leaves(jx: dict, tag: str, part: str) -> dict:
    pre = f"{tag}/{part}/"
    return {k[len(pre):]: v for k, v in jx.items() if k.startswith(pre)}


def _port_leaves(state, part: str) -> dict:
    tree = state.params if part == "params" else getattr(state.opt_state, part)
    return {k: np.asarray(v) for k, v in R.flat(tree).items()}


def _check_against_jax(res: dict, jx: dict, name: str, mesh: str) -> None:
    for tag in (f"{name}/single", f"{name}/{mesh}"):
        assert len(res["losses"]) == R.TRAIN_STEPS
        for i, (loss, norm) in enumerate(zip(res["losses"], res["grad_norms"])):
            assert abs(loss - float(jx[f"{tag}/loss{i}"])) < LOSS_TOL, (tag, i, loss)
            np.testing.assert_allclose(norm, float(jx[f"{tag}/grad_norm{i}"]), rtol=LOSS_TOL)
        for part in ("params", "mu", "nu"):
            want, got = _jax_leaves(jx, tag, part), _port_leaves(res["first"], part)
            assert sorted(want) == sorted(got), (tag, part)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                           err_msg=f"{tag} {part} {k}")


@pytest.mark.parametrize("name,mesh", [("dense", "2x2"), ("cb", "1x2"), ("cb", "2x2"),
                                       ("moe", "2x2")])
def test_sharded_train_steps_match_the_jax_single_and_sharded_steps(runs, name, mesh):
    ranks = runs["ranks"][mesh]
    _check_against_jax(ranks[0][name], runs["jax"], name, mesh)
    # every rank reports the same losses and the same whole state
    for r in ranks[1:]:
        assert r[name]["losses"] == ranks[0][name]["losses"]
        assert r[name]["grad_norms"] == ranks[0][name]["grad_norms"]
    # the layout is the reference's: FSDP over data, Megatron and experts over
    # model (placements in mesh order: data, model), the CB tiles replicated
    pl = ranks[0][name]["placements"]
    want = {"dense": {"layers.0.attn.wq": ["Shard(0)", "Shard(1)"],
                      "embed": ["Shard(1)", "Shard(0)"]},
            "moe": {"layers.0.ffn.w_gate": ["Shard(1)", "Shard(0)"]},
            "cb": {"layers.0.ffn.gate": ["Replicate()", "Replicate()"]}}[name]
    assert {k: pl[k] for k in want} == want


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_cb_tiles_stay_bit_equal_on_every_rank(runs, mesh):
    ranks = runs["ranks"][mesh]
    first = ranks[0]["cb"]["tiles"]
    assert len(first) == 6
    for r in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(first, r["cb"]["tiles"]))


def _one_rank(case: dict, routing=False):
    """The case's two steps on one rank of the port (no mesh)."""
    model = Model(R.mesh_config(case), "cpu")
    state = train_state_from_numpy(R.reference_state(case, model), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in np.load(case["batch"]).items()}
    return model, state, R.train_steps(model, state, batch, routing=routing)


def test_moe_routing_is_the_one_rank_runs(runs):
    _, _, (losses, _, counts, _) = _one_rank(runs["cases"]["moe"], routing=True)
    ranks = runs["ranks"]["2x2"]
    for step in range(R.TRAIN_STEPS):
        for layer, whole in enumerate(counts[step]):
            # ranks (data d, model m) = 2 d + m hold groups [d G/2, (d + 1) G/2)
            half = whole.shape[0] // 2
            for rank, r in enumerate(ranks):
                d = rank // 2
                got = r["moe"]["routing"][step][layer]
                assert torch.equal(got, whole[d * half:(d + 1) * half]), (step, layer, rank)
    assert all(abs(a - b) < LOSS_TOL for a, b in zip(losses, ranks[0]["moe"]["losses"]))


def _local_grads(case: dict):
    model = Model(R.mesh_config(case), "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return params, R.random_grads(model, params, GRADS_SEED)


def test_clip_by_global_norm_at_2x2_is_one_ranks(runs):
    params, (grads, _) = _local_grads(runs["cases"]["dense"])
    g = [torch.from_numpy(a.copy()) for a in grads]
    clipped, norm = opt.clip_by_global_norm(g, 1.0)
    ranks = [r["grads"] for r in runs["ranks"]["2x2"]]
    assert all(torch.equal(r["norm"], ranks[0]["norm"]) for r in ranks)   # every rank alike
    np.testing.assert_allclose(float(ranks[0]["norm"]), float(norm), rtol=NORM_RTOL)
    assert float(norm) > 1.0                                          # the clip scaled
    for a, b in zip(ranks[0]["clipped"], clipped):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=NORM_RTOL, atol=1e-9)


def test_int8_ef_codes_and_scales_at_2x2_are_one_ranks(runs):
    params, (grads, efs) = _local_grads(runs["cases"]["dense"])
    got = runs["ranks"]["2x2"][0]["grads"]["codes"]
    groups = _leaf_groups(params)
    assert [c["idx"] for c in got] == groups
    for c, idx in zip(got, groups):
        qs, scale, _ = gc.ef_quantize_stacked([torch.from_numpy(grads[i]) for i in idx],
                                              [torch.from_numpy(efs[i]) for i in idx])
        assert torch.equal(c["scale"], scale), idx
        assert all(torch.equal(a, b) for a, b in zip(c["codes"], qs)), idx


def test_a_checkpoint_saved_at_2x2_restores_everywhere_bit_equal(runs):
    rank0 = runs["ranks"]["2x2"][0]["dense"]
    saved = dict(leaves_with_names(rank0["state"]))
    # at 2x2, into a sharded example: sharded like it, and the same bits
    assert rank0["restored_dtensor"]
    back = dict(leaves_with_names(rank0["restored"]))
    assert sorted(back) == sorted(saved)
    assert all(np.array_equal(back[k], saved[k]) for k in saved)
    ck = Checkpointer(runs["ckpt"])
    assert ck.list_steps() == [R.TRAIN_STEPS]
    # at one rank of the port
    case = runs["cases"]["dense"]
    model = Model(R.mesh_config(case), "cpu")
    example = train_state_from_numpy(R.reference_state(case, model), "cpu")
    one = dict(leaves_with_names(train_state_to_numpy(ck.restore(example))))
    assert all(np.array_equal(one[k], saved[k]) for k in saved)
    # by the JAX package's checkpointer
    jparams, _ = JModel(jax_config(case)).init(jax.random.PRNGKey(0))
    jstate = JCheckpointer(runs["ckpt"]).restore(
        JTrainState.create(jparams, JOPTIMIZERS["adamw"]()))
    jleaves = jax.tree_util.tree_leaves(jstate)
    assert len(jleaves) == len(saved)
    for (name, a), b in zip(leaves_with_names(rank0["state"]), jleaves):
        assert np.array_equal(np.asarray(b), a), name


# ---------------------------------------------------------------------------
# one rank in this process: the mesh path is the local path
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank_mesh():
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=0,
                                world_size=1)
        try:
            yield make_mesh((1, 1), ("data", "model"), device_type="cpu")
        finally:
            dist.destroy_process_group()


@pytest.mark.parametrize("name", list(CASES))
def test_a_one_rank_mesh_is_bit_equal_to_the_local_model(runs, one_rank_mesh, name):
    case = runs["cases"][name]
    _, local, (losses, norms, _, _) = _one_rank(case)
    model = Model(R.mesh_config(case), "cpu", mesh=one_rank_mesh)
    state = train_state_from_numpy(R.reference_state(case, model), "cpu", model=model)
    batch = {k: torch.from_numpy(v) for k, v in np.load(case["batch"]).items()}
    m_losses, m_norms, _, _ = R.train_steps(model, state,
                                            S.place_batch(batch, one_rank_mesh))
    assert (m_losses, m_norms) == (losses, norms)
    for (n, a), b in zip(local.params.named_parameters(), state.params.parameters()):
        assert torch.equal(a, b.to_local()), n


def test_cb_linear_apply_takes_a_dtensor(one_rank_mesh):
    model = Model(get_smoke_config("cb-paper").scaled(dtype="float32"), "cpu")
    tiles = model.init(torch.Generator().manual_seed(0)).layers[0].ffn["gate"].detach()
    spec = model.specs["gate"]
    x = torch.randn((4, 8, spec.in_features), generator=torch.Generator().manual_seed(1))
    want = cb_linear_apply({"tiles": tiles}, spec, x, device="cpu")
    xd = S.distribute_local(x, one_rank_mesh, S.placements_for(one_rank_mesh, "batch", None,
                                                                None))
    td = S.distribute_local(tiles, one_rank_mesh, S.placements_for(one_rank_mesh, None, None,
                                                                    None))
    y = cb_linear_apply({"tiles": td}, spec, xd, device="cpu")
    assert y.placements == xd.placements and torch.equal(y.to_local(), want)
    split = S.distribute_local(x, one_rank_mesh, S.placements_for(one_rank_mesh, None, None,
                                                                   "batch"))
    with pytest.raises(errors.InvalidArgError, match="feature dim"):
        cb_linear_apply({"tiles": td}, spec, split, device="cpu")


def test_decode_and_odd_batches_on_a_mesh_raise(one_rank_mesh):
    """A mesh with ``expert_shard`` raises; decoding on a mesh runs (it is
    held to the JAX package in ``test_torch_mesh_decode.py``): on a one-rank
    mesh it is the local model's decode, bit for bit."""
    with pytest.raises(errors.InvalidArgError, match="expert_shard"):
        Model(get_smoke_config("mixtral-8x7b"), "cpu", mesh=one_rank_mesh, expert_shard=(0, 2))
    cfg = get_smoke_config("granite-8b").scaled(dtype="float32")
    local = Model(cfg, "cpu")
    params = local.init(torch.Generator().manual_seed(0))
    model = Model(cfg, "cpu", mesh=one_rank_mesh)
    sharded = model.shard(local.init(torch.Generator().manual_seed(0)))
    tok, pos = torch.tensor([[3], [5]]), torch.zeros(2, dtype=torch.int32)
    want, _ = local.decode_step(params, local.init_decode_state(2, 8), tok, pos)
    got, state = model.decode_step(sharded, model.init_decode_state(2, 8), tok, pos)
    assert torch.equal(S.full_tensor(got), want)
    assert all(isinstance(v, torch.distributed.tensor.DTensor) for v in state.values())


def test_a_live_state_restores_onto_a_mesh_with_shardings(one_rank_mesh, tmp_path):
    model = Model(get_smoke_config("granite-8b"), "cpu")
    state = TrainState.create(model.init(torch.Generator().manual_seed(0)), OPTIMIZERS["adamw"]())
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(state, 1)
    tree = S.sanitize_shardings(param_tree(state.params),
                                S.logical_to_sharding(model.axes(), one_rank_mesh), one_rank_mesh)
    example = TrainState.create(model.init(torch.Generator().manual_seed(1)),
                                OPTIMIZERS["adamw"]())
    back = ck.restore(example, shardings=tree)
    want = [sh.placements for sh in S.model_shardings(state.params, model.axes(), one_rank_mesh)]
    assert [p.placements for p in back.params.parameters()] == want
    assert all(torch.equal(p.to_local(), q) for p, q in zip(back.params.parameters(),
                                                            state.params.parameters()))
    assert all(m.placements == p.placements for m, p in zip(back.opt_state.mu,
                                                            back.params.parameters()))


def test_routing_is_recorded_only_when_asked():
    cfg = get_smoke_config("mixtral-8x7b").scaled(dtype="float32")
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.zeros((2, 16), dtype=torch.long)
    with moe.record_routing() as rec:
        model.forward(params, toks)
    assert len(rec) == cfg.num_layers and rec[0].shape[1] == cfg.num_experts
    assert int(rec[0].sum()) == 2 * 16 * cfg.top_k            # capacity holds them all here
    model.forward(params, toks)
    assert moe._routing is None and len(rec) == cfg.num_layers


# ---------------------------------------------------------------------------
# the launcher on 2 gloo ranks
# ---------------------------------------------------------------------------

def _launch_ranks(tmp_path, tag, *args, arch="cb-paper") -> list[subprocess.CompletedProcess]:
    env = dict(os.environ, PYTHONPATH=str(R.SRC), WORLD_SIZE="2", OMP_NUM_THREADS="1")
    store = (tmp_path / f"store_{tag}").resolve()
    procs = []
    for r in range(2):
        log = open(tmp_path / f"{tag}_rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--smoke",
             "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"), "--init-method",
             f"file://{store}", *args], env=dict(env, RANK=str(r)), cwd=tmp_path,
            stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for p, _ in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return [(p.returncode, (tmp_path / f"{tag}_rank{r}.log").read_text())
            for r, (p, _) in enumerate(procs)]


def test_launch_train_on_two_ranks_then_resume(tmp_path):
    out = _launch_ranks(tmp_path, "a", "--steps", "3")
    assert [rc for rc, _ in out] == [0, 0], out
    lead, other = out[0][1], out[1][1]
    assert "mesh: {'data': 1, 'model': 2}  arch: cb-paper-smoke" in lead
    assert "(2 ranks)" in lead and "final:" in lead and "final:" not in other
    ck = Checkpointer(str(tmp_path / "ck" / "cb-paper-smoke"))
    assert ck.list_steps() == [3]
    out = _launch_ranks(tmp_path, "b", "--steps", "5", "--resume")
    assert [rc for rc, _ in out] == [0, 0], out
    assert "resumed from step 3" in out[0][1] and ck.list_steps() == [3, 5]
    final = [ln for ln in out[0][1].splitlines() if ln.startswith("final:")]
    assert final and "'step': 4" in final[0]


@pytest.mark.parametrize("arch", ["mamba2-130m", "whisper-small"])
def test_launch_train_runs_the_ssm_and_encdec_families_on_two_ranks(tmp_path, arch):
    """launch/train with WORLD_SIZE 2 trains mamba2 and whisper (its batches
    with stub frames) on a (1, 2) mesh to the end; rank 0 reports."""
    out = _launch_ranks(tmp_path, arch, "--steps", "2", arch=arch)
    assert [rc for rc, _ in out] == [0, 0], out
    lead = out[0][1]
    assert f"mesh: {{'data': 1, 'model': 2}}  arch: {arch}" in lead and "(2 ranks)" in lead
    final = [ln for ln in lead.splitlines() if ln.startswith("final:")]
    assert final and "'step': 1" in final[0]
