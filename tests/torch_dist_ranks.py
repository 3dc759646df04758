"""Rank processes of the port's multi-rank tests on the CPU (gloo), and their launcher.

    python tests/torch_dist_ranks.py <job.json> <rank>

runs one rank of a job that ``Ranks`` wrote: it joins a gloo process
group through a file store beside the job (no port to collide with other
test workers), runs the job's task on the port alone (torch, numpy and
``repro_torch``; no JAX, so a rank starts in a few seconds), and saves what
it saw with ``torch.save`` for the test to compare with the JAX package.
``Ranks.wait`` bounds the whole job by a timeout and kills every rank
that outlives it, so a hung collective fails one test and not the run.
"""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
SPMV_SHAPES = ((160, 160), (150, 144))        # D-divisible and ragged m (tests/test_distributed.py)
COMBINES = ("psum", "psum_scatter")
PIPE_MICROBATCHES = (4, 8)


# ---------------------------------------------------------------------------
# inputs every rank and the tests build alike, from seeds
# ---------------------------------------------------------------------------

def spmv_inputs(shape):
    """(rows, cols, vals float32, x float32) of the power-law matrix the JAX
    package's distribution tests use, seed 7."""
    from repro_torch.data import matrices

    m, n = shape
    r, c, v = matrices.power_law(m, n, seed=7)
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    return r, c, v.astype(np.float32), x


def pod_grads(pod: int):
    """Pod ``pod``'s gradients and EF buffers: different on every pod."""
    rng = np.random.default_rng(100 + pod)
    grads = {"w": rng.standard_normal((3, 5)).astype(np.float32),
             "b": (rng.standard_normal(7) * 1e-3).astype(np.float32)}
    efs = {k: (rng.standard_normal(g.shape) * 1e-3).astype(np.float32)
           for k, g in grads.items()}
    return grads, efs


def pipe_inputs(S: int, M: int):
    """Stage weights (S, 8, 8) and microbatches (M, 2, 8), float32."""
    rng = np.random.default_rng(10 * S + M)
    ws = (rng.standard_normal((S, 8, 8)) / np.sqrt(8)).astype(np.float32)
    mbs = rng.standard_normal((M, 2, 8)).astype(np.float32)
    return ws, mbs


def stage_fn(w, h):
    return torch.tanh(h @ w)


# ---------------------------------------------------------------------------
# the tasks
# ---------------------------------------------------------------------------

def _spmv(world: int) -> dict:
    from torch.distributed.tensor import DTensor

    from repro_torch.core import CBMatrix
    from repro_torch.core import distributed as tdist
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((world,), ("model",), device_type="cpu")
    out = {}
    for shape in SPMV_SHAPES:
        r, c, v, x = spmv_inputs(shape)
        cb = CBMatrix.from_coo(r, c, v, shape, block_size=16, val_dtype=np.float32)
        sh = tdist.shard_streams(cb, world)
        for combine in COMBINES:
            for impl in ("reference", "cuda"):
                y = tdist.distributed_spmv(sh, torch.from_numpy(x), mesh, impl=impl,
                                           device="cpu", combine=combine)
                again = tdist.distributed_spmv(sh, torch.from_numpy(x), mesh, impl=impl,
                                               device="cpu", combine=combine)
                is_d = isinstance(y, DTensor)
                out[f"{shape[0]}x{shape[1]}/{combine}/{impl}"] = dict(
                    full=(y.full_tensor() if is_d else y).clone(),
                    local=(y.to_local() if is_d else y).clone(),
                    dtensor=is_d, placements=[str(p) for p in y.placements] if is_d else None,
                    bit_equal_rerun=bool(torch.equal(
                        y.to_local() if is_d else y, again.to_local() if is_d else again)),
                    device_nnz=sh.device_nnz.tolist(), load_imbalance=sh.load_imbalance)
    return out


def _compressed(world: int) -> dict:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import axis_rules
    from repro_torch.training.grad_compression import compressed_cross_pod_sum

    mesh = make_mesh((world,), ("pod",), device_type="cpu")
    grads, efs = pod_grads(dist.get_rank())
    g = {k: torch.from_numpy(a) for k, a in grads.items()}
    e = {k: torch.from_numpy(a) for k, a in efs.items()}
    summed, new_ef = compressed_cross_pod_sum(g, e, "pod", mesh=mesh)
    with axis_rules(mesh):                      # the mesh of the active rules, by default
        summed2, new_ef2 = compressed_cross_pod_sum(g, e)
    same = all(torch.equal(summed[k], summed2[k]) and torch.equal(new_ef[k], new_ef2[k])
               for k in g)
    return dict(summed=summed, new_ef=new_ef, active_mesh_same=same)


def _pipeline(world: int) -> dict:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import pipeline_forward

    mesh = make_mesh((world,), ("pod",), device_type="cpu")
    out = {}
    for M in PIPE_MICROBATCHES:
        ws, mbs = pipe_inputs(world, M)
        ws_t, mbs_t = torch.from_numpy(ws), torch.from_numpy(mbs)
        got = pipeline_forward(stage_fn, mesh, axis="pod")(ws_t, mbs_t)
        seq = []
        for i in range(M):                      # the stages applied one after another
            h = mbs_t[i]
            for s in range(world):
                h = stage_fn(ws_t[s], h)
            seq.append(h)
        out[M] = dict(outputs=got, sequential=torch.stack(seq))
    return out


def _sharding(world: int, ckpt_dir: str, arch: str) -> dict:
    """Elastic restore of a checkpoint written by the JAX package onto a
    (data=world, model=1) mesh, ``make_mesh``'s checks, and ``constrain``."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch import errors
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model, axis_rules, constrain, logical_to_sharding
    from repro_torch.models.sharding import NamedSharding, sanitize_shardings
    from repro_torch.training.train_state import leaves_with_names

    out = {}
    try:
        make_mesh((world + 1,), ("data",), device_type="cpu")
    except errors.InvalidArgError as e:
        out["wrong_world_size"] = str(e)
    mesh = make_mesh((world, 1), ("data", "model"), device_type="cpu")
    out["mesh"] = dict(names=list(mesh.mesh_dim_names), shape=list(mesh.shape))

    ck = Checkpointer(ckpt_dir)
    example = json.loads((pathlib.Path(ckpt_dir) / "example.json").read_text())
    like = _tree_of_arrays(example)
    plain = ck.restore(like)
    model = Model(get_smoke_config(arch), device="cpu")
    shardings = sanitize_shardings(plain, logical_to_sharding(model.axes(), mesh), mesh)
    placed = ck.restore(like, shardings=shardings)
    leaves = []
    for (name, a), (_, t) in zip(leaves_with_names(plain), leaves_with_names(placed)):
        leaves.append(dict(name=name, plain=torch.from_numpy(np.asarray(a)),
                           local=t.to_local().clone(), full=t.full_tensor().clone(),
                           placements=[str(p) for p in t.placements],
                           dtensor=isinstance(t, DTensor)))
    out["leaves"] = leaves

    x = torch.arange(4 * world * 3, dtype=torch.float32).reshape(4 * world, 3)
    with axis_rules(mesh):
        out["constrain_local_same"] = constrain(x, "batch", None) is x
        d = distribute_tensor(x, mesh, list(NamedSharding(mesh, (None, None)).placements))
        c = constrain(d, "batch", None)
        out["constrain_placements"] = [str(p) for p in c.placements]
        out["constrain_local"] = c.to_local().clone()
    out["constrain_no_mesh_same"] = constrain(x, "batch") is x
    return out


# ---------------------------------------------------------------------------
# the LM's train step on a (data, model) mesh (tests/test_torch_mesh.py)
# ---------------------------------------------------------------------------

TRAIN_STEPS = 3          # step 0 runs at lr 0 (warmup), step 1 moves the weights, and
                         # step 2's loss is that of the moved weights


def flat(tree, prefix="") -> dict:
    """A nested dict of arrays as one level, keys joined by ``/``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflat(d: dict) -> dict:
    tree: dict = {}
    for key, v in d.items():
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def mesh_config(case: dict):
    """The case's ``ModelConfig``: a smoke config, or the JAX test's own."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ModelConfig

    if "arch" in case:
        return get_smoke_config(case["arch"]).scaled(dtype="float32")
    return ModelConfig(**case["config"])


def reference_state(case: dict, model):
    """The reference's ``TrainState`` tree (numpy) of the case's initial weights."""
    from repro_torch.training.optimizer import AdamWState
    from repro_torch.training.train_state import TrainState

    params = unflat(dict(np.load(case["init"])))

    def zeros():
        return unflat({k: np.zeros_like(v) for k, v in flat(params).items()})

    return TrainState(step=np.int32(0), params=params,
                      opt_state=AdamWState(mu=zeros(), nu=zeros(), count=np.int32(0)),
                      ef_buffers=None)


def train_steps(model, state, batch, steps=TRAIN_STEPS, routing=False):
    """``steps`` AdamW steps of the reference's test (peak lr 1e-3, warmup 2,
    clip 1.0); (losses, grad norms, each step's routing counts, the state
    after the first step in the reference's layout)."""
    from repro_torch.models import moe
    from repro_torch.training import OPTIMIZERS, build_train_step, warmup_cosine
    from repro_torch.training.train_state import train_state_to_numpy

    step = build_train_step(model, OPTIMIZERS["adamw"](), warmup_cosine(1e-3, 2, 100))
    losses, norms, counts, first = [], [], [], None
    for i in range(steps):
        with moe.record_routing() as rec:
            state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        counts.append([c.clone() for c in rec] if routing else None)
        if i == 0:
            first = train_state_to_numpy(state)
    return losses, norms, counts, first


def placement_names(t) -> list[str]:
    """A ``DTensor``'s placements as "Shard(d)" / "Replicate()", in mesh order."""
    return [f"Shard({p.dim})" if p.is_shard() else "Replicate()" for p in t.placements]


def _mesh_train(world: int, shape, cases, grads_seed=None, ckpt_dir=None) -> dict:
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.models import sharding as S
    from repro_torch.training import OPTIMIZERS, TrainState
    from repro_torch.training.train_state import (train_state_from_numpy,
                                                  train_state_to_numpy)

    mesh = make_mesh(tuple(shape), ("data", "model"), device_type="cpu")
    out = {}
    for case in cases:
        cfg = mesh_config(case)
        model = Model(cfg, "cpu", mesh=mesh)
        with S.axis_rules(mesh, case.get("rules")):   # the case's rules lay out its state
            state = train_state_from_numpy(reference_state(case, model), "cpu", model=model)
            batch = {k: torch.from_numpy(v) for k, v in np.load(case["batch"]).items()}
            losses, norms, counts, first = train_steps(model, state,
                                                       S.place_batch(batch, mesh),
                                                       routing=cfg.family == "moe")
        res = dict(losses=losses, grad_norms=norms, routing=counts, first=first,
                   placements={n: placement_names(t) for n, t in state.params.named_parameters()},
                   state=train_state_to_numpy(state))
        if cfg.sparse_mlp:                       # each rank's copy of the replicated tiles
            res["tiles"] = [t.to_local().clone() for n, t in state.params.named_parameters()
                            if n.endswith(("gate", "up", "down"))]
        if ckpt_dir is not None and case["name"] == "dense":
            ck = Checkpointer(ckpt_dir)
            ck.save(state, TRAIN_STEPS)
            example = TrainState.create(model.init(torch.Generator().manual_seed(5)),
                                        OPTIMIZERS["adamw"]())
            back = ck.restore(example)
            res["restored_dtensor"] = all(isinstance(p, DTensor)
                                          for p in back.params.parameters())
            res["restored"] = train_state_to_numpy(back)
        out[case["name"]] = res
    if grads_seed is not None:
        out["grads"] = _sharded_grads(mesh, cases[0], grads_seed)
    return out


def random_grads(model, params, seed: int):
    """Per-parameter float32 normals and EF buffers of the parameters' shapes."""
    rng = np.random.default_rng(seed)
    shapes = [tuple(p.shape) for p in params.parameters()]
    grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    efs = [(rng.standard_normal(s) * 1e-2).astype(np.float32) for s in shapes]
    return grads, efs


def _sharded_grads(mesh, case: dict, seed: int) -> dict:
    """The clip and the int8-EF quantization of the same gradients, sharded
    like the parameters: the norm on every rank, and each leaf's codes and
    scale gathered whole."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import Model
    from repro_torch.models import sharding as S
    from repro_torch.training import grad_compression as gc
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import _leaf_groups

    model = Model(mesh_config(case), "cpu", mesh=mesh)
    params = model.init(torch.Generator().manual_seed(0))
    grads, efs = random_grads(model, params, seed)

    def placed(arrays):
        return [S.distribute_local(torch.from_numpy(a), p.device_mesh, p.placements)
                for a, p in zip(arrays, params.parameters())]

    layouts = [(p.device_mesh, p.placements) for p in params.parameters()]
    g, e = placed(grads), placed(efs)
    codes = []
    for idx in _leaf_groups(params):
        qs, scale, _ = gc.ef_quantize_stacked([g[i] for i in idx], [e[i] for i in idx])
        whole = [S.full_tensor(DTensor.from_local(q, *layouts[i], run_check=False))
                 for q, i in zip(qs, idx)]
        codes.append(dict(idx=idx, scale=scale.clone(), codes=whole))
    clipped, norm = opt.clip_by_global_norm(placed(grads), 1.0)
    return dict(codes=codes, norm=norm.clone(),
                clipped=[S.full_tensor(t).clone() for t in clipped])


def _mesh_decode(world: int, shape, cases) -> dict:
    """Each case's prefill and teacher-forced decode steps on a (data, model)
    mesh under ``rules_for``'s rules for its shapes, from the JAX package's
    weights and decode state: the logits and the final state, gathered."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh, rules_for
    from repro_torch.models import Model
    from repro_torch.models import sharding as S
    from repro_torch.models.model import decode_state_from_numpy, params_from_numpy

    mesh = make_mesh(tuple(shape), ("data", "model"), device_type="cpu")
    out = {}
    for case in cases:
        cfg = mesh_config(case)
        model = Model(cfg, "cpu", mesh=mesh)
        tree = unflat(dict(np.load(case["init"])))
        data = dict(np.load(case["data"]))
        B = data["tokens"].shape[0]
        res = {}
        prefill = ShapeConfig("prefill", "prefill", data["prompt"].shape[1], B)
        rules = rules_for(cfg, prefill, mesh)
        if B % shape[0]:                        # a batch of one: replicated, as at decode
            rules["batch"] = None
        with S.axis_rules(mesh, rules):
            params = params_from_numpy(cfg, tree, "cpu", model=model)
            kw = {k: torch.from_numpy(data[k]) for k in ("frames", "patch_embeds") if k in data}
            with torch.no_grad():
                logits = model.forward(params, torch.from_numpy(data["prompt"]),
                                       last_only=True, **kw).logits
            res["prefill"] = S.full_tensor(logits).clone()
            res["prefill_placements"] = placement_names(logits)
        decode = ShapeConfig("decode", "decode", case["max_len"], B)
        with S.axis_rules(mesh, rules_for(cfg, decode, mesh)):
            params = params_from_numpy(cfg, tree, "cpu", model=model)
            state = decode_state_from_numpy(model, unflat(
                {k[len("state/"):]: v for k, v in data.items() if k.startswith("state/")}),
                "cpu")
            res["state_placements"] = {k: placement_names(v) for k, v in flat(state).items()}
            steps = []
            for t in range(data["tokens"].shape[1]):
                logits, state = model.decode_step(
                    params, state, torch.from_numpy(data["tokens"][:, t:t + 1]),
                    torch.from_numpy(data["pos"] + t))
                steps.append(S.full_tensor(logits).clone())
            res["decode"] = steps
            res["logits_placements"] = placement_names(logits)
            res["state"] = {k: S.full_tensor(v).clone() for k, v in flat(state).items()}
        out[case["name"]] = res
    return out


def _tree_of_arrays(example):
    """A restore example from its JSON description: {name: [shape, dtype]} nested."""
    if isinstance(example, dict) and "shape" not in example:
        return {k: _tree_of_arrays(v) for k, v in example.items()}
    return np.zeros(example["shape"], example["dtype"])


TASKS = {"spmv": _spmv, "compressed": _compressed, "pipeline": _pipeline,
         "sharding": _sharding, "mesh_train": _mesh_train, "mesh_decode": _mesh_decode}


def rank_main(job_path: str, rank: int) -> None:
    job = json.loads(pathlib.Path(job_path).read_text())
    world = job["world"]
    dist.init_process_group("gloo", init_method=f"file://{job['store']}", rank=rank,
                            world_size=world)
    try:
        results = {t: TASKS[t](world, **job["params"].get(t, {})) for t in job["tasks"]}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(results, pathlib.Path(job["out"]) / f"rank{rank}.pt")


# ---------------------------------------------------------------------------
# the launcher the tests call
# ---------------------------------------------------------------------------

class Ranks:
    """``world`` rank processes of ``tasks``, started at once."""

    def __init__(self, tasks, world: int, workdir: pathlib.Path, params=None):
        workdir = workdir.resolve()         # a file:// URL takes an absolute path
        workdir.mkdir(parents=True, exist_ok=True)
        self.workdir, self.world = workdir, world
        job = workdir / "job.json"
        job.write_text(json.dumps(dict(tasks=list(tasks), world=world, params=params or {},
                                       store=str(workdir / "store"), out=str(workdir))))
        env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
        # each rank logs to a file: a rank blocked on a full pipe would hang the others
        self.logs = [workdir / f"rank{r}.log" for r in range(world)]
        self.procs = []
        for r, log in enumerate(self.logs):
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, __file__, str(job), str(r)], env=env, stdout=f,
                    stderr=subprocess.STDOUT))

    def wait(self, timeout: float) -> list[dict]:
        """Every rank's results; fails on a rank that fails or outlives ``timeout``."""
        deadline = time.monotonic() + timeout
        try:
            for p in self.procs:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"{self.world} ranks still running after {timeout} s")
        finally:
            self.kill()
        bad = [(r, p.returncode, log.read_text()[-3000:]) for r, (p, log) in
               enumerate(zip(self.procs, self.logs)) if p.returncode != 0]
        assert not bad, bad
        return [torch.load(self.workdir / f"rank{r}.pt", weights_only=False)
                for r in range(self.world)]

    def kill(self) -> None:
        """End every rank still running (a job left behind when another failed)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


if __name__ == "__main__":
    rank_main(sys.argv[1], int(sys.argv[2]))
