"""The JAX package's side of the port's mesh tests, and the checks against it.

``jax_side(script, base, cases, *args)`` starts subprocesses with
``--xla_force_host_platform_device_count=4`` that run the JAX package's
steps (``JAX_TRAIN``: single-device and sharded AdamW steps; ``JAX_DECODE``:
the sharded prefill and teacher-forced decode steps, jitted with the
reference dry run's in / out shardings under ``rules_for``), each case in
one of them, and saves them as npz files. The port's ranks are processes of ``torch_dist_ranks.py``;
both are bounded by a timeout.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np

import torch_dist_ranks as R
from repro.configs import get_smoke_config as jsmoke
from repro.models import Model as JModel

TIMEOUT = 300           # seconds for every job of ranks, and for the JAX subprocess
LOSS_TOL = 1e-4
RTOL, ATOL = 1e-4, 1e-5
LOGIT_TOL = 1e-4        # decode / prefill logits at float32, relative to their largest
STATE_TOL = 1e-5        # the decode state after the steps, absolute

_PRELUDE = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.configs import get_smoke_config
from repro.configs.base import ModelConfig, ShapeConfig
from repro.launch.mesh import rules_for
from repro.models import Model, axis_rules, logical_to_sharding
from repro.models.sharding import sanitize_shardings

def unflat(d):
    tree = {}
    for key, v in d.items():
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(v)
    return tree

def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out

def config(case):
    cfg = (ModelConfig(**case["config"]) if "config" in case
           else get_smoke_config(case["arch"]).scaled(dtype="float32"))
    return cfg.scaled(**case.get("overrides", {}))

def mesh_of(shape):
    n = shape[0] * shape[1]
    return compat.make_mesh(tuple(shape), ("data", "model"), devices=jax.devices()[:n])

def batch_sh(mesh, batch):
    return {k: NamedSharding(mesh, P(*(("data",) + (None,) * (v.ndim - 1))))
            for k, v in batch.items()}

out = {}
"""

JAX_TRAIN = _PRELUDE + r"""
from repro.training import build_train_step, TrainState, OPTIMIZERS, warmup_cosine
from repro.training.optimizer import AdamWState
for case in json.loads(sys.argv[2]):
    cfg = config(case)
    model = Model(cfg)
    _, axes = model.init(jax.random.PRNGKey(0))
    params = unflat(dict(np.load(case["init"])))
    batch = {k: jnp.asarray(v) for k, v in np.load(case["batch"]).items()}
    opt = OPTIMIZERS["adamw"]()
    step = build_train_step(model, opt, warmup_cosine(1e-3, 2, 100))
    rules = case.get("rules")

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
        mesh = mesh_of(shape)
        with axis_rules(mesh, rules):
            psh = sanitize_shardings(jax.eval_shape(lambda: params),
                                     logical_to_sharding(axes, mesh, rules), mesh)
            rep = NamedSharding(mesh, P())
            ssh = TrainState(step=rep, params=psh,
                             opt_state=AdamWState(mu=psh, nu=psh, count=rep), ef_buffers=None)
            f = jax.jit(step, in_shardings=(ssh, batch_sh(mesh, batch)),
                        out_shardings=(ssh, None))
            run(f, f"{case['name']}/{shape[0]}x{shape[1]}")
np.savez(sys.argv[1], **out)
"""

JAX_DECODE = _PRELUDE + r"""
for case in json.loads(sys.argv[2]):
    cfg = config(case)
    model = Model(cfg)
    _, axes = model.init(jax.random.PRNGKey(0))
    params = unflat(dict(np.load(case["init"])))
    data = dict(np.load(case["data"]))
    B = data["tokens"].shape[0]
    mesh = mesh_of(case["shape"])
    name = case["name"]
    # prefill: the forward's last position under the prefill shape's rules
    pre = ShapeConfig("prefill", "prefill", data["prompt"].shape[1], B)
    rules = rules_for(cfg, pre, mesh)
    if B % case["shape"][0]:                # a batch of one: replicated, as at decode
        rules["batch"] = None
    with axis_rules(mesh, rules):
        psh = sanitize_shardings(jax.eval_shape(lambda: params),
                                 logical_to_sharding(axes, mesh, rules), mesh)
        inputs = {"tokens": jnp.asarray(data["prompt"])}
        for k in ("frames", "patch_embeds"):
            if k in data:
                inputs[k] = jnp.asarray(data[k])
        def fwd(p, b):
            kw = {k: v for k, v in b.items() if k != "tokens"}
            return model.forward(p, b["tokens"], last_only=True, **kw).logits
        ish = logical_to_sharding({"tokens": ("batch", None), "frames": ("batch", "frames", "embed"),
                                   "patch_embeds": ("batch", "patches", "embed")}, mesh, rules)
        out[f"{name}/prefill"] = np.asarray(jax.jit(
            fwd, in_shardings=(psh, {k: ish[k] for k in inputs}))(params, inputs))
    # decode: teacher-forced steps under the decode shape's rules (dryrun.build_cell)
    dec = ShapeConfig("decode", "decode", case["max_len"], B)
    rules = rules_for(cfg, dec, mesh)
    state = unflat({k[len("state/"):]: v for k, v in data.items() if k.startswith("state/")})
    with axis_rules(mesh, rules):
        psh = sanitize_shardings(jax.eval_shape(lambda: params),
                                 logical_to_sharding(axes, mesh, rules), mesh)
        ssh = sanitize_shardings(jax.eval_shape(lambda: state),
                                 logical_to_sharding(model.decode_state_axes(), mesh, rules), mesh)
        bsh = logical_to_sharding({"tokens": ("batch", None), "pos": ("batch",)}, mesh, rules)
        step = jax.jit(lambda p, s, b: model.decode_step(p, s, b["tokens"], b["pos"]),
                       in_shardings=(psh, ssh, bsh), out_shardings=(None, ssh))
        for t in range(data["tokens"].shape[1]):
            b = {"tokens": jnp.asarray(data["tokens"][:, t:t + 1]),
                 "pos": jnp.asarray(data["pos"] + t)}
            logits, state = step(params, state, b)
            out[f"{name}/decode{t}"] = np.asarray(logits)
    for k, v in flat(state).items():
        out[f"{name}/state/{k}"] = v
np.savez(sys.argv[1], **out)
"""


def jax_config(case: dict):
    from repro.configs.base import ModelConfig as JModelConfig

    cfg = JModelConfig(**case["config"]) if "config" in case else \
        jsmoke(case["arch"]).scaled(dtype="float32")
    return cfg.scaled(**case.get("overrides", {}))


def init_weights(base, name: str, cfg) -> str:
    """The JAX package's ``init`` of key 0 as an npz; its path."""
    params, _ = JModel(cfg).init(jax.random.PRNGKey(0))
    path = base / f"{name}_init.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in R.flat(params).items()})
    return str(path)


def jax_side(script: str, base, cases: list, *args, parts: int = 2) -> list:
    """The JAX package's side, started as ``parts`` subprocesses, each with its
    share of the cases (compiling is most of their time), writing
    ``base/jax{i}.npz`` (``finish`` waits for them and merges their outputs)."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(R.SRC))
    return [(subprocess.Popen([sys.executable, "-c", script, str(base / f"jax{i}.npz"),
                               json.dumps(cases[i::parts]), *map(str, args)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True), base / f"jax{i}.npz")
            for i in range(min(parts, len(cases)))]


def finish(procs: list, jobs: dict, task: str) -> tuple[dict, dict]:
    """Wait for the JAX subprocesses and every job of ranks (killing what
    outlives ``TIMEOUT``); (each job's per-rank results of ``task``, the JAX
    side's arrays)."""
    logs = []
    try:
        for proc, _ in procs:
            logs.append(proc.communicate(timeout=TIMEOUT)[0])
        ranks = {k: [r[task] for r in job.wait(TIMEOUT)] for k, job in jobs.items()}
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for job in jobs.values():
            job.kill()
    for (proc, _), log in zip(procs, logs):
        assert proc.returncode == 0, log[-3000:]
    jx = {}
    for _, out in procs:
        jx.update(np.load(out))
    return ranks, jx


def check_train(res: dict, jx: dict, name: str, mesh: str) -> None:
    """A rank's steps against the JAX package's single-device and sharded
    steps: each loss within ``LOSS_TOL``, each grad norm within it relative,
    and every parameter and moment after the first step within rtol / atol."""
    for tag in (f"{name}/single", f"{name}/{mesh}"):
        assert len(res["losses"]) == R.TRAIN_STEPS
        for i, (loss, norm) in enumerate(zip(res["losses"], res["grad_norms"])):
            assert abs(loss - float(jx[f"{tag}/loss{i}"])) < LOSS_TOL, (tag, i, loss)
            np.testing.assert_allclose(norm, float(jx[f"{tag}/grad_norm{i}"]), rtol=LOSS_TOL)
        for part in ("params", "mu", "nu"):
            pre = f"{tag}/{part}/"
            want = {k[len(pre):]: v for k, v in jx.items() if k.startswith(pre)}
            tree = res["first"].params if part == "params" else \
                getattr(res["first"].opt_state, part)
            got = {k: np.asarray(v) for k, v in R.flat(tree).items()}
            assert sorted(want) == sorted(got), (tag, part)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                           err_msg=f"{tag} {part} {k}")


def close_logits(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max()) / scale
    assert err <= LOGIT_TOL, f"{what}: {err:.3e} of the logits' scale"
