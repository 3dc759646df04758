"""The port's runtime, checkpoint and training launcher (``repro_torch.runtime``,
``repro_torch.checkpoint``, ``repro_torch.launch.train``) against the JAX
package's, on the CPU.

Host code is held equal to the reference's outright: mesh plans, restart
decisions, heartbeat and straggler bookkeeping on a simulated clock, and
the fault injectors at the same seed (the same bytes flipped, entries
poisoned, values corrupted). Checkpoints are held to the reference's
layout by crossing them: a ``repro.training.run_training`` checkpoint
restored here, and one written here restored by ``repro``'s
``Checkpointer``, each continued by both packages to parameters within
1e-5 at float32, and with ``int8_ef`` within the train steps' bound for
flipped int8 ties (``tests/test_torch_training.py``).
"""
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed
from torch.distributed.tensor import DTensor, Shard

from repro import runtime as jrt
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs.base import ModelConfig as JConfig
from repro.core import CBMatrix as JCBMatrix
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import SyntheticTokenStream as JStream
from repro.models import Model as JModel
from repro.training import OPTIMIZERS as JOPT, TrainLoopConfig as JLoopConfig
from repro.training import TrainState as JState, run_training as j_run
from repro_torch import errors, runtime as trt
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.sharding import NamedSharding
from repro_torch.core import CBMatrix
from repro_torch.data.synthetic import DataConfig, SyntheticTokenStream
from repro_torch.models import Model
from repro_torch.training import OPTIMIZERS, TrainLoopConfig, TrainState, run_training
from repro_torch.training import train_state_from_numpy, train_state_to_numpy
from repro_torch.training.train_state import leaves_with_names

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 1e-5
TINY = dict(name="t", family="dense", num_layers=2, d_model=32, num_heads=2, num_kv_heads=1,
            d_ff=64, vocab_size=256, attn_chunk=32, remat="none", dtype="float32")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# elastic, fault tolerance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("devices,prefer,batch,pod", [
    (1, 1, 8, 256), (1, 16, None, 256), (32, 16, None, 256), (24, 16, None, 256),
    (10, 4, 8, 256), (256, 16, None, 256), (512, 16, None, 256), (240, 16, None, 256),
    (7, 16, None, 256), (1024, 8, 64, 128), (96, 16, 12, 32)])
def test_plan_mesh_equals_the_reference(devices, prefer, batch, pod):
    kw = dict(prefer_model=prefer, global_batch=batch, pod_size=pod)
    got, want = trt.plan_mesh(devices, **kw), jrt.plan_mesh(devices, **kw)
    assert (got.shape, got.axis_names, got.dropped_devices, got.num_devices) == \
        (want.shape, want.axis_names, want.dropped_devices, want.num_devices)
    other = (trt.plan_mesh(max(1, devices // 2)), jrt.plan_mesh(max(1, devices // 2)))
    assert trt.reshard_instructions(got, other[0]) == jrt.reshard_instructions(want, other[1])


def test_plan_mesh_refuses_no_devices():
    with pytest.raises(errors.InvalidArgError):
        trt.plan_mesh(0)


def _drive_monitor(pkg):
    """The reference's heartbeat scenarios (tests/test_runtime.py,
    tests/test_faults.py) on one package's monitor; returns what it saw."""
    clock = FakeClock()
    mon = pkg.HeartbeatMonitor(num_hosts=3, timeout_s=10.0, straggler_factor=2.0, clock=clock)
    seen = []
    for step in range(3):
        clock.t += 1.0
        for h in range(3):
            mon.heartbeat(step, host_id=h)
    seen.append(mon.check())
    for step in range(3, 8):                     # host 2 goes silent
        clock.t += 3.0
        mon.heartbeat(step, host_id=0)
        mon.heartbeat(step, host_id=1)
    seen += [mon.check(), mon.check(), mon.alive_hosts]
    clock.t += 40.0                              # one slow step
    mon.heartbeat(8, host_id=0)
    mon.report_straggler(9, 42.0)
    pkg.lose_host(mon, 1)
    seen += [mon.check(), list(mon.stragglers), mon.step_ewma]

    class FakeCk:
        def latest_step(self):
            return 40

    policy = pkg.RestartPolicy(FakeCk(), mon, max_restarts=1)
    seen.append(vars(policy.on_failure()))
    try:
        policy.on_failure()
    except Exception as e:                       # the typed budget error of each package
        seen.append((type(e).__name__, e.code))
    return seen


def test_heartbeats_stragglers_and_restart_policy_equal_the_reference():
    got, want = _drive_monitor(trt), _drive_monitor(jrt)
    assert got == want
    assert got[-1] == ("RestartBudgetError", errors.RESTART_BUDGET_EXHAUSTED)
    assert got[1] == [2] and got[2] == [] and got[4] == [1]


def _supervised(ckpt_cls, directory, fail_on, max_restarts, pkg, num_steps=8):
    def step(state, step_idx):
        return state * 2 + step_idx

    flaky = pkg.FlakyStepFn(step, fail_on=fail_on)
    ckpt = ckpt_cls(str(directory), async_write=False)
    mon = pkg.HeartbeatMonitor(num_hosts=1, timeout_s=1e9, clock=FakeClock())
    policy = pkg.RestartPolicy(ckpt, mon, max_restarts=max_restarts)
    final = pkg.run_supervised(flaky, np.asarray(1, np.int64), num_steps=num_steps,
                               checkpointer=ckpt, policy=policy, checkpoint_every=2)
    return final, policy, flaky


def test_run_supervised_with_flaky_steps_replays_bitwise(tmp_path):
    fault_free, _, _ = _supervised(Checkpointer, tmp_path / "a", (), 0, trt)
    injected, policy, flaky = _supervised(Checkpointer, tmp_path / "b", {5}, 3, trt)
    want, jpolicy, _ = _supervised(JCheckpointer, tmp_path / "c", {5}, 3, jrt)
    assert int(injected) == int(fault_free) == int(want)
    assert policy.restarts == jpolicy.restarts == 1 and flaky.failures == 1
    with pytest.raises(errors.RestartBudgetError) as e:
        _supervised(Checkpointer, tmp_path / "d", set(range(100)), 2, trt)
    assert e.value.code == errors.RESTART_BUDGET_EXHAUSTED


def test_run_supervised_trains_a_torch_state(tmp_path):
    """A torch tensor state under supervision: a failed step restores it from
    the newest checkpoint as a tensor, and the replay ends bit-equal."""
    def step(state, i):
        return state * 1.5 + i

    def run(fail_on, d):
        ckpt = Checkpointer(str(tmp_path / d), async_write=True)
        mon = trt.HeartbeatMonitor(num_hosts=1, timeout_s=1e9, clock=FakeClock())
        return trt.run_supervised(trt.FlakyStepFn(step, fail_on=fail_on),
                                  torch.linspace(0, 1, 5), num_steps=6, checkpointer=ckpt,
                                  policy=trt.RestartPolicy(ckpt, mon, max_restarts=2))

    clean, faulty = run((), "a"), run({0, 4}, "b")
    assert isinstance(faulty, torch.Tensor) and torch.equal(clean, faulty)


# ---------------------------------------------------------------------------
# fault injectors, the same seed
# ---------------------------------------------------------------------------

def test_flip_file_bytes_flips_the_same_bytes(tmp_path):
    data = np.random.default_rng(0).bytes(4096)
    for seed, kw in ((0, {}), (3, {"n": 7}), (5, {"n": 3, "start": 100, "stop": 200})):
        a, b = tmp_path / f"a{seed}", tmp_path / f"b{seed}"
        a.write_bytes(data)
        b.write_bytes(data)
        assert trt.flip_file_bytes(a, seed=seed, **kw) == jrt.flip_file_bytes(b, seed=seed, **kw)
        assert a.read_bytes() == b.read_bytes() != data
    with pytest.raises(errors.InvalidArgError):
        trt.flip_file_bytes(a, start=10, stop=10)


def test_poison_vector_and_flaky_step_fn_equal_the_reference():
    x = np.arange(50, dtype=np.float32)
    for kw in ({}, {"n": 4, "seed": 2}, {"n": 3, "seed": 1, "value": np.inf}):
        np.testing.assert_array_equal(trt.poison_vector(x, **kw), jrt.poison_vector(x, **kw))
    fn = trt.FlakyStepFn(lambda v: v + 1, fail_on={0, 2})
    with pytest.raises(errors.InjectedFault) as e:
        fn(1)
    assert e.value.code == errors.INJECTED
    assert fn(1) == 2
    with pytest.raises(errors.InjectedFault):
        fn(1)
    assert fn(10) == 11 and (fn.calls, fn.failures) == (4, 2)


def test_corrupt_packed_values_writes_the_same_bytes():
    rng = np.random.default_rng(1)
    rows, cols = rng.integers(0, 60, 400), rng.integers(0, 50, 400)
    keys = np.unique(rows * 50 + cols)
    rows, cols = keys // 50, keys % 50
    vals = rng.standard_normal(len(keys)).astype(np.float32)
    jcb = JCBMatrix.from_coo(rows, cols, vals, (60, 50), block_size=8, val_dtype=np.float32)
    tcb = CBMatrix.from_coo(rows, cols, vals, (60, 50), block_size=8, val_dtype=np.float32)
    for kw in ({}, {"n": 5, "seed": 3}, {"n": 2, "seed": 1, "value": np.inf}):
        tbad, jbad = trt.corrupt_packed_values(tcb, **kw), jrt.corrupt_packed_values(jcb, **kw)
        np.testing.assert_array_equal(tbad.packed, jbad.packed)
        tbad.validate()                          # structure untouched
        with pytest.raises(errors.NonFiniteError):
            tbad.validate(check_finite=True)


# ---------------------------------------------------------------------------
# checkpoints: atomicity, GC, and the reference's layout both ways
# ---------------------------------------------------------------------------

def test_checkpointer_atomicity_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_write=False)
    state = {"w": torch.arange(4.0), "step": torch.tensor(3)}
    for s in (1, 2, 3):
        ck.save(state, s)
    assert ck.list_steps() == [2, 3] and ck.latest_step() == 3
    os.makedirs(tmp_path / "step_00000009.tmp")                 # a crashed write
    assert ck.list_steps() == [2, 3]
    got = ck.restore({"w": torch.zeros(4), "step": torch.tensor(0)})
    assert torch.equal(got["w"], torch.arange(4.0)) and int(got["step"]) == 3
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp") and "9" not in f]
    # elastic restore: every leaf placed on a one-rank CPU mesh, a DTensor
    # whose full tensor is the plain restore's; a tree of another shape refused
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                                         rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("data",), device_type="cpu")
        placed = ck.restore({"w": torch.zeros(4), "step": torch.tensor(0)},
                            shardings={"w": NamedSharding(mesh, ("data",)),
                                       "step": NamedSharding(mesh, ())})
        assert isinstance(placed["w"], DTensor) and placed["w"].placements == (Shard(0),)
        assert torch.equal(placed["w"].full_tensor(), torch.arange(4.0))
        assert int(placed["step"].full_tensor()) == 3
        with pytest.raises(errors.InvalidArgError, match="shardings"):
            ck.restore(state, shardings={"w": NamedSharding(mesh, ())})
    finally:
        torch.distributed.destroy_process_group()
    with pytest.raises(errors.InvalidArgError, match="leaves"):
        ck.restore({"w": torch.zeros(4)})
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(state)


def test_generic_states_cross_between_the_packages(tmp_path):
    """A dict of arrays written by either checkpointer reads back in the other."""
    state = {"w": np.arange(6.0).reshape(2, 3), "b": {"x": np.int32(7), "y": np.ones(2)}}
    JCheckpointer(str(tmp_path / "j"), async_write=False).save(
        jax.tree_util.tree_map(jnp.asarray, state), 4)
    got = Checkpointer(str(tmp_path / "j")).restore(state)
    Checkpointer(str(tmp_path / "t"), async_write=False).save(state, 4)
    back = JCheckpointer(str(tmp_path / "t")).restore(state)
    for tree in (got, back):
        np.testing.assert_array_equal(np.asarray(tree["w"]), state["w"])
        assert int(tree["b"]["x"]) == 7
    assert sorted(os.listdir(tmp_path / "j" / "step_00000004")) == \
        sorted(os.listdir(tmp_path / "t" / "step_00000004"))


def _pair(compression="none"):
    jm = JModel(JConfig(**TINY))
    tm = Model(ModelConfig(**TINY), "cpu")
    params, _ = jm.init(jax.random.PRNGKey(0))
    js = JState.create(params, JOPT["adamw"](), use_compression=compression != "none")
    return jm, tm, js


def _streams():
    return (JStream(JDataConfig(vocab_size=256, seq_len=32, global_batch=4)),
            SyntheticTokenStream(DataConfig(vocab_size=256, seq_len=32, global_batch=4)))


def _assert_params_close(tstate, jstate, compression="none", lr_steps=0.0):
    """Within ``F32_TOL``; with ``int8_ef`` all but the elements of a flipped
    int8 tie (at most 1e-3 of them, each within 2 lr a step: the bound of
    ``tests/test_torch_training.py``)."""
    got = [a for _, a in leaves_with_names(train_state_to_numpy(tstate).params)]
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jstate.params))
    assert len(got) == len(want)
    diff = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got, want)])
    if compression == "none":
        assert diff.max() <= F32_TOL
    else:
        assert (diff > F32_TOL).mean() <= 1e-3 and diff.max() <= 2 * lr_steps + F32_TOL


@pytest.mark.parametrize("compression", ["none", "int8_ef"])
def test_a_jax_checkpoint_continues_in_the_port(tmp_path, compression):
    jm, tm, js = _pair(compression)
    jstream, tstream = _streams()
    kw = dict(warmup_steps=2, checkpoint_every=4, compression=compression)
    jck = JCheckpointer(str(tmp_path), async_write=False)
    j_run(jm, jstream, JLoopConfig(total_steps=4, **kw), checkpointer=jck, initial_state=js)
    example = TrainState.create(tm.init(torch.Generator().manual_seed(3)), OPTIMIZERS["adamw"](),
                                use_compression=compression != "none")
    mid = Checkpointer(str(tmp_path)).restore(example)
    assert int(mid.step) == 4 and (mid.ef_buffers is None) == (compression == "none")
    jmid = jck.restore(_pair(compression)[2])
    jmid = jax.tree_util.tree_map(jnp.asarray, jmid)
    jend, _ = j_run(jm, jstream, JLoopConfig(total_steps=8, **kw), initial_state=jmid)
    tend, _ = run_training(tm, tstream, TrainLoopConfig(total_steps=8, **kw), initial_state=mid)
    assert int(tend.step) == int(jend.step) == 8
    _assert_params_close(tend, jend, compression, lr_steps=4 * TrainLoopConfig().peak_lr)


def test_a_port_checkpoint_continues_in_jax(tmp_path):
    jm, tm, js = _pair()
    jstream, tstream = _streams()
    kw = dict(warmup_steps=2, checkpoint_every=4)
    ts = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, js), device="cpu")
    ck = Checkpointer(str(tmp_path), async_write=True)
    tmid, _ = run_training(tm, tstream, TrainLoopConfig(total_steps=4, **kw), checkpointer=ck,
                           initial_state=ts)
    ck.wait()
    with open(tmp_path / "step_00000004" / "manifest.json") as f:
        assert json.load(f)["step"] == 4
    jmid = JCheckpointer(str(tmp_path)).restore(_pair()[2])
    jmid = jax.tree_util.tree_map(jnp.asarray, jmid)
    assert int(jmid.step) == 4
    jend, _ = j_run(jm, jstream, JLoopConfig(total_steps=8, **kw), initial_state=jmid)
    tend, _ = run_training(tm, tstream, TrainLoopConfig(total_steps=8, **kw), initial_state=tmid)
    _assert_params_close(tend, jend)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(*args, cwd):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_launch_train_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    out = _launch("--arch", "cb-paper", "--smoke", "--device", "cpu", "--steps", "3",
                  "--ckpt-dir", str(tmp_path), cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "mesh: {'data': 1, 'model': 1}  arch: cb-paper-smoke" in out.stdout
    assert "(one rank)" in out.stdout
    # more than one rank (torchrun's WORLD_SIZE) trains on a mesh, every family
    # (tests/test_torch_mesh.py): an SSM config goes on to join the process
    # group, here through env://, which finds no MASTER_ADDR
    from repro_torch.launch import train

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        train.main(["--arch", "mamba2-130m", "--smoke", "--device", "cpu", "--steps", "1",
                    "--ckpt-dir", str(tmp_path / "two")])
    monkeypatch.delenv("WORLD_SIZE")
    final = out.stdout.strip().splitlines()[-1]
    assert final.startswith("final:") and "'step': 2" in final
    ck = Checkpointer(str(tmp_path / "cb-paper-smoke"))
    assert ck.list_steps() == [3]
    # --resume picks up the checkpoint (written by this package or by the JAX one)
    out = _launch("--arch", "cb-paper", "--smoke", "--device", "cpu", "--steps", "5",
                  "--ckpt-dir", str(tmp_path), "--resume", cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "resumed from step 3" in out.stdout and ck.list_steps() == [3, 5]


def test_launch_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    from repro_torch.launch import train

    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(errors.DeviceUnavailableError):
            train.main(["--arch", "cb-paper", "--smoke", "--steps", "1", "--ckpt-dir", d])
