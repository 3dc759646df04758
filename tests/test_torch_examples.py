"""The port's five examples (``examples_torch/``) against the JAX repo's
(``examples/``), on the CPU.

Each reference example runs as it is, its ``main()`` driven with spies on
the names it calls so that its objects can be read: the CB structure and y
of ``quickstart`` (its ``ops.cb_spmv`` at ``impl="reference"``), the CG
result of ``solve_poisson``, the gathered y of ``distributed_spmv`` (in one
subprocess with 8 forced host devices, while the port's 8 gloo ranks run at
``--device cpu``, each side bounded by 120 s), the config, weights and
engine of ``serve_decode`` and the initial state and history of
``train_lm``. The LM examples run at a smaller depth (2 layers, float32),
the port's from the reference's weights (``params_from_numpy``,
``train_state_from_numpy``). Tolerances: quickstart's y 1e-5 and
distributed_spmv's 1e-5 of max|y|; CG iterations within 2 and x within 1e-4
(the solver tests' margins); train_lm's losses within 1e-4 of the
reference's; tokens equal.
"""
import dataclasses
import importlib.util
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

from repro.configs.base import ModelConfig as JConfig
from repro.serving import ServingEngine as JEngine
from repro.training import OPTIMIZERS as JOPT, TrainState as JState
from repro.training import run_training as j_run
from repro_torch.models import Model, params_from_numpy
from repro_torch.training import run_training as t_run
from repro_torch.training import train_state_from_numpy

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:            # the examples' package, for the spawned ranks too
    sys.path.insert(0, str(REPO))

from examples_torch import distributed_spmv as t_dist  # noqa: E402
from examples_torch import quickstart as t_quick  # noqa: E402
from examples_torch import serve_decode as t_serve  # noqa: E402
from examples_torch import solve_poisson as t_poisson  # noqa: E402
from examples_torch import train_lm as t_train  # noqa: E402

TIMEOUT = 120          # seconds for the JAX subprocess (the port's ranks: t_dist.TIMEOUT_S)
LM_LAYERS = 2          # the LM examples' depth in these tests (the examples: 4 and 12)
LOSS_TOL = 1e-4        # train_lm's losses, relative to max(1, |loss|)


def _reference(name: str):
    """A fresh module of ``examples/<name>.py`` (its own globals, safe to spy on)."""
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _copy(tree):
    """Host copies of a JAX tree (the train step donates its buffers)."""
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def test_quickstart_matches_the_reference():
    ref, seen = _reference("quickstart"), {}
    build, spmv = ref.build_streams, ref.ops.cb_spmv

    def spy_build(cb):
        seen["cb"] = cb
        return build(cb)

    def spy_spmv(streams, x):
        seen["y"] = np.asarray(spmv(streams, x, impl="reference"))
        return seen["y"]

    ref.build_streams = spy_build
    ref.ops = types.SimpleNamespace(cb_spmv=spy_spmv)
    ref.main()
    out = t_quick.main(["--device", "cpu"])
    assert out["stats"] == seen["cb"].stats()
    y, want = out["y"].numpy(), seen["y"]
    assert y.shape == want.shape and y.dtype == np.float32
    assert np.abs(y - want).max() <= 1e-5 * max(1.0, np.abs(want).max())
    assert out["err_vs_oracle"] < 1e-3


# ---------------------------------------------------------------------------
# solve_poisson
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [3, 40])
def test_poisson_2d_is_the_references_bit_for_bit(g):
    ref = _reference("solve_poisson")
    got, want = t_poisson.poisson_2d(g), ref.poisson_2d(g)
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_solve_poisson_matches_the_reference():
    ref, seen = _reference("solve_poisson"), {}
    cg = ref.cg

    def spy_cg(*a, **kw):
        seen["res"] = cg(*a, **kw)
        return seen["res"]

    ref.cg = spy_cg
    ref.main()
    out = t_poisson.main(["--device", "cpu"])
    want = seen["res"]
    assert out["converged"] and bool(want.converged)
    assert abs(out["iterations"] - int(want.iterations)) <= 2
    x_ref = np.asarray(want.x)
    assert np.abs(out["x"] - x_ref).max() <= 1e-4 * max(1.0, np.abs(x_ref).max())
    assert sorted(out["amortization"]) == sorted({1, 10, 100, out["iterations"]})


# ---------------------------------------------------------------------------
# distributed_spmv: the reference on 8 host devices, the port on 8 gloo ranks
# ---------------------------------------------------------------------------

JAX_SIDE = r"""
import importlib.util, sys
import numpy as np
spec = importlib.util.spec_from_file_location("ref_dist", sys.argv[1])
ex = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ex)
seen = {}
run = ex.dist.distributed_spmv

def spy(sharded, x, mesh, **kw):
    y = run(sharded, x, mesh, **kw)
    seen.update(y=np.asarray(y), device_nnz=np.asarray(sharded.device_nnz),
                load_imbalance=sharded.load_imbalance)
    return y

ex.dist.distributed_spmv = spy
ex.main()
np.savez(sys.argv[2], **seen)
"""


def test_distributed_spmv_matches_the_reference(tmp_path):
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, str(REPO / "examples" / "distributed_spmv.py"),
         str(tmp_path / "jax.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        out = t_dist.main(["--device", "cpu"])
        log, _ = jax_proc.communicate(timeout=TIMEOUT)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0, log
    want = np.load(tmp_path / "jax.npz")
    assert out["device_nnz"] == want["device_nnz"].tolist()
    assert out["load_imbalance"] == float(want["load_imbalance"])
    assert out["ranks"] == 8 and out["ranks_agree"] and not out["one_card"]
    assert out["rank_launches"] == {"dense": 0, "panel": 0, "panel_bitmap": 0, "coo": 0,
                                    "combine": 0}
    y, y_ref = out["y"], want["y"]
    assert y.shape == y_ref.shape
    assert np.abs(y - y_ref).max() <= 1e-5 * np.abs(y_ref).max()


# ---------------------------------------------------------------------------
# serve_decode
# ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


def _reference_serve_config() -> JConfig:
    """The config the reference's ``main`` builds (it stops at ``Model``)."""
    ref, seen = _reference("serve_decode"), {}

    def capture(cfg):
        seen["cfg"] = cfg
        raise _Stop

    ref.Model = capture
    with pytest.raises(_Stop):
        ref.main()
    return seen["cfg"]


def test_serve_decode_config_is_the_references():
    want, got = _reference_serve_config(), t_serve.build_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert (t_serve.SLOTS, t_serve.MAX_LEN, t_serve.N_REQUESTS) == (8, 128, 24)


def test_serve_decode_tokens_equal_the_reference(monkeypatch):
    ref, seen = _reference("serve_decode"), {}
    ref.ModelConfig = lambda **kw: JConfig(**kw).scaled(num_layers=LM_LAYERS, dtype="float32")

    class SpyEngine(JEngine):
        def __init__(self, model, params, **kw):
            super().__init__(model, params, **kw)
            seen.update(params=_copy(params), kw=kw)

        def run_until_done(self, *a, **kw):
            seen["done"] = super().run_until_done(*a, **kw)
            seen["ticks"] = self.ticks
            return seen["done"]

    ref.ServingEngine = SpyEngine
    ref.main()
    tcfg = t_serve.build_config().scaled(num_layers=LM_LAYERS, dtype="float32")
    params = params_from_numpy(tcfg, seen["params"], device="cpu")
    monkeypatch.setattr(t_serve, "build_config", lambda: tcfg)
    monkeypatch.setattr(Model, "init", lambda self, generator: params)
    out = t_serve.main(["--device", "cpu"])
    assert seen["kw"] == {"slots": t_serve.SLOTS, "max_len": t_serve.MAX_LEN}
    assert out["ticks"] == seen["ticks"] and out["served"] == out["requests"] == 24
    assert out["generated"] == {r.uid: list(r.generated) for r in seen["done"]}


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sparse", [True, False])
def test_train_lm_config_is_the_references(sparse):
    ref = _reference("train_lm")
    want, got = ref.build_config(sparse), t_train.build_config(sparse)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()


def test_train_lm_losses_match_the_reference(tmp_path, monkeypatch):
    argv = ["--steps", "3", "--batch", "2", "--seq", "32"]
    ref, seen = _reference("train_lm"), {}
    build = ref.build_config
    ref.build_config = lambda sparse: build(sparse).scaled(num_layers=LM_LAYERS)

    def spy_run(model, stream, loop, **kw):
        params, _ = model.init(jax.random.PRNGKey(0))   # what run_training draws itself
        state = JState.create(params, JOPT[loop.optimizer](), use_compression=False)
        seen.update(init=_copy(state), loop=loop)
        state, history = j_run(model, stream, loop, initial_state=state, **kw)
        seen["history"] = history
        return state, history

    ref.run_training = spy_run
    (tmp_path / "ref").mkdir()
    monkeypatch.chdir(tmp_path / "ref")
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *argv])
    ref.main()

    build_t = t_train.build_config
    monkeypatch.setattr(t_train, "build_config",
                        lambda sparse: build_t(sparse).scaled(num_layers=LM_LAYERS))
    state = train_state_from_numpy(seen["init"], device="cpu")
    monkeypatch.setattr(t_train, "run_training",
                        lambda *a, **kw: t_run(*a, **dict(kw, initial_state=state)))
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    out = t_train.main(argv + ["--device", "cpu"])
    want = seen["history"]
    assert [h["step"] for h in out["history"]] == [h["step"] for h in want] == [0, 2]
    for a, b in zip(out["history"], want):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(a[k] - b[k]) <= LOSS_TOL * max(1.0, abs(b[k])), (a["step"], k)
    assert out["losses"] == {h["step"]: h["loss"] for h in out["history"]}
    assert out["learning"] == (want[0]["loss"] - want[-1]["loss"] > 0)
    assert out["checkpoint_step"] == 3
    assert (tmp_path / "port" / "checkpoints" / "lm100m-cb").is_dir()
