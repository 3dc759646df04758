"""The port's serving stack (``repro_torch.serving``, ``repro_torch.launch.serve``)
against the JAX package's, on the CPU.

The reference's serving tests (``tests/test_runtime.py``, ``tests/test_faults.py``,
``tests/test_obs.py``) on the port's engine, and the port's greedy tokens
equal to the JAX package's at float32 from the same weights (carried
across with ``params_from_numpy``).
"""
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ModelConfig as JConfig
from repro.models import Model as JModel
from repro.serving import Request as JRequest, ServingEngine as JEngine
from repro.serving import greedy_decode as j_greedy
from repro_torch import errors, obs
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model, params_from_numpy
from repro_torch.runtime import FlakyStepFn
from repro_torch.serving import Request, ServingEngine, greedy_decode

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(name="t", family="dense", num_layers=2, d_model=32, num_heads=2, num_kv_heads=1,
            d_ff=64, vocab_size=128, attn_chunk=32, remat="none", dtype="float32")


@pytest.fixture(autouse=True)
def _clean_obs():
    """Every test starts enabled on the real clock with empty stores."""
    obs.configure(enabled=True, clock=time.monotonic)
    obs.reset()
    yield
    obs.configure(enabled=True, clock=time.monotonic)
    obs.reset()


def _pair(jcfg, tcfg):
    """(JAX model, its params, the port's model, the same params)."""
    jm = JModel(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(0))
    tm = Model(tcfg, "cpu")
    return jm, params, tm, params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")


def _tiny_model():
    _, _, model, params = _pair(JConfig(**TINY), ModelConfig(**TINY))
    return model, params


# ---------------------------------------------------------------------------
# tokens equal to the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tiny", "cb-paper", "qwen3-32b"])
def test_greedy_decode_tokens_equal_the_reference(arch):
    if arch == "tiny":
        jcfg, tcfg = JConfig(**TINY), ModelConfig(**TINY)
    else:
        jcfg, tcfg = (get(arch).scaled(dtype="float32") for get in (j_smoke, t_smoke))
    jm, jp, tm, tp = _pair(jcfg, tcfg)
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab_size, (3, 5)).astype(np.int32)
    want = np.asarray(j_greedy(jm, jp, jnp.asarray(prompts), 6))
    got = greedy_decode(tm, tp, torch.from_numpy(prompts), 6)
    assert got.dtype == torch.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_tokens_equal_the_reference_engine():
    jm, jp, tm, tp = _pair(JConfig(**TINY), ModelConfig(**TINY))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 128, rng.integers(2, 7)).astype(np.int32) for _ in range(5)]
    out = []
    for eng_cls, req_cls, model, params in ((JEngine, JRequest, jm, jp),
                                            (ServingEngine, Request, tm, tp)):
        eng = eng_cls(model, params, slots=2, max_len=32)
        for uid, p in enumerate(prompts):
            eng.submit(req_cls(uid=uid, prompt=p, max_new_tokens=4 + uid))
        out.append(({r.uid: r.generated for r in eng.run_until_done()}, eng.ticks))
    assert out[1] == out[0]


def test_engine_matches_direct_decode():
    """Continuous batching must produce the same tokens as greedy_decode."""
    model, params = _tiny_model()
    prompt = np.array([3, 14, 15, 9], np.int32)
    direct = greedy_decode(model, params, torch.from_numpy(prompt)[None, :], 5).numpy()[0]

    eng = ServingEngine(model, params, slots=3, max_len=64)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=5))
    # interference: other requests share the batch
    eng.submit(Request(uid=1, prompt=np.array([7, 7], np.int32), max_new_tokens=3))
    eng.submit(Request(uid=2, prompt=np.array([100], np.int32), max_new_tokens=7))
    done = {r.uid: r for r in eng.run_until_done()}
    np.testing.assert_array_equal(np.asarray(done[0].generated), direct)


def test_engine_slot_reuse():
    model, params = _tiny_model()
    eng = ServingEngine(model, params, slots=1, max_len=64)
    for uid in range(3):
        eng.submit(Request(uid=uid, prompt=np.array([uid + 1], np.int32), max_new_tokens=2))
    done = eng.run_until_done()
    assert sorted(r.uid for r in done) == [0, 1, 2]
    assert all(len(r.generated) == 2 for r in done)


def test_engine_ring_cache_wraps_past_max_len():
    """Prompt plus output longer than the cache: the ring buffer wraps and
    the engine keeps matching the reference's."""
    jm, jp, tm, tp = _pair(JConfig(**TINY), ModelConfig(**TINY))
    prompt = np.arange(1, 7, dtype=np.int32)
    out = []
    for eng_cls, req_cls, model, params in ((JEngine, JRequest, jm, jp),
                                            (ServingEngine, Request, tm, tp)):
        eng = eng_cls(model, params, slots=1, max_len=8)
        eng.submit(req_cls(uid=0, prompt=prompt, max_new_tokens=10))
        out.append(eng.run_until_done()[0].generated)
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# degradation (tests/test_faults.py)
# ---------------------------------------------------------------------------

def test_serving_queue_backpressure_is_typed():
    model, params = _tiny_model()
    eng = ServingEngine(model, params, slots=1, max_len=64, max_queue=1)
    reqs = [Request(uid=i, prompt=np.array([i + 1], np.int32), max_new_tokens=2)
            for i in range(3)]
    statuses = [eng.submit(r) for r in reqs]
    assert statuses == [errors.ACCEPTED, errors.QUEUE_FULL, errors.QUEUE_FULL]
    assert reqs[1].status == errors.QUEUE_FULL
    assert eng.health()["rejected"] == 2
    done = eng.run_until_done()
    assert [r.uid for r in done] == [0]


def test_serving_deadline_expires_and_frees_slot():
    model, params = _tiny_model()
    eng = ServingEngine(model, params, slots=1, max_len=64)
    slow = Request(uid=0, prompt=np.array([1], np.int32), max_new_tokens=500, deadline_ticks=3)
    quick = Request(uid=1, prompt=np.array([2], np.int32), max_new_tokens=2)
    eng.submit(slow)
    eng.submit(quick)
    done = eng.run_until_done(max_ticks=50)
    assert [r.uid for r in done] == [1]          # slot was reclaimed
    assert slow.status == errors.DEADLINE_EXCEEDED
    assert not slow.done
    h = eng.health()
    assert h["deadline_expired"] == 1 and h["completed"] == 1


def test_serving_tick_retry_is_bit_identical_to_fault_free():
    model, params = _tiny_model()
    prompt = np.array([3, 14, 15], np.int32)

    ref = ServingEngine(model, params, slots=2, max_len=64)
    ref.submit(Request(uid=0, prompt=prompt, max_new_tokens=4))
    baseline = ref.run_until_done()[0].generated
    ref_state = {k: v.clone() for k, v in ref.state.items()}

    eng = ServingEngine(model, params, slots=2, max_len=64, max_step_retries=2,
                        retry_backoff_s=0.01, sleep=lambda s: None)
    eng.step_fn = FlakyStepFn(eng.step_fn, fail_on={1, 3})
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=4))
    out = eng.run_until_done()[0].generated
    assert out == baseline
    assert eng.health()["retries"] == 2
    assert all(torch.equal(eng.state[k], ref_state[k]) for k in ref_state)


def test_serving_retry_exhaustion_raises_tick_error():
    model, params = _tiny_model()
    eng = ServingEngine(model, params, slots=1, max_len=64, max_step_retries=1,
                        sleep=lambda s: None)
    eng.step_fn = FlakyStepFn(eng.step_fn, fail_on=set(range(10)))
    eng.submit(Request(uid=0, prompt=np.array([1], np.int32), max_new_tokens=2))
    with pytest.raises(errors.TickError) as e:
        eng.tick()
    assert e.value.code == errors.TICK_FAILED
    assert "injected" in eng.health()["last_error"].lower()


# ---------------------------------------------------------------------------
# telemetry (tests/test_obs.py)
# ---------------------------------------------------------------------------

def test_serving_health_histograms_and_backoff():
    sleeps = []
    model, params = _tiny_model()
    eng = ServingEngine(model, params, slots=2, max_len=64, max_step_retries=2,
                        retry_backoff_s=0.5, sleep=sleeps.append)
    fail = {"n": 2}
    orig = eng.step_fn

    def flaky(params, state, tokens, pos):
        if fail["n"]:
            fail["n"] -= 1
            raise RuntimeError("injected step fault")
        return orig(params, state, tokens, pos)

    eng.step_fn = flaky
    eng.submit(Request(uid=0, prompt=np.array([1], np.int32), max_new_tokens=2))
    eng.run_until_done(max_ticks=16)
    h = eng.health()
    assert h["retries"] == 2
    # exponential backoff: 0.5 * 2^0 + 0.5 * 2^1, accumulated exactly
    assert h["backoff_total_s"] == pytest.approx(1.5)
    assert sleeps == [0.5, 1.0]
    assert h["deadline_miss_count"] == h["deadline_expired"] == 0
    assert h["tick_latency_s"]["count"] == h["ticks"] > 0
    assert h["queue_depth_hist"]["count"] == h["ticks"]
    assert obs.counter("repro.serving.ticks").total() == h["ticks"]
    assert obs.counter("repro.serving.retries").total() == 2
    names = [r.name for r in obs.tracer().records()]
    assert "serving.tick" in names


def test_serving_health_keeps_legacy_keys_when_disabled():
    obs.configure(enabled=False)
    model, params = _tiny_model()
    eng = ServingEngine(model, params, slots=2, max_len=64)
    eng.submit(Request(uid=0, prompt=np.array([1], np.int32), max_new_tokens=1))
    eng.run_until_done(max_ticks=8)
    h = eng.health()
    for key in ("ticks", "queue_depth", "active_slots", "completed",
                "rejected", "retries", "deadline_expired", "last_error"):
        assert key in h
    assert h["completed"] == 1
    assert h["tick_latency_s"]["count"] == 0
    assert obs.snapshot() == {}


def test_sparse_mlp_records_spmm_accounting_per_tick():
    """Each CB-sparse product records ``repro.ops.spmm.calls`` (and, for
    ``impl="cuda"``, its launch); a tick of cb-paper runs three a layer."""
    cfg = t_smoke("cb-paper").scaled(dtype="float32")
    for impl in ("cuda", "reference"):
        obs.reset()
        model = Model(cfg, "cpu", impl=impl)
        eng = ServingEngine(model, model.init(torch.Generator().manual_seed(0)),
                            slots=2, max_len=16)
        eng.submit(Request(uid=0, prompt=np.array([1, 2], np.int32), max_new_tokens=2))
        eng.run_until_done()
        per_tick = 3 * cfg.num_layers
        assert obs.counter("repro.ops.spmm.calls").total() == per_tick * eng.ticks
        launches = obs.counter("repro.ops.spmm.launches").total()
        assert launches == (per_tick * eng.ticks if impl == "cuda" else 0)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launch_serve_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "cb-paper", "--smoke",
         "--device", "cpu", "--requests", "3", "--max-new", "4"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("3 requests, 12 tokens, ") and "tok/s" in lines[0]
    assert len(lines) == 4 and all(ln.startswith("  req ") for ln in lines[1:])
