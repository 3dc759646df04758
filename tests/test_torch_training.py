"""The port's training path (``repro_torch.data.synthetic``, ``transformer.lm_loss``
and remat, ``repro_torch.training``, ``sparse.prune.refreeze_training_step``)
against the JAX package's, on the CPU at smoke size.

Every case builds its inputs with numpy from a seed and hands the same
arrays to both packages; whole models get the JAX ``Model.init`` weights
(``train_state_from_numpy`` / ``params_from_numpy``). The models are the
reference's ``_tiny_cfg`` (``tests/test_training.py``) and ``cb-paper-smoke``
(CB-sparse SwiGLU). Tolerances:

* synthetic batches, int8 codes and scales, remat modes: bit for bit;
* the schedule: ``LR_ULPS`` float32 ulps of the reference's eager lr. The
  aim was one ulp, but XLA's float32 ``cos`` is itself not correctly
  rounded (the port's is), ``1 + cos`` near 0 triples an ulp of it, and the
  reference's jitted lr differs from its own eager lr by up to 8 ulps;
* loss and gradients: ``F32_TOL`` = 1e-5 at float32 (measured ~1.4e-6 of a
  gradient leaf's largest magnitude; both sides sum the same products in
  another order), ``BF16_TOL`` = 2^-5 of the scale at bfloat16 (measured up
  to 0.025: bfloat16 rounds at other places in the two frameworks, see
  ``tests/test_torch_models.py``);
* train steps at float32: parameters and metrics within ``F32_TOL`` after
  3 steps (measured 6e-8). With ``int8_ef`` an int8 code sitting on a
  rounding tie flips by one when the gradient differs in its last bit
  (measured: one code of 35k a step). That element's gradient moves by one
  quantization step (amax / 127 of its leaf), so ``grad_norm`` is held to
  ``INT8_NORM_TOL`` (measured 5.5e-5), and its Adam update by up to 2 lr:
  such elements (``INT8_FLIP_SHARE`` of them at most; measured 1 of
  34,976) are held to 2 lr a step.
"""
import dataclasses
import math
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ModelConfig as JConfig
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import SyntheticTokenStream as JStream
from repro.models import Model as JModel
from repro.sparse import linear as JL
from repro.sparse import prune as JP
from repro.training import grad_compression as jgc
from repro.training import optimizer as jopt
from repro.training import schedule as jsched
from repro.training import OPTIMIZERS as JOPT, TrainLoopConfig as JLoopConfig
from repro.training import TrainState as JState, build_train_step as j_build
from repro.training import run_training as j_run
from repro_torch import configs as tconfigs
from repro_torch import obs
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import DataConfig, SyntheticTokenStream
from repro_torch.models import Model, params_from_numpy
from repro_torch.sparse import linear as TL
from repro_torch.sparse import prune as TP
from repro_torch.training import grad_compression as tgc
from repro_torch.training import optimizer as topt
from repro_torch.training import schedule as tsched
from repro_torch.training import OPTIMIZERS, TrainLoopConfig, TrainState, build_train_step
from repro_torch.training import run_training, train_state_from_numpy, train_state_to_numpy
from repro_torch.training.train_state import leaves_with_names, map_leaves, stacked_tree, to_numpy

F32_TOL = 1e-5
BF16_TOL = 2.0**-5
LR_ULPS = 2
INT8_FLIP_SHARE = 1e-3
INT8_NORM_TOL = 1e-3
TINY = dict(name="t", family="dense", num_layers=2, d_model=32, num_heads=2, num_kv_heads=1,
            d_ff=64, vocab_size=256, attn_chunk=32, remat="none")


def _cfgs(name: str, **kw):
    """The same config in both packages: ``tiny`` or a smoke arch."""
    if name == "tiny":
        return JConfig(**TINY).scaled(**kw), ModelConfig(**TINY).scaled(**kw)
    return (jconfigs.get_smoke_config(name).scaled(**kw),
            tconfigs.get_smoke_config(name).scaled(**kw))


def _models(name: str, **kw):
    """(JAX model, its params, the port's model, the same params on the CPU)."""
    jc, tc = _cfgs(name, **kw)
    jm = JModel(jc)
    params, _ = jm.init(jax.random.PRNGKey(0))
    tm = Model(tc, "cpu")
    return jm, params, tm, params_from_numpy(tc, _host(params), device="cpu")


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(a) -> np.ndarray:
    """A JAX, torch or numpy array as float32 numpy (bfloat16 widened exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _port_leaves(tm_params, values=None) -> list:
    """The port's values in the reference's leaf order, layers stacked."""
    tree = stacked_tree(tm_params, values)
    return [a for _, a in leaves_with_names(map_leaves(to_numpy, tree))]


def _close_leaves(got: list, want: list, tol: float, what: str) -> float:
    """Each leaf within ``tol`` of its own largest magnitude; returns the worst ratio."""
    worst = 0.0
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        g, w = _f32(g), _f32(w)
        assert g.shape == w.shape and np.isfinite(g).all(), what
        scale = float(np.abs(w).max()) or 1.0
        worst = max(worst, float(np.abs(g - w).max()) / scale)
    assert worst <= tol, f"{what}: {worst:.3e} > {tol}"
    return worst


def _batch(vocab: int, seed: int, B: int = 2, S: int = 16, cfg=None) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg is not None and cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# data, schedule, int8 codes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,hosts", [(64, 16, 4, 1), (256, 32, 4, 2),
                                                    (49152, 256, 8, 1), (512, 8, 6, 3)])
def test_synthetic_batches_bit_equal(vocab, seq, batch, hosts):
    for host in range(hosts):
        j = JStream(JDataConfig(vocab, seq, batch, seed=7), host_id=host, num_hosts=hosts)
        t = SyntheticTokenStream(DataConfig(vocab, seq, batch, seed=7), host_id=host,
                                 num_hosts=hosts)
        for step in (0, 1, 13):
            jb, tb = j.batch(step), t.batch(step)
            for k in ("tokens", "targets"):
                assert tb[k].dtype == jb[k].dtype == np.int32
                np.testing.assert_array_equal(tb[k], jb[k])
        assert [b["tokens"].tolist() for _, b in zip(range(2), t)] == \
            [b["tokens"].tolist() for _, b in zip(range(2), j)]


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("args", [(3e-4, 10, 100), (1.0, 10, 100), (1e-3, 2, 10), (3e-4, 0, 5),
                                  (1e-2, 37, 1001)])
def test_schedule_matches_the_reference(args):
    steps = range(args[2] + 5)
    want = np.asarray(jnp.stack([jsched.warmup_cosine(*args)(s) for s in steps]))
    fn = tsched.warmup_cosine(*args)
    got = torch.stack([fn(s) for s in steps])
    assert got.dtype == torch.float32
    assert _ulps(got.numpy(), want) <= LR_ULPS
    as_tensor = torch.stack([fn(torch.tensor(s, dtype=torch.int32)) for s in steps])
    assert torch.equal(as_tensor, got)
    assert tsched.constant(args[0])(torch.tensor(3)).item() == float(jsched.constant(args[0])(3))


def _int8_inputs(seed: int) -> list[np.ndarray]:
    """Random values, values on exact rounding ties (k + 1/2 codes), zeros."""
    rng = np.random.default_rng(seed)
    ties = (np.arange(-20, 20) + 0.5).astype(np.float32) * np.float32(127.0 / 19.5)
    return [rng.standard_normal((7, 33)).astype(np.float32) * 3, ties,
            np.zeros(5, np.float32), rng.standard_normal(1000).astype(np.float32) * 1e-3]


@pytest.mark.parametrize("seed", range(3))
def test_int8_codes_bit_equal(seed):
    for x in _int8_inputs(seed):
        (jq, js), (tq, ts) = jgc.quantize_int8(jnp.asarray(x)), tgc.quantize_int8(
            torch.from_numpy(x))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.item() == float(js)
        np.testing.assert_array_equal(tgc.dequantize_int8(tq, ts).numpy(),
                                      np.asarray(jgc.dequantize_int8(jq, js)))
        ef = np.random.default_rng(seed + 9).standard_normal(x.shape).astype(np.float32) * 0.01
        jq, js, je = jgc.ef_quantize(jnp.asarray(x), jnp.asarray(ef))
        tq, ts, te = tgc.ef_quantize(torch.from_numpy(x), torch.from_numpy(ef))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_int8_stacked_leaf_is_the_references_one_leaf():
    """A layer-stacked leaf, one tensor a layer here, takes the stack's one scale."""
    rng = np.random.default_rng(4)
    g = rng.standard_normal((3, 6, 5)).astype(np.float32)
    e = rng.standard_normal((3, 6, 5)).astype(np.float32) * 0.01
    g[1] *= 10                                       # the largest layer sets the scale
    jq, js, je = jgc.ef_quantize(jnp.asarray(g), jnp.asarray(e))
    tq, ts, te = tgc.ef_quantize_stacked([torch.from_numpy(a) for a in g],
                                         [torch.from_numpy(a) for a in e])
    assert ts.item() == float(js)
    np.testing.assert_array_equal(torch.stack(tq).numpy(), np.asarray(jq))
    np.testing.assert_array_equal(torch.stack(te).numpy(), np.asarray(je))
    jd, jn = jgc.ef_compress_grads({"tiles": jnp.asarray(g)}, {"tiles": jnp.asarray(e)})
    td, tn = tgc.ef_compress_grads({"tiles": torch.from_numpy(g)}, {"tiles": torch.from_numpy(e)})
    np.testing.assert_array_equal(td["tiles"].numpy(), np.asarray(jd["tiles"]))
    np.testing.assert_array_equal(tn["tiles"].numpy(), np.asarray(jn["tiles"]))
    assert torch.equal(tgc.init_ef_buffers({"tiles": torch.ones(2, 3)})["tiles"],
                       torch.zeros(2, 3))


# ---------------------------------------------------------------------------
# optimizers, one update against the reference's
# ---------------------------------------------------------------------------

def _opt_tree(seed: int):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k, shape in (("a", (5, 7)), ("b", (13,)), ("c", (2, 3, 4)))}


@pytest.mark.parametrize("name,kw", [("adamw", {}), ("adamw", {"weight_decay": 0.0}),
                                     ("adamw", {"moments_dtype": "bfloat16"}), ("lion", {})])
def test_optimizer_updates_match_the_reference(name, kw, monkeypatch):
    """Four updates with the gradients of both sides fed the same; then
    ``apply_updates``. Chunks of one tensor each exercise ``_chunks``."""
    monkeypatch.setattr(topt, "CHUNK_ELEMS", 20)
    tkw = dict(kw)
    if "moments_dtype" in kw:
        kw = {"moments_dtype": jnp.bfloat16}
        tkw = {"moments_dtype": torch.bfloat16}
    jo, to = JOPT[name](**kw), OPTIMIZERS[name](**tkw)
    p = _opt_tree(0)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = [torch.from_numpy(p[k].copy()) for k in sorted(p)]
    js, ts = jo.init(jp), to.init(tp)
    for step in range(4):
        g = _opt_tree(step + 1)
        ju, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, 1e-2)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update([torch.from_numpy(g[k].copy()) for k in sorted(g)], ts, tp,
                           torch.tensor(1e-2))
        topt.apply_updates(tp, tu)
        _close_leaves(tu, [ju[k] for k in sorted(g)], F32_TOL, f"{name} updates {step}")
    _close_leaves(tp, [jp[k] for k in sorted(p)], F32_TOL, f"{name} params")
    moments = [ts.mu] + ([ts.nu] if name == "adamw" else [])
    jmoments = [js.mu] + ([js.nu] if name == "adamw" else [])
    for tm, jm in zip(moments, jmoments):
        assert all(t.dtype == (torch.bfloat16 if "moments_dtype" in tkw else torch.float32)
                   for t in tm)
        _close_leaves(tm, [jm[k] for k in sorted(p)],
                      BF16_TOL if "moments_dtype" in tkw else F32_TOL, f"{name} moments")
    assert int(ts.count) == int(js.count) == 4


def test_clip_by_global_norm_matches_the_reference():
    g = _opt_tree(5)
    for max_norm in (1.0, 1e3):
        jc, jn = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        tc, tn = topt.clip_by_global_norm([torch.from_numpy(g[k].copy()) for k in sorted(g)],
                                          max_norm)
        assert abs(tn.item() - float(jn)) <= F32_TOL * float(jn)
        _close_leaves(tc, [jc[k] for k in sorted(g)], F32_TOL, "clipped")
    assert topt.global_norm([torch.full((4,), 3.0), torch.full((4,), 4.0)]).item() == \
        pytest.approx(10.0)


# ---------------------------------------------------------------------------
# loss, gradients and remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "cb-paper", "internvl2-2b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_loss_and_grads_match_jax_grad(name, dtype):
    jm, params, tm, tp = _models(name, dtype=dtype)
    batch = _batch(tm.cfg.vocab_size, 3, cfg=tm.cfg)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(params, _jb(batch))
    tl, tmet = tm.loss(tp, _tb(batch))
    tl.backward()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert tl.dtype == torch.float32 and set(tmet) == set(jmet) == {"xent", "aux", "zloss"}
    for k in ("xent", "zloss"):
        assert abs(tmet[k].item() - float(jmet[k])) <= tol * abs(float(jmet[k]))
    assert abs(tl.item() - float(jl)) <= tol * abs(float(jl))
    _close_leaves(_port_leaves(tp, [p.grad for p in tp.parameters()]),
                  jax.tree_util.tree_leaves(jg), tol, f"{name} {dtype} grads")


def test_gathered_target_logit_is_the_one_hot_sum_bit_for_bit():
    rng = np.random.default_rng(6)
    logits = torch.from_numpy(rng.standard_normal((3, 5, 40)).astype(np.float32) * 4)
    logits[..., 33:] = -1e9                                 # padded vocabulary ids
    tgt = torch.from_numpy(rng.integers(0, 33, (3, 5)))
    one_hot = torch.nn.functional.one_hot(tgt, 40).float()
    assert torch.equal(torch.gather(logits, -1, tgt[..., None])[..., 0],
                       torch.sum(logits * one_hot, -1))


@pytest.fixture
def _obs_on():
    """obs enabled for the test, the process's switch restored after it."""
    was = obs.is_enabled()
    obs.configure(enabled=True)
    yield
    obs.configure(enabled=was)


@pytest.mark.parametrize("name", ["tiny", "cb-paper"])
def test_remat_modes_are_bit_equal(name, _obs_on):
    """none / full / dots: the same loss and gradients, bit for bit; on the
    sparse model "full" and "dots" rerun each layer's three products (obs's
    launch count, which the wrappers' plain path on the CPU still records)."""
    out, launches = {}, {}
    for remat in ("none", "full", "dots"):
        _, _, tm, tp = _models(name, dtype="float32", remat=remat)
        before = obs.counter("repro.ops.spmm.launches").total()
        loss, _ = tm.loss(tp, _tb(_batch(tm.cfg.vocab_size, 4)))
        loss.backward()
        launches[remat] = obs.counter("repro.ops.spmm.launches").total() - before
        out[remat] = [loss.detach()] + [p.grad for p in tp.parameters()]
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(out["none"], out[remat])), remat
    if name == "cb-paper":
        L = tm.cfg.num_layers
        assert launches == {"none": 6 * L, "full": 9 * L, "dots": 9 * L}


def test_dots_policy_saves_the_products_without_batch_dims():
    """The outputs of mm and of einsum's batch-of-one bmm are saved; batched
    products and everything else are recomputed."""
    from repro_torch.models import transformer as TT

    x, w = torch.randn(6, 16), torch.randn(16, 8)
    a, b = torch.randn(4, 5, 3), torch.randn(4, 3, 2)
    saved = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    assert TT._dots_policy(None, torch.ops.aten.mm.default, x, w) == saved
    assert TT._dots_policy(None, torch.ops.aten.bmm.default, x[None], w[None]) == saved
    assert TT._dots_policy(None, torch.ops.aten.bmm.default, a, b) != saved
    assert TT._dots_policy(None, torch.ops.aten.silu.default, x) != saved


# ---------------------------------------------------------------------------
# the train step and the loop
# ---------------------------------------------------------------------------

def _states(name: str, optimizer: str, compression: str, **kw):
    jm, params, tm, _ = _models(name, dtype="float32", **kw)
    jo, to = JOPT[optimizer](), OPTIMIZERS[optimizer]()
    js = JState.create(params, jo, use_compression=compression != "none")
    ts = train_state_from_numpy(_host(js), device="cpu")
    return jm, jo, js, tm, to, ts


def _hold_params(ts, js, compression: str, lr_steps: float, what: str):
    got = train_state_to_numpy(ts)
    gl = jax.tree_util.tree_leaves(got.params)
    wl = jax.tree_util.tree_leaves(_host(js.params))
    if compression == "none":
        for g, w in zip(gl, wl):
            assert np.abs(g - w).max() <= F32_TOL, what
        return
    diff = np.concatenate([np.abs(g - w).ravel() for g, w in zip(gl, wl)])
    assert (diff > F32_TOL).mean() <= INT8_FLIP_SHARE, what
    assert diff.max() <= 2 * lr_steps + F32_TOL, what


@pytest.mark.parametrize("optimizer", ["adamw", "lion"])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("compression", ["none", "int8_ef"])
def test_train_steps_match_the_reference(optimizer, microbatches, compression):
    jm, jo, js, tm, to, ts = _states("tiny", optimizer, compression)
    lr = 1e-3
    kw = dict(microbatches=microbatches, compression=compression)
    jstep = jax.jit(j_build(jm, jo, jsched.warmup_cosine(lr, 2, 100), **kw))
    tstep = build_train_step(tm, to, tsched.warmup_cosine(lr, 2, 100), **kw)
    for step in range(3):
        batch = _batch(tm.cfg.vocab_size, 10 + step, B=4)
        js, jmet = jstep(js, _jb(batch))
        ts, tmet = tstep(ts, _tb(batch))
        assert set(tmet) == set(jmet)
        for k in jmet:
            tol = INT8_NORM_TOL if (k, compression) == ("grad_norm", "int8_ef") else F32_TOL
            assert abs(tmet[k].item() - float(jmet[k])) <= tol * max(1.0, abs(float(jmet[k]))), k
    assert int(ts.step) == 3
    _hold_params(ts, js, compression, 3 * lr, f"{optimizer} mb={microbatches} {compression}")
    got = train_state_to_numpy(ts)
    want = jax.tree_util.tree_leaves(_host(js.opt_state))
    have = [a for _, a in leaves_with_names(got.opt_state)]
    assert len(have) == len(want)
    for tm_, jm_ in zip(have, want):
        assert tm_.shape == jm_.shape and tm_.dtype == jm_.dtype


def test_train_steps_match_the_reference_with_the_sparse_mlp():
    jm, jo, js, tm, to, ts = _states("cb-paper", "adamw", "none")
    jstep = jax.jit(j_build(jm, jo, jsched.warmup_cosine(1e-3, 2, 100)))
    tstep = build_train_step(tm, to, tsched.warmup_cosine(1e-3, 2, 100))
    for step in range(3):
        batch = _batch(tm.cfg.vocab_size, 20 + step)
        js, _ = jstep(js, _jb(batch))
        ts, _ = tstep(ts, _tb(batch))
    _hold_params(ts, js, "none", 0.0, "cb-paper-smoke adamw")


def test_run_training_loss_curves_match_the_reference():
    jm, jo, js, tm, to, ts = _states("tiny", "adamw", "none")
    stream_j = JStream(JDataConfig(vocab_size=256, seq_len=32, global_batch=4))
    stream_t = SyntheticTokenStream(DataConfig(vocab_size=256, seq_len=32, global_batch=4))
    jcfg = JLoopConfig(total_steps=8, log_every=1, warmup_steps=2)
    tcfg = TrainLoopConfig(total_steps=8, log_every=1, warmup_steps=2)
    _, jh = j_run(jm, stream_j, jcfg, initial_state=js)
    state, th = run_training(tm, stream_t, tcfg, initial_state=ts)
    assert [h["step"] for h in th] == [h["step"] for h in jh] == list(range(8))
    for a, b in zip(th, jh):
        for k in ("loss", "grad_norm", "lr", "xent", "zloss"):
            assert abs(a[k] - b[k]) <= F32_TOL * max(1.0, abs(b[k])), (a["step"], k)
    assert np.mean([h["loss"] for h in th[-3:]]) < np.mean([h["loss"] for h in th[:3]])
    assert int(state.step) == 8 and state is ts                 # trained in place


def test_run_training_from_scratch_and_resume_is_exact():
    """The reference's own loop test on the port: the loss falls, and a run
    restored at step 5 finishes with the straight run's parameters."""
    cfg = ModelConfig(**TINY)
    model = Model(cfg, "cpu")
    stream = SyntheticTokenStream(DataConfig(vocab_size=256, seq_len=32, global_batch=4))
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, async_write=False)
        state, hist = run_training(model, stream, TrainLoopConfig(
            total_steps=10, checkpoint_every=5, log_every=1, warmup_steps=2), checkpointer=ck)
        losses = [h["loss"] for h in hist]
        assert np.mean(losses[-3:]) < np.mean(losses[:3]) and all(map(math.isfinite, losses))
        assert ck.list_steps() == [5, 10]
        example = TrainState.create(model.init(torch.Generator().manual_seed(1)),
                                    OPTIMIZERS["adamw"]())
        mid = ck.restore(example, step=5)
        assert int(mid.step) == 5
        state2, _ = run_training(model, stream, TrainLoopConfig(
            total_steps=10, log_every=2, warmup_steps=2), initial_state=mid)
        for a, b in zip(state.params.parameters(), state2.params.parameters()):
            assert torch.equal(a, b)


def test_run_training_heartbeats_and_stragglers():
    from repro_torch.runtime import HeartbeatMonitor

    model = Model(ModelConfig(**TINY), "cpu")
    stream = SyntheticTokenStream(DataConfig(vocab_size=256, seq_len=8, global_batch=2))
    mon = HeartbeatMonitor(num_hosts=1)
    _, hist = run_training(model, stream, TrainLoopConfig(
        total_steps=3, log_every=10, step_deadline_s=0.0), monitor=mon)
    assert [h["step"] for h in hist] == [0, 2]                 # log_every, and the last step
    assert mon.hosts[0].last_step == 2
    assert {s for s, _ in mon.stragglers} == {0, 1, 2}         # every step over a 0 s deadline


# ---------------------------------------------------------------------------
# train state, the checkpoint's async snapshot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optimizer,compression", [("adamw", "none"), ("lion", "int8_ef")])
def test_train_state_round_trips_the_reference_layout(optimizer, compression):
    jm, jo, js, tm, to, ts = _states("cb-paper", optimizer, compression)
    back = train_state_to_numpy(ts)
    want = _host(js)
    assert [n for n, _ in leaves_with_names(back)] == \
        ["__".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)
         for path, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    for (_, g), w in zip(leaves_with_names(back), jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert isinstance(ts.opt_state, (topt.AdamWState, topt.LionState))
    assert len(ts.opt_state.mu) == len(list(ts.params.parameters()))


def test_train_state_bfloat16_moments_round_trip():
    _, params, tm, tp = _models("tiny", dtype="float32")
    jo = JOPT["adamw"](moments_dtype=jnp.bfloat16)
    js = JState.create(params, jo)
    js = dataclasses.replace(js, opt_state=dataclasses.replace(
        js.opt_state, mu=jax.tree_util.tree_map(lambda m: m + 1.5, js.opt_state.mu)))
    ts = train_state_from_numpy(_host(js), device="cpu")
    assert ts.opt_state.mu[0].dtype == torch.bfloat16 and ts.opt_state.mu[0].eq(1.5).all()
    for (_, g), w in zip(leaves_with_names(train_state_to_numpy(ts).opt_state.mu),
                         jax.tree_util.tree_leaves(_host(js.opt_state.mu))):
        np.testing.assert_array_equal(g.view(np.uint16), w.view(np.uint16))


def test_async_save_writes_the_state_of_its_step(tmp_path):
    """``save`` copies the state to the host before its thread starts: the
    in-place update right after it does not reach the checkpoint."""
    _, _, tm, tp = _models("tiny", dtype="float32")
    to = OPTIMIZERS["adamw"]()
    state = TrainState.create(tp, to)
    before = train_state_to_numpy(state)
    ck = Checkpointer(str(tmp_path), async_write=True)
    ck.save(state, 1)
    with torch.no_grad():                                  # the next step, in place
        for p in state.params.parameters():
            p.add_(1.0)
        for m in state.opt_state.mu:
            m.add_(2.0)
        state.step += 1
    ck.wait()
    got = ck.restore(state)
    assert int(got.step) == 0 and int(state.step) == 1
    for (_, g), (_, w) in zip(leaves_with_names(train_state_to_numpy(got)),
                              leaves_with_names(before)):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# refreeze_training_step
# ---------------------------------------------------------------------------

def test_refreeze_training_step_matches_the_reference():
    """12 EF-int8 SGD steps with every_k=4 on the same layer: the same
    ``changed`` flags and final specs, tiles and losses within ``F32_TOL``,
    and the spec object kept while the mask holds. The layer is pruned at
    keep 0.6 and refrozen at 0.4, so the first refreeze (step 4) drifts the
    mask and the later ones hold it."""
    jparams, jspec = JL.cb_linear_init(jax.random.PRNGKey(4), 48, 32, block_size=16,
                                       keep_fraction=0.6)
    fields = {f.name: getattr(jspec, f.name) for f in dataclasses.fields(jspec)}
    tparams, tspec = TL.from_numpy(_host(jparams), fields, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 48)).astype(np.float32)
    y = x @ (rng.standard_normal((48, 32)) * 0.1).astype(np.float32)
    jef, tef = jgc.init_ef_buffers(jparams), tgc.init_ef_buffers(tparams)
    flags, spec_ids = [], []
    for step in range(12):
        jparams, jef, jspec, jloss, jchanged = JP.refreeze_training_step(
            jparams, jef, jspec, jnp.asarray(x), jnp.asarray(y), step=step, every_k=4, lr=0.05,
            keep_fraction=0.4)
        prev = tspec
        tparams, tef, tspec, tloss, tchanged = TP.refreeze_training_step(
            tparams, tef, tspec, torch.from_numpy(x), torch.from_numpy(y), step=step,
            every_k=4, lr=0.05, keep_fraction=0.4)
        flags.append((jchanged, tchanged))
        assert (tspec is prev) == (not tchanged)
        spec_ids.append(id(tspec))
        assert abs(tloss.item() - float(jloss)) <= F32_TOL * float(jloss)
        np.testing.assert_allclose(tparams["tiles"].numpy(), np.asarray(jparams["tiles"]),
                                   rtol=F32_TOL, atol=F32_TOL)
    assert all(j == t for j, t in flags), flags
    assert [t for _, t in flags] == [step == 4 for step in range(12)]
    assert tef["tiles"].shape == tparams["tiles"].shape
    for f in ("brow", "bcol", "t_perm", "browT", "bcolT"):
        np.testing.assert_array_equal(getattr(tspec, f), np.asarray(getattr(jspec, f)))
    assert spec_ids[0] == spec_ids[1] == spec_ids[2] == spec_ids[3]
