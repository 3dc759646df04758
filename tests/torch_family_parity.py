"""Shared helpers of the model-family parity tests (``tests/test_torch_ssm.py``,
``test_torch_moe.py``, ``test_torch_hybrid_encdec.py``).

Inputs are numpy arrays from a seed; the weights are the JAX ``Model.init``
tree carried across with ``params_from_numpy``. Tolerances are those of
``tests/test_torch_models.py``: ``F32_TOL`` 1e-4 and ``BF16_TOL`` 2^-5 of the
result's scale; gradients as ``check_grads`` says.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import Model as JModel
from repro.serving import ServingEngine as JEngine, Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.models import Model as TModel, params_from_numpy
from repro_torch.models.model import param_tree, tree_values
from repro_torch.serving import Request, ServingEngine
from repro_torch.training.train_state import leaves_with_names, map_leaves, stacked_tree, \
    to_numpy

F32_TOL = 1e-4
BF16_TOL = 2.0**-5
DECODE_TOL = 2e-3          # teacher-forced decode vs forward, float32 (tests/test_models.py)
BF16_GRAD_SPREAD = 3.0     # bfloat16 gradients: per leaf, times the reference's own spread
REPO = pathlib.Path(__file__).resolve().parents[1]


def tol(dtype: str) -> float:
    return BF16_TOL if dtype == "bfloat16" else F32_TOL


def f32(a) -> np.ndarray:
    """A JAX, torch or numpy array as float32 numpy (bfloat16 widened exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def close(got, want, tolerance: float, what: str = "") -> float:
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tolerance * scale, f"{what}: max abs err {err:.3e} > {tolerance} * {scale:.3e}"
    return err


def both(x: np.ndarray, dtype: str = "float32"):
    """The same numpy array as a JAX and a torch array of ``dtype``."""
    j = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    t = torch.from_numpy(np.ascontiguousarray(x)).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return j, t


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def torch_tree(tree):
    """A numpy tree as float32 torch tensors (the reference's dict layout)."""
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def cfgs(arch: str, **kw):
    """The same smoke config in both packages."""
    return (jconfigs.get_smoke_config(arch).scaled(**kw),
            tconfigs.get_smoke_config(arch).scaled(**kw))


def models(arch: str, dtype: str = "float32", **kw):
    """(JAX model, its params, the port's model on the CPU, the same params)."""
    jc, tc = cfgs(arch, dtype=dtype, **kw)
    jm = JModel(jc)
    params, _ = jm.init(jax.random.PRNGKey(0))
    tm = TModel(tc, "cpu")
    return jm, params, tm, params_from_numpy(tc, host(params), device="cpu")


def port_leaves(tp, values=None) -> list:
    """The port's values in the reference's leaf order, layers stacked."""
    return [a for _, a in leaves_with_names(map_leaves(to_numpy, stacked_tree(tp, values)))]


def batch_for(cfg, seed: int, B: int = 2, S: int = 8) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, cfg.num_frames, cfg.d_model)).astype(
            np.float32)
    return batch


def check_whole_model(arch: str, dtype: str) -> None:
    """``forward`` logits and aux loss, ``loss`` and its gradients against
    ``jax.grad``, and teacher-forced ``decode_step`` against the reference's;
    at float32 also the port's decode against its own forward (the
    reference's check)."""
    jm, params, tm, tp = models(arch, dtype)
    cfg, t = tm.cfg, tol(dtype)
    batch = batch_for(cfg, 5)
    toks = batch["tokens"]
    B, S = toks.shape
    dt = "bfloat16" if dtype == "bfloat16" else "float32"
    jkw, tkw = {}, {}
    if cfg.family == "encdec":
        jkw["frames"], tkw["frames"] = both(batch["frames"], dt)

    # forward
    jout = jax.jit(lambda p, tk, kw: jm.forward(p, tk, **kw))(params, jnp.asarray(toks), jkw)
    with torch.no_grad():
        tout = tm.forward(tp, torch.from_numpy(toks), **tkw)
    assert tout.logits.dtype == cfg.activation_dtype
    close(tout.logits, jout.logits, t, f"{arch} {dtype} forward")
    close(tout.aux_loss, jout.aux_loss, t, f"{arch} {dtype} aux")
    if cfg.family == "moe":
        assert float(tout.aux_loss) > 0

    # loss and gradients
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(params, jb)
    tl, tmet = tm.loss(tp, tb)
    tl.backward()
    assert tl.dtype == torch.float32 and set(tmet) == set(jmet)
    assert abs(tl.item() - float(jl)) <= t * abs(float(jl)), (tl.item(), float(jl))
    want_f32 = None
    if dtype == "bfloat16":       # the reference's float32 gradients, the same weights
        jm32 = JModel(jm.cfg.scaled(dtype="float32"))
        want_f32 = jax.tree_util.tree_leaves(
            jax.jit(jax.grad(lambda p, b: jm32.loss(p, b)[0]))(params, jb))
    check_grads(port_leaves(tp, [p.grad for p in tp.parameters()]),
                jax.tree_util.tree_leaves(jg), dtype, f"{arch} {dtype}", want_f32)

    # teacher-forced decode
    jst, tst = jm.init_decode_state(B, S + 4), tm.init_decode_state(B, S + 4)
    if cfg.family == "encdec":
        from repro.models import encdec as jencdec
        from repro_torch.models import encdec as tencdec
        jst["cross"] = jencdec.precompute_cross(params, jm.cfg, jkw["frames"])
        tst["cross"] = tencdec.precompute_cross(tp, cfg, tkw["frames"])
    jstep = jax.jit(jm.decode_step)
    dec, ref = [], []
    for s in range(S):
        pos = np.full((B,), s, np.int32)
        lg, jst = jstep(params, jst, jnp.asarray(toks[:, s:s + 1]), jnp.asarray(pos))
        tlg, tst = tm.decode_step(tp, tst, torch.from_numpy(toks[:, s:s + 1]),
                                  torch.from_numpy(pos))
        ref.append(f32(lg))
        dec.append(f32(tlg))
    dec, ref = np.stack(dec, 1), np.stack(ref, 1)
    close(dec, ref, t, f"{arch} {dtype} decode")
    if dtype == "float32":
        np.testing.assert_allclose(dec, f32(tout.logits), rtol=DECODE_TOL, atol=DECODE_TOL)


def check_grads(got: list, want: list, dtype: str, what: str, want_f32=None) -> None:
    """float32: every leaf within ``F32_TOL`` of its own largest magnitude.

    bfloat16: every leaf within ``BF16_GRAD_SPREAD`` times the reference's
    own bfloat16 spread, ``||port - ref|| <= 3 ||ref - ref_f32|| + F32_TOL
    ||ref_f32||`` (L2 over the leaf; ``want_f32`` the reference's float32
    gradients of the same weights and batch), and the whole gradient within
    ``BF16_TOL`` of the reference's in relative L2 norm. A max-abs bound
    per leaf could not hold: a gradient that sums many bfloat16-rounded
    terms which cancel is noisy in both packages (at zamba2's smoke size
    the reference's own bfloat16 gradients stand 2-11% from its float32
    ones, max-abs over each leaf's scale).

    Readings the bound was set from (smoke size, this check's batch), the
    ratio ``||port - ref|| / ||ref - ref_f32||``: at most 2.14 (zamba2
    ``A_log``, whose terms cancel to 1e-3 of their size), 1.43 (mamba2
    ``D``), 1.08 (whisper), 1.07 (llama4), 0.91 (mixtral); zamba2's LoRA A
    factors have gradients of exactly 0 in both packages. A port whose ``dt_bias``
    enters the softplus 5% too large reads 2.75 (mamba2 ``in_dt``) and 4.79
    (zamba2 ``A_log``), while the whole-tree norm stays at 0.013 and 0.021,
    inside ``BF16_TOL``.
    """
    assert len(got) == len(want), what
    if dtype == "bfloat16":
        assert want_f32 is not None and len(want_f32) == len(want), what
    num = den = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = f32(g), f32(w)
        assert g.shape == w.shape and np.isfinite(g).all(), (what, i)
        if dtype == "float32":
            scale = float(np.abs(w).max()) or 1.0
            err = float(np.abs(g - w).max())
            assert err <= F32_TOL * scale, f"{what} grad leaf {i}: {err:.3e} > {scale:.3e}"
        else:
            w32 = f32(want_f32[i])
            spread = float(np.linalg.norm(w - w32))
            err = float(np.linalg.norm(g - w))
            bound = BF16_GRAD_SPREAD * spread + F32_TOL * float(np.linalg.norm(w32))
            assert err <= bound, (f"{what} grad leaf {i}: L2 {err:.3e} > {BF16_GRAD_SPREAD} x "
                                  f"the reference's bfloat16 spread {spread:.3e}")
        num += float(np.square(g - w).sum())
        den += float(np.square(w).sum())
    assert num <= (tol(dtype) ** 2) * den, f"{what} grads: relative L2 {(num / den) ** 0.5:.3e}"


def check_trees(arch: str) -> None:
    """``params_from_numpy`` bit-equal, ``param_tree`` of it the reference's
    tree (the identity), ``train_state`` crossing both ways, and
    ``Model.axes()`` equal to the reference's, at smoke and full size."""
    from repro.training import OPTIMIZERS as JOPT, TrainState as JState
    from repro_torch.training import train_state_from_numpy, train_state_to_numpy

    jm, params, tm, tp = models(arch)
    want = jax.tree_util.tree_flatten_with_path(host(params))[0]
    got = leaves_with_names(map_leaves(to_numpy, stacked_tree(tp)))
    assert [n for n, _ in got] == ["__".join(str(k.key) for k in p) for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert sum(p.numel() for p in tp.parameters()) == sum(a.size for _, a in want)
    assert tree_values(tp, param_tree(tp)) == list(tp.parameters())

    js = JState.create(params, JOPT["adamw"]())
    js = host(dataclasses.replace(js, opt_state=dataclasses.replace(
        js.opt_state, mu=jax.tree_util.tree_map(lambda m: m + 0.5, js.opt_state.mu))))
    ts = train_state_from_numpy(js, device="cpu")
    assert type(ts.params) is type(tp)
    for (_, g), w in zip(leaves_with_names(train_state_to_numpy(ts)),
                         jax.tree_util.tree_leaves(js)):
        np.testing.assert_array_equal(g, w)

    for get in ("get_smoke_config", "get_config"):
        assert TModel(getattr(tconfigs, get)(arch), "cpu").axes() == \
            JModel(getattr(jconfigs, get)(arch)).axes()
        assert TModel(getattr(tconfigs, get)(arch), "cpu").decode_state_axes() == \
            JModel(getattr(jconfigs, get)(arch)).decode_state_axes()


def check_axes_match_params(arch: str) -> None:
    """The port's own axis tree against its parameter tree: key for key, one
    logical axis a dim, ``w_layers`` leading each stacked level."""
    model = TModel(tconfigs.get_smoke_config(arch), "cpu")
    params = param_tree(model.init(torch.Generator().manual_seed(0)))

    def ndim(leaf):
        return 1 + ndim(leaf[0]) if isinstance(leaf, list) else leaf.ndim

    def levels(leaf):
        return 1 + levels(leaf[0]) if isinstance(leaf, list) else 0

    def walk(axes, leaf):
        if isinstance(axes, dict):
            assert sorted(axes) == sorted(leaf)
            for k in axes:
                walk(axes[k], leaf[k])
            return
        assert len(axes) == ndim(leaf), (axes, ndim(leaf))
        n = levels(leaf)
        assert axes[:n] == ("w_layers",) * n, axes

    walk(model.axes(), params)


def greedy_matches(arch: str) -> None:
    """The port's greedy tokens equal the JAX package's at float32."""
    from repro.serving import greedy_decode as j_greedy
    from repro_torch.serving import greedy_decode

    jm, jp, tm, tp = models(arch)
    prompts = np.random.default_rng(0).integers(0, tm.cfg.vocab_size, (3, 5)).astype(np.int32)
    want = np.asarray(j_greedy(jm, jp, jnp.asarray(prompts), 6))
    got = greedy_decode(tm, tp, torch.from_numpy(prompts), 6)
    assert got.dtype == torch.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def engine_matches(arch: str) -> None:
    """``launch/serve``'s traffic at smoke size (fewer requests) through both
    engines: the same tokens per request, float32."""
    jm, jp, tm, tp = models(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tm.cfg.vocab_size, rng.integers(2, 7)).astype(np.int32)
               for _ in range(5)]
    je = JEngine(jm, jp, slots=2, max_len=32)
    te = ServingEngine(tm, tp, slots=2, max_len=32)
    for uid, p in enumerate(prompts):
        je.submit(JRequest(uid=uid, prompt=p, max_new_tokens=4))
        te.submit(Request(uid=uid, prompt=p, max_new_tokens=4))
    jd = {r.uid: r.generated for r in je.run_until_done()}
    td = {r.uid: r.generated for r in te.run_until_done()}
    assert td == jd and len(td) == len(prompts)
    assert te.ticks == je.ticks


def run_launcher(module: str, *args, cwd) -> str:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout
