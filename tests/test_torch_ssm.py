"""The port's Mamba2 / SSD block (``repro_torch.models.ssm``) and the ssm family
(mamba2-130m) against the JAX package's, at smoke size on the CPU.

Tolerances: ``F32_TOL`` 1e-4 and ``BF16_TOL`` 2^-5 of the result's scale
(``tests/torch_family_parity.py``). The SSD checks mirror the reference's
own (``tests/test_models.py``: chunked == step-by-step); the chunk-128
gradient check documents ROADMAP C.8, the reference's overflow.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm

import torch_family_parity as fp

ARCH = "mamba2-130m"


def _ssd_inputs(seed: int, B=2, L=32, nh=4, hd=16, ds=8, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, L, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, nh)))).astype(np.float32) * dt_scale
    A = -np.exp(rng.standard_normal(nh) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((B, L, ds)).astype(np.float32)
    Cm = rng.standard_normal((B, L, ds)).astype(np.float32)
    S0 = rng.standard_normal((B, nh, hd, ds)).astype(np.float32)
    return xh, dt, A, Bm, Cm, S0


@pytest.mark.parametrize("chunk", [8, 32])
@pytest.mark.parametrize("initial", [False, True], ids=["zero_state", "initial_state"])
def test_ssd_chunked_matches_the_reference(chunk, initial):
    xh, dt, A, Bm, Cm, S0 = _ssd_inputs(0)
    args = (xh, dt, A, Bm, Cm)
    kw = {"initial_state": S0} if initial else {}
    jy, jS = jssm.ssd_chunked(*map(jnp.asarray, args), chunk,
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    ty, tS = tssm.ssd_chunked(*map(torch.from_numpy, args), chunk,
                              **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert ty.dtype == tS.dtype == torch.float32
    fp.close(ty, jy, fp.F32_TOL, "y")
    fp.close(tS, jS, fp.F32_TOL, "final state")


def test_ssd_chunked_matches_the_sequential_recurrence():
    """SSD chunked == the step-by-step recurrence (the duality claim)."""
    xh, dt, A, Bm, Cm, _ = (torch.from_numpy(a) for a in _ssd_inputs(3))
    y_chunk, S_last = tssm.ssd_chunked(xh, dt, A, Bm, Cm, chunk=8)
    B, L, nh, hd = xh.shape
    S = torch.zeros((B, nh, hd, Bm.shape[-1]))
    ys = []
    for t in range(L):
        decay = torch.exp(dt[:, t] * A[None, :])
        S = decay[:, :, None, None] * S + torch.einsum("bh,bhp,bs->bhps", dt[:, t], xh[:, t],
                                                       Bm[:, t])
        ys.append(torch.einsum("bs,bhps->bhp", Cm[:, t], S))
    np.testing.assert_allclose(y_chunk.numpy(), torch.stack(ys, 1).numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(S_last.numpy(), S.numpy(), rtol=1e-4, atol=1e-4)


def _ssd_grads(args, chunk):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y, S = tssm.ssd_chunked(*ts, chunk=chunk)
    (y.square().sum() + S.square().sum()).backward()
    return y.detach(), [t.grad for t in ts]


def test_ssd_chunk_8_and_32_agree_in_outputs_and_gradients():
    args = _ssd_inputs(4)[:5]
    y8, g8 = _ssd_grads(args, 8)
    y32, g32 = _ssd_grads(args, 32)
    fp.close(y8, y32, fp.F32_TOL, "y")
    for name, a, b in zip(("xh", "dt", "A", "B", "C"), g8, g32):
        assert torch.isfinite(a).all()
        fp.close(a, b, fp.F32_TOL, f"grad {name}")


def _mixer(cfg_kw: dict):
    jc, tc = fp.cfgs(ARCH, **{"dtype": "float32", **cfg_kw})
    jp, _ = jssm.ssm_init(jax.random.PRNGKey(1), jc)
    return jc, tc, jp, fp.torch_tree(fp.host(jp))


def test_chunk_128_gradients_are_finite_in_the_port_and_not_in_the_reference():
    """ROADMAP C.8: at the real chunk (128) the reference's where(causal,
    exp(seg), 0) overflows above the diagonal and its backward gives 0 * inf.
    The port masks seg first: finite, and equal to its own chunk-32 gradients."""
    jc, tc, jp, tp = _mixer({"ssm_chunk": 128})
    x = np.random.default_rng(5).standard_normal((1, 128, tc.d_model)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jnp.square(jssm.ssm_apply(p, jc, jnp.asarray(x))[0]))

    jg = jax.grad(jloss)(jp)
    bad = sorted(k for k, g in jg.items() if not np.isfinite(np.asarray(g)).all())
    assert {"A_log", "dt_bias", "in_dt"} <= set(bad), bad

    grads = {}
    for chunk in (128, 32):
        p = {k: v.clone().requires_grad_() for k, v in tp.items()}
        out, _ = tssm.ssm_apply(p, tc.scaled(ssm_chunk=chunk), torch.from_numpy(x))
        out.square().sum().backward()
        grads[chunk] = {k: v.grad for k, v in p.items()}
    for k, g in grads[128].items():
        assert torch.isfinite(g).all(), k
        scale = float(grads[32][k].abs().max()) or 1.0
        assert float((g - grads[32][k]).abs().max()) <= fp.F32_TOL * scale, k
    # where the reference's gradient is finite, the port's is the reference's
    for k in sorted(set(jg) - set(bad)):
        fp.close(grads[128][k], jg[k], fp.F32_TOL, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_apply_and_decode_step_match_the_reference(dtype):
    jc, tc, jp, tp = _mixer({"dtype": dtype})
    rng = np.random.default_rng(6)
    B, L = 2, 64
    x = rng.standard_normal((B, L, tc.d_model)).astype(np.float32)
    jx, tx = fp.both(x, dtype)
    want, _ = jax.jit(lambda p, x: jssm.ssm_apply(p, jc, x))(jp, jx)
    got, none = tssm.ssm_apply(tp, tc, tx)
    assert none is None and got.dtype == tx.dtype
    fp.close(got, want, fp.tol(dtype), "ssm_apply")

    jst = {k: v[0] for k, v in jssm.ssm_state_init(jc, B, 1).items()}
    tst = {k: v[0] for k, v in tssm.ssm_state_init(tc, B, 1, device="cpu").items()}
    jstep = jax.jit(lambda p, x, s: jssm.ssm_decode_step(p, jc, x, s))
    for t in range(6):
        jo, jst = jstep(jp, jx[:, t:t + 1], jst)
        to, tst2 = tssm.ssm_decode_step(tp, tc, tx[:, t:t + 1], tst)
        assert not torch.equal(tst2["ssd"], tst["ssd"])      # a new state, the input kept
        tst = tst2
        fp.close(to, jo, fp.tol(dtype), f"decode step {t}")
        fp.close(tst["ssd"], jst["ssd"], fp.tol(dtype), "ssd state")
        fp.close(tst["conv"], jst["conv"], fp.tol(dtype), "conv state")


def test_ssm_apply_keeps_the_chunk_divisibility_assert():
    _, tc, _, tp = _mixer({})
    with pytest.raises(AssertionError):
        tssm.ssm_apply(tp, tc, torch.zeros((1, 48, tc.d_model)))


def test_state_init_and_axes_equal_the_reference():
    jc, tc = fp.cfgs(ARCH)
    assert tssm.SSM_STATE_AXES == jssm.SSM_STATE_AXES
    assert tssm.ssm_axes(tc) == jssm.ssm_axes(jc)
    j, t = jssm.ssm_state_init(jc, 3, 2), tssm.ssm_state_init(tc, 3, 2, device="cpu")
    for k in ("ssd", "conv"):
        assert tuple(t[k].shape) == j[k].shape and t[k].dtype == torch.float32
    assert {k: v.shape for k, v in tssm.ssm_init(torch.Generator(), tc, "cpu").items()} == \
        {k: tuple(v.shape) for k, v in jssm.ssm_init(jax.random.PRNGKey(0), jc)[0].items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_model_matches_the_reference(dtype):
    fp.check_whole_model(ARCH, dtype)


def test_trees_cross_both_ways():
    fp.check_trees(ARCH)
    fp.check_axes_match_params(ARCH)


def test_greedy_and_engine_tokens_equal_the_reference():
    fp.greedy_matches(ARCH)
    fp.engine_matches(ARCH)


def test_launch_serve_and_train_on_the_cpu(tmp_path):
    out = fp.run_launcher("repro_torch.launch.serve", "--arch", ARCH, "--smoke", "--device",
                          "cpu", cwd=tmp_path)
    assert out.startswith("8 requests, 128 tokens")
    out = fp.run_launcher("repro_torch.launch.train", "--arch", ARCH, "--smoke", "--device",
                          "cpu", "--steps", "2", "--ckpt-dir", str(tmp_path / "ck"),
                          cwd=tmp_path)
    assert "final:" in out and "arch: mamba2-130m" in out
