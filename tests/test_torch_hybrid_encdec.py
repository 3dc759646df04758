"""The port's hybrid (zamba2) and encoder-decoder (whisper) families
(``repro_torch.models.hybrid`` / ``encdec``) against the JAX package's, at
smoke size on the CPU, and the serving engine's reset of their nested
decode states.

Tolerances: ``F32_TOL`` 1e-4 and ``BF16_TOL`` 2^-5 of the result's scale
(``tests/torch_family_parity.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jencdec
from repro.models import hybrid as jhybrid
from repro.serving import ServingEngine as JEngine
from repro_torch.errors import InvalidArgError
from repro_torch.models import encdec as tencdec
from repro_torch.models import hybrid as thybrid
from repro_torch.serving import ServingEngine, greedy_decode

import torch_family_parity as fp

HYBRID, ENCDEC = "zamba2-2.7b", "whisper-small"
ARCHS = (HYBRID, ENCDEC)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_block_with_lora_matches_the_reference(dtype):
    """Non-zero LoRA up-projections, so that the delta is folded in."""
    jm, params, tm, _ = fp.models(HYBRID, dtype)
    rng = np.random.default_rng(9)
    params = dict(params)
    params["lora"] = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
                      for k, v in params["lora"].items()}
    tp = fp.params_from_numpy(tm.cfg, fp.host(params), device="cpu")
    x = rng.standard_normal((2, 8, tm.cfg.d_model)).astype(np.float32)
    jx, tx = fp.both(x, dtype)
    pos = np.arange(8)
    for g in range(thybrid._num_groups(tm.cfg)):
        jl = jax.tree_util.tree_map(lambda a: a[g], params["lora"])
        want, _ = jax.jit(lambda h: jhybrid._shared_block(params["shared"], jl, jm.cfg, h,
                                                          jnp.asarray(pos)))(jx)
        got, none = thybrid._shared_block(tp.shared, thybrid._lora(tp, g), tm.cfg, tx,
                                          torch.from_numpy(pos))
        assert none is None and got.dtype == tx.dtype
        fp.close(got, want, fp.tol(dtype), f"shared block {g}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_cross_kv_and_precompute_cross_match_the_reference(dtype):
    jm, params, tm, tp = fp.models(ENCDEC, dtype)
    cfg = tm.cfg
    frames = np.random.default_rng(10).standard_normal(
        (2, cfg.num_frames, cfg.d_model)).astype(np.float32)
    jf, tf = fp.both(frames, dtype)
    jenc = jax.jit(lambda p, f: jencdec.encode(p, jm.cfg, f))(params, jf)
    with torch.no_grad():
        tenc = tencdec.encode(tp, cfg, tf)
        assert tenc.dtype == cfg.activation_dtype
        fp.close(tenc, jenc, fp.tol(dtype), "encode")
        jkv = jencdec.cross_kv(jax.tree_util.tree_map(lambda a: a[0], params["decoder"]["cross"]),
                               jm.cfg, jenc)
        tkv = tencdec.cross_kv(tp.decoder[0]["cross"], cfg, tenc)
    for k in ("k", "v"):
        fp.close(tkv[k], jkv[k], fp.tol(dtype), f"cross_kv {k}")
    jx = jax.jit(lambda p, f: jencdec.precompute_cross(p, jm.cfg, f))(params, jf)
    tx = tencdec.precompute_cross(tp, cfg, tf)
    for k in ("k", "v"):
        assert tuple(tx[k].shape) == jx[k].shape and tx[k].dtype == cfg.activation_dtype
        fp.close(tx[k], jx[k], fp.tol(dtype), f"precompute_cross {k}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_model_matches_the_reference(arch, dtype):
    fp.check_whole_model(arch, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_trees_cross_both_ways(arch):
    fp.check_trees(arch)
    fp.check_axes_match_params(arch)


def test_decode_state_shapes_equal_the_reference():
    for arch in ARCHS:
        jm, _, tm, _ = fp.models(arch)
        j, t = jm.init_decode_state(3, 20), tm.init_decode_state(3, 20)
        jleaves = jax.tree_util.tree_flatten_with_path(j)[0]
        tleaves = fp.leaves_with_names(t)
        assert [n for n, _ in tleaves] == ["__".join(k.key for k in p) for p, _ in jleaves]
        for (_, a), (_, b) in zip(tleaves, jleaves):
            assert tuple(a.shape) == b.shape and not a.any()
            assert fp.f32(a).dtype == np.float32 and str(a.dtype).endswith(str(b.dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_and_engine_tokens_equal_the_reference(arch):
    fp.greedy_matches(arch)
    fp.engine_matches(arch)


def test_greedy_from_precomputed_cross_equals_the_reference_loop():
    """Whisper served over encoder states: ``greedy_decode(frames=)``, which
    decodes over ``precompute_cross``'s k/v, against the reference's decode
    loop over the same."""
    from repro.serving.decode import build_decode_fn

    jm, jp, tm, tp = fp.models(ENCDEC)
    cfg = tm.cfg
    rng = np.random.default_rng(11)
    frames = rng.standard_normal((2, cfg.num_frames, cfg.d_model)).astype(np.float32)
    prompts = rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    B, P, N = 2, 4, 5
    jst = jm.init_decode_state(B, P + N)
    jst["cross"] = jencdec.precompute_cross(jp, jm.cfg, jnp.asarray(frames))
    step = build_decode_fn(jm)
    for t in range(P):
        lg, jst = step(jp, jst, jnp.asarray(prompts[:, t:t + 1]), jnp.full((B,), t, jnp.int32))
    want = []
    tok = jnp.argmax(lg, -1).astype(jnp.int32)
    for t in range(N):
        want.append(np.asarray(tok))
        lg, jst = step(jp, jst, tok[:, None], jnp.full((B,), P + t, jnp.int32))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)

    got = greedy_decode(tm, tp, torch.from_numpy(prompts), N, frames=torch.from_numpy(frames))
    np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))
    zero = greedy_decode(tm, tp, torch.from_numpy(prompts), N)
    assert not torch.equal(got, zero)                 # the encoder states matter

    _, _, hm, hp = fp.models(HYBRID)
    with pytest.raises(InvalidArgError):               # frames are the encoder's alone
        greedy_decode(hm, hp, torch.from_numpy(prompts), N, frames=torch.from_numpy(frames))


def _filled(state, rng):
    """``state`` with every leaf random (integers for ``pos``)."""
    if isinstance(state, dict):
        return {k: _filled(v, rng) for k, v in state.items()}
    a = np.asarray(fp.f32(state) if isinstance(state, torch.Tensor) else state)
    if a.dtype.kind in "iu" or str(getattr(state, "dtype", "")).endswith("int32"):
        return rng.integers(1, 50, a.shape).astype(np.int32)
    return rng.standard_normal(a.shape).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS + ("mamba2-130m",))
def test_engine_resets_a_nested_state_like_the_reference(arch):
    """Admission zeroes one slot of every leaf, at any depth: (L, B, ...) on
    axis 1, (B,) on axis 0, as the JAX engine's ``tree_map`` does."""
    jm, jp, tm, tp = fp.models(arch)
    slots = 3
    je = JEngine(jm, jp, slots=slots, max_len=16)
    te = ServingEngine(tm, tp, slots=slots, max_len=16)
    filled = _filled(je.state, np.random.default_rng(12))

    def to_jax(t):
        return {k: to_jax(v) for k, v in t.items()} if isinstance(t, dict) else jnp.asarray(t)

    def to_torch(t, like):
        if isinstance(t, dict):
            return {k: to_torch(v, like[k]) for k, v in t.items()}
        return torch.from_numpy(t).to(like.dtype)

    je.state = to_jax(filled)
    te.state = to_torch(filled, te.state)
    for s in (1, 0):
        je._reset_slot_cache(s)
        te._reset_slot_cache(s)
    got = fp.leaves_with_names(te.state)
    want = jax.tree_util.tree_leaves(je.state)
    assert len(got) == len(want)
    for (name, g), w in zip(got, want):
        np.testing.assert_array_equal(fp.f32(g), fp.f32(w), err_msg=name)
        assert fp.f32(g).any(), name                   # slot 2 kept its values


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_and_train_on_the_cpu(arch, tmp_path):
    out = fp.run_launcher("repro_torch.launch.serve", "--arch", arch, "--smoke", "--device",
                          "cpu", cwd=tmp_path)
    assert out.startswith("8 requests, 128 tokens")
    out = fp.run_launcher("repro_torch.launch.train", "--arch", arch, "--smoke", "--device",
                          "cpu", "--steps", "2", "--seq-len", "32", "--ckpt-dir",
                          str(tmp_path / "ck"), cwd=tmp_path)
    assert "final:" in out and f"arch: {arch}" in out
