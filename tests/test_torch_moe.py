"""The port's MoE FFN (``repro_torch.models.moe``) and the moe family
(mixtral-8x7b, llama4-maverick's interleave and shared expert) against the
JAX package's, at smoke size on the CPU.

Tolerances: ``F32_TOL`` 1e-4 and ``BF16_TOL`` 2^-5 of the result's scale
(``tests/torch_family_parity.py``). At float32 the routing (experts, buffer
slots, drops) is held equal to the reference's exactly. At bfloat16 the
router's product may round differently in the two packages, so a token
whose k-th and (k+1)-th probabilities lie within 2^-7 (relative) may pick
another expert: such tokens are counted and reported, and every other
token must route as in the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt

import torch_family_parity as fp

ARCHS = ("mixtral-8x7b", "llama4-maverick-400b-a17b")
MARGIN = 2.0**-7
# name: (arch, config overrides, (B, S))
CASES = {
    "groups16": ("mixtral-8x7b", {}, (2, 16)),
    "groups1": ("mixtral-8x7b", {"moe_groups": 1}, (2, 16)),
    "groups_fall_back": ("mixtral-8x7b", {"moe_groups": 4}, (1, 6)),   # 6 % 4: G = 3
    "capacity_drops": ("mixtral-8x7b", {"moe_groups": 1, "capacity_factor": 0.25}, (4, 16)),
    "shared_expert": ("llama4-maverick-400b-a17b", {"moe_every": 1}, (2, 16)),
    "top3": ("mixtral-8x7b", {"top_k": 3, "moe_groups": 2}, (2, 16)),
}


def _layer(case: str, dtype: str):
    arch, kw, (B, S) = CASES[case]
    jc, tc = fp.cfgs(arch, dtype=dtype, **kw)
    jp, _ = jmoe.moe_init(jax.random.PRNGKey(2), jc)
    x = np.random.default_rng(7).standard_normal((B, S, tc.d_model)).astype(np.float32)
    return jc, tc, jp, fp.torch_tree(fp.host(jp)), x


def _dispatch_one_group(tp, tc, xt, C):
    """The port's ``_dispatch`` of one group (G = 1), in the reference's
    ``_dispatch_one_group`` layout."""
    buf, meta = tmoe._dispatch(tp, tc, xt[None], C)
    return buf[0], tuple(m[0] for m in meta)


def _shard(tp: dict, first: int, held: int) -> dict:
    """The layer's weights as shard [first, first + held) of its experts."""
    return {k: v[first:first + held] if k in ("w_gate", "w_up", "w_down") else v
            for k, v in tp.items()}


def _near_tie(probs: np.ndarray, K: int) -> np.ndarray:
    """Per token: whether its k-th and (k+1)-th probabilities lie within
    ``MARGIN`` of each other (relative to the k-th)."""
    ranked = np.sort(probs, axis=-1)[..., ::-1]
    kth, nxt = ranked[..., K - 1], ranked[..., K]
    return (kth - nxt) < MARGIN * kth


@pytest.mark.parametrize("case", ["groups16", "capacity_drops", "top3"])
def test_dispatch_is_the_references_at_float32(case):
    jc, tc, jp, tp, x = _layer(case, "float32")
    T = x.shape[0] * x.shape[1]
    C = tmoe._capacity(T, tc)
    assert C == jmoe._capacity(T, jc)
    xt = x.reshape(T, -1)
    jbuf, jmeta = jmoe._dispatch_one_group(jp, jc, jnp.asarray(xt), C)
    tbuf, tmeta = _dispatch_one_group(tp, tc, torch.from_numpy(xt), C)
    for name, j, t in zip(("buf_idx", "s_token", "s_gate", "keep"), jmeta[:4], tmeta[:4]):
        if name == "s_gate":
            fp.close(t, j, fp.F32_TOL, name)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    fp.close(tmeta[4], jmeta[4], fp.F32_TOL, "aux")
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))    # copied rows, exact
    if case == "capacity_drops":
        assert not tmeta[3].all()                                     # some tokens dropped


def test_capacity_equals_the_reference():
    for arch in ARCHS:
        for kw in ({}, {"capacity_factor": 0.25}, {"top_k": 3}):
            jc, tc = fp.cfgs(arch, **kw)
            for T in (1, 4, 7, 16, 100, 1024, 4096):
                assert tmoe._capacity(T, tc) == jmoe._capacity(T, jc), (arch, kw, T)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_the_reference(case, dtype):
    jc, tc, jp, tp, x = _layer(case, dtype)
    jx, tx = fp.both(x, dtype)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_apply(p, jc, x))(jp, jx)
    ty, taux = tmoe.moe_apply(tp, tc, tx)
    assert ty.dtype == tx.dtype and taux.dtype == torch.float32
    tol = fp.tol(dtype)
    K, T = tc.top_k, x.shape[0] * x.shape[1]
    # the routing of each token, both packages' router products
    jprobs = np.asarray(jax.nn.softmax(
        (jx.reshape(T, -1) @ jnp.asarray(jp["router"]).astype(jx.dtype)).astype(jnp.float32)))
    tprobs = torch.softmax((tx.reshape(T, -1) @ tp["router"].to(tx.dtype)).float(), -1)
    jids = np.asarray(jax.lax.top_k(jnp.asarray(jprobs), K)[1])
    tids = torch.topk(tprobs, K, dim=-1)[1].numpy()
    near = _near_tie(jprobs, K)
    moved = (jids != tids).any(-1)
    if dtype == "float32":
        assert not moved.any()
    else:
        assert not (moved & ~near).any(), "a token away from a tie routed otherwise"
        print(f"{case}: {int(near.sum())} of {T} tokens within 2^-7 of a routing tie, "
              f"{int(moved.sum())} routed otherwise")
    if moved.any():
        # another choice moves that token's output (and, under capacity, others')
        assert case != "capacity_drops", "a routing change under drops: compare whole rows"
        keep = ~moved
        fp.close(ty.reshape(T, -1)[torch.from_numpy(keep)],
                 np.asarray(jy.astype(jnp.float32)).reshape(T, -1)[keep], tol, "kept rows")
    else:
        fp.close(ty, jy, tol, "out")
        fp.close(taux, jaux, tol, "aux")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_adds_like_the_reference_bit_for_bit_at_top_2(dtype):
    """K = 2: each token's two gated outputs summed once, in either order."""
    jc, tc, jp, tp, x = _layer("groups1", "float32")
    T = x.shape[0] * x.shape[1]
    C = tmoe._capacity(T, tc)
    _, meta = _dispatch_one_group(tp, tc, torch.from_numpy(x.reshape(T, -1)), C)
    out = np.random.default_rng(8).standard_normal((tc.num_experts, C, tc.d_model))
    jout, tout = fp.both(out.astype(np.float32), dtype)
    want = jmoe._combine_one_group(jout, tuple(jnp.asarray(m.numpy()) for m in meta[:5]), T,
                                   jout.dtype)
    got = tmoe._combine(tout[None], tuple(m[None] for m in meta), T, tc.top_k, tout.dtype)[0]
    assert got.dtype == tout.dtype
    np.testing.assert_array_equal(fp.f32(got), fp.f32(want))


def test_two_runs_are_bit_equal_at_any_top_k():
    jc, tc, jp, tp, x = _layer("top3", "bfloat16")
    tx = torch.from_numpy(x).to(torch.bfloat16)
    a, b = tmoe.moe_apply(tp, tc, tx), tmoe.moe_apply(tp, tc, tx)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_moe_gradients_match_jax_grad():
    jc, tc, jp, tp, x = _layer("capacity_drops", "float32")

    def jloss(p, x):
        y, aux = jmoe.moe_apply(p, jc, x)
        return jnp.sum(jnp.square(y)) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    p = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.moe_apply(p, tc, tx)
    (y.square().sum() + aux).backward()
    for k in p:
        fp.close(p[k].grad, jg[k], fp.F32_TOL, f"grad {k}")
    fp.close(tx.grad, jgx, fp.F32_TOL, "grad x")


def test_axes_equal_the_reference():
    for arch in ARCHS:
        for get in (fp.jconfigs.get_config, fp.jconfigs.get_smoke_config):
            jc = get(arch)
            tc = getattr(fp.tconfigs, get.__name__)(arch)
            assert tmoe.moe_axes(tc) == jmoe.moe_axes(jc)
            assert tt._layer_axes(tc) == jt._layer_axes(jc)
            assert tt.lm_axes(tc) == jt.lm_axes(jc)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_model_matches_the_reference(arch, dtype):
    fp.check_whole_model(arch, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_trees_cross_both_ways(arch):
    fp.check_trees(arch)
    fp.check_axes_match_params(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_and_engine_tokens_equal_the_reference(arch):
    fp.greedy_matches(arch)
    fp.engine_matches(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_on_the_cpu(arch, tmp_path):
    out = fp.run_launcher("repro_torch.launch.serve", "--arch", arch, "--smoke", "--device",
                          "cpu", cwd=tmp_path)
    assert out.startswith("8 requests, 128 tokens")


@pytest.mark.parametrize("case", ["groups16", "capacity_drops", "top3", "shared_expert"])
@pytest.mark.parametrize("shards", [2, 4])
def test_expert_shards_sum_to_the_whole_layer(case, shards):
    """Each shard routes as the whole layer does and runs only its experts:
    the shards' outputs, the shared expert counted once, sum to the whole
    layer's (float32); the aux loss is the whole layer's on every shard."""
    jc, tc, jp, tp, x = _layer(case, "float32")
    tx = torch.from_numpy(x)
    whole, whole_aux = tmoe.moe_apply(tp, tc, tx)
    held = tc.num_experts // shards
    outs = []
    for i in range(shards):
        first, n = tmoe.expert_range(tc, (i, shards))
        assert (first, n) == (i * held, held)
        y, aux = tmoe.moe_apply(_shard(tp, first, n), tc, tx, first)
        assert torch.equal(aux, whole_aux)
        outs.append(y)
    total = sum(outs)
    if tc.moe_shared_expert:
        sh = tp["shared"]
        shared = (torch.nn.functional.silu(tx @ sh["w_gate"]) * (tx @ sh["w_up"])) @ sh["w_down"]
        total = total - (shards - 1) * shared
    fp.close(total, whole, fp.F32_TOL, f"{case} over {shards} shards")
    assert all(not torch.equal(y, whole) for y in outs)          # each shard holds a part


def test_model_holds_its_expert_shard():
    """``Model(expert_shard=)``: each MoE layer holds its share of the experts
    beside the whole router, knows where the share starts, and its decode
    agrees with its forward; the whole share is the plain model."""
    from repro_torch.models import Model

    cfg = fp.tconfigs.get_smoke_config("llama4-maverick-400b-a17b").scaled(dtype="float32")
    E = cfg.num_experts
    model = Model(cfg, "cpu", expert_shard=(1, 2))
    params = model.init(torch.Generator().manual_seed(0))
    moe_layers = [g["moe"] for g in params.layers]
    for lyr in moe_layers:
        assert lyr.first_expert == E // 2
        assert lyr.ffn["router"].shape == (cfg.d_model, E)
        assert lyr.ffn["w_gate"].shape == (E // 2, cfg.d_model, cfg.d_ff)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 6))
                            .astype(np.int32))
    with torch.no_grad():
        full = model.forward(params, toks).logits
    st, dec = model.init_decode_state(2, 8), []
    for t in range(6):
        lg, st = model.decode_step(params, st, toks[:, t:t + 1], torch.full((2,), t,
                                                                            dtype=torch.int32))
        dec.append(lg)
    np.testing.assert_allclose(torch.stack(dec, 1).numpy(), full.numpy(),
                               rtol=fp.DECODE_TOL, atol=fp.DECODE_TOL)

    whole = Model(cfg, "cpu", expert_shard=(0, 1))
    plain = Model(cfg, "cpu")
    a = whole.init(torch.Generator().manual_seed(0))
    b = plain.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(whole.forward(a, toks).logits, plain.forward(b, toks).logits)


@pytest.mark.parametrize("arch, shard", [("llama4-maverick-400b-a17b", (0, 3)),
                                         ("llama4-maverick-400b-a17b", (2, 2)),
                                         ("mamba2-130m", (0, 2))])
def test_a_bad_expert_shard_raises(arch, shard):
    from repro_torch import errors
    from repro_torch.models import Model

    with pytest.raises(errors.InvalidArgError):
        Model(fp.tconfigs.get_smoke_config(arch), "cpu", expert_shard=shard)
