"""Prefill and decode on a (data, model) mesh, every family, held against the
JAX package's sharded steps.

Each case (float32 smoke configs: dense granite-8b, VLM internvl2-2b, MoE
mixtral-8x7b and llama4, SSM mamba2-130m, hybrid zamba2-2.7b, encoder-decoder
whisper-small, and cb-paper's CB-sparse MLP) runs on 2x2 gloo ranks of
``tests/torch_dist_ranks.py`` under ``launch.mesh.rules_for``'s rules for its
shapes, from the JAX package's weights and decode state
(``params_from_numpy(model=)``, ``decode_state_from_numpy``): the prefill
logits (``forward(last_only=True)``), then four teacher-forced
``decode_step``s with the KV cache's sequence split over ``model`` (heads
replicated, the batch over ``data`` where it divides), against the JAX
package's forward and ``decode_step`` jitted with the reference dry run's in
/ out shardings (``torch_mesh_parity.JAX_DECODE``). Logits within 1e-4 of
their scale, the gathered state after the steps within 1e-5. Batch-1 cases
replicate the batch over ``data``; mixtral's case starts two steps before
its sliding window's ring wraps, over a seeded cache.
"""
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
import torch_mesh_parity as P
from repro.models import encdec as jencdec
from repro.models import Model as JModel

STEPS = 4
PROMPT = 8
CASES = {
    "granite": dict(arch="granite-8b", batch=4),
    "internvl2": dict(arch="internvl2-2b", batch=4),
    "mixtral_wrap": dict(arch="mixtral-8x7b", batch=4, max_len=64, start=30),
    "llama4": dict(arch="llama4-maverick-400b-a17b", batch=4),
    "mamba2": dict(arch="mamba2-130m", batch=4),
    "mamba2_b1": dict(arch="mamba2-130m", batch=1),
    "zamba2": dict(arch="zamba2-2.7b", batch=4),
    "whisper": dict(arch="whisper-small", batch=4),
    "cb": dict(arch="cb-paper", batch=4),
    "cb_b1": dict(arch="cb-paper", batch=1),
}


def _inputs(base, name: str, case: dict) -> dict:
    """The case's weights, prompt, tokens, positions and initial decode state
    (the JAX package's ``init_decode_state``; whisper's cross k/v from
    ``precompute_cross`` of its frames; a seeded cache where the case starts
    late), as npz files the JAX side and the ranks both read."""
    import jax
    import jax.numpy as jnp

    cfg = P.jax_config(case)
    B, max_len, start = case["batch"], case.get("max_len", 16), case.get("start", 0)
    rng = np.random.default_rng(3)
    data = {"prompt": rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32),
            "pos": np.full((B,), start, np.int32)}
    init = P.init_weights(base, name, cfg)
    model = JModel(cfg)
    state = jax.tree_util.tree_map(np.asarray, model.init_decode_state(B, max_len))
    if cfg.family == "encdec":
        data["frames"] = rng.standard_normal((B, cfg.num_frames, cfg.d_model)).astype(np.float32)
        params = jax.tree_util.tree_map(jnp.asarray, R.unflat(dict(np.load(init))))
        state["cross"] = jax.tree_util.tree_map(
            np.asarray, jencdec.precompute_cross(params, cfg, jnp.asarray(data["frames"])))
    if cfg.family == "vlm":
        data["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if start:
        for k in ("k", "v"):
            state[k] = rng.standard_normal(state[k].shape).astype(np.float32)
        state["pos"] = data["pos"].copy()
    data.update({f"state/{k}": v for k, v in R.flat(state).items()})
    np.savez(base / f"{name}_data.npz", **data)
    return dict(case, name=name, init=init, data=str(base / f"{name}_data.npz"),
                max_len=max_len, shape=[2, 2])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("mesh_decode")
    cases = [_inputs(base, n, c) for n, c in CASES.items()]
    procs = P.jax_side(P.JAX_DECODE, base, cases, parts=3)
    jobs = {"2x2": R.Ranks(["mesh_decode"], 4, base / "w4",
                           params={"mesh_decode": dict(shape=[2, 2], cases=cases)})}
    ranks, jx = P.finish(procs, jobs, "mesh_decode")
    return dict(ranks=ranks["2x2"], jax=jx)


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_on_a_mesh_matches_the_jax_sharded_forward(runs, name):
    for r in runs["ranks"]:
        P.close_logits(r[name]["prefill"], runs["jax"][f"{name}/prefill"], f"{name} prefill")
    # the logits stay split over vocab (placements: data, model)
    assert runs["ranks"][0][name]["prefill_placements"][1] == "Shard(2)"


@pytest.mark.parametrize("name", list(CASES))
def test_decode_steps_on_a_mesh_match_the_jax_sharded_decode(runs, name):
    jx = runs["jax"]
    for r in runs["ranks"]:
        for t in range(STEPS):
            P.close_logits(r[name]["decode"][t], jx[f"{name}/decode{t}"], f"{name} step {t}")
        pre = f"{name}/state/"
        want = {k[len(pre):]: v for k, v in jx.items() if k.startswith(pre)}
        assert sorted(want) == sorted(r[name]["state"]), name
        for k, v in want.items():
            np.testing.assert_allclose(r[name]["state"][k].numpy(), v, rtol=0, atol=P.STATE_TOL,
                                       err_msg=f"{name} state {k}")
    assert runs["ranks"][0][name]["logits_placements"][1] == "Shard(1)"


def test_decode_state_layout_follows_the_decode_rules(runs):
    """The KV cache's sequence over model (placements: data, model), the batch
    over data where it divides and replicated where it does not, an SSM
    state's heads replicated and its conv channels over model."""
    pl = {n: runs["ranks"][0][n]["state_placements"] for n in CASES}
    assert pl["cb"]["k"] == ["Shard(1)", "Shard(2)"]
    assert pl["cb_b1"]["k"] == ["Replicate()", "Shard(2)"]
    assert pl["mamba2"]["ssd"] == ["Shard(1)", "Replicate()"]
    assert pl["mamba2"]["conv"] == ["Shard(1)", "Shard(3)"]
    assert pl["mamba2_b1"]["ssd"] == ["Replicate()", "Replicate()"]
    assert pl["whisper"]["cross/k"] == ["Shard(1)", "Replicate()"]
    assert pl["zamba2"]["attn/k"] == ["Shard(1)", "Shard(2)"]


def test_batch_one_decodes_the_same_on_every_rank(runs):
    for name in ("cb_b1", "mamba2_b1"):
        first = runs["ranks"][0][name]["decode"]
        for r in runs["ranks"][1:]:
            assert all(torch.equal(a, b) for a, b in zip(first, r[name]["decode"])), name
