"""The SSM, hybrid and encoder-decoder families, and TP-MoE, trained on a
(data, model) mesh, held against the JAX package.

mamba2-, zamba2- and whisper-smoke in float32 at 2x2 and 1x2, and
mixtral-smoke under the TP-MoE rules (``{"experts": None, "expert_mlp":
"model"}``, the layout ``launch.mesh.rules_for`` gives mixtral at a model
width of 16) at 1x2 and 2x2: three AdamW steps of the reference's mesh test
from the JAX package's weights (``train_state_from_numpy(model=)``) on gloo
ranks of ``tests/torch_dist_ranks.py``, against the JAX package's
single-device and sharded steps under the same rules
(``torch_mesh_parity.JAX_TRAIN``): each loss within 1e-4, each grad norm
within 1e-4 relative, every parameter and moment after the first step within
rtol 1e-4 / atol 1e-5. Every rank reports the same losses; the layouts are
the reference's (the SSM mixer's ``mlp`` dims and the attention heads over
``model``, FSDP over ``data``; TP-MoE's expert FFN dim over ``model``).
"""
import numpy as np
import pytest

import torch_dist_ranks as R
import torch_mesh_parity as P

TP_MOE = {"experts": None, "expert_mlp": "model"}
CASES = {"mamba2": dict(arch="mamba2-130m", shapes=[[2, 2], [1, 2]]),
         "zamba2": dict(arch="zamba2-2.7b", shapes=[[2, 2], [1, 2]]),
         "whisper": dict(arch="whisper-small", shapes=[[2, 2], [1, 2]]),
         "tp_moe": dict(arch="mixtral-8x7b", shapes=[[1, 2], [2, 2]], rules=TP_MOE)}
BATCH = (4, 32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX side and both jobs of ranks, started together."""
    base = tmp_path_factory.mktemp("mesh_families")
    cases = {}
    for name, case in CASES.items():
        cfg = P.jax_config(case)
        rng = np.random.default_rng(1)
        toks = rng.integers(0, cfg.vocab_size, BATCH).astype(np.int32)
        batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (BATCH[0], cfg.num_frames, cfg.d_model)).astype(np.float32)
        np.savez(base / f"{name}_batch.npz", **batch)
        cases[name] = dict(case, name=name, init=P.init_weights(base, name, cfg),
                           batch=str(base / f"{name}_batch.npz"))
    procs = P.jax_side(P.JAX_TRAIN, base, list(cases.values()), R.TRAIN_STEPS, parts=4)
    jobs = {f"{d}x{m}": R.Ranks(["mesh_train"], d * m, base / f"w{d}x{m}", params={
        "mesh_train": dict(shape=[d, m], cases=[c for c in cases.values()
                                                 if [d, m] in c["shapes"]])})
        for d, m in ((2, 2), (1, 2))}
    ranks, jx = P.finish(procs, jobs, "mesh_train")
    return dict(ranks=ranks, jax=jx)


@pytest.mark.parametrize("name,mesh", [(n, f"{s[0]}x{s[1]}") for n, c in CASES.items()
                                       for s in c["shapes"]])
def test_family_steps_on_a_mesh_match_the_jax_single_and_sharded_steps(runs, name, mesh):
    ranks = runs["ranks"][mesh]
    P.check_train(ranks[0][name], runs["jax"], name, mesh)
    for r in ranks[1:]:
        assert r[name]["losses"] == ranks[0][name]["losses"]
        assert r[name]["grad_norms"] == ranks[0][name]["grad_norms"]


@pytest.mark.parametrize("mesh", ["2x2", "1x2"])
def test_family_layouts_are_the_references(runs, mesh):
    """Placements in mesh order (data, model)."""
    want = {"mamba2": {"layers.0.mixer.in_z": ["Shard(0)", "Shard(1)"],
                       "layers.0.mixer.out_proj": ["Shard(1)", "Shard(0)"],
                       "layers.0.mixer.A_log": ["Replicate()", "Replicate()"]},
            "zamba2": {"shared.attn.wq": ["Shard(0)", "Shard(1)"],
                       "lora.qb": ["Replicate()", "Replicate()"],
                       "mamba.0.mixer.conv_w": ["Replicate()", "Shard(1)"]},
            "whisper": {"decoder.0.cross.wk": ["Shard(0)", "Shard(1)"],
                        "encoder.0.mlp.w_down": ["Shard(1)", "Shard(0)"]},
            "tp_moe": {"layers.0.ffn.w_gate": ["Shard(1)", "Shard(2)"],
                       "layers.0.ffn.w_down": ["Shard(2)", "Shard(1)"]}}
    for name, pl in want.items():       # a data axis of one rank keeps its Shard
        got = runs["ranks"][mesh][0][name]["placements"]
        assert {k: got[k] for k in pl} == pl, name


def test_tp_moe_routes_every_token_on_every_model_rank(runs):
    """Under TP-MoE every model rank fills all experts' buffers: the routing
    counts of the two model ranks of a data rank are equal, and at 1x2 they
    hold every assignment of the batch within capacity."""
    for mesh in ("1x2", "2x2"):
        ranks = runs["ranks"][mesh]
        for d in range(len(ranks) // 2):
            a, b = ranks[2 * d]["tp_moe"]["routing"], ranks[2 * d + 1]["tp_moe"]["routing"]
            assert all(all((x == y).all() for x, y in zip(sa, sb)) for sa, sb in zip(a, b))
    first = runs["ranks"]["1x2"][0]["tp_moe"]["routing"][0]
    assert sum(int(c.sum()) for c in first) > 0
