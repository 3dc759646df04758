"""The port's dry run against the JAX package's (``repro.launch.dryrun``).

``configs.input_specs`` and ``Model.abstract_init`` are held to the
reference's (shapes and dtypes of every cell's inputs; every parameter's
path, shape and dtype against ``jax.eval_shape`` of ``Model.init`` at full
size). The counting is held to arithmetic: a smoke-size cell's FLOPs to the
sum of its matrix products, the CB-sparse MLP's to
``CBLinearSpec.flops_per_token`` x tokens x passes, and the full-depth count
to the reference's 2- and 4-layer extrapolation. The reference's pure tests
of ``_extrapolate`` and ``supports_shape`` are ported, and both packages'
``roofline.fmt_table`` print the same table from the same cell JSONs.
Everything runs on the meta device: nothing is allocated, and no kernel is
built or launched.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import roofline as jroofline
from repro.models import Model as JModel
from repro_torch import configs as tconfigs
from repro_torch.configs import SHAPES, ShapeConfig, input_specs, supports_shape
from repro_torch.kernels import _build, cb_block_dense, cb_colagg, cb_combine, cb_coo, cb_spmm
from repro_torch.launch import dryrun, roofline
from repro_torch.models import Model

ARCHS = list(tconfigs.ARCH_IDS) + ["cb-paper"]
CELLS = [(a, s) for a in tconfigs.ARCH_IDS for s in SHAPES]
WRAPPERS = (cb_block_dense.block_dense_spmv_batched, cb_colagg.panel_spmv_batched,
            cb_coo.coo_spmv_batched, cb_combine.segment_combine, cb_spmm.super_tile_spmm)
# a small train / prefill shape for the counted smoke cells (S below attn_chunk)
SMALL_TRAIN = ShapeConfig("small_train", "train", 32, 2)
SMALL_PREFILL = ShapeConfig("small_prefill", "prefill", 32, 2)
SMALL_DECODE = ShapeConfig("small_decode", "decode", 64, 2)


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape):
    want = jconfigs.input_specs(jconfigs.get_config(arch), jconfigs.SHAPES[shape])
    got = input_specs(tconfigs.get_config(arch), SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        assert tuple(got[k].shape) == tuple(spec.shape), k
        assert _dtype_name(got[k].dtype) == str(spec.dtype), k
        assert got[k].device.type == "meta", k


def _port_leaves(tree, path=()) -> list:
    """(path, shape, dtype) of ``param_tree``'s leaves, a stacked leaf (a list
    of its layers' tensors, nested for llama4's groups) as one stacked shape."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _port_leaves(tree[k], path + (k,))]

    def shape(leaf):
        return (len(leaf),) + shape(leaf[0]) if isinstance(leaf, list) else tuple(leaf.shape)

    first = tree
    while isinstance(first, list):
        first = first[0]
    assert first.device.type == "meta", path
    return [("/".join(path), shape(tree), _dtype_name(first.dtype))]


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_init_matches_eval_shape(arch):
    """Full size, every leaf: the port's meta parameters against the
    reference's ``jax.eval_shape`` of ``Model.init``, and the axis trees."""
    jmodel = JModel(jconfigs.get_config(arch))
    shapes, jaxes = jmodel.abstract_init(jax.random.PRNGKey(0))
    want = [("/".join(str(k.key) for k in p), tuple(s.shape), str(s.dtype))
            for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    before = _rss_bytes()
    tree, axes = Model(tconfigs.get_config(arch), device="meta").abstract_init()
    grown = _rss_bytes() - before
    assert _port_leaves(tree) == want
    assert axes == jaxes
    assert grown < 1 << 30, f"abstract_init grew the process by {grown / 2**30:.2f} GiB"


def test_abstract_init_draws_nothing_and_ignores_the_models_device():
    cfg = tconfigs.get_smoke_config("cb-paper")
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    tree, _ = Model(cfg, device="cpu").abstract_init(gen)
    assert torch.equal(gen.get_state(), state)
    assert all(leaf.device.type == "meta" for _, leaf in _flat(tree))


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# the reference's pure tests (tests/test_launch.py), on the port
# ---------------------------------------------------------------------------

def test_probe_extrapolation_linear():
    cfg = tconfigs.get_config("granite-8b")  # 36 layers
    # cost(L) = 100 + 7L
    samples = [({"l": 2}, 114.0), ({"l": 4}, 128.0)]
    assert abs(dryrun._extrapolate(cfg, samples) - (100 + 7 * 36)) < 1e-6


def test_probe_extrapolation_hybrid_two_species():
    cfg = tconfigs.get_config("zamba2-2.7b")  # 54 mamba layers, attn every 6 -> 9
    a, bm, bs = 50.0, 3.0, 11.0
    samples = [
        ({"m": 2, "s": 2}, a + 2 * bm + 2 * bs),
        ({"m": 4, "s": 4}, a + 4 * bm + 4 * bs),
        ({"m": 4, "s": 2}, a + 4 * bm + 2 * bs),
    ]
    expected = a + 54 * bm + 9 * bs
    assert abs(dryrun._extrapolate(cfg, samples) - expected) < 1e-6


def test_supports_shape_matrix():
    runs_long = {"mixtral-8x7b", "mamba2-130m", "zamba2-2.7b"}
    for arch in tconfigs.ARCH_IDS:
        cfg = tconfigs.get_config(arch)
        ok, why = supports_shape(cfg, SHAPES["long_500k"])
        assert ok == (arch in runs_long), (arch, why)
        for s in ("train_4k", "prefill_32k", "decode_32k"):
            assert supports_shape(cfg, SHAPES[s])[0]


def test_probe_configs_are_the_references():
    from repro.launch.dryrun import _probe_cfgs as j_probe_cfgs

    for arch in ("granite-8b", "zamba2-2.7b", "whisper-small"):
        got = dryrun._probe_cfgs(tconfigs.get_config(arch))
        want = j_probe_cfgs(jconfigs.get_config(arch))
        assert [(c.num_layers, c.attn_every, c.encoder_layers, m) for c, m in got] == \
            [(c.num_layers, c.attn_every, c.encoder_layers, m) for c, m in want]


# ---------------------------------------------------------------------------
# the counts, held to arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,layers,extra", [
    ("granite-8b", 6, {}),
    ("zamba2-2.7b", 6, {"attn_every": 3}),       # 6 Mamba2 layers, 2 shared invocations
])
@pytest.mark.parametrize("shape", [SMALL_TRAIN, SMALL_DECODE], ids=["train", "decode"])
def test_probes_extrapolate_to_the_full_depth_count(arch, layers, extra, shape):
    """The reference's 2- and 4-layer probes, extrapolated, equal the eager
    full-depth count (smoke widths: the linearity does not depend on them)."""
    cfg = tconfigs.get_smoke_config(arch).scaled(num_layers=layers, **extra)
    full = dryrun.count_cell(cfg, shape, memory=False)
    probed = dryrun.probe_costs(cfg, shape)
    for key in dryrun.COUNTS:
        assert probed[key] == pytest.approx(full[key], rel=1e-9), key


def _dense_products(cfg, shape, mlp: bool = True) -> float:
    """FLOPs of a dense-family cell's matrix products: the attention
    projections, QK^T and PV over the full S x S, the SwiGLU's three products
    (``mlp``), each layer's forward run 1 + remat times in training plus its
    backward (2x), and the unembedding (forward and, in training, backward).
    ``torch.utils.checkpoint`` stops a recompute once the tensors the
    backward saved are back, so under ``remat="full"`` a layer's last
    product, the dense MLP's down projection, is not run again (a CB
    product's autograd Function reruns whole)."""
    B, S = shape.global_batch, shape.seq_len
    N = B * S
    d, H, Hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    layer = 2 * N * d * dh * (2 * H + 2 * Hkv) + 2 * 2 * B * H * S * S * dh
    if mlp:
        layer += 3 * 2 * N * d * cfg.d_ff
    if shape.kind == "train":
        runs = 1 + (cfg.remat == "full")
        down = 2 * N * cfg.d_ff * d if mlp and cfg.remat == "full" else 0
        return (cfg.num_layers * (layer * (runs + 2) - down)
                + 3 * 2 * N * d * cfg.padded_vocab)
    return cfg.num_layers * layer + 2 * B * d * cfg.padded_vocab      # last_only


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("shape", [SMALL_TRAIN, SMALL_PREFILL], ids=["train", "prefill"])
def test_counted_flops_of_a_dense_cell_are_its_products(remat, shape):
    cfg = tconfigs.get_smoke_config("granite-8b").scaled(remat=remat)
    assert shape.seq_len <= cfg.attn_chunk                  # one q chunk: S x S as computed
    got = dryrun.count_cell(cfg, shape, memory=False)["flops"]
    assert got == _dense_products(cfg, shape)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("shape", [SMALL_TRAIN, SMALL_PREFILL], ids=["train", "prefill"])
def test_sparse_flops_are_flops_per_token_times_tokens_and_passes(remat, shape):
    """cb-paper-smoke: what the cell counts beyond its dense products is the
    three CB products, ``flops_per_token`` x tokens each pass: the forward
    (run again by ``remat="full"``), and in training dX (the transposed
    stream, as many tiles here) and dW. No kernel is built or launched."""
    cfg = tconfigs.get_smoke_config("cb-paper").scaled(remat=remat)
    specs = Model(cfg, device="meta").specs
    assert all(len(s.browT) == s.num_tiles for s in specs.values())   # no padding tiles
    launches = [w.launches for w in WRAPPERS]
    got = dryrun.count_cell(cfg, shape)
    assert [w.launches for w in WRAPPERS] == launches == [0] * len(WRAPPERS)
    assert "lib" not in _build._state
    tokens = shape.global_batch * shape.seq_len
    passes = (1 + (remat == "full") + 2) if shape.kind == "train" else 1
    sparse = cfg.num_layers * sum(s.flops_per_token() for s in specs.values()) * tokens * passes
    assert got["flops"] - _dense_products(cfg, shape, mlp=False) == sparse


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("arch", ["granite-8b", "cb-paper"])
@pytest.mark.parametrize("shape", [SMALL_TRAIN, SMALL_PREFILL, SMALL_DECODE],
                         ids=["train", "prefill", "decode"])
def test_byte_floor_is_the_steps_inputs_and_outputs(arch, shape):
    """The floor is each step input read once and each output written once.
    Training: the float32 parameters and AdamW's two moments read and written
    in place, the batch read, the metrics written. Serving (bfloat16
    weights): the weights read, of the embedding only the gathered rows, the
    inputs and the KV cache read, the logits and the new decode state
    (``decode_step`` copies the cache) written. Intermediates, the gathers of
    the CB-sparse MLP's plain version among them, move nothing."""
    cfg = tconfigs.get_smoke_config(arch)
    model = Model(cfg, device="meta")
    params = model.init(None)
    batch = input_specs(cfg, shape)
    B, d, act = shape.global_batch, cfg.d_model, 2                    # bf16 activations
    got = dryrun.count_cell(cfg, shape, memory=False)
    if shape.kind == "train":
        metrics = 3 * 4                                               # loss, grad_norm, lr
        want = 2 * 3 * _nbytes(params.parameters()) + _nbytes(batch.values())
        assert 0 <= got["bytes_floor"] - want <= 2 * metrics
    else:
        params = params.to(torch.bfloat16)
        rows = B * (shape.seq_len if shape.kind == "prefill" else 1)
        weights = _nbytes(params.parameters()) - _nbytes([params.embed]) + rows * d * 2
        logits = B * cfg.padded_vocab * act
        state = (_nbytes(model.init_decode_state(B, shape.seq_len).values())
                 if shape.kind == "decode" else 0)
        assert got["bytes_floor"] == weights + _nbytes(batch.values()) + 2 * state + logits
    assert got["bytes_unfused"] > got["bytes_floor"]


def test_train_cell_peak_holds_the_state():
    """The peak of a float32 training step holds at least the parameters,
    their gradients and AdamW's two moments."""
    cfg = tconfigs.get_smoke_config("granite-8b")
    got = dryrun.count_cell(cfg, SMALL_TRAIN)
    n = sum(t.numel() for _, t in _flat(Model(cfg, device="meta").abstract_init()[0]))
    assert got["memory"]["total"] >= 4 * 4 * n
    assert got["memory"]["param"] == pytest.approx(4 * n, rel=0.01)


# ---------------------------------------------------------------------------
# cells, the CLI and the roofline report
# ---------------------------------------------------------------------------

def test_full_size_cell_runs():
    """granite-8b decode_32k at full size on one rank: ok, the reference's keys,
    and a peak that holds the 618 GB bfloat16 KV cache."""
    cell = dryrun.run_cell("granite-8b", "decode_32k")
    assert cell["status"] == "ok", cell.get("error")
    cfg = tconfigs.get_config("granite-8b")
    kv = 2 * cfg.num_layers * 128 * 32_768 * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    assert cell["memory"]["peak_memory_in_bytes"] >= kv
    assert cell["chips"] == 1 and cell["mesh"] == "1"
    assert cell["collectives"]["total_bytes"] == 0
    r = cell["roofline"]
    assert r["collective_s"] == 0.0 and r["bottleneck"] == "memory"
    assert r["model_flops"] == 2 * cfg.active_param_count() * 128
    assert cell["flops_per_device"] > 0
    # the floor reads the cache and writes its copy; the eager count moves more
    assert 2 * kv <= cell["bytes_per_device"] < cell["bytes_unfused_per_device"]
    assert r["memory_s"] == cell["bytes_per_device"] / dryrun.HBM_BW
    assert r["memory_unfused_s"] > r["memory_s"]


def test_cli_skips_and_runs(tmp_path, capsys):
    dryrun.main(["--arch", "granite-8b", "--shape", "long_500k", "--out", str(tmp_path)])
    dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "skipped" in out and "0 FAILED" in out
    cells = {(c["arch"], c["status"]) for c in roofline.load_cells(str(tmp_path))}
    assert cells == {("granite-8b", "skipped"), ("mamba2-130m", "ok")}
    roofline.main(["--dir", str(tmp_path)])
    table = capsys.readouterr().out
    assert "| mamba2-130m | long_500k |" in table and '"ok": 1' in table


def test_roofline_tables_agree(tmp_path):
    """The reference's report and the port's print the same text from the
    same cell JSONs (ok, skipped and FAILED cells)."""
    small = tconfigs.get_smoke_config("granite-8b")
    for shape in ("train_4k", "decode_32k"):
        cell = dryrun.run_cell("granite-8b", shape, cfg_override=small.scaled(
            name="granite-8b"), out_dir=None)
        (tmp_path / f"granite-8b_{shape}_1.json").write_text(json.dumps(cell))
    dryrun.run_cell("granite-8b", "long_500k", out_dir=str(tmp_path))
    (tmp_path / "qwen3-32b_train_4k_1.json").write_text(json.dumps(
        {"arch": "qwen3-32b", "shape": "train_4k", "mesh": "1", "status": "FAILED",
         "error": "InvalidArgError: stand-in"}))
    d = str(tmp_path)
    assert roofline.fmt_table(roofline.load_cells(d), "1") == \
        jroofline.fmt_table(jroofline.load_cells(d), "1")
    assert roofline.summarize(roofline.load_cells(d)) == \
        jroofline.summarize(jroofline.load_cells(d))
    assert np.isfinite([c["roofline"]["compute_s"] for c in roofline.load_cells(d)
                        if c["status"] == "ok"]).all()
