"""The dry run on a mesh (``launch.dryrun.mesh_cell``), held against the JAX
package's layouts and against a count written from the code.

A subprocess of the port (no JAX) counts, under torch.distributed's
``"fake"`` backend, every arch's smoke train / prefill / decode cell at 2x2
(and a batch-1 decode, the batch replicated) and the full-size cb-paper
``train_4k`` cell at 16x16; a JAX subprocess with 256 forced host devices
gives the reference's per-device state bytes of the same cells
(``NamedSharding.shard_shape`` over its ``sanitize_shardings`` tree, nothing
compiled). Checks: every cell completes; its per-device parameter,
optimizer and decode-state bytes equal the reference's shard shapes; the
dense smoke train cell's collectives equal the count written below from
the code; the CLI writes a cell per production mesh; both packages'
``roofline.fmt_table`` print the same table of mesh cells.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_dist_ranks as R
from repro.launch import roofline as jroofline
from repro_torch.configs import ARCH_IDS
from repro_torch.launch import dryrun, roofline

TIMEOUT = 300
ARCHS = list(ARCH_IDS) + ["cb-paper"]
SMALL = {"train": ("train", 32, 4), "prefill": ("prefill", 32, 4), "decode": ("decode", 32, 4),
         "decode_b1": ("decode", 32, 1)}
FULL = ("cb-paper", "train_4k", "16x16")

# the port's side, in three processes at once: the smoke cells of half the
# archs each, or (no archs) the full-size cell and the probed one
PORT_SIDE = r"""
import json, sys
from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
small = json.loads(sys.argv[2])
out = {}
for arch in json.loads(sys.argv[3]):
    cfg = get_smoke_config(arch)
    for name, (kind, seq, batch) in small.items():
        cell = dryrun.mesh_cell(arch, name, cfg, "2x2", shape=ShapeConfig(name, kind, seq, batch))
        out[f"{arch}/{name}"] = cell
if not json.loads(sys.argv[3]):
    arch, shape, mesh = json.loads(sys.argv[4])
    out["full"] = dryrun.mesh_cell(arch, shape, get_config(arch), mesh)
    deep = get_smoke_config("granite-8b").scaled(num_layers=6)
    out["probed"] = dryrun.mesh_cell("granite-8b", "train", deep, "2x2",
                                     shape=ShapeConfig("train", *small["train"]), probes=True)
json.dump(out, open(sys.argv[1], "w"))
"""

JAX_SIDE = r"""
import json, math, sys
import numpy as np, jax, jax.numpy as jnp
from repro import compat
from repro.configs import SHAPES, get_config, get_smoke_config
from repro.configs.base import ShapeConfig
from repro.launch.mesh import rules_for
from repro.models import Model, logical_to_sharding
from repro.models.sharding import sanitize_shardings

def shard_bytes(shapes, axes, mesh, rules, dtype=None):
    sh = sanitize_shardings(shapes, logical_to_sharding(axes, mesh, rules), mesh)
    leaves = jax.tree_util.tree_leaves(shapes)
    shs = jax.tree_util.tree_leaves(sh, is_leaf=lambda x: hasattr(x, "shard_shape"))
    return sum(math.prod(s.shard_shape(x.shape)) * jnp.dtype(dtype or x.dtype).itemsize
               for x, s in zip(leaves, shs, strict=True))

def cell(cfg, shape, mesh):
    rules = rules_for(cfg, shape, mesh)
    model = Model(cfg)
    shapes, axes = model.abstract_init(jax.random.PRNGKey(0))
    if shape.kind == "train":
        p = shard_bytes(shapes, axes, mesh, rules)
        m = shard_bytes(shapes, axes, mesh, rules,
                        jnp.bfloat16 if cfg.param_count() > 100e9 else jnp.float32)
        return {"params": p, "mu": m, "nu": m}
    out = {"params": shard_bytes(shapes, axes, mesh, rules, jnp.bfloat16)}
    if shape.kind == "decode":
        st = jax.eval_shape(lambda: model.init_decode_state(shape.global_batch, shape.seq_len))
        out["decode_state"] = shard_bytes(st, model.decode_state_axes(), mesh, rules)
    return out

small = json.loads(sys.argv[2])
devs = jax.devices()
m4 = compat.make_mesh((2, 2), ("data", "model"), devices=devs[:4])
out = {}
for arch in json.loads(sys.argv[3]):
    cfg = get_smoke_config(arch)
    for name, (kind, seq, batch) in small.items():
        out[f"{arch}/{name}"] = cell(cfg, ShapeConfig(name, kind, seq, batch), m4)
arch, shape, mesh = json.loads(sys.argv[4])
m256 = compat.make_mesh((16, 16), ("data", "model"), devices=devs[:256])
out["full"] = cell(get_config(arch), SHAPES[shape], m256)
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Both sides' cells, counted at once in two subprocesses."""
    base = tmp_path_factory.mktemp("dryrun_mesh")
    env = dict(os.environ, PYTHONPATH=str(R.SRC), OMP_NUM_THREADS="1")

    def start(script, tag, archs, **extra):
        return subprocess.Popen(
            [sys.executable, "-c", script, str(base / f"{tag}.json"), json.dumps(SMALL),
             json.dumps(archs), json.dumps(FULL)], env=dict(env, **extra),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    procs = {"port0": start(PORT_SIDE, "port0", ARCHS[::2]),
             "port1": start(PORT_SIDE, "port1", ARCHS[1::2]),
             "port2": start(PORT_SIDE, "port2", []),
             "jax": start(JAX_SIDE, "jax", ARCHS,
                          XLA_FLAGS="--xla_force_host_platform_device_count=256")}
    try:
        logs = {k: p.communicate(timeout=TIMEOUT)[0] for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, p in procs.items():
        assert p.returncode == 0, (k, logs[k][-3000:])
    out = {k: json.loads((base / f"{k}.json").read_text()) for k in procs}
    port = {}
    for k in ("port0", "port1", "port2"):
        port.update(out[k])
    return {"port": port, "jax": out["jax"]}


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cells_on_a_2x2_mesh_hold_the_references_shards(cells, arch):
    for name, (kind, _, batch) in SMALL.items():
        cell = cells["port"][f"{arch}/{name}"]
        assert cell["status"] == "ok", (arch, name, cell.get("error"), cell.get("traceback"))
        assert cell["chips"] == 4 and cell["mesh"] == "2x2"
        assert cell["state_bytes_per_device"] == cells["jax"][f"{arch}/{name}"], (arch, name)
        # a layout that splits anything moves bytes between the ranks
        assert cell["collectives"]["total_bytes"] > 0, (arch, name)
        assert cell["roofline"]["collective_s"] > 0
        if kind == "decode" and batch == 1:
            assert any("batch 1" in r for r in cell["replicated"]), cell["replicated"]


def test_full_size_cb_paper_train_at_16x16(cells):
    cell = cells["port"]["full"]
    assert cell["status"] == "ok", cell.get("error")
    assert cell["chips"] == 256 and cell["mesh"] == "16x16"
    assert cell["state_bytes_per_device"] == cells["jax"]["full"]
    # every axis of the production mesh crosses nodes: priced at the NIC's rate
    assert {a: v["link"] for a, v in cell["links"].items()} == \
        {"data": "infiniband_ndr", "model": "infiniband_ndr"}
    coll = cell["collectives"]
    assert coll["total_bytes"] == sum(coll[k]["bytes"] for k in dryrun._COLLECTIVES)
    by_axis = cell["collectives_by_axis"]
    assert cell["roofline"]["collective_s"] == pytest.approx(
        sum(v["bytes"] for kinds in by_axis.values() for v in kinds.values()) / dryrun.IB_BW)
    assert cell["roofline"]["bottleneck"] in ("compute", "memory", "collective")


def test_probes_extrapolate_the_collective_bytes_on_a_mesh(cells):
    """granite-8b-smoke at 6 layers, train, 2x2: the 2- and 4-layer probes
    extrapolated equal the full-depth count, the collective bytes too."""
    cell = cells["port"]["probed"]
    assert cell["status"] == "ok", cell.get("error")
    full = {"flops": cell["flops_per_device"], "bytes_floor": cell["bytes_per_device"],
            "bytes_unfused": cell["bytes_unfused_per_device"],
            "coll": cell["collectives"]["total_bytes"]}
    assert set(cell["probe"]) == set(full) and full["coll"] > 0
    for k, v in full.items():
        assert cell["probe"][k] == pytest.approx(v, rel=1e-9), k


def test_dense_smoke_train_collectives_are_the_codes(cells):
    """granite-8b-smoke (2 layers, d 128, 4 heads / 1 KV head, d_ff 256, vocab
    512, untied, bfloat16 activations, remat none) at 2x2, batch 4 x 32: this
    rank holds 2 rows. Written from the code, in bytes per device (f32
    weights; a (2, 32, 128) bfloat16 activation is A bytes):

    forward: all-gathers of each FSDP-split weight's shard over data (embed
    (256, 64), per layer wq (64, 2, 32), wk and wv (64, 1, 32), wo (2, 32,
    64), w_gate and w_up (64, 128), w_down (128, 64), unembed (64, 256)); the
    vocab-parallel embedding's rows (2, 32, 128) f32 added over model; per
    layer wo's and w_down's partial sums (A each) added over model; the
    loss's row max, log-sum-exp and target logit over model ((2, 32) f32
    each) and its two global means over data (4 bytes each).
    backward: a reduce-scatter of each gathered weight's gradient (the whole
    gathered tensor); all-reduces of the norms' gradients over data (128 f32;
    2 a layer and the final norm), of wk's and wv's over model (replicated
    there, used for the local heads' groups: (128, 1, 32) f32), and of the
    Megatron inputs' gradients over model (A: attention and MLP per layer,
    and the unembedding's).
    optimizer: the global norm's squares over data (the 12 leaves split on
    data and model, then the 4 on data alone) and over model (the 12).
    """
    A = 2 * 32 * 128 * 2
    layer_ag = 4 * (64 * 2 * 32 + 2 * 64 * 1 * 32 + 2 * 32 * 64 + 3 * 64 * 128)
    ag = 4 * 256 * 64 + 2 * layer_ag + 4 * 64 * 256
    fwd_ar = [4 * 2 * 32 * 128] + [A] * 4 + [4 * 2 * 32] * 3 + [4] * 2
    bwd_ar = [4 * 128] * 5 + [4 * 128 * 32] * 4 + [A] * 4 + [A]
    opt_ar = [4 * 12, 4 * 12, 4 * 4]
    want = {"all-gather": {"count": 16, "bytes": ag},
            "reduce-scatter": {"count": 16, "bytes": 2 * ag},
            "all-reduce": {"count": len(fwd_ar + bwd_ar + opt_ar),
                           "bytes": sum(fwd_ar + bwd_ar + opt_ar)},
            "all-to-all": {"count": 0, "bytes": 0},
            "collective-permute": {"count": 0, "bytes": 0}}
    coll = cells["port"]["granite-8b/train"]["collectives"]
    assert {k: coll[k] for k in want} == want
    assert coll["total_bytes"] == sum(v["bytes"] for v in want.values())


def test_cli_writes_a_cell_per_production_mesh(tmp_path, capsys):
    dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k", "--multipod", "both",
                 "--workers", "2", "--out", str(tmp_path)])
    assert "2 ok / 0 skipped / 0 FAILED" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == ["mamba2-130m_long_500k_16x16.json",
                                           "mamba2-130m_long_500k_2x16x16.json"]
    for mesh, chips in (("16x16", 256), ("2x16x16", 512)):
        cell = json.loads((tmp_path / f"mamba2-130m_long_500k_{mesh}.json").read_text())
        assert cell["status"] == "ok" and cell["chips"] == chips
        assert cell["collectives"]["total_bytes"] > 0
        assert cell["rules"]["batch"] is None            # a batch of one, replicated
    # both packages' reports print the same table of these cells
    for mesh in ("16x16", "2x16x16"):
        d = str(tmp_path)
        assert roofline.fmt_table(roofline.load_cells(d), mesh) == \
            jroofline.fmt_table(jroofline.load_cells(d), mesh)
    assert np.isfinite([c["roofline"]["collective_s"]
                        for c in roofline.load_cells(str(tmp_path))]).all()
