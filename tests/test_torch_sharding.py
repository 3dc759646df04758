"""The port's logical-axis sharding, production meshes and elastic restore,
held against the JAX package on the CPU.

- ``models.sharding``: ``DEFAULT_RULES`` equal; ``spec_for`` and
  ``logical_to_sharding`` give the reference's ``PartitionSpec`` entries, and
  ``sanitize_shardings`` its decisions, on stand-in production meshes
  (16 x 16 and 2 x 16 x 16, which this process does not hold: the port reads
  ``mesh_dim_names`` / ``shape``, the reference an ``AbstractMesh``);
  ``placements`` shard a dim mapped to ``("pod", "data")`` over both;
- ``launch.mesh``: ``data_width`` and ``rules_for`` equal for every arch x
  ``SHAPES`` entry on both meshes; ``make_mesh`` refuses without a process
  group or with another world size;
- the axis trees (``attention_axes``, ``mlp_axes``, ``CACHE_AXES``,
  ``lm_axes``, ``decode_state_axes``, ``Model.axes()``) equal for every dense
  and VLM config and ``cb-paper``, and matching the port's parameter tree;
- ``Checkpointer.restore(shardings=)``: a checkpoint written by
  ``repro.checkpoint`` restored onto a 2-rank gloo mesh (processes of
  ``tests/torch_dist_ranks.py``): every leaf a ``DTensor`` whose local shard
  is the slice of the plain restore and whose ``full_tensor()`` is it, bit
  for bit; ``constrain`` redistributes a ``DTensor`` and leaves a local
  tensor alone.
"""
import json
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import torch_dist_ranks as R
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import mesh as jmesh
from repro.models import layers as jlayers
from repro.models import sharding as jsharding
from repro.models import transformer as jtransformer
from repro.models.model import Model as JModel
from repro_torch import errors
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers as tlayers
from repro_torch.models import sharding as tsharding
from repro_torch.models import transformer as ttransformer
from repro_torch.models.model import Model as TModel
from repro_torch.models.model import param_tree

TIMEOUT = 120          # seconds for the job of ranks

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
PORTED = [a for a in ARCH_IDS if get_config(a).family in ("dense", "vlm")] + ["cb-paper"]


def _meshes(name):
    shape, names = MESHES[name]
    return (types.SimpleNamespace(mesh_dim_names=names, shape=shape),
            AbstractMesh(shape, names))


def _spec(p) -> tuple:
    """A reference PartitionSpec (or NamedSharding) as the port's tuple."""
    return tuple(getattr(p, "spec", p))


def _specs(tree):
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return _spec(tree)


# ---------------------------------------------------------------------------
# rules, specs, production meshes
# ---------------------------------------------------------------------------

def test_default_rules_equal_the_reference():
    assert tsharding.DEFAULT_RULES == jsharding.DEFAULT_RULES


LOGICAL = [tuple(k for k in jsharding.DEFAULT_RULES), ("batch", "seq", "embed"),
           ("w_layers", "w_embed", "heads", None), ("batch", "kv_seq", "kv", None),
           (None,), ()]


@pytest.mark.parametrize("override", [None, {"batch": None, "heads": None},
                                      {"kv_seq": "model", "batch": ("data",)},
                                      {"embed": ("pod", "model")}])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for_equals_the_reference(mesh, override):
    tm, jm = _meshes(mesh)
    for axes in LOGICAL:
        with tsharding.axis_rules(tm, override), jsharding.axis_rules(jm, override):
            assert tsharding.spec_for(axes) == _spec(jsharding.spec_for(axes)), axes
    with tsharding.axis_rules(None):                 # no mesh: everything replicated
        assert tsharding.spec_for(("batch", "heads")) == (None, None)
    assert tsharding.active_mesh() is None


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list(ARCH_IDS) + ["cb-paper"])
def test_rules_for_and_data_width_equal_the_reference(arch, shape, mesh):
    tm, jm = _meshes(mesh)
    assert tmesh.data_width(tm) == jmesh.data_width(jm)
    assert tmesh.rules_for(get_config(arch), SHAPES[shape], tm) == \
        jmesh.rules_for(jget_config(arch), JSHAPES[shape], jm)


def test_placements_follow_the_mesh_order():
    tm, _ = _meshes("2x16x16")
    sh = tsharding.NamedSharding(tm, (("pod", "data"), None, "model"))
    assert [str(p) for p in sh.placements] == ["S(0)", "S(0)", "S(2)"]
    assert [str(p) for p in tsharding.NamedSharding(tm, (None, None)).placements] == \
        ["R", "R", "R"]


def test_make_mesh_needs_a_process_group_of_its_size():
    with pytest.raises(errors.InvalidArgError, match="process group"):
        tmesh.make_mesh((2,), ("model",), device_type="cpu")
    with pytest.raises(errors.InvalidArgError, match="differ"):
        tmesh.make_mesh((2, 2), ("model",), device_type="cpu")
    with pytest.raises(errors.InvalidArgError, match="process group"):
        tmesh.make_production_mesh(device_type="cpu")
    assert (tmesh.backend_for("cuda"), tmesh.backend_for("cpu")) == ("nccl", "gloo")
    assert (tmesh.SINGLE_POD, tmesh.MULTI_POD) == (jmesh.SINGLE_POD, jmesh.MULTI_POD)


# ---------------------------------------------------------------------------
# the models' axis trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", PORTED)
def test_axis_trees_equal_the_reference(arch, smoke):
    tcfg = (get_smoke_config if smoke else get_config)(arch)
    jcfg = (jget_smoke if smoke else jget_config)(arch)
    assert tlayers.attention_axes(tcfg) == jlayers.attention_axes(jcfg)
    assert tlayers.mlp_axes(tcfg) == jlayers.mlp_axes(jcfg)
    assert tlayers.CACHE_AXES == jlayers.CACHE_AXES
    assert ttransformer._layer_axes(tcfg) == jtransformer._layer_axes(jcfg)
    assert ttransformer.lm_axes(tcfg) == jtransformer.lm_axes(jcfg)
    assert ttransformer.decode_state_axes(tcfg) == jtransformer.decode_state_axes(jcfg)
    assert TModel(tcfg, device="cpu").axes() == JModel(jcfg).axes()


@pytest.mark.parametrize("arch", PORTED)
def test_axis_tree_matches_the_parameter_tree(arch):
    """Key for key, one logical axis a dim, each stacked leaf led by w_layers."""
    cfg = get_smoke_config(arch)
    model = TModel(cfg, device="cpu")
    params = param_tree(model.init(torch.Generator().manual_seed(0)))

    def walk(axes, leaf):
        if isinstance(axes, dict):
            assert sorted(axes) == sorted(leaf)
            for k in axes:
                walk(axes[k], leaf[k])
            return
        assert len(axes) == len(tsharding._shape(leaf)), (axes, tsharding._shape(leaf))
        assert isinstance(leaf, list) == (axes[:1] == ("w_layers",))

    walk(model.axes(), params)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", PORTED)
def test_shardings_and_their_sanitizing_equal_the_reference(arch, mesh):
    tm, jm = _meshes(mesh)
    jmodel = JModel(jget_config(arch))
    shapes = jax.eval_shape(lambda k: jmodel.init(k)[0], jax.random.PRNGKey(0))
    axes = TModel(get_config(arch), device="cpu").axes()
    rules = jmesh.rules_for(jget_config(arch), JSHAPES["train_4k"], jm)
    t_sh = tsharding.logical_to_sharding(axes, tm, rules)
    j_sh = jsharding.logical_to_sharding(jmodel.axes(), jm, rules)
    assert _specs(t_sh) == _specs(j_sh)
    t_fixed = tsharding.sanitize_shardings(shapes, t_sh, tm)
    j_fixed = jsharding.sanitize_shardings(shapes, j_sh, jm)
    assert _specs(t_fixed) == _specs(j_fixed)


def test_constrain_without_a_mesh_is_a_no_op():
    x = torch.ones(4, 3)
    assert tsharding.constrain(x, "batch", None) is x
    tm, _ = _meshes("16x16")
    with tsharding.axis_rules(tm):
        assert tsharding.constrain(x, "batch", None) is x     # a local tensor


# ---------------------------------------------------------------------------
# elastic restore onto a 2-rank mesh
# ---------------------------------------------------------------------------

ARCH = "granite-8b"


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    base = tmp_path_factory.mktemp("sharding")
    ckpt = base / "ckpt"
    params, _ = JModel(jget_smoke(ARCH)).init(jax.random.PRNGKey(3))
    JCheckpointer(str(ckpt), async_write=False).save(params, 3)

    def describe(t):
        if isinstance(t, dict):
            return {k: describe(v) for k, v in t.items()}
        return {"shape": list(t.shape), "dtype": str(t.dtype)}

    (ckpt / "example.json").write_text(json.dumps(describe(params)))
    job = R.Ranks(["sharding"], 2, base / "ranks",
                  params={"sharding": {"ckpt_dir": str(ckpt), "arch": ARCH}})
    return [res["sharding"] for res in job.wait(TIMEOUT)]


def _local_slice(full: torch.Tensor, placements, coords):
    out = full
    for p, (coord, size) in zip(placements, coords):
        if p.startswith("S("):
            dim = int(p[2:-1])
            out = torch.chunk(out, size, dim=dim)[coord]
    return out


def test_restore_with_shardings_places_every_leaf(restored):
    sharded_leaves = 0
    for rank, res in enumerate(restored):
        assert res["mesh"] == {"names": ["data", "model"], "shape": [2, 1]}
        assert "3 ranks" in res["wrong_world_size"]
        for leaf in res["leaves"]:
            assert leaf["dtensor"], leaf["name"]
            assert torch.equal(leaf["full"], leaf["plain"]), leaf["name"]
            want = _local_slice(leaf["plain"], leaf["placements"], [(rank, 2), (0, 1)])
            assert torch.equal(leaf["local"], want), leaf["name"]
            sharded_leaves += leaf["placements"][0] != "R"
    assert sharded_leaves > 0          # w_embed rides the data axis


def test_constrain_redistributes_a_dtensor(restored):
    for rank, res in enumerate(restored):
        assert res["constrain_local_same"] and res["constrain_no_mesh_same"]
        assert res["constrain_placements"] == ["S(0)", "R"]
        x = torch.arange(4 * 2 * 3, dtype=torch.float32).reshape(8, 3)
        assert torch.equal(res["constrain_local"], x[rank * 4:(rank + 1) * 4])
