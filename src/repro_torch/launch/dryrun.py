"""The dry run: every (arch x shape) cell's step on the meta device, on the
production mesh.

For each cell this builds the model on the meta device
(``Model.abstract_init``'s parameters: shapes and dtypes, no allocation),
runs the real step on stand-in inputs (``configs.input_specs``) — the train
step with its optimizer update, the prefill forward, or one decode step —
and counts, as it runs:

  * FLOPs — ``torch.utils.flop_counter.FlopCounterMode`` (matrix products,
    recompute and backward included);
  * bytes, two counts: the floor — each step input (parameters, optimizer
    state, decode state, the batch) read once and each step output written
    once, what a step that kept every intermediate on chip would still move
    (``bytes_per_device``, ``memory_s`` and ``bottleneck``); and the eager
    ceiling — every dispatched op's tensor inputs and outputs, views left out,
    an unfused count (``bytes_unfused_per_device``, ``memory_unfused_s``,
    left out of ``bottleneck``). ``bytes_counted_as`` in the JSON says so;
  * peak bytes per device — ``torch.distributed._tools.mem_tracker.MemTracker``
    over the step, parameters, optimizer state and inputs included: the
    stand-in for XLA's ``memory_analysis()``;
  * collectives — every c10d op the step dispatches (``Collectives``), by
    the reference's five kinds and by mesh axis, in the reference's
    ``parse_collectives`` convention: per-device operand bytes (an
    all-gather's input shard, a reduce-scatter's whole input, an
    all-reduce's tensor).

**The mesh.** By default a cell runs on the production mesh, ``16x16``
(data x model, 256 ranks) or ``2x16x16`` with ``--multipod`` (pod x data x
model, 512), under ``launch.mesh.rules_for``, as the reference lowers it.
Each such cell runs in a process of its own, which joins torch.distributed's
``"fake"`` backend (``torch.testing._internal.distributed.fake_pg``) as rank
0 of the mesh's world: the collectives run and move nothing, and the
``DeviceMesh`` is built over the CPU device type. The model's parameters,
optimizer state, batch and decode state are that rank's shards
(``Model(cfg, "meta", mesh=)``), and only those are counted. ``--mesh 1``
keeps the one-rank cells, whose collective term is 0.

**The collective term.** Each collective's bytes go over the slowest link
its group crosses, at that link's rate a direction: NVLink 4 inside an
8-GPU node (``NVLINK_BW``), one 400 Gb/s NDR InfiniBand NIC per GPU across
nodes (``IB_BW``; NVIDIA DGX H100 data sheet). A rank is numbered in mesh
order (pod, data, model), ``GPUS_PER_NODE`` to a node, so on the production
mesh a ``model`` group spans 2 nodes and a ``data`` or ``pod`` group 16:
every collective there is priced at the NIC's rate. The JSON records each
axis' link (``links``).

The step is the port's eager one, so a full-depth run counts every layer
(XLA counts a scanned layer once, which is why the reference extrapolates
from 2- and 4-layer probes; ``probe_costs`` does the same here, the
collective bytes too, a cross-check of the full count). The CB-sparse MLP
runs its kernels' plain versions on meta tensors: nothing is built and no
launch counter moves.

Results are printed and dumped as JSON under ``experiments/dryrun_torch/``
in the reference's layout, so ``launch.roofline`` reads both packages' cells.

Usage:
    python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multipod single|multi|both] [--workers 8]
    python -m repro_torch.launch.dryrun --all --mesh 1
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import torch
import torch.distributed as dist
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import errors
from repro_torch.configs import SHAPES, get_config, input_specs, supports_shape
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import Model, axis_rules
from repro_torch.models import sharding as S
from repro_torch.training import build_train_step
from repro_torch.training.optimizer import adamw
from repro_torch.training.schedule import warmup_cosine
from repro_torch.training.train_state import TrainState

from .mesh import make_mesh, rules_for

# ---------------------------------------------------------------------------
# NVIDIA H100 80GB HBM3 (SXM, 700 W) constants per card, from NVIDIA's data
# sheet — §Roofline
# ---------------------------------------------------------------------------
PEAK_FLOPS = 989e12      # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12         # HBM3 bytes/s
NVLINK_BW = 450e9        # NVLink 4 bytes/s per direction (900 GB/s both), inside a node
IB_BW = 50e9             # one 400 Gb/s NDR InfiniBand NIC per GPU, bytes/s per direction,
                         # across nodes (NVIDIA DGX H100 data sheet)
GPUS_PER_NODE = 8        # a DGX H100 / HGX H100 node

PRODUCTION = {"single": "16x16", "multi": "2x16x16"}     # --multipod's meshes


def mesh_dims(name: str):
    """A mesh name's (shape, axis names): "DxM" is data x model, "PxDxM" pod x
    data x model (``launch.mesh.SINGLE_POD`` / ``MULTI_POD`` are the
    production ones); "1" is one rank and no mesh (None)."""
    if name == "1":
        return None
    dims = tuple(int(x) for x in name.split("x"))
    if len(dims) not in (2, 3):
        raise errors.InvalidArgError(f"mesh {name!r}: DxM or PxDxM")
    return dims, ("data", "model") if len(dims) == 2 else ("pod", "data", "model")

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# ops that allocate without reading or writing any element
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
               torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}


# gathers: of the table (their first argument) they read only the rows they take
_GATHERS = {torch.ops.aten.embedding, torch.ops.aten.index_select, torch.ops.aten.index,
            torch.ops.aten.gather}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(obj) -> list[torch.Tensor]:
    """The tensors of a pytree, modules' parameters and buffers included."""
    if isinstance(obj, torch.nn.Module):
        return [*obj.parameters(), *obj.buffers()]
    return [t for leaf in pytree.tree_leaves(obj) for t in
            (_tensors(leaf) if isinstance(leaf, torch.nn.Module) else [leaf])
            if isinstance(t, torch.Tensor)]


class OpBytes(TorchDispatchMode):
    """The two byte counts of one step.

    ``bytes``: every dispatched op's tensor inputs and outputs, an unfused
    count: views and bare allocations move nothing; an in-place target counts
    as read and written.

    ``floor``: each of the step's inputs (the tensors of ``inputs``) read
    once, each of its outputs written once: the largest view of an input's
    storage that an op reads, of the table of a gather only the rows it takes;
    the largest view of an input's storage that an op writes in place (an
    optimizer's update, a cache write); and, by ``add_outputs``, what the
    step returns that it made itself. Intermediates move nothing."""

    def __init__(self, inputs=()):
        super().__init__()
        self.bytes = 0
        self._inputs = {_storage(t) for t in _tensors(inputs)}
        self._read: dict[int, int] = {}
        self._written: dict[int, int] = {}

    @property
    def floor(self) -> int:
        return sum(self._read.values()) + sum(self._written.values())

    def _touch(self, into: dict, t: torch.Tensor, nbytes: int) -> None:
        key = _storage(t)
        into[key] = max(into.get(key, 0), min(nbytes, t.untyped_storage().nbytes()))

    def add_outputs(self, out) -> None:
        for t in _tensors(out):
            if _storage(t) not in self._inputs:
                self._touch(self._written, t, _nbytes(t))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func.overloadpacket in _NO_TRAFFIC:
            return out
        self.bytes += sum(_nbytes(t) for t in pytree.tree_leaves((args, kwargs, out))
                          if isinstance(t, torch.Tensor))
        schema = func._schema.arguments
        given = [*zip(schema, args),
                 *((a, kwargs[a.name]) for a in schema if a.name in kwargs)]
        for i, (arg, value) in enumerate(given):
            written = arg.alias_info is not None and arg.alias_info.is_write
            for t in _tensors(value):
                if _storage(t) not in self._inputs:
                    continue
                if written:
                    self._touch(self._written, t, _nbytes(t))
                read = _nbytes(t)
                if i == 0 and func.overloadpacket in _GATHERS:
                    read = min(read, sum(_nbytes(o) for o in _tensors(out)))
                self._touch(self._read, t, read)
        return out


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

# the c10d ops models/sharding.py dispatches -> the reference's kind, and the
# argument holding the operand the reference counts (an all-reduce's tensors,
# an all-gather's input shard, a reduce-scatter's whole input)
_C10D_KINDS = {"allreduce_": ("all-reduce", 0), "_allgather_base_": ("all-gather", 1),
               "_reduce_scatter_base_": ("reduce-scatter", 1)}


def _empty_collectives() -> dict:
    return {k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}


class Collectives(TorchDispatchMode):
    """Every c10d collective dispatched while active: ``kinds`` (the
    reference's ``parse_collectives`` layout, per-device operand bytes) and
    ``by_axis`` (the same per mesh axis of ``mesh``, by the op's process
    group)."""

    def __init__(self, mesh):
        super().__init__()
        self.axis_of = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
        self.kinds = _empty_collectives()
        self.by_axis = {a: _empty_collectives() for a in mesh.mesh_dim_names}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace not in ("c10d", "_c10d_functional"):
            return out
        name = func.overloadpacket.__name__
        if func.namespace != "c10d" or name not in _C10D_KINDS:
            raise errors.InvalidArgError(
                f"{func.namespace}.{name}: a collective the dry run does not count")
        kind, arg = _C10D_KINDS[name]
        axis = "?"
        for a in args:
            if isinstance(a, torch.ScriptObject):
                try:
                    axis = self.axis_of.get(dist.ProcessGroup.unbox(a).group_name, "?")
                    break
                except RuntimeError:                 # a ReduceOp, not the group
                    continue
        operand = args[arg]
        nbytes = sum(_nbytes(t) for t in pytree.tree_leaves(operand)
                     if isinstance(t, torch.Tensor))
        for table in (self.kinds, self.by_axis.setdefault(axis, _empty_collectives())):
            table[kind]["count"] += 1
            table[kind]["bytes"] += nbytes
        return out


def links(mesh_name: str) -> dict:
    """Each axis of a named mesh: its ranks, the nodes a group of them spans
    (ranks numbered in mesh order, ``GPUS_PER_NODE`` to a node), and the
    link and rate its collectives are priced at."""
    if mesh_dims(mesh_name) is None:
        return {}
    shape, names = mesh_dims(mesh_name)
    out = {}
    for i, (n, a) in enumerate(zip(shape, names)):
        stride = math.prod(shape[i + 1:])
        nodes = len({r * stride // GPUS_PER_NODE for r in range(n)})   # rank 0's group
        link = ("nvlink", NVLINK_BW) if nodes == 1 else ("infiniband_ndr", IB_BW)
        out[a] = {"ranks": n, "nodes_spanned": nodes, "link": link[0],
                  "bytes_per_s": link[1]}
    return out


def collective_seconds(by_axis: dict, mesh_name: str) -> float:
    """The collective term: each axis' operand bytes over its link's rate."""
    rate = links(mesh_name)
    return sum(sum(v["bytes"] for v in kinds.values()) / rate[a]["bytes_per_s"]
               for a, kinds in by_axis.items() if a in rate)


# ---------------------------------------------------------------------------
# step construction per shape kind
# ---------------------------------------------------------------------------

def _local(tensors) -> list[torch.Tensor]:
    """Each tensor as this rank holds it (a ``DTensor``'s local shard)."""
    return [t.to_local() if isinstance(t, DTensor) else t for t in _tensors(tensors)]


def _tracked(objs, mesh) -> list:
    """What ``MemTracker`` and the byte floor track: the objects themselves
    (a module's parameters count as parameters), on a mesh their local shards."""
    return objs if mesh is None else _local(objs)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, *,
               serve_dtype: torch.dtype | None = torch.bfloat16, mesh=None):
    """``(run, tracked, state_bytes)`` for one dry-run cell on the meta
    device: ``run()`` takes the step once and returns what it makes (the
    metrics, the logits, the new decode state; the train step updates its
    state in place); ``tracked`` is what exists before it (parameters,
    optimizer state, decode state, inputs: this rank's shards on a mesh),
    for ``MemTracker`` and the byte floor; ``state_bytes`` the parameters'
    and the optimizer state's or the decode state's bytes on this rank.
    Serving cells cast the parameters to ``serve_dtype`` as the reference
    does (``None`` keeps them float32, as the port's engine serves them).
    On ``mesh`` the step runs under the active rules (``axis_rules``)."""
    model = Model(cfg, device="meta", mesh=mesh)
    params = model.init(None)
    batch = input_specs(cfg, shape)
    if mesh is not None:
        batch = S.place_batch(batch, mesh)

    def nbytes(tensors) -> int:
        return sum(_nbytes(t) for t in _local(tensors))

    if shape.kind == "train":
        moments = torch.bfloat16 if cfg.param_count() > 100e9 else torch.float32
        optimizer = adamw(moments_dtype=moments)
        step = build_train_step(model, optimizer, warmup_cosine(3e-4, 100, 10_000))
        state = TrainState.create(params, optimizer)
        mu, nu = state.opt_state.mu, state.opt_state.nu
        tracked = _tracked([params, *mu, *nu, *batch.values()], mesh)
        sizes = {"params": nbytes(params), "mu": nbytes(mu), "nu": nbytes(nu)}
        return (lambda: step(state, batch)[1]), tracked, sizes

    if serve_dtype is not None:
        params = params.to(serve_dtype)
    kw = {}
    if cfg.family == "vlm" and shape.kind == "prefill":
        kw["patch_embeds"] = batch["patch_embeds"]
    if cfg.family == "encdec":
        kw["frames"] = batch["frames"]

    if shape.kind == "prefill":
        def fwd():
            with torch.no_grad():
                return model.forward(params, batch["tokens"], last_only=True, **kw).logits

        return fwd, _tracked([params, *batch.values()], mesh), {"params": nbytes(params)}

    # decode
    state = model.init_decode_state(shape.global_batch, shape.seq_len)

    def decode():
        with torch.no_grad():
            return model.decode_step(params, state, batch["tokens"], batch["pos"])

    leaves = pytree.tree_leaves(state)
    return decode, _tracked([params, *leaves, *batch.values()], mesh), \
        {"params": nbytes(params), "decode_state": nbytes(leaves)}


def count_cell(cfg: ModelConfig, shape: ShapeConfig, *,
               serve_dtype: torch.dtype | None = torch.bfloat16, memory: bool = True,
               mesh=None) -> dict:
    """FLOPs, the byte floor and the unfused bytes, the collectives (on a
    mesh), the state's bytes and (``memory``) the peak bytes of one step of
    the cell, on this rank."""
    run, tracked, sizes = build_cell(cfg, shape, serve_dtype=serve_dtype, mesh=mesh)
    mt = MemTracker() if memory else None
    if mt is not None:
        mt.track_external(*tracked)
    counter = OpBytes(tracked)
    coll = Collectives(mesh) if mesh is not None else contextlib.nullcontext()
    with FlopCounterMode(display=False) as flops, mt or contextlib.nullcontext(), counter, \
            coll:
        counter.add_outputs(_local(run()))
    out = {"flops": float(flops.get_total_flops()), "bytes_floor": float(counter.floor),
           "bytes_unfused": float(counter.bytes), "state_bytes": sizes}
    if mesh is not None:
        out["collectives"] = {**coll.kinds,
                              "total_bytes": sum(v["bytes"] for v in coll.kinds.values())}
        out["collectives_by_axis"] = coll.by_axis
    out["coll"] = float(out["collectives"]["total_bytes"]) if mesh is not None else 0.0
    if mt is not None:
        peak = mt.get_tracker_snapshot("peak")[torch.device("meta")]
        out["memory"] = {str(k).rsplit(".", 1)[-1].lower(): int(v) for k, v in peak.items()}
    return out


# ---------------------------------------------------------------------------
# cost probes — the reference's 2- and 4-layer extrapolation, a cross-check
# ---------------------------------------------------------------------------
# The reference compiles small UNROLLED probes because XLA counts a scanned
# layer once; the port's eager step counts every layer, so these probes are
# not needed for the cells, and serve to check that the full-depth count is
# linear in the layers as the reference assumes.

def _probe_cfgs(cfg: ModelConfig) -> list[tuple[ModelConfig, dict]]:
    base = cfg.scaled(scan_layers=False, attn_unroll=True)
    if cfg.family == "hybrid":
        return [
            (base.scaled(num_layers=2, attn_every=1), {"m": 2, "s": 2}),
            (base.scaled(num_layers=4, attn_every=1), {"m": 4, "s": 4}),
            (base.scaled(num_layers=4, attn_every=2), {"m": 4, "s": 2}),
        ]
    if cfg.family == "encdec":
        return [
            (base.scaled(num_layers=2, encoder_layers=2), {"l": 2}),
            (base.scaled(num_layers=4, encoder_layers=4), {"l": 4}),
        ]
    return [
        (base.scaled(num_layers=2), {"l": 2}),
        (base.scaled(num_layers=4), {"l": 4}),
    ]


def _extrapolate(cfg: ModelConfig, samples: list[tuple[dict, float]]) -> float:
    """Solve the per-layer-species linear model and evaluate at full depth."""
    if cfg.family == "hybrid":
        (_, m1), (_, m2), (_, m3) = samples
        bs = (m2 - m3) / 2.0
        bm = (m2 - m1) / 2.0 - bs
        a = m1 - 2 * bm - 2 * bs
        n_shared = cfg.num_layers // cfg.attn_every
        return a + cfg.num_layers * bm + n_shared * bs
    (_, m1), (_, m2) = samples
    l1, l2 = samples[0][0]["l"], samples[1][0]["l"]
    # per-LAYER slope; grouped MoE (llama4) stays linear in layers because
    # each group is a fixed layer bundle (2 layers incl. 1 MoE).
    b = (m2 - m1) / (l2 - l1)
    a = m1 - l1 * b
    return a + cfg.num_layers * b


COUNTS = ("flops", "bytes_floor", "bytes_unfused", "coll")


def probe_costs(cfg: ModelConfig, shape: ShapeConfig, *,
                serve_dtype: torch.dtype | None = torch.bfloat16, mesh=None) -> dict:
    """FLOPs, both byte counts and the collective bytes extrapolated to full
    depth from the probes (on ``mesh``, under the active rules)."""
    samples = [(meta, count_cell(pcfg, shape, serve_dtype=serve_dtype, memory=False,
                                 mesh=mesh))
               for pcfg, meta in _probe_cfgs(cfg)]
    return {key: _extrapolate(cfg, [(m, v[key]) for m, v in samples]) for key in COUNTS}


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

def analyze(counts: dict, cfg: ModelConfig, shape: ShapeConfig, mesh_name: str = "1") -> dict:
    """The reference's cell keys from one rank's counts on the named mesh."""
    chips = 1 if mesh_dims(mesh_name) is None else math.prod(mesh_dims(mesh_name)[0])
    flops_dev, bytes_dev = counts["flops"], counts["bytes_floor"]
    mem = {"peak_memory_in_bytes": counts["memory"]["total"],
           "by_kind": {k: v for k, v in counts["memory"].items() if k != "total"},
           "source": "MemTracker peak over the meta step"}
    coll = counts.get("collectives", {**_empty_collectives(), "total_bytes": 0})
    by_axis = counts.get("collectives_by_axis", {})

    flops_global = flops_dev * chips
    bytes_global = bytes_dev * chips
    t_compute = flops_global / (chips * PEAK_FLOPS)
    t_memory = bytes_global / (chips * HBM_BW)
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": collective_seconds(by_axis, mesh_name)}
    bottleneck = max(terms, key=terms.get)
    t_unfused = counts["bytes_unfused"] / HBM_BW     # the eager ceiling: not a bound

    # MODEL_FLOPS: 6·N·D for train (fwd+bwd), 2·N·D for single forward.
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 6 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 2 * n_active * tokens
    else:
        tokens = shape.global_batch
        model_flops = 2 * n_active * tokens

    return {
        "chips": chips,
        "flops_per_device": flops_dev,
        "flops_global": flops_global,
        "bytes_per_device": bytes_dev,
        "bytes_global": bytes_global,
        "bytes_unfused_per_device": counts["bytes_unfused"],
        "bytes_counted_as": {
            "bytes_per_device": "floor: each step input read once, each output written once",
            "bytes_unfused_per_device": "eager ceiling: every op's tensor inputs and outputs, "
                                        "views left out"},
        # the reference's parse_collectives layout (all zero at one rank)
        "collectives": coll,
        "collectives_by_axis": by_axis,
        "links": links(mesh_name),
        "state_bytes_per_device": counts["state_bytes"],
        "memory": mem,
        "roofline": {
            **terms,
            "memory_unfused_s": t_unfused,
            "bottleneck": bottleneck.replace("_s", ""),
            "model_flops": model_flops,
            "useful_flops_ratio": (
                model_flops / flops_global if flops_global else 0.0
            ),
        },
    }


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, out_dir: str | None = None,
             cfg_override: ModelConfig | None = None, mesh: str = "1") -> dict:
    """One cell on the named mesh (``mesh_dims``): "1" (one rank) in this
    process, a mesh such as ``PRODUCTION["single"]`` in a spawned process of
    its own (``mesh_cell``)."""
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh}

    ok, why = supports_shape(cfg, shape)
    if not ok:
        cell["status"] = "skipped"
        cell["reason"] = why
        _dump(cell, out_dir)
        return cell
    if mesh_dims(mesh) is not None:
        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as ex:
            cell = ex.submit(mesh_cell, arch, shape_name, cfg, mesh).result()
        _dump(cell, out_dir)
        return cell

    t0 = time.time()
    try:
        counts = count_cell(cfg, shape)
        cell.update(analyze(counts, cfg, shape))
        _timing(cell, t0)
    except Exception as e:
        _failed(cell, e)
    _dump(cell, out_dir)
    return cell


def mesh_cell(arch: str, shape_name: str, cfg: ModelConfig, mesh: str,
              shape: ShapeConfig | None = None, probes: bool = False) -> dict:
    """One cell on a named production mesh, in this process, which must hold
    no process group: it joins the ``"fake"`` backend as rank 0 of the
    mesh's world, builds the mesh over the CPU device type, runs the cell
    under ``rules_for`` and leaves the group. ``shape`` overrides the named
    shape's sizes; ``probes`` adds the 2- and 4-layer probes' extrapolation
    (``probe``)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = shape or SHAPES[shape_name]
    dims, names = mesh_dims(mesh)
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh}
    t0 = time.time()
    # DTensor's sharding cache would hand an earlier cell's (equal) mesh, and
    # its process group, to this cell's tensors
    _clear_sharding_cache()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(dims))
    try:
        dm = make_mesh(dims, names, device_type="cpu")
        rules = rules_for(cfg, shape, dm)
        with axis_rules(dm, rules):
            counts = count_cell(cfg, shape, mesh=dm)
            if probes:
                cell["probe"] = probe_costs(cfg, shape, mesh=dm)
        cell.update(analyze(counts, cfg, shape, mesh))
        cell["rules"] = {k: v for k, v in rules.items()}
        cell["replicated"] = replicated_dims(cfg, shape, dm, rules)
        _timing(cell, t0)
    except Exception as e:
        _failed(cell, e)
    finally:
        dist.destroy_process_group()
    return cell


def _clear_sharding_cache() -> None:
    prop = getattr(getattr(DTensor, "_op_dispatcher", None), "sharding_propagator", None)
    clear = getattr(getattr(prop, "propagate_op_sharding", None), "cache_clear", None)
    if clear is not None:
        clear()


def replicated_dims(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: dict) -> list[str]:
    """What every rank of an axis computes alike where the rules would split
    it: the dims that do not divide their mesh axes (the reference's
    ``sanitize_shardings`` replicates them), a batch the rules replicate, and
    the CB-sparse MLP's replicated tiles; as text, for the cell's JSON."""
    out = []
    width = S.axis_size(mesh, "model")
    heads_split = rules.get("heads", "model") == "model"
    if cfg.family in ("ssm", "hybrid"):
        nh = cfg.d_model * cfg.ssm_expand // cfg.ssm_headdim
        if heads_split and nh % width:
            out.append(f"SSD heads {nh} over model {width}: every rank runs all of them")
    if cfg.family != "ssm":
        if heads_split and cfg.num_heads % width:
            out.append(f"attention heads {cfg.num_heads} over model {width}")
        elif rules.get("kv", "model") == "model" and cfg.num_kv_heads % width:
            out.append(f"KV heads {cfg.num_kv_heads} over model {width}: each rank takes its "
                       "query heads' groups")
    if "batch" in rules and rules["batch"] is None:
        out.append(f"batch {shape.global_batch} over the batch axes: replicated (rules_for)")
    if cfg.family == "moe":
        tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
        G, D = max(1, min(cfg.moe_groups, tokens)), S.batch_width(mesh)
        if G < D:
            out.append(f"MoE token groups {G} over {D} batch ranks: each group on {D // G} "
                       "ranks, every one running the group's whole expert buffer")
    if cfg.sparse_mlp:
        out.append("CB-sparse MLP tiles replicated (mlp_axes): every model rank runs the "
                   "same products on its batch rows")
    return out


def _timing(cell: dict, t0: float) -> None:
    cell["status"] = "ok"
    # the reference's timing keys: no lowering, compile or probes here;
    # compile_s is the counted meta step's host seconds
    cell["lower_s"] = 0.0
    cell["compile_s"] = round(time.time() - t0, 1)
    cell["probe_s"] = 0.0


def _failed(cell: dict, e: Exception) -> None:
    cell["status"] = "FAILED"
    cell["error"] = f"{type(e).__name__}: {e}"
    cell["traceback"] = traceback.format_exc()[-6000:]


def _dump(cell: dict, out_dir: str | None) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{cell['arch']}_{cell['shape']}_{cell['mesh']}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(cell, f, indent=1)


def _fmt_row(c: dict) -> str:
    if c["status"] != "ok":
        return (f"{c['arch']:26s} {c['shape']:12s} {c['mesh']:8s} "
                f"{c['status']}: {c.get('reason', c.get('error', ''))[:80]}")
    r = c["roofline"]
    return (
        f"{c['arch']:26s} {c['shape']:12s} {c['mesh']:8s} ok "
        f"comp={r['compute_s']:.3e}s mem={r['memory_s']:.3e}s "
        f"coll={r['collective_s']:.3e}s bound={r['bottleneck']:4s} "
        f"useful={r['useful_flops_ratio']:.2f} "
        f"[{c['compile_s']:.0f}s compile]"
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multipod", choices=["single", "multi", "both"], default="single",
                    help="the production mesh: 16x16 (single), 2x16x16 (multi) or both")
    ap.add_argument("--mesh", choices=["1"], default=None,
                    help="1: one rank, no mesh (the collective term is 0)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--workers", type=int, default=max(1, min(8, os.cpu_count() or 1)),
                    help="cells counted at once, each in its own process (production mesh)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCH_IDS

    archs = ARCH_IDS if args.all or args.arch is None else [args.arch]
    shapes = (
        list(SHAPES) if args.all or args.shape is None else [args.shape]
    )
    meshes = ["1"] if args.mesh else {"single": [PRODUCTION["single"]],
                                      "multi": [PRODUCTION["multi"]],
                                      "both": list(PRODUCTION.values())}[args.multipod]
    jobs = [(a, s, m) for a in archs for s in shapes for m in meshes]

    results = []
    if meshes == ["1"]:
        for a, s, m in jobs:
            c = run_cell(a, s, out_dir=args.out, mesh=m)
            print(_fmt_row(c), flush=True)
            results.append(c)
    else:
        with ProcessPoolExecutor(args.workers, mp_context=multiprocessing.get_context("spawn"),
                                 max_tasks_per_child=1) as ex:
            futures = [(a, s, m, ex.submit(_sweep_cell, a, s, m)) for a, s, m in jobs]
            for a, s, m, f in futures:
                c = f.result()
                _dump(c, args.out)
                print(_fmt_row(c), flush=True)
                results.append(c)
    n_ok = sum(1 for c in results if c["status"] == "ok")
    n_skip = sum(1 for c in results if c["status"] == "skipped")
    n_fail = sum(1 for c in results if c["status"] == "FAILED")
    print(f"\n{n_ok} ok / {n_skip} skipped / {n_fail} FAILED")
    if n_fail:
        raise SystemExit(1)


def _sweep_cell(arch: str, shape_name: str, mesh: str) -> dict:
    """A sweep's cell in a fresh worker process (one cell a process)."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    ok, why = supports_shape(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh, "status": "skipped",
                "reason": why}
    return mesh_cell(arch, shape_name, cfg, mesh)


if __name__ == "__main__":
    main()
