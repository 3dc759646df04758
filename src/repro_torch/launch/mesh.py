"""Production mesh construction + logical-axis rule selection.

The port of ``repro.launch.mesh``. A mesh is a ``torch.distributed``
``DeviceMesh`` whose ``mesh_dim_names`` are the reference's axis names.
``make_production_mesh`` is a FUNCTION (importing this module touches no
process group). Single pod = (data=16, model=16) — 256 ranks; multi-pod
adds a leading ``pod`` axis (2 pods = 512 ranks). ``pod`` is pure DP by
default (weights replicated per pod, gradients summed across pods);
``runtime.pipeline`` can alternatively run GPipe stages over it.

``rules_for`` returns the logical->physical overrides per (cfg, shape):
  * decode shapes with batch < data width: batch unsharded, KV cache
    *sequence* sharded over model (flash-decoding style);
  * small archs (whisper) replicate attention heads (TP over 16 ranks of
    a 12-head model is padding waste, not parallelism).
``data_width`` and ``rules_for`` read only the mesh's axis names and sizes,
so a stand-in with ``mesh_dim_names`` and ``shape`` answers for a
production mesh this process does not hold.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import errors
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.streams import resolve_device
from repro_torch.models.sharding import mesh_axes

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


def backend_for(device_type: str) -> str:
    """The process-group backend of a device type: NCCL for CUDA, gloo for the CPU."""
    return {"cuda": "nccl", "cpu": "gloo"}[device_type]


def make_mesh(shape: tuple, axis_names: tuple, *, device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axis_names`` over the ranks of
    the process group this process has initialised (with
    ``backend_for(device_type)``), whose world size must be the product of
    ``shape``. The counterpart of the reference's ``compat.make_mesh``."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise errors.InvalidArgError(f"mesh shape {shape} and axis names {axis_names} differ")
    if not (dist.is_available() and dist.is_initialized()):
        raise errors.InvalidArgError(
            "make_mesh needs an initialised process group: call torch.distributed."
            f"init_process_group({backend_for(device_type)!r}, ...) on every rank first")
    if math.prod(shape) != dist.get_world_size():
        raise errors.InvalidArgError(
            f"a {shape} mesh needs {math.prod(shape)} ranks, the process group has "
            f"{dist.get_world_size()}")
    resolve_device(device_type)
    return init_device_mesh(device_type, shape, mesh_dim_names=axis_names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def data_width(mesh) -> int:
    size = mesh_axes(mesh)
    w = size["data"]
    if "pod" in size:
        w *= size["pod"]
    return w


def rules_for(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    rules: dict = {}
    dw = data_width(mesh)
    model_width = mesh_axes(mesh)["model"]

    if shape.kind == "decode":
        # Decode caches dominate memory. Shard the cache SEQUENCE dim over
        # the model axis (flash-decoding); kv-head sharding would replicate
        # whenever kv_heads < TP width (GQA: 8 < 16), which is exactly the
        # big-cache regime. Batch rides data when divisible (decode_32k),
        # else the whole cache burden is on the seq shards (long_500k,
        # batch 1). Heads replicated: q-heads sharded over model would make
        # attention h-parallel and gather the seq-sharded cache each layer;
        # replicated heads keep the contraction s-parallel.
        rules["kv_seq"] = "model"
        rules["kv"] = None
        rules["heads"] = None
        if shape.global_batch % dw != 0:
            rules["batch"] = None

    if cfg.num_heads < model_width:
        # whisper (12 heads < 16): replicate heads, shard MLP only.
        rules["heads"] = None
        rules["kv"] = None

    if cfg.family == "moe":
        if cfg.num_experts % model_width == 0:
            pass  # EP (experts -> model), the default rule table
        else:
            # too few experts for the TP width (mixtral 8 < 16): replicate
            # the expert axis and TP-shard inside each expert's FFN.
            rules["experts"] = None
            rules["expert_mlp"] = "model"
    return rules
