"""Logical-axis sharding rules (MaxText-style) for the model stack.

The port of ``repro.models.sharding``. Model code names tensor dimensions
with *logical* axes ("batch", "embed", "heads", ...); a rule table maps
them to the named dimensions of a ``torch.distributed`` ``DeviceMesh``.
Parameters carry a parallel tree of logical-axis tuples (``Model.axes()``);
``logical_to_sharding`` turns it into a tree of ``NamedSharding``s, whose
``placements`` are what ``torch.distributed.tensor.distribute_tensor``
takes, and ``constrain`` redistributes a ``DTensor`` activation.

Default rules implement Megatron-TP x FSDP x DP:
  * activations: batch -> (pod, data); model-parallel dims -> model
  * weights: the "embed" dim shards over data (ZeRO/FSDP — keeps per-chip
    parameter+optimizer bytes flat as the pod grows), TP dims over model,
    and nothing over pod (pod is pure DP: weights replicated per pod,
    gradients summed across pods).

A mesh here is anything with ``mesh_dim_names`` and ``shape`` (a
``DeviceMesh``, or a stand-in naming a production shape that this process
does not hold). The port's models run local tensors (tensor parallelism of
their layers is not ported), so they call no ``constrain`` yet.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

from torch.distributed.tensor import DTensor, Replicate, Shard

# logical axis -> mesh axis (or tuple of mesh axes, or None = replicated)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,        # activations' model dim stays replicated
    "heads": "model",
    "kv": "model",
    "kv_seq": None,       # decode cache seq; long-context overrides to model
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,   # EP default; flipped to "model" for TP-MoE
    "expert_cap": None,
    "layers": None,
    "conv": None,
    "ssm_state": None,
    "frames": None,
    "patches": None,
    # weight-only axes
    "w_embed": "data",    # FSDP shard of the embed dim of weight matrices
    "w_layers": None,
}


def mesh_axes(mesh) -> dict[str, int]:
    """Mesh axis name -> size, in mesh order."""
    return dict(zip(tuple(mesh.mesh_dim_names), (int(s) for s in mesh.shape)))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout on ``mesh``: ``spec`` has one entry per tensor dim,
    ``None`` (replicated), a mesh axis name, or a tuple of them."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        """One ``Shard(dim)`` / ``Replicate()`` per mesh dim, in mesh order. A
        tensor dim mapped to several mesh axes shards over each of them."""
        names = tuple(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for dim, entry in enumerate(self.spec):
            for a in () if entry is None else (entry if isinstance(entry, tuple) else (entry,)):
                out[names.index(a)] = Shard(dim)
        return tuple(out)


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict = dict(DEFAULT_RULES)


_ctx = _Ctx()


@contextlib.contextmanager
def axis_rules(mesh, rules: dict | None = None):
    """Activate a mesh + rule table for this thread."""
    old = (_ctx.mesh, _ctx.rules)
    _ctx.mesh = mesh
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _ctx.rules = merged
    try:
        yield
    finally:
        _ctx.mesh, _ctx.rules = old


def active_mesh():
    """The mesh of the innermost ``axis_rules`` of this thread, or None."""
    return _ctx.mesh


def _resolve(axis: str | None):
    if axis is None:
        return None
    mapped = _ctx.rules.get(axis, None)
    if mapped is None:
        return None
    names = tuple(_ctx.mesh.mesh_dim_names) if _ctx.mesh is not None else ()
    if isinstance(mapped, tuple):
        present = tuple(a for a in mapped if a in names)
        # a PartitionSpec entry of one axis is that axis' name
        return (present if len(present) > 1 else present[0]) if present else None
    return mapped if mapped in names else None


def spec_for(axes: tuple) -> tuple:
    """Logical axis tuple -> one mesh-axis entry per dim, under the active rules."""
    return tuple(_resolve(a) for a in axes)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _map_axes(fn, tree):
    """``fn`` at every logical-axis tuple of a tree of dicts and lists."""
    if _is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_axes(fn, v) for v in tree)
    raise TypeError(f"not a logical-axis tree node: {tree!r}")


def logical_to_sharding(axes_tree, mesh, rules: dict | None = None):
    """Map a tree of logical-axis tuples to ``NamedSharding``s."""
    with axis_rules(mesh, rules):
        return _map_axes(lambda axes: NamedSharding(mesh, spec_for(axes)), axes_tree)


def _shape(leaf) -> tuple:
    """A leaf's logical shape; a list is a layer-stacked leaf (one tensor a layer)."""
    if isinstance(leaf, list):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def _map_shardings(fn, shapes, shardings):
    if isinstance(shardings, NamedSharding):
        return fn(shapes, shardings)
    if isinstance(shardings, dict):
        return {k: _map_shardings(fn, shapes[k], v) for k, v in shardings.items()}
    return type(shardings)(_map_shardings(fn, a, b) for a, b in zip(shapes, shardings,
                                                                   strict=True))


def sanitize_shardings(shapes_tree, shardings_tree, mesh):
    """Drop sharding on any dim the mesh axes don't divide (a sharded
    placement of this layout requires exact divisibility). The production
    rule tables avoid this by construction (vocab padding, split
    projections); this is the safety net for residual odd dims (e.g. a
    12-head model on a 16-wide axis). ``shapes_tree`` holds anything with a
    ``shape`` at each leaf of ``shardings_tree``."""
    size = mesh_axes(mesh)

    def fix(shape_leaf, sh: NamedSharding):
        shape = _shape(shape_leaf)
        spec = list(sh.spec) + [None] * (len(shape) - len(sh.spec))
        out = []
        for dim, ax in zip(shape, spec):
            if ax is None:
                out.append(None)
                continue
            width = 1
            for a in ax if isinstance(ax, tuple) else (ax,):
                width *= size[a]
            out.append(ax if dim % width == 0 else None)
        return NamedSharding(mesh, tuple(out))

    return _map_shardings(fix, shapes_tree, shardings_tree)


def constrain(x, *axes: str | None):
    """Apply a logical-axis sharding constraint: a ``DTensor`` is
    redistributed to the spec; without a mesh, or on a local tensor, ``x``
    is returned as it is."""
    if _ctx.mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(_ctx.mesh, NamedSharding(_ctx.mesh, spec_for(axes)).placements)
