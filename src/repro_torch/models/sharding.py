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
does not hold).

**The mesh's compute** (the second half of this module). Where the
reference hands GSPMD a layout and lets it place the collectives, the port
keeps the layout in the state and writes the collectives out:
``shard_params`` turns a model's parameters into ``DTensor``s placed by
``sanitize_shardings(logical_to_sharding(model.axes(), mesh))``; each layer
body takes ``local_param`` of its weights (the rank's shard, gathered over
``data`` where FSDP splits it, its gradient reduce-scattered back) and
computes on local tensors; and at the reference's ``constrain`` points the
layers call the differentiable collectives ``sum_grad`` (Megatron's f:
identity forward, gradient summed over ``model``), ``reduce_over`` (g: the
row-parallel partial sums added, identity backward) and ``gather_over``.
Every collective over an axis of one rank is the identity and runs nothing,
so a one-rank mesh computes the local model's ops in the local model's
order. ``constrain`` redistributes a ``DTensor``; ``as_dtensor`` names a
local activation's layout at a constrain point. Gloo serves CUDA tensors
by staging them through the host (NCCL refuses two ranks on one card, and
``DTensor.full_tensor`` crashes under gloo on CUDA in torch 2.11), so no
collective here goes through ``DTensor``'s own redistribution.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import errors

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
    """A leaf's logical shape; a list is a layer-stacked leaf (one tensor a layer, or
    a list of them: a llama4 group's dense layers)."""
    if isinstance(leaf, list):
        return (len(leaf),) + _shape(leaf[0])
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


def placements_for(mesh, *axes: str | None) -> tuple:
    """The placements of a tensor whose dims carry the logical ``axes``, under
    the active rules when ``mesh`` is the active mesh, else the default ones."""
    if _is_active(mesh):
        return NamedSharding(mesh, spec_for(axes)).placements
    with axis_rules(mesh):
        return NamedSharding(mesh, spec_for(axes)).placements


def as_dtensor(x: torch.Tensor, mesh, *axes: str | None):
    """A rank's local activation as the ``DTensor`` it is a shard of, its
    dims carrying the logical ``axes`` (no communication); ``constrain``
    then holds it to the active rules' layout. Without a mesh, ``x`` itself."""
    if mesh is None:
        return x
    return constrain(DTensor.from_local(x, mesh, placements_for(mesh, *axes), run_check=False),
                     *axes)


# ---------------------------------------------------------------------------
# the mesh's compute: local tensors and explicit collectives
# ---------------------------------------------------------------------------

def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` (1 for an axis the mesh lacks)."""
    names = tuple(mesh.mesh_dim_names)
    return int(mesh.size(names.index(axis))) if axis in names else 1


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 for an axis the mesh lacks)."""
    return mesh.get_local_rank(axis) if axis in tuple(mesh.mesh_dim_names) else 0


def _is_active(mesh) -> bool:
    """Whether ``mesh`` is the active one (a ``DTensor`` may carry an equal
    ``DeviceMesh`` object of its own: DTensor's sharding cache hands out
    the mesh it first saw)."""
    return _ctx.mesh is not None and (_ctx.mesh is mesh or _ctx.mesh == mesh)


def active_rules(mesh) -> dict:
    """The rule table that lays out tensors on ``mesh``: the innermost
    ``axis_rules``' when it was entered with this mesh, else the defaults."""
    return _ctx.rules if _is_active(mesh) else DEFAULT_RULES


def rule_axes(mesh, axis: str) -> tuple[str, ...]:
    """The mesh axes a logical axis maps to on ``mesh`` under its rules
    (``active_rules``), in the mapping's order; () where it is replicated."""
    mapped = active_rules(mesh).get(axis)
    if mapped is None:
        return ()
    mapped = mapped if isinstance(mapped, tuple) else (mapped,)
    return tuple(a for a in mapped if a in tuple(mesh.mesh_dim_names))


def batch_axes(mesh) -> tuple[str, ...]:
    """The mesh axes the batch shards over: the rules' ``batch`` (pod, data),
    none where the active rules replicate the batch (a decode batch that
    does not divide, ``launch.mesh.rules_for``)."""
    return rule_axes(mesh, "batch")


def batch_width(mesh) -> int:
    w = 1
    for a in batch_axes(mesh):
        w *= axis_size(mesh, a)
    return w


def param_mesh(t):
    """The mesh of a ``DTensor`` (a sharded model's parameter), else None."""
    return t.device_mesh if isinstance(t, DTensor) else None


def sharded_axes(t) -> tuple[str, ...]:
    """The mesh axes a ``DTensor`` is split over (none for a local tensor)."""
    if not isinstance(t, DTensor):
        return ()
    return tuple(n for n, p in zip(t.device_mesh.mesh_dim_names, t.placements) if p.is_shard())


def model_sharded(t) -> bool:
    """Whether a parameter is split over ``model`` (its layer runs Megatron-style)."""
    return "model" in sharded_axes(t) and axis_size(t.device_mesh, "model") > 1


def split_dim(t, axis: str = "model") -> int | None:
    """The dim of a ``DTensor`` split over ``axis`` (of more than one rank), else None."""
    if not isinstance(t, DTensor) or axis_size(t.device_mesh, axis) == 1:
        return None
    pl = t.placements[tuple(t.device_mesh.mesh_dim_names).index(axis)]
    return pl.dim if pl.is_shard() else None


def part_like(x: torch.Tensor, t) -> torch.Tensor:
    """This rank's part of ``x``, a whole tensor of ``t``'s shape, split along
    the dim that the ``DTensor`` ``t`` splits over ``model`` (``x`` itself
    where it splits none)."""
    dim = split_dim(t)
    return x if dim is None else _my_part(x, t.device_mesh, "model", dim)


# the single-tensor collectives, under their names in this torch (newer
# releases renamed *_into_tensor / *_tensor to *_single)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _staged(t: torch.Tensor, group):
    """c10d's operand for ``t``: gloo takes CUDA tensors through the host."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.detach().cpu(), True  # cblint: disable=CB211 -- gloo's staging copy
    return t, False


def all_reduce(t: torch.Tensor, mesh, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``axis`` (a new tensor; ``t`` itself on one rank)."""
    if axis_size(mesh, axis) == 1:
        return t
    group = mesh.get_group(axis)
    buf, staged = _staged(t.contiguous(), group)
    buf = buf.clone() if not staged else buf
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device) if staged else buf


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The shards of ``axis`` joined along ``dim``, in rank order."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    group = mesh.get_group(axis)
    src, staged = _staged(t.movedim(dim, 0).contiguous(), group)
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    _ALL_GATHER(out, src, group=group)
    out = out.to(t.device) if staged else out
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """``t`` summed over ``axis``, this rank's part of it along ``dim``."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    group = mesh.get_group(axis)
    src, staged = _staged(t.movedim(dim, 0).contiguous(), group)
    if src.shape[0] % n:
        raise errors.InvalidArgError(f"dim {dim} of size {src.shape[0]} does not split "
                                     f"{n} ways over {axis!r}")
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    _REDUCE_SCATTER(out, src, group=group)
    out = out.to(t.device) if staged else out
    return out.movedim(0, dim)


def _my_part(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = axis_size(mesh, axis)
    return t.chunk(n, dim)[axis_rank(mesh, axis)] if n > 1 else t


class _Reduce(torch.autograd.Function):
    """Forward: sum over the axes. Backward: the cotangent as it is (every rank
    downstream holds the same sum, so each gets the same gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        for a in axes:
            x = all_reduce(x, mesh, a)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrad(torch.autograd.Function):
    """Forward: the identity. Backward: the cotangent summed over the axes
    (each rank's part of the compute gave only its share of the gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for a in ctx.axes:
            g = all_reduce(g, ctx.mesh, a)
        return g, None, None


class _Gather(torch.autograd.Function):
    """Forward: all-gather along ``dim``. Backward: reduce-scatter (``grad=
    "sum"``, each rank's compute downstream differs: FSDP) or this rank's
    slice (``"slice"``: every rank downstream computes the same thing)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, grad):
        ctx.mesh, ctx.axis, ctx.dim, ctx.grad = mesh, axis, dim, grad
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            g = reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim)
        else:
            g = _my_part(g, ctx.mesh, ctx.axis, ctx.dim).contiguous()
        return g, None, None, None, None


def _live(mesh, axes) -> tuple:
    return tuple(a for a in axes if axis_size(mesh, a) > 1)


def reduce_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Partial results summed over ``axes`` (g); identity backward."""
    axes = () if mesh is None else _live(mesh, axes)
    return _Reduce.apply(x, mesh, axes) if axes else x


def sum_grad(x: torch.Tensor, mesh, axes=("model",)) -> torch.Tensor:
    """The input of a split compute (f): itself, its gradient summed over ``axes``."""
    axes = () if mesh is None else _live(mesh, axes)
    return _SumGrad.apply(x, mesh, axes) if axes else x


def gather_over(x: torch.Tensor, mesh, axis: str, dim: int, grad: str = "sum") -> torch.Tensor:
    """The shards of ``axis`` joined along ``dim`` (see ``_Gather`` for ``grad``)."""
    if mesh is None or axis_size(mesh, axis) == 1:
        return x
    return _Gather.apply(x, mesh, axis, dim, grad)


def global_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of a batch-sharded tensor over the global batch: each rank's
    mean (the shards are of one size) averaged over the batch axes."""
    m = x.mean()
    if mesh is None or batch_width(mesh) == 1:
        return m
    return reduce_over(m, mesh, batch_axes(mesh)) / batch_width(mesh)


def local_param(p, partial=()):
    """A weight as this rank's compute uses it.

    A local tensor is itself. A ``DTensor`` parameter gives its shard,
    all-gathered along each dim split over a batch axis (FSDP: ``w_embed ->
    data``; the gradient is reduce-scattered back), kept split where it is
    split over ``model`` (TP: the layer computes its part). Its gradient is
    summed over each batch axis it is replicated on (the ranks saw different
    rows of the batch), and over the axes of ``partial`` on which it is
    replicated but used by a split compute (a norm of the local heads)."""
    if not isinstance(p, DTensor):
        return p
    mesh = p.device_mesh
    x = p.to_local()
    names = tuple(mesh.mesh_dim_names)
    batch = batch_axes(mesh)
    for name, pl in zip(names, p.placements):
        if pl.is_shard() and name != "model":
            x = gather_over(x, mesh, name, pl.dim)
    summed = tuple(n for n, pl in zip(names, p.placements)
                   if pl.is_replicate() and (n in batch or n in partial))
    return sum_grad(x, mesh, summed)


def distribute_local(t: torch.Tensor, mesh, placements, device=None) -> DTensor:
    """``t``, whole and equal on every rank, as a ``DTensor`` of ``placements``:
    each rank keeps its own part (no communication), moved to ``device`` (by
    default where ``t`` is). Dims split evenly."""
    local = t
    for i, pl in enumerate(placements):
        if pl.is_shard():
            n = int(mesh.size(i))
            if local.shape[pl.dim] % n:
                raise errors.InvalidArgError(
                    f"dim {pl.dim} of a {tuple(t.shape)} tensor does not split {n} ways")
            local = local.chunk(n, pl.dim)[mesh.get_local_rank(i)]
    local = local.contiguous() if local is t else local.clone()
    if device is not None:
        local = local.to(device)
    return DTensor.from_local(local, mesh, list(placements), run_check=False,
                              shape=t.shape, stride=t.stride())


def full_tensor(t):
    """A ``DTensor``'s whole tensor on every rank, by c10d all-gathers (a local
    tensor is itself). ``DTensor.full_tensor`` is not used: it crashes under
    gloo on CUDA tensors in torch 2.11."""
    if not isinstance(t, DTensor):
        return t
    mesh, x = t.device_mesh, t.to_local()
    with torch.no_grad():
        for name, pl in zip(mesh.mesh_dim_names, t.placements):
            if pl.is_shard():
                x = all_gather(x, mesh, name, pl.dim)
    return x


def param_shardings(params, tree) -> list[NamedSharding]:
    """One ``NamedSharding`` per parameter of ``params`` (``parameters()``
    order) from ``tree``, a tree of them in the reference's stacked layout:
    a stacked leaf's spec loses its layer axes."""
    from .model import _path

    out = []
    for name, _ in params.named_parameters():
        path, idx = _path(params, name)
        node = tree
        for k in path:
            node = node[k]
        if not isinstance(node, NamedSharding):
            raise errors.InvalidArgError(f"shardings holds {node!r} for parameter {name}")
        out.append(NamedSharding(node.mesh, tuple(node.spec[len(idx):])))
    return out


def model_shardings(params, axes_tree, mesh) -> list[NamedSharding]:
    """The layout of each parameter, as the reference's sharded step takes it:
    ``sanitize_shardings(shapes, logical_to_sharding(axes, mesh, rules), mesh)``
    under the mesh's rules (``active_rules``)."""
    from .model import param_tree

    tree = sanitize_shardings(param_tree(params),
                              logical_to_sharding(axes_tree, mesh, active_rules(mesh)), mesh)
    return param_shardings(params, tree)


def shard_tree(tree, axes_tree, mesh, device=None):
    """A tree of whole tensors (equal on every rank; ``axes_tree`` of the same
    structure, as a decode state and ``decode_state_axes``) as ``DTensor``s laid
    out as the reference lays them, ``sanitize_shardings(shapes,
    logical_to_sharding(axes, mesh, rules), mesh)`` under the mesh's rules:
    each rank keeps its part, on ``device``."""
    shardings = sanitize_shardings(
        tree, logical_to_sharding(axes_tree, mesh, active_rules(mesh)), mesh)
    return _map_shardings(lambda t, sh: distribute_local(t, mesh, sh.placements, device),
                          tree, shardings)


def local_tree(tree):
    """Each ``DTensor`` of a tree of dicts as its local shard."""
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    return tree.to_local() if isinstance(tree, DTensor) else tree


def tree_like(local, like):
    """Local shards back into the ``DTensor``s of the tree ``like`` (their
    layouts and whole shapes); a local leaf of ``like`` takes the tensor as it is."""
    if isinstance(like, dict):
        return {k: tree_like(local[k], v) for k, v in like.items()}
    if not isinstance(like, DTensor):
        return local
    return DTensor.from_local(local, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def local_index(t, dim: int, i: int) -> int | None:
    """Where index ``i`` of ``t``'s dim ``dim`` lies in this rank's shard of it
    (a ``DTensor`` split evenly), or None when another rank holds it."""
    if not isinstance(t, DTensor):
        return i
    mesh, n, lo = t.device_mesh, t.shape[dim], 0
    for m, pl in enumerate(t.placements):
        if pl.is_shard() and pl.dim == dim:
            n //= int(mesh.size(m))
            lo = lo * int(mesh.size(m)) + mesh.get_local_rank(m)
    lo *= n
    return i - lo if lo <= i < lo + n else None


def _set_param(module, name: str, value) -> None:
    *path, leaf = name.split(".")
    for k in path:
        module = module[int(k)] if k.isdigit() else getattr(module, k)
    module._parameters[leaf] = value


@torch.no_grad()
def shard_params(params, model, mesh, device=None):
    """Distribute a model's parameters over ``mesh``, in place: each becomes a
    ``DTensor`` parameter placed as the reference's sharded train step places
    it (``model_shardings`` of ``model.axes()``): FSDP ``w_embed -> data``;
    ``heads`` / ``kv`` / ``mlp`` / ``vocab`` / ``experts -> model``; the rest
    (norms, the router's expert dim, the CB tiles) replicated. Every rank
    passes the same whole weights; each keeps its part, moved to ``device``
    (default: where it is). The rules are the mesh's (``active_rules``).
    Returns ``params``."""
    shs = model_shardings(params, model.axes(), mesh)
    named = list(params.named_parameters())
    for (name, p), sh in zip(named, shs, strict=True):
        _set_param(params, name, torch.nn.Parameter(distribute_local(p.detach(), mesh,
                                                                     sh.placements, device)))
    return params


def place_batch(batch: dict, mesh) -> dict:
    """The global batch (equal on every rank) as ``DTensor``s split on the
    leading dim over ``batch -> (pod, data)``, replicated over ``model`` (and
    whole on every rank where the active rules replicate ``batch``)."""
    out = {}
    w = batch_width(mesh)
    for k, v in batch.items():
        if v.shape[0] % w:
            raise errors.InvalidArgError(
                f"batch[{k!r}] has {v.shape[0]} rows, which do not split over the "
                f"{w} ranks of {batch_axes(mesh)}")
        out[k] = distribute_local(v, mesh, placements_for(mesh, "batch",
                                                          *(None,) * (v.ndim - 1)))
    return out


def local_batch(x, mesh):
    """This rank's rows of a batch tensor: a ``DTensor``'s local shard, or the
    rank's part of a whole tensor that every rank holds (all of it where the
    active rules replicate ``batch``)."""
    if isinstance(x, DTensor):
        return x.to_local()
    if x is None or mesh is None:
        return x
    w = batch_width(mesh)
    if x.shape[0] % w:
        raise errors.InvalidArgError(
            f"{x.shape[0]} rows do not split over the {w} ranks of {batch_axes(mesh)}: "
            "replicate the batch (the rules' batch -> None, as rules_for does at decode)")
    return x if w == 1 else x.chunk(w, 0)[batch_rank(mesh)]


def batch_rank(mesh) -> int:
    """This rank's index among the ranks of the batch axes (pod-major)."""
    i = 0
    for a in batch_axes(mesh):
        i = i * axis_size(mesh, a) + axis_rank(mesh, a)
    return i
