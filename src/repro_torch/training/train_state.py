"""TrainState: params + optimizer state + step, and its reference layout.

The port of ``repro.training.train_state``. ``params`` is the model's
module of parameters (``transformer.LM``, ``hybrid.HybridLM`` or
``encdec.EncDecLM``); the optimizer's moments and the EF buffers are lists in
``params.parameters()`` order (``training.optimizer``).

``train_state_to_numpy`` / ``train_state_from_numpy`` map a state to and
from the reference's ``TrainState`` pytree as numpy, the layers stacked on
axis 0 (``models.model.param_tree``): a ``TrainState`` of the same fields
whose params and moments are the reference's nested dicts. That is what
``checkpoint.Checkpointer`` writes, leaf for leaf in the order and under the
names JAX flattens the reference's state with (``leaves_with_names``), so a
checkpoint crosses between the two packages both ways. bfloat16 leaves go
to numpy as raw two-byte values (``|V2``), as ``np.save`` stores the
reference's bfloat16 arrays.

On a mesh the state's tensors are ``DTensor``s (``TrainState.create`` of a
sharded model places the moments and EF buffers like their parameters).
The reference's layout is whole arrays, so ``to_numpy`` gathers each
(every rank calls it), and ``train_state_from_numpy(model=)`` /
``shard_state`` give each rank its part of a whole state.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import errors
from repro_torch.core.streams import _as_tensor, resolve_device
from repro_torch.models import sharding as S
from repro_torch.models.model import lm_from_tree, param_tree, tree_values

from .grad_compression import init_ef_buffers
from .optimizer import AdamWState, LionState


@dataclasses.dataclass
class TrainState:
    step: Any                # () int32 tensor (numpy in the reference layout)
    params: Any              # the model's nn.Module (the nested dict in the reference layout)
    opt_state: Any
    ef_buffers: Any = None   # int8-compression error feedback

    @classmethod
    def create(cls, params, optimizer, use_compression: bool = False):
        leaves = list(params.parameters())
        return cls(
            step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
            params=params,
            opt_state=optimizer.init(leaves),
            ef_buffers=init_ef_buffers(leaves) if use_compression else None,
        )


# ---------------------------------------------------------------------------
# pytrees, flattened as JAX flattens the reference's
# ---------------------------------------------------------------------------

class Stacked(list):
    """One leaf of the reference layout that the port holds per layer."""


def _children(node):
    """(name, child) pairs in JAX's order, or None for a leaf: dict keys
    sorted, dataclass fields in declaration order, sequences by index;
    ``None`` is an empty subtree."""
    if isinstance(node, Stacked):
        return None
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    if node is None:
        return []
    return None


def leaves_with_names(tree) -> list[tuple[str, Any]]:
    """Every leaf with its path joined by ``__`` (the reference checkpointer's
    file names; ``leaf`` for a tree that is one leaf)."""
    out = []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            out.append(("__".join(path) or "leaf", node))
            return
        for name, child in kids:
            walk(child, path + [name])

    walk(tree, [])
    return out


def map_leaves(fn, tree, like=None):
    """``tree``'s structure with ``fn(leaf)`` at each leaf; with ``like``, the
    structure of ``like`` filled with ``fn(leaf, like_leaf)`` from ``tree``'s
    leaves taken in order (``tree`` then is their list)."""
    it = iter(tree) if like is not None else None

    def build(node):
        kids = _children(node)
        if kids is None:
            return fn(next(it), node) if it is not None else fn(node)
        if isinstance(node, dict):
            return {k: build(c) for k, c in kids}
        if dataclasses.is_dataclass(node):
            return dataclasses.replace(node, **{k: build(c) for k, c in kids})
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for _, c in kids)
        return None                                   # None, an empty subtree

    return build(tree if like is None else like)


# ---------------------------------------------------------------------------
# the reference layout
# ---------------------------------------------------------------------------

def to_numpy(x) -> np.ndarray:
    """A host copy: tensors (bfloat16 as ``|V2``; a ``DTensor`` whole, gathered
    from every rank), stacked layers, arrays."""
    if isinstance(x, Stacked):
        return np.stack([to_numpy(t) for t in x])
    if isinstance(x, torch.Tensor):
        t = S.full_tensor(x.detach()).to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.array(x)


def from_numpy(a, device) -> torch.Tensor:
    """``to_numpy``'s inverse on ``device`` (ml_dtypes bfloat16 taken too)."""
    a = np.asarray(a)
    if a.dtype == np.dtype("V2"):
        a = a.view(np.int16)
        return torch.from_numpy(a.copy()).view(torch.bfloat16).to(device)
    return _as_tensor(a).reshape(a.shape).to(device)


def stacked_tree(params, values=None) -> dict:
    """``models.model.param_tree`` with each layer-stacked leaf a ``Stacked``
    list, so that the tree flattens to the reference's leaves."""
    def stacked(node):
        if isinstance(node, dict):
            return {k: stacked(c) for k, c in node.items()}
        return Stacked(stacked(c) for c in node) if isinstance(node, list) else node

    return stacked(param_tree(params, values))


def layout(state: TrainState) -> TrainState:
    """The reference's ``TrainState`` pytree over ``state``'s own tensors (no
    copy): params, moments and EF buffers as the reference's parameter
    tree, each layer-stacked leaf a ``Stacked`` list of the layers' tensors."""
    def per_param(v):
        return stacked_tree(state.params, v) if isinstance(v, list) else v

    opt = state.opt_state
    opt = dataclasses.replace(opt, **{f.name: per_param(getattr(opt, f.name))
                                      for f in dataclasses.fields(opt)})
    return TrainState(step=state.step, params=stacked_tree(state.params), opt_state=opt,
                      ef_buffers=None if state.ef_buffers is None
                      else stacked_tree(state.params, state.ef_buffers))


def train_state_to_numpy(state: TrainState) -> TrainState:
    """A host copy of ``state`` in the reference's layout (synchronous)."""
    return map_leaves(to_numpy, layout(state))


def train_state_from_numpy(tree, device=None, *, model=None) -> TrainState:
    """The port's state from the reference's ``TrainState`` as numpy (this
    package's layout, or the reference's own dataclasses with numpy leaves),
    on ``device`` (default CUDA). With ``model`` on a mesh (``Model(cfg,
    mesh=)``), each rank's part of it, laid out as ``model.shard`` lays the
    parameters (the whole state is read on the host, never on the device)."""
    if model is not None and model.mesh is not None:
        whole = train_state_from_numpy(tree, "cpu")
        layouts = [(sh.mesh, sh.placements) for sh in
                   S.model_shardings(whole.params, model.axes(), model.mesh)]
        return shard_state(whole, layouts, resolve_device(device))
    dev = resolve_device(device)
    params = lm_from_tree(tree.params, dev)

    def values(t):
        return [from_numpy(a, dev) for a in tree_values(params, t)]

    opt = tree.opt_state
    count = from_numpy(opt.count, dev)
    if hasattr(opt, "nu"):
        opt_state = AdamWState(mu=values(opt.mu), nu=values(opt.nu), count=count)
    else:
        opt_state = LionState(mu=values(opt.mu), count=count)
    return TrainState(step=from_numpy(tree.step, dev), params=params, opt_state=opt_state,
                      ef_buffers=None if tree.ef_buffers is None else values(tree.ef_buffers))


@torch.no_grad()
def shard_state(state: TrainState, layouts: list, device=None) -> TrainState:
    """``state`` (whole tensors, equal on every rank) distributed over a mesh,
    in place: parameter i by ``layouts[i] = (mesh, placements)``, its moments
    and EF buffer like it; each rank keeps its part, moved to ``device``
    (default: where it is). Returns ``state``."""
    named = list(state.params.named_parameters())
    if len(layouts) != len(named):
        raise errors.InvalidArgError(f"{len(layouts)} layouts for {len(named)} parameters")

    def place(t, layout):
        return S.distribute_local(t.detach(), *layout, device=device)

    for (name, p), layout in zip(named, layouts):
        S._set_param(state.params, name, torch.nn.Parameter(place(p, layout)))
    opt = state.opt_state
    for f in dataclasses.fields(opt):
        v = getattr(opt, f.name)
        if isinstance(v, list):
            setattr(opt, f.name, [place(t, lay) for t, lay in zip(v, layouts, strict=True)])
        elif device is not None:
            setattr(opt, f.name, v.to(device))
    if state.ef_buffers is not None:
        state.ef_buffers = [place(t, lay) for t, lay in zip(state.ef_buffers, layouts,
                                                              strict=True)]
    if device is not None:
        state.step = state.step.to(device)
    return state


def layouts_of(params) -> list:
    """(mesh, placements) of each ``DTensor`` parameter (None for a local one)."""
    return [(p.device_mesh, p.placements) if S.param_mesh(p) is not None else None
            for p in params.parameters()]
