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
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.streams import _as_tensor, resolve_device
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
    """A host copy: tensors (bfloat16 as ``|V2``), stacked layers, arrays."""
    if isinstance(x, Stacked):
        return np.stack([to_numpy(t) for t in x])
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
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


def train_state_from_numpy(tree, device=None) -> TrainState:
    """The port's state from the reference's ``TrainState`` as numpy (this
    package's layout, or the reference's own dataclasses with numpy leaves),
    on ``device`` (default CUDA)."""
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
