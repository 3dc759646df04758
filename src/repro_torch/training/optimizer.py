"""Optimizers from scratch: AdamW, Lion, + global-norm clip.

The port of ``repro.training.optimizer`` (``src/repro/training/optimizer.py``),
with its surface and its update math:

    opt = adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params, lr)
    params = apply_updates(params, updates)

``params`` and ``grads`` are lists of tensors in one order (a model's
``parameters()``); the state holds one moment per parameter in that order.
On a mesh they are ``DTensor``s (the moments placed like their parameters,
``zeros_like``): every pass runs on the rank's local shards, and the
global norm sums each tensor's squares over the mesh axes it is split on.

**In place.** The reference is functional; a literal port materialises the
new moments, the updates and the clipped grads beside the old ones, which
at cb-paper (14 GB of float32 parameters; params, grads and two moments are
56 GB) is more than an 80 GB card holds. So here the state is updated in
place with ``torch._foreach_*`` ops, in the reference's order of
operations, a bounded chunk of the parameter list at a time, and the
updates are written into the grads' storage: ``update`` consumes ``grads``
and returns them holding the updates. ``clip_by_global_norm`` scales in
place too, and ``apply_updates`` adds in place. Where an in-place op fuses
a multiply and an add (``add_(g, alpha=)``, ``addcmul_``) its rounding can
differ from XLA's in the last bit; the parity tests state the tolerance.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import sharding as S

# Most elements a chunk of the update touches at once: bounds the temporaries
# (two chunk-sized float32 buffers, 1 GB here) whatever the model's size. A
# tensor larger than this is a chunk of its own.
CHUNK_ELEMS = 2**27


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


def _chunks(*lists):
    """Zip the lists and cut them into runs of at most ``CHUNK_ELEMS`` elements."""
    run, size = [], 0
    for items in zip(*lists):
        n = items[0].numel()
        if run and size + n > CHUNK_ELEMS:
            yield tuple(map(list, zip(*run)))
            run, size = [], 0
        run.append(items)
        size += n
    if run:
        yield tuple(map(list, zip(*run)))


def local(tensors) -> list:
    """Each tensor's local shard (a ``DTensor``'s storage, written in place by
    the passes below; a local tensor itself)."""
    return [t.to_local() if isinstance(t, DTensor) else t for t in tensors]


@torch.no_grad()
def apply_updates(params, updates):
    """``p + u`` into ``p``, in place; returns ``params``."""
    params = list(params)
    torch._foreach_add_(local(params), local(updates))
    return params


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every element's square, in float32 (a 0-d tensor).
    A ``DTensor``'s squares are summed over the mesh axes it is split on, so
    every rank gets the norm of the whole tensors."""
    tree = list(tree)
    sq = torch.stack(torch._foreach_norm([x.float() for x in local(tree)])).square()
    by_axes: dict = {}
    for i, t in enumerate(tree):
        axes = tuple(a for a in S.sharded_axes(t) if S.axis_size(t.device_mesh, a) > 1)
        if axes:
            by_axes.setdefault((t.device_mesh, axes), []).append(i)
    for (mesh, axes), idx in by_axes.items():
        at = torch.tensor(idx, device=sq.device)
        part = sq.index_select(0, at)
        for a in axes:
            part = S.all_reduce(part, mesh, a)
        sq = sq.index_copy(0, at, part)
    return sq.sum().sqrt()


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place by ``min(1, max_norm / (norm + 1e-9))``;
    returns ``(grads, norm)``."""
    grads = list(grads)
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    torch._foreach_mul_(local(grads), scale)
    return grads, norm


# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdamWState:
    mu: Any           # list of tensors, one per parameter
    nu: Any
    count: Any        # () int32


def _moments(params, dtype) -> list:
    return [torch.zeros_like(p, dtype=dtype) for p in params]


def _count(params) -> torch.Tensor:
    dev = params[0].device if params else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, moments_dtype=torch.float32) -> Optimizer:
    """AdamW. ``moments_dtype=torch.bfloat16`` halves optimizer memory (the
    update math still runs in float32; the moments are rounded on store).
    Weight decay applies to every parameter, as in the reference."""

    def init(params):
        params = list(params)
        return AdamWState(mu=_moments(params, moments_dtype),
                          nu=_moments(params, moments_dtype), count=_count(params))

    @torch.no_grad()
    def update(grads, state: AdamWState, params, lr):
        grads = local(grads)
        state.count += 1
        cf = state.count.to(torch.float32)
        mu_hat_scale = 1.0 / (1 - b1**cf)
        nu_hat_scale = 1.0 / (1 - b2**cf)
        neg_lr = -torch.as_tensor(lr, dtype=torch.float32, device=cf.device)
        for g, m, v, p in _chunks(grads, local(state.mu), local(state.nu), local(params)):
            m32 = m if moments_dtype == torch.float32 else [t.float() for t in m]
            v32 = v if moments_dtype == torch.float32 else [t.float() for t in v]
            torch._foreach_mul_(m32, b1)                  # b1 m + (1 - b1) g
            torch._foreach_add_(m32, g, alpha=1 - b1)
            torch._foreach_mul_(v32, b2)                  # b2 v + (1 - b2) g^2
            torch._foreach_addcmul_(v32, g, g, value=1 - b2)
            den = torch._foreach_mul(v32, nu_hat_scale)   # sqrt(v nu_hat) + eps
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            upd = torch._foreach_mul(m32, mu_hat_scale)   # m mu_hat / den
            torch._foreach_div_(upd, den)
            del den
            torch._foreach_add_(upd, p, alpha=weight_decay)   # + wd p
            torch._foreach_mul_(upd, neg_lr)              # -lr (...)
            torch._foreach_copy_(g, upd)                  # the update, in g's storage
            del upd
            if moments_dtype != torch.float32:
                torch._foreach_copy_(m, m32)
                torch._foreach_copy_(v, v32)
        return grads, state

    return Optimizer(init=init, update=update)


# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LionState:
    mu: Any
    count: Any


def lion(b1: float = 0.9, b2: float = 0.99,
         weight_decay: float = 0.1) -> Optimizer:
    """Lion (EvoLved Sign Momentum) — half the optimizer memory of Adam."""

    def init(params):
        params = list(params)
        return LionState(mu=_moments(params, torch.float32), count=_count(params))

    @torch.no_grad()
    def update(grads, state: LionState, params, lr):
        grads = local(grads)
        neg_lr = -torch.as_tensor(lr, dtype=torch.float32, device=state.count.device)
        for g, m, p in _chunks(grads, local(state.mu), local(params)):
            upd = torch._foreach_mul(m, b1)               # sign(b1 m + (1 - b1) g)
            torch._foreach_add_(upd, g, alpha=1 - b1)
            torch._foreach_sign_(upd)
            torch._foreach_add_(upd, p, alpha=weight_decay)   # + wd p
            torch._foreach_mul_(upd, neg_lr)              # -lr (...)
            torch._foreach_mul_(m, b2)                    # b2 m + (1 - b2) g
            torch._foreach_add_(m, g, alpha=1 - b2)
            torch._foreach_copy_(g, upd)
            del upd
        state.count += 1
        return grads, state

    return Optimizer(init=init, update=update)


OPTIMIZERS = {"adamw": adamw, "lion": lion}
