"""Mixture-of-Experts FFN: top-k routing with sort-based dispatch.

The port of ``repro.models.moe`` (``src/repro/models/moe.py``). Token ->
expert assignments are sorted by expert id, each token's position within
its expert comes from the runs' starts, tokens beyond capacity are dropped
(GShard's capacity discipline) into an overflow row, and the (E, C, d)
buffer is filled by one indexed write. The experts are batched products
over the group and expert axes.

The reference vmaps its per-group dispatch (``_dispatch_one_group``,
``_combine_one_group``); here ``_dispatch`` and ``_combine`` take every
group at once, and one group is G = 1. Every shape is fixed by the config
and the token count, and nothing reads a value back to the host
(``argsort(stable=True)``, ``searchsorted``, ``topk``, indexed writes of
fixed size), so a decode step that runs this layer captures in a CUDA
graph. The combine adds each token's K contributions in a fixed order
(k = 0, 1, ...) instead of the reference's scatter-add, so two runs are
bit-equal for any ``top_k``; for K <= 2 the sums are the reference's bit
for bit (0 + a + b rounds once, in either order).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import errors
from repro_torch.configs.base import ModelConfig

from . import sharding as S
from .layers import _normal, swiglu


def moe_axes(cfg: ModelConfig) -> dict:
    # the experts' FFN dim has its own logical axis, "expert_mlp": with expert
    # parallelism it maps to None; where the expert count does not divide the
    # TP width the rules flip to experts -> None, expert_mlp -> model
    # (launch/mesh.rules_for).
    axes = {
        "router": ("w_embed", None),
        "w_gate": ("experts", "w_embed", "expert_mlp"),
        "w_up": ("experts", "w_embed", "expert_mlp"),
        "w_down": ("experts", "expert_mlp", "w_embed"),
    }
    if cfg.moe_shared_expert:
        axes["shared"] = {
            "w_gate": ("w_embed", "mlp"),
            "w_up": ("w_embed", "mlp"),
            "w_down": ("mlp", "w_embed"),
        }
    return axes


def expert_range(cfg: ModelConfig, shard: tuple[int, int] | None) -> tuple[int, int]:
    """(first expert, experts held) of shard ``(i, n)`` of ``cfg``'s experts
    (``None``: all of them)."""
    E = cfg.num_experts
    if shard is None:
        return 0, E
    i, n = shard
    if not (n >= 1 and E % n == 0 and 0 <= i < n):
        raise errors.InvalidArgError(f"expert shard {shard}: needs 0 <= i < n and n dividing {E} experts")
    return i * (E // n), E // n


def moe_init(generator: torch.Generator, cfg: ModelConfig, device=None,
             shard: tuple[int, int] | None = None) -> dict:
    """The layer's weights; with ``shard=(i, n)`` only shard i of n of the
    experts' (the router scores all of them)."""
    d, ff = cfg.d_model, cfg.d_ff
    E = expert_range(cfg, shard)[1]
    params = {
        "router": _normal(generator, (d, cfg.num_experts), d**-0.5, device),
        "w_gate": _normal(generator, (E, d, ff), d**-0.5, device),
        "w_up": _normal(generator, (E, d, ff), d**-0.5, device),
        "w_down": _normal(generator, (E, ff, d), ff**-0.5, device),
    }
    if cfg.moe_shared_expert:
        params["shared"] = {
            "w_gate": _normal(generator, (d, ff), d**-0.5, device),
            "w_up": _normal(generator, (d, ff), d**-0.5, device),
            "w_down": _normal(generator, (ff, d), ff**-0.5, device),
        }
    return params


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    cap = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-cap // 8) * 8)


class _Route(NamedTuple):
    """Every group's assignments in expert order: expert, token, gate, position
    within the expert, index in the (token, k) layout; and the groups' aux."""
    s_expert: torch.Tensor
    s_token: torch.Tensor
    s_gate: torch.Tensor
    pos: torch.Tensor
    order: torch.Tensor
    aux: torch.Tensor


def _route(router: torch.Tensor, cfg: ModelConfig, xg: torch.Tensor, span=None) -> _Route:
    """Top-k routing of every token group at once. xg (G, T, d). ``span`` =
    (mesh, k): each group is this rank's share of a group held by k ranks of
    the batch axes (``_span_offsets``)."""
    G, T, d = xg.shape
    E, K = cfg.num_experts, cfg.top_k
    dev = xg.device

    logits = (xg @ router.to(xg.dtype)).float()                     # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1)            # (G, T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # Switch-style load-balancing auxiliary loss. The one-hot is a comparison:
    # F.one_hot checks its input's range on the host.
    first = expert_ids[..., 0, None] == torch.arange(E, device=dev)
    if span is None:
        me = probs.mean(dim=1)
        ce = first.float().mean(dim=1)
    else:                       # the means over the whole group, on its k ranks
        me = _span_rows(probs.sum(dim=1), *span).sum(dim=0) / (T * span[1])
        ce = _span_rows(first.float().sum(dim=1), *span).sum(dim=0) / (T * span[1])
    aux = E * (me * ce).sum(-1)                                     # (G,)

    # ---- sort-based dispatch ------------------------------------------------
    flat_expert = expert_ids.reshape(G, T * K)
    flat_gate = gate_vals.reshape(G, T * K)
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    s_expert = torch.gather(flat_expert, 1, order)
    s_token = torch.div(order, K, rounding_mode="floor")            # repeat(arange(T), K)
    s_gate = torch.gather(flat_gate, 1, order)
    # position within expert = rank - start of the expert's run
    starts = torch.searchsorted(s_expert, torch.arange(E, device=dev).expand(G, E).contiguous())
    pos = torch.arange(T * K, device=dev) - torch.gather(starts, 1, s_expert)
    if span is not None:
        # the group's ranks hold its tokens in order: before this rank's
        # assignments to an expert come those of the ranks before it
        counts = torch.diff(starts, dim=1, append=torch.full((G, 1), T * K, dtype=starts.dtype,
                                                                device=dev))
        before = _span_rows(counts, *span, upto_self=True).sum(dim=0)   # (G, E)
        pos = pos + torch.gather(before, 1, s_expert)
    return _Route(s_expert, s_token, s_gate, pos, order, aux)


def _span_rows(t: torch.Tensor, mesh, k: int, upto_self: bool = False) -> torch.Tensor:
    """The tensors ``t`` of the k ranks (of the batch axes, in order) that hold
    this rank's group, stacked on a new leading dim; with ``upto_self`` only
    those of the ranks before this one (zeros for the rest). Gathered over
    the batch axes, the gradient summed back."""
    rows = t[None]
    for a in reversed(S.batch_axes(mesh)):          # inner axis first: pod-major order
        rows = S.gather_over(rows, mesh, a, 0)
    i = S.batch_rank(mesh)
    g0 = i - i % k
    mine = rows[g0:g0 + k]
    if upto_self:
        mine = mine * (torch.arange(k, device=t.device) < i - g0).to(t.dtype).reshape(
            (k,) + (1,) * t.ndim)
    return mine


def _slots(r: _Route, C: int, first_expert: int, El: int) -> tuple:
    """(buf_idx, keep) of the El experts from ``first_expert`` on: an
    assignment is kept when within capacity and held here; the rest go to
    the overflow slot El * C."""
    local = r.s_expert - first_expert
    keep = (r.pos < C) & (local >= 0) & (local < El)
    return torch.where(keep, local * C + r.pos, El * C), keep


def _fill(r: _Route, values: torch.Tensor, buf_idx: torch.Tensor, El: int, C: int):
    """The (G, El, C, d) expert buffer: each kept assignment's token row."""
    G, _, d = values.shape
    rows = torch.arange(G, device=values.device)[:, None]
    buf = torch.zeros((G, El * C + 1, d), dtype=values.dtype, device=values.device)
    # the kept slots are distinct; the overflow row takes the rest and is dropped
    buf = buf.index_put((rows, buf_idx), values[rows, r.s_token])
    return buf[:, :-1].reshape(G, El, C, d)


def _dispatch(params, cfg: ModelConfig, xg: torch.Tensor, C: int, first_expert: int = 0):
    """Sort-based top-k dispatch of every token group at once. xg (G, T, d).

    Returns (buf (G, El, C, d), meta) for the El experts held from
    ``first_expert`` on (El is ``w_gate``'s first dim): ``meta`` is (buf_idx,
    s_token, s_gate, keep, aux, order), each (G, T*K) but ``aux`` (G,);
    entry j of a group is the j-th assignment in expert order, ``keep`` says
    it is within capacity and held here, and ``order`` is its index in the
    (token, k) layout."""
    El = params["w_gate"].shape[0]
    r = _route(params["router"], cfg, xg)
    buf_idx, keep = _slots(r, C, first_expert, El)
    return _fill(r, xg, buf_idx, El, C), (buf_idx, r.s_token, r.s_gate, keep, r.aux, r.order)


def _combine(out_buf: torch.Tensor, meta, T: int, K: int, dt) -> torch.Tensor:
    """out_buf (G, El, C, d) -> (G, T, d): each token's K gated expert outputs,
    added in k order (0 for an assignment not kept here)."""
    buf_idx, _, s_gate, keep, _, order = meta
    G, E, C, d = out_buf.shape
    flat_out = out_buf.reshape(G, E * C, d)
    rows = torch.arange(G, device=out_buf.device)[:, None]
    gathered = torch.where(keep[..., None], flat_out[rows, torch.clamp(buf_idx, max=E * C - 1)],
                           0.0)
    contrib = gathered * s_gate[..., None].to(dt)
    # back to the (token, k) layout: order is a permutation, so the write is exact
    per_k = torch.empty_like(contrib).index_put((rows, order), contrib).reshape(G, T, K, d)
    y = per_k[:, :, 0]
    for k in range(1, K):
        y = y + per_k[:, :, k]
    return y


# Routing counts are recorded while ``record_routing`` is active (a list per
# context); None otherwise, one check a layer.
_routing: list | None = None


@contextlib.contextmanager
def record_routing():
    """Collect each MoE layer's routing while active: a list that gets, per
    ``moe_apply`` call, the (G, E) int64 count of assignments kept per
    expert of this rank's token groups (device tensors, nothing read back)."""
    global _routing
    old, _routing = _routing, []
    try:
        yield _routing
    finally:
        _routing = old


def _record(r: _Route, C: int, E: int) -> None:
    if _routing is not None:
        _, keep = _slots(r, C, 0, E)
        counts = torch.zeros((keep.shape[0], E), dtype=torch.int64, device=keep.device)
        _routing.append(counts.scatter_add_(1, r.s_expert, keep.long()).detach())


def moe_apply(params, cfg: ModelConfig, x: torch.Tensor,
              first_expert: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out, aux_loss).

    Dispatch runs per token group (``cfg.moe_groups``, GShard-style):
    capacity is per group; groups=1 is global dispatch. The group count
    falls back until it divides the token count, as in the reference.
    ``params`` holds the experts from ``first_expert`` on (all by default).

    On a mesh (``DTensor`` weights; x is this rank's batch rows) the
    reference's layout (``src/repro/models/moe.py:133-148``): the groups
    split over the batch axes (x's rows are whole groups; where there are
    fewer groups than ranks, each group is held by k consecutive ranks, and
    its positions within the experts and its aux loss are taken over them:
    ``_span_rows``), and the routing of each is computed on every ``model``
    rank alike. Which dim of ``w_gate`` is split over ``model`` says the
    layout of the experts: ``experts -> model`` (expert parallelism) runs
    the products of the rank's E / model experts and gathers their outputs
    over ``model`` before the combine; ``expert_mlp -> model`` (TP-MoE,
    ``launch.mesh.rules_for`` where the experts do not divide ``model``)
    fills every expert's buffer on every rank, runs ``w_gate`` / ``w_up``
    by columns and ``w_down`` by rows, and adds the partial outputs over
    ``model``. The aux loss is the mean over every group of the global batch.
    """
    mesh = S.param_mesh(params["w_gate"])
    B, S_, d = x.shape
    T = B * S_
    D = 1 if mesh is None else S.batch_width(mesh)
    G = _groups(T * D, cfg)                # the groups of the global batch
    if G % D == 0:
        G_l, span = G // D, None
    elif D % G == 0:                       # a group on each D / G ranks
        G_l, span = 1, (mesh, D // G)
    else:
        raise errors.InvalidArgError(
            f"{G} token groups do not split over the {D} ranks of {S.batch_axes(mesh)}")
    E = cfg.num_experts
    dt = x.dtype
    xg = x.reshape(G_l, T // G_l, d)       # this rank's groups (or its share of one)
    C = _capacity((T // G_l) * (1 if span is None else span[1]), cfg)

    w_gate, w_up, w_down = (S.local_param(params[k]) for k in ("w_gate", "w_up", "w_down"))
    El = w_gate.shape[0]
    split = S.split_dim(params["w_gate"])
    ep, tp = split == 0, split == 2
    if split not in (None, 0, 2):
        raise errors.InvalidArgError(f"w_gate split over 'model' on dim {split}: the experts "
                                     "split by 'experts' (dim 0) or 'expert_mlp' (dim 2)")
    if ep:
        first_expert = S.axis_rank(mesh, "model") * El
    r = _route(S.local_param(params["router"]), cfg, xg, span)
    _record(r, C, E)
    buf_idx, keep = _slots(r, C, first_expert, El)
    # on a mesh the buffer feeds this rank's part of the experts: x's gradient from it is partial
    buf = _fill(r, S.sum_grad(xg, mesh) if ep or tp else xg, buf_idx, El, C)  # (G, El, C, d)
    out_buf = _experts(buf, w_gate, w_up, w_down)
    if ep:
        out_buf = S.gather_over(out_buf, mesh, "model", 1, grad="slice")
        buf_idx, keep = _slots(r, C, 0, E)
    elif tp:
        out_buf = S.reduce_over(out_buf, mesh, ("model",))
    y = _combine(out_buf, (buf_idx, r.s_token, r.s_gate, keep, r.aux, r.order),
                 T // G_l, cfg.top_k, dt)
    aux = S.global_mean(r.aux, mesh)

    y = y.reshape(T, d)
    if cfg.moe_shared_expert:
        sh = params["shared"]
        y = y + swiglu(x.reshape(T, d), sh["w_gate"], sh["w_up"], sh["w_down"],
                       mesh if S.model_sharded(sh["w_gate"]) else None)
    return y.reshape(B, S_, d), aux


def _groups(T: int, cfg: ModelConfig) -> int:
    G = max(1, min(cfg.moe_groups, T))   # batch-1 decode: fall back to G=1
    while T % G:
        G -= 1
    return G


def _experts(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """The expert FFN, batched over the group and expert axes."""
    dt = buf.dtype
    g = torch.einsum("gecd,edf->gecf", buf, w_gate.to(dt))
    u = torch.einsum("gecd,edf->gecf", buf, w_up.to(dt))
    return torch.einsum("gecf,efd->gecd", F.silu(g) * u, w_down.to(dt))
