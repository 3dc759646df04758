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

import torch
import torch.nn.functional as F

from repro_torch import errors
from repro_torch.configs.base import ModelConfig

from .layers import _normal


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


def _dispatch(params, cfg: ModelConfig, xg: torch.Tensor, C: int, first_expert: int = 0):
    """Sort-based top-k dispatch of every token group at once. xg (G, T, d).

    Returns (buf (G, El, C, d), meta) for the El experts held from
    ``first_expert`` on (El is ``w_gate``'s first dim): ``meta`` is (buf_idx,
    s_token, s_gate, keep, aux, order), each (G, T*K) but ``aux`` (G,);
    entry j of a group is the j-th assignment in expert order, ``keep`` says
    it is within capacity and held here, and ``order`` is its index in the
    (token, k) layout."""
    G, T, d = xg.shape
    E, K = cfg.num_experts, cfg.top_k
    El = params["w_gate"].shape[0]
    dt = xg.dtype
    dev = xg.device

    logits = (xg @ params["router"].to(dt)).float()                # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1)            # (G, T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # Switch-style load-balancing auxiliary loss. The one-hot is a comparison:
    # F.one_hot checks its input's range on the host.
    me = probs.mean(dim=1)
    first = expert_ids[..., 0, None] == torch.arange(E, device=dev)
    ce = first.float().mean(dim=1)
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
    local = s_expert - first_expert
    keep = (pos < C) & (local >= 0) & (local < El)

    buf_idx = torch.where(keep, local * C + pos, El * C)            # overflow slot
    rows = torch.arange(G, device=dev)[:, None]
    buf = torch.zeros((G, El * C + 1, d), dtype=dt, device=dev)
    # the kept slots are distinct; the overflow row takes the rest and is dropped
    buf = buf.index_put((rows, buf_idx), xg[rows, s_token])
    buf = buf[:, :-1].reshape(G, El, C, d)
    return buf, (buf_idx, s_token, s_gate, keep, aux, order)


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


def moe_apply(params, cfg: ModelConfig, x: torch.Tensor,
              first_expert: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out, aux_loss).

    Dispatch runs per token group (``cfg.moe_groups``, GShard-style):
    capacity is per group; groups=1 is global dispatch. The group count
    falls back until it divides the token count, as in the reference.
    ``params`` holds the experts from ``first_expert`` on (all by default).
    """
    B, S, d = x.shape
    T = B * S
    G = max(1, min(cfg.moe_groups, T))   # batch-1 decode: fall back to G=1
    while T % G:
        G -= 1
    dt = x.dtype
    xg = x.reshape(G, T // G, d)
    C = _capacity(T // G, cfg)

    buf, meta = _dispatch(params, cfg, xg, C, first_expert)    # buf (G, El, C, d)

    # ---- expert FFN (batched over the group and expert axes) ---------------
    g = torch.einsum("gecd,edf->gecf", buf, params["w_gate"].to(dt))
    u = torch.einsum("gecd,edf->gecf", buf, params["w_up"].to(dt))
    h = F.silu(g) * u
    out_buf = torch.einsum("gecf,efd->gecd", h, params["w_down"].to(dt))

    y = _combine(out_buf, meta, T // G, cfg.top_k, dt)
    aux = meta[4].mean()

    y = y.reshape(T, d)
    if cfg.moe_shared_expert:
        sh = params["shared"]
        xt = x.reshape(T, d)
        gs = xt @ sh["w_gate"].to(dt)
        us = xt @ sh["w_up"].to(dt)
        y = y + (F.silu(gs) * us) @ sh["w_down"].to(dt)

    return y.reshape(B, S, d), aux
