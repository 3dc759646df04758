"""Zamba2-style hybrid: a Mamba2 trunk and one weight-shared attention block.

The port of ``repro.models.hybrid`` (``src/repro/models/hybrid.py``). Every
``cfg.attn_every`` SSM layers one *shared* transformer block (attention +
SwiGLU) is applied; its weights are shared by all G invocations, each
specialised by low-rank LoRA deltas on the q/k/v projections (stacked
(G, ...), the zamba2 recipe, arXiv:2411.15242). The trunk runs in G equal
slices with the shared block after each.

On a mesh (``DTensor`` weights) the Mamba2 layers run ``ssm.ssm_apply``'s
layout and the shared block the transformer's (attention and MLP
Megatron-style); the LoRA deltas are folded into this rank's heads of
``wq`` / ``wk`` / ``wv`` (each rank adds its part of the whole delta, the
LoRA factors' gradient summed over ``model``). The constrain points are the
reference's (``src/repro/models/hybrid.py:142,167,228``): the embedding's
output over ``batch``, the logits over ``vocab``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.streams import resolve_device

from . import layers as L
from . import sharding as S
from . import ssm as ssm_mod
from .transformer import LMOutputs, _prepend_layers_axis, embed_tokens, mesh_logits, \
    param_dict, remat_block, seq_mesh, ssm_layers_decode, unembed


def _num_groups(cfg: ModelConfig) -> int:
    assert cfg.attn_every > 0 and cfg.num_layers % cfg.attn_every == 0
    return cfg.num_layers // cfg.attn_every


class HybridLM(nn.Module):
    """The hybrid model's float32 parameters, named by the reference's tree:
    ``embed``, ``mamba.<i>.{mixer.*, norm1}``, ``shared.{attn, mlp, norm1,
    norm2}``, ``lora.{qa, qb, ka, kb, va, vb}`` (G, ...), ``final_norm``,
    ``unembed``."""

    def __init__(self, embed, mamba: list[dict], shared: dict, lora: dict, final_norm,
                 unembed):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.mamba = nn.ModuleList([param_dict(m) for m in mamba])
        self.shared = param_dict(shared)
        self.lora = param_dict(lora)
        self.final_norm = nn.Parameter(final_norm)
        self.unembed = nn.Parameter(unembed)


def hybrid_axes(cfg: ModelConfig) -> dict:
    return {
        "embed": ("vocab", "w_embed"),
        "mamba": {
            "mixer": _prepend_layers_axis(ssm_mod.ssm_axes(cfg)),
            "norm1": ("w_layers", "embed"),
        },
        "shared": {
            "attn": L.attention_axes(cfg),
            "mlp": L.mlp_axes(cfg.scaled(sparse_mlp=False)),
            "norm1": ("embed",), "norm2": ("embed",),
        },
        "lora": {k: ("w_layers", None, None) for k in ("qa", "qb", "ka", "kb", "va", "vb")},
        "final_norm": ("embed",),
        "unembed": ("w_embed", "vocab"),
    }


def hybrid_init(generator: torch.Generator, cfg: ModelConfig, specs=None,
                device=None) -> HybridLM:
    """Random float32 weights from ``generator``, on ``device`` (default CUDA);
    the LoRA up-projections start at zero, as in the reference."""
    del specs
    dev = resolve_device(device)
    G = _num_groups(cfg)
    d, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim
    r = max(1, cfg.shared_attn_lora_rank)

    embed = L.embed_init(generator, cfg.padded_vocab, d, device=dev)
    mamba = [{"mixer": ssm_mod.ssm_init(generator, cfg, dev),
              "norm1": torch.ones(d, device=dev)} for _ in range(cfg.num_layers)]
    shared = {"attn": L.attention_init(generator, cfg, dev),
              "mlp": L.mlp_init(generator, cfg.scaled(sparse_mlp=False), device=dev),
              "norm1": torch.ones(d, device=dev), "norm2": torch.ones(d, device=dev)}

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    lora = {
        "qa": L._normal(generator, (G, d, r), d**-0.5, dev), "qb": zeros(G, r, H * dh),
        "ka": L._normal(generator, (G, d, r), d**-0.5, dev), "kb": zeros(G, r, Hkv * dh),
        "va": L._normal(generator, (G, d, r), d**-0.5, dev), "vb": zeros(G, r, Hkv * dh),
    }
    unembed = L._normal(generator, (d, cfg.padded_vocab), d**-0.5, dev)
    return HybridLM(embed, mamba, shared, lora, torch.ones(d, device=dev), unembed)


def _shared_block(params, lora_g, cfg: ModelConfig, h, positions, cache=None):
    """The shared attention + MLP block with this invocation's LoRA delta
    (``lora_g``: the factors as ``_lora`` gives them). Returns (h, new_cache)."""
    dt = h.dtype
    dh = cfg.resolved_head_dim
    hn = L.rmsnorm(h, S.local_param(params["norm1"]))

    # the LoRA deltas fold into the attention projections: per-invocation
    # effective weights, float32 weight + delta in the activation dtype
    # (promoted to float32, as in the reference)
    def delta(a, b, heads):
        return (a.to(dt) @ b.to(dt)).reshape(cfg.d_model, heads, dh)

    deltas = {"wq": delta(lora_g["qa"], lora_g["qb"], cfg.num_heads),
              "wk": delta(lora_g["ka"], lora_g["kb"], cfg.num_kv_heads),
              "wv": delta(lora_g["va"], lora_g["vb"], cfg.num_kv_heads)}
    attn_out, new_cache = L.attention_apply(dict(params["attn"].items()), cfg, hn,
                                            positions=positions, causal=True, cache=cache,
                                            window=cfg.swa_window, deltas=deltas)
    h = h + attn_out
    hn2 = L.rmsnorm(h, S.local_param(params["norm2"]))
    h = h + L.mlp_apply(dict(params["mlp"].items()), cfg.scaled(sparse_mlp=False), hn2)
    return h, new_cache


def _lora_factors(params: HybridLM) -> dict:
    """The LoRA factors (G, ...) as this rank uses them: on a mesh, where the
    shared attention's heads split over ``model``, each rank folds only its
    part of the deltas, so their gradient is summed over ``model``."""
    part = ("model",) if S.model_sharded(params.shared["attn"]["wq"]) else ()
    return {k: S.local_param(v, part) for k, v in params.lora.items()}


def _lora(params: HybridLM, g: int, factors: dict | None = None) -> dict:
    """Invocation g's LoRA factors (of ``factors``, by default ``_lora_factors``)."""
    factors = _lora_factors(params) if factors is None else factors
    return {k: v[g] for k, v in factors.items()}


def forward(params: HybridLM, cfg: ModelConfig, tokens, *, specs=None, patch_embeds=None,
            last_only: bool = False) -> LMOutputs:
    del patch_embeds, specs
    per = cfg.attn_every
    mesh = S.param_mesh(params.embed)
    h = embed_tokens(params.embed, S.local_batch(tokens, mesh), cfg)
    if mesh is not None:
        h = S.as_dtensor(h, mesh, "batch", "seq", "embed").to_local()
    positions = torch.arange(h.shape[1], device=h.device)
    lora = _lora_factors(params)

    def mamba_body(layer, h):
        mix, _ = ssm_mod.ssm_apply(layer["mixer"], cfg,
                                   L.rmsnorm(h, S.local_param(layer["norm1"])))
        return h + mix

    def block(g, h):
        return _shared_block(params.shared, _lora(params, g, lora), cfg, h, positions)[0]

    mamba_body, block = remat_block(mamba_body, cfg), remat_block(block, cfg)
    for g in range(_num_groups(cfg)):
        for layer in params.mamba[g * per:(g + 1) * per]:
            h = mamba_body(layer, h)
        h = block(g, h)

    h = L.rmsnorm(h, S.local_param(params.final_norm))
    if last_only:
        h = h[:, -1:, :]
    logits = unembed(params.unembed, cfg, h)
    return LMOutputs(logits=mesh_logits(logits, params.unembed, "seq"),
                     aux_loss=torch.zeros((), device=h.device))


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    return {"ssm": ssm_mod.ssm_state_init(cfg, batch, cfg.num_layers, device=device),
            "attn": L.decode_cache_init(cfg, batch, max_len, _num_groups(cfg), device=device)}


def decode_state_axes(cfg: ModelConfig) -> dict:
    return {"ssm": ssm_mod.SSM_STATE_AXES, "attn": L.CACHE_AXES}


@torch.no_grad()
def decode_step(params: HybridLM, cfg: ModelConfig, state: dict, tokens, pos, *,
                specs=None) -> tuple[torch.Tensor, dict]:
    """One token for every sequence. ``state`` is not written: the shared
    block's caches are copied once and this step's k/v written into the copy;
    the SSM states come back as new tensors. On a mesh the state and the
    logits are ``DTensor``s, as in ``transformer.decode_step``."""
    per = cfg.attn_every
    mesh = S.param_mesh(params.embed)
    seq = None
    if mesh is not None:
        tokens, pos = S.local_batch(tokens, mesh), S.local_batch(pos, mesh)
        seq = seq_mesh(state["attn"]["k"])
        whole, state = state, S.local_tree(state)
    h = embed_tokens(params.embed, tokens, cfg)
    positions = pos[:, None]
    ck, cv = state["attn"]["k"].clone(), state["attn"]["v"].clone()
    lora = _lora_factors(params)

    new_ssd, new_conv = [], []
    for g in range(_num_groups(cfg)):
        sl = slice(g * per, (g + 1) * per)
        h, ssd_g, conv_g = ssm_layers_decode(params.mamba[sl], cfg, h,
                                             state["ssm"]["ssd"][sl], state["ssm"]["conv"][sl])
        new_ssd.append(ssd_g)
        new_conv.append(conv_g)
        cache = {"k": ck[g], "v": cv[g], "pos": state["attn"]["pos"], "seq_mesh": seq}
        h, _ = _shared_block(params.shared, _lora(params, g, lora), cfg, h, positions,
                             cache=cache)

    new_state = {
        "ssm": {"ssd": torch.cat(new_ssd), "conv": torch.cat(new_conv)},
        "attn": {"k": ck, "v": cv, "pos": state["attn"]["pos"] + 1},
    }
    h = L.rmsnorm(h, S.local_param(params.final_norm))
    logits = mesh_logits(unembed(params.unembed, cfg, h)[:, 0, :], params.unembed)
    return logits, (new_state if mesh is None else S.tree_like(new_state, whole))
