"""Zamba2-style hybrid: a Mamba2 trunk and one weight-shared attention block.

The port of ``repro.models.hybrid`` (``src/repro/models/hybrid.py``). Every
``cfg.attn_every`` SSM layers one *shared* transformer block (attention +
SwiGLU) is applied; its weights are shared by all G invocations, each
specialised by low-rank LoRA deltas on the q/k/v projections (stacked
(G, ...), the zamba2 recipe, arXiv:2411.15242). The trunk runs in G equal
slices with the shared block after each.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.streams import resolve_device

from . import layers as L
from . import ssm as ssm_mod
from .transformer import LMOutputs, _prepend_layers_axis, embed_tokens, param_dict, \
    remat_block, ssm_layers_decode


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
    """The shared attention + MLP block with this invocation's LoRA delta.
    Returns (h, new_cache)."""
    dt = h.dtype
    dh = cfg.resolved_head_dim
    hn = L.rmsnorm(h, params["norm1"])

    # the LoRA deltas fold into the attention projections: per-invocation
    # effective weights, float32 weight + delta in the activation dtype
    # (promoted to float32, as in the reference)
    def delta(a, b, heads):
        return (a.to(dt) @ b.to(dt)).reshape(cfg.d_model, heads, dh)

    attn_p = dict(params["attn"].items())
    attn_p["wq"] = params["attn"]["wq"] + delta(lora_g["qa"], lora_g["qb"], cfg.num_heads)
    attn_p["wk"] = params["attn"]["wk"] + delta(lora_g["ka"], lora_g["kb"], cfg.num_kv_heads)
    attn_p["wv"] = params["attn"]["wv"] + delta(lora_g["va"], lora_g["vb"], cfg.num_kv_heads)

    attn_out, new_cache = L.attention_apply(attn_p, cfg, hn, positions=positions, causal=True,
                                            cache=cache, window=cfg.swa_window)
    h = h + attn_out
    hn2 = L.rmsnorm(h, params["norm2"])
    h = h + L.mlp_apply(params["mlp"], cfg.scaled(sparse_mlp=False), hn2)
    return h, new_cache


def _lora(params: HybridLM, g: int) -> dict:
    return {k: v[g] for k, v in params.lora.items()}


def forward(params: HybridLM, cfg: ModelConfig, tokens, *, specs=None, patch_embeds=None,
            last_only: bool = False) -> LMOutputs:
    del patch_embeds, specs
    dt = cfg.activation_dtype
    per = cfg.attn_every
    h = embed_tokens(params.embed, tokens, cfg)
    positions = torch.arange(h.shape[1], device=h.device)

    def mamba_body(layer, h):
        mix, _ = ssm_mod.ssm_apply(layer["mixer"], cfg, L.rmsnorm(h, layer["norm1"]))
        return h + mix

    def block(g, h):
        return _shared_block(params.shared, _lora(params, g), cfg, h, positions)[0]

    mamba_body, block = remat_block(mamba_body, cfg), remat_block(block, cfg)
    for g in range(_num_groups(cfg)):
        for layer in params.mamba[g * per:(g + 1) * per]:
            h = mamba_body(layer, h)
        h = block(g, h)

    h = L.rmsnorm(h, params.final_norm)
    if last_only:
        h = h[:, -1:, :]
    logits = L.mask_pad_logits(h @ params.unembed.to(dt), cfg)
    return LMOutputs(logits=logits, aux_loss=torch.zeros((), device=h.device))


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
    the SSM states come back as new tensors."""
    dt = cfg.activation_dtype
    per = cfg.attn_every
    h = embed_tokens(params.embed, tokens, cfg)
    positions = pos[:, None]
    ck, cv = state["attn"]["k"].clone(), state["attn"]["v"].clone()

    new_ssd, new_conv = [], []
    for g in range(_num_groups(cfg)):
        sl = slice(g * per, (g + 1) * per)
        h, ssd_g, conv_g = ssm_layers_decode(params.mamba[sl], cfg, h,
                                             state["ssm"]["ssd"][sl], state["ssm"]["conv"][sl])
        new_ssd.append(ssd_g)
        new_conv.append(conv_g)
        cache = {"k": ck[g], "v": cv[g], "pos": state["attn"]["pos"]}
        h, _ = _shared_block(params.shared, _lora(params, g), cfg, h, positions, cache=cache)

    new_state = {
        "ssm": {"ssd": torch.cat(new_ssd), "conv": torch.cat(new_conv)},
        "attn": {"k": ck, "v": cv, "pos": state["attn"]["pos"] + 1},
    }
    h = L.rmsnorm(h, params.final_norm)
    logits = L.mask_pad_logits((h @ params.unembed.to(dt))[:, 0, :], cfg)
    return logits, new_state
