"""Whisper-style encoder-decoder backbone.

The port of ``repro.models.encdec`` (``src/repro/models/encdec.py``). The
conv/audio frontend is a stub, as in the reference: the caller hands in
frame embeddings (B, num_frames, d_model). The encoder is bidirectional
self-attention; the decoder causal self-attention plus cross-attention to
the encoder states. RoPE on both stacks, as in the reference.

On a mesh (``DTensor`` weights) the frames and tokens are this rank's rows
(``batch``; the reference's constrain points at
``src/repro/models/encdec.py:111,139,163,233``), self- and cross-attention
take their heads over ``model`` (``rules_for`` replicates whisper's 12
heads at a width of 16), the MLPs are dense TP, and the logits are split
over ``vocab``. The cross k/v of a decode state are split by ``batch``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.streams import resolve_device

from . import layers as L
from . import sharding as S
from .transformer import LMOutputs, _prepend_layers_axis, embed_tokens, mesh_logits, \
    param_dict, remat_block, seq_mesh, unembed


class EncDecLM(nn.Module):
    """The encoder-decoder's float32 parameters, named by the reference's
    tree: ``embed``, ``encoder.<i>.{attn, mlp, norm1, norm2}``,
    ``decoder.<i>.{self, cross, mlp, norm1, norm2, norm3}``, ``enc_norm``,
    ``final_norm``, ``unembed``."""

    def __init__(self, embed, encoder: list[dict], decoder: list[dict], enc_norm, final_norm,
                 unembed):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.encoder = nn.ModuleList([param_dict(p) for p in encoder])
        self.decoder = nn.ModuleList([param_dict(p) for p in decoder])
        self.enc_norm = nn.Parameter(enc_norm)
        self.final_norm = nn.Parameter(final_norm)
        self.unembed = nn.Parameter(unembed)


def _cross_attention_init(generator, cfg: ModelConfig, device=None) -> dict:
    return L.attention_init(generator, cfg, device)


def _cross_attention_apply(params, cfg: ModelConfig, x, enc_kv, positions):
    """q from the decoder's x; k/v precomputed from the encoder states (on a
    mesh this rank's heads of them, ``cross_kv``)."""
    dt = x.dtype
    mesh, tp = S.param_mesh(params["wq"]), S.model_sharded(params["wq"])
    part = ("model",) if tp else ()
    if tp:
        x = S.sum_grad(x, mesh)
    q = torch.einsum("bsd,dhk->bshk", x, S.local_param(params["wq"]).to(dt))
    if cfg.qk_norm:
        q = L.rmsnorm(q, S.local_param(params["q_norm"], part))
    out = L.attention_core(q, enc_kv["k"], enc_kv["v"], causal=False, chunk=cfg.attn_chunk)
    y = torch.einsum("bshk,hkd->bsd", out, S.local_param(params["wo"]).to(dt))
    return S.reduce_over(y, mesh, ("model",)) if tp else y


def cross_kv(params, cfg: ModelConfig, enc: torch.Tensor) -> dict:
    """The cross k/v of the encoder states: where the heads split over
    ``model``, this rank's KV heads (or the groups its query heads read)."""
    dt = enc.dtype
    mesh, tp = S.param_mesh(params["wq"]), S.model_sharded(params["wq"])
    part = ("model",) if tp else ()
    if tp:
        enc = S.sum_grad(enc, mesh)
    k = torch.einsum("bsd,dhk->bshk", enc, S.local_param(params["wk"], part).to(dt))
    v = torch.einsum("bsd,dhk->bshk", enc, S.local_param(params["wv"], part).to(dt))
    if tp and not S.model_sharded(params["wk"]):
        k, v = L._local_kv_heads(k, v, params["wq"].to_local().shape[1], cfg, mesh)
    return {"k": k, "v": v}


def _enc_layer_init(generator, cfg: ModelConfig, dev) -> dict:
    d = cfg.d_model
    return {"attn": L.attention_init(generator, cfg, dev),
            "mlp": L.mlp_init(generator, cfg.scaled(sparse_mlp=False), device=dev),
            "norm1": torch.ones(d, device=dev), "norm2": torch.ones(d, device=dev)}


def _dec_layer_init(generator, cfg: ModelConfig, dev) -> dict:
    d = cfg.d_model
    return {"self": L.attention_init(generator, cfg, dev),
            "cross": _cross_attention_init(generator, cfg, dev),
            "mlp": L.mlp_init(generator, cfg.scaled(sparse_mlp=False), device=dev),
            "norm1": torch.ones(d, device=dev), "norm2": torch.ones(d, device=dev),
            "norm3": torch.ones(d, device=dev)}


def encdec_axes(cfg: ModelConfig) -> dict:
    mcfg = cfg.scaled(sparse_mlp=False)
    enc_axes = {"attn": L.attention_axes(cfg), "mlp": L.mlp_axes(mcfg),
                "norm1": ("embed",), "norm2": ("embed",)}
    dec_axes = {"self": L.attention_axes(cfg), "cross": L.attention_axes(cfg),
                "mlp": L.mlp_axes(mcfg),
                "norm1": ("embed",), "norm2": ("embed",), "norm3": ("embed",)}
    return {
        "embed": ("vocab", "w_embed"),
        "encoder": _prepend_layers_axis(enc_axes),
        "decoder": _prepend_layers_axis(dec_axes),
        "enc_norm": ("embed",), "final_norm": ("embed",),
        "unembed": ("w_embed", "vocab"),
    }


def encdec_init(generator: torch.Generator, cfg: ModelConfig, specs=None,
                device=None) -> EncDecLM:
    """Random float32 weights from ``generator``, on ``device`` (default CUDA)."""
    del specs
    dev = resolve_device(device)
    d = cfg.d_model
    embed = L.embed_init(generator, cfg.padded_vocab, d, device=dev)
    enc = [_enc_layer_init(generator, cfg, dev) for _ in range(cfg.encoder_layers)]
    dec = [_dec_layer_init(generator, cfg, dev) for _ in range(cfg.num_layers)]
    unembed = L._normal(generator, (d, cfg.padded_vocab), d**-0.5, dev)
    return EncDecLM(embed, enc, dec, torch.ones(d, device=dev), torch.ones(d, device=dev),
                    unembed)


def encode(params: EncDecLM, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, T, d) -> encoder states (B, T, d); on a mesh this rank's rows."""
    mesh = S.param_mesh(params.embed)
    h = S.local_batch(frames, mesh).to(cfg.activation_dtype)
    if mesh is not None:
        h = S.as_dtensor(h, mesh, "batch", "frames", "embed").to_local()
    positions = torch.arange(h.shape[1], device=h.device)
    mcfg = cfg.scaled(sparse_mlp=False)

    def body(lp, h):
        attn, _ = L.attention_apply(dict(lp["attn"].items()), cfg,
                                    L.rmsnorm(h, S.local_param(lp["norm1"])),
                                    positions=positions, causal=False)
        h = h + attn
        return h + L.mlp_apply(dict(lp["mlp"].items()), mcfg,
                               L.rmsnorm(h, S.local_param(lp["norm2"])))

    body = remat_block(body, cfg)
    for lp in params.encoder:
        h = body(lp, h)
    return L.rmsnorm(h, S.local_param(params.enc_norm))


def forward(params: EncDecLM, cfg: ModelConfig, tokens, *, specs=None,
            frames: torch.Tensor | None = None, patch_embeds=None,
            last_only: bool = False) -> LMOutputs:
    del patch_embeds, specs
    mesh = S.param_mesh(params.embed)
    enc = encode(params, cfg, frames)
    h = embed_tokens(params.embed, S.local_batch(tokens, mesh), cfg)
    if mesh is not None:
        h = S.as_dtensor(h, mesh, "batch", "seq", "embed").to_local()
    positions = torch.arange(h.shape[1], device=h.device)
    mcfg = cfg.scaled(sparse_mlp=False)

    def body(lp, h):
        attn, _ = L.attention_apply(dict(lp["self"].items()), cfg,
                                    L.rmsnorm(h, S.local_param(lp["norm1"])),
                                    positions=positions, causal=True)
        h = h + attn
        kv = cross_kv(lp["cross"], cfg, enc)
        h = h + _cross_attention_apply(lp["cross"], cfg,
                                       L.rmsnorm(h, S.local_param(lp["norm2"])), kv, positions)
        return h + L.mlp_apply(dict(lp["mlp"].items()), mcfg,
                               L.rmsnorm(h, S.local_param(lp["norm3"])))

    body = remat_block(body, cfg)
    for lp in params.decoder:
        h = body(lp, h)
    h = L.rmsnorm(h, S.local_param(params.final_norm))
    if last_only:
        h = h[:, -1:, :]
    logits = unembed(params.unembed, cfg, h)
    return LMOutputs(logits=mesh_logits(logits, params.unembed, "seq"),
                     aux_loss=torch.zeros((), device=h.device))


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """The decoder's self-attention caches and zero cross k/v (the encoder's
    are written in by ``precompute_cross``, or left zero as the reference's
    engine serves them)."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, cfg.num_frames, cfg.num_kv_heads, cfg.resolved_head_dim)
    dt = cfg.activation_dtype
    return {"self": L.decode_cache_init(cfg, batch, max_len, cfg.num_layers, device=dev),
            "cross": {"k": torch.zeros(shape, dtype=dt, device=dev),
                      "v": torch.zeros(shape, dtype=dt, device=dev)}}


def decode_state_axes(cfg: ModelConfig) -> dict:
    return {
        "self": L.CACHE_AXES,
        "cross": {"k": (None, "batch", "frames", "kv", None),
                  "v": (None, "batch", "frames", "kv", None)},
    }


@torch.no_grad()
def precompute_cross(params: EncDecLM, cfg: ModelConfig, frames: torch.Tensor) -> dict:
    """Run the encoder once and stack every decoder layer's cross k/v
    (L, B, T, Hkv, dh) for decoding; on a mesh as ``DTensor``s of this rank's
    rows and heads (``decode_state_axes``' ``cross``)."""
    enc = encode(params, cfg, frames)
    kvs = [cross_kv(lp["cross"], cfg, enc) for lp in params.decoder]
    out = {"k": torch.stack([kv["k"] for kv in kvs]), "v": torch.stack([kv["v"] for kv in kvs])}
    mesh = S.param_mesh(params.embed)
    if mesh is None:
        return out
    return {k: S.as_dtensor(v, mesh, *decode_state_axes(cfg)["cross"][k])
            for k, v in out.items()}


@torch.no_grad()
def decode_step(params: EncDecLM, cfg: ModelConfig, state: dict, tokens, pos, *,
                specs=None) -> tuple[torch.Tensor, dict]:
    """One token for every sequence. ``state`` is not written: the self-attention
    caches are copied once and this step's k/v written into the copy; the
    returned state holds the same cross k/v. On a mesh the state and the
    logits are ``DTensor``s, as in ``transformer.decode_step``."""
    mesh = S.param_mesh(params.embed)
    seq = None
    if mesh is not None:
        tokens, pos = S.local_batch(tokens, mesh), S.local_batch(pos, mesh)
        seq = seq_mesh(state["self"]["k"])
        whole, state = state, S.local_tree(state)
    h = embed_tokens(params.embed, tokens, cfg)
    positions = pos[:, None]
    mcfg = cfg.scaled(sparse_mlp=False)
    ck, cv = state["self"]["k"].clone(), state["self"]["v"].clone()
    xk, xv = state["cross"]["k"], state["cross"]["v"]
    for i, lp in enumerate(params.decoder):
        attn, _ = L.attention_apply(dict(lp["self"].items()), cfg,
                                    L.rmsnorm(h, S.local_param(lp["norm1"])),
                                    positions=positions, causal=True,
                                    cache={"k": ck[i], "v": cv[i], "pos": pos, "seq_mesh": seq})
        h = h + attn
        h = h + _cross_attention_apply(lp["cross"], cfg,
                                       L.rmsnorm(h, S.local_param(lp["norm2"])),
                                       {"k": xk[i], "v": xv[i]}, positions)
        h = h + L.mlp_apply(dict(lp["mlp"].items()), mcfg,
                            L.rmsnorm(h, S.local_param(lp["norm3"])))
    new_state = {"self": {"k": ck, "v": cv, "pos": state["self"]["pos"] + 1},
                 "cross": state["cross"]}
    h = L.rmsnorm(h, S.local_param(params.final_norm))
    logits = mesh_logits(unembed(params.unembed, cfg, h)[:, 0, :], params.unembed)
    return logits, (new_state if mesh is None else S.tree_like(new_state, whole))
