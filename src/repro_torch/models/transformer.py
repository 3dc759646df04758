"""Decoder-only LM of the dense and VLM families: init, forward, loss, decode.

The port of ``repro.models.transformer`` (``src/repro/models/transformer.py``)
for ``family in {"dense", "vlm"}``. The reference stacks every layer's
parameters on a leading axis and scans over them; here each decoder layer
is an ``nn.Module`` (``DecoderLayer``) in an ``nn.ModuleList``, driven by a
Python loop, each layer under the remat policy ``cfg.remat`` when autograd
records. The MoE, SSM, hybrid and encoder-decoder families are not ported
yet and raise ``errors.InvalidArgError``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch import errors
from repro_torch.configs.base import ModelConfig
from repro_torch.core.streams import resolve_device

from . import layers as L

PORTED_FAMILIES = ("dense", "vlm")


class LMOutputs(NamedTuple):
    logits: torch.Tensor
    aux_loss: torch.Tensor


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise errors.InvalidArgError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to repro_torch yet; "
            f"ported: {', '.join(PORTED_FAMILIES)}")


class DecoderLayer(nn.Module):
    """Pre-norm residual layer: attention, then the dense or CB-sparse SwiGLU.

    Built from ``layers.attention_init`` / ``layers.mlp_init``'s dicts (a
    sparse projection is ``{"tiles": t}``); the tensors become parameters.
    """

    def __init__(self, attn: dict, ffn: dict, norm1: torch.Tensor, norm2: torch.Tensor):
        super().__init__()
        self.attn = nn.ParameterDict({k: nn.Parameter(v) for k, v in attn.items()})
        self.sparse = isinstance(next(iter(ffn.values())), dict)
        self.ffn = nn.ParameterDict({k: nn.Parameter(v["tiles"] if self.sparse else v)
                                     for k, v in ffn.items()})
        self.norm1 = nn.Parameter(norm1)
        self.norm2 = nn.Parameter(norm2)

    def ffn_params(self) -> dict:
        """The MLP's weights in ``layers.mlp_apply``'s layout."""
        if self.sparse:
            return {k: {"tiles": v} for k, v in self.ffn.items()}
        return dict(self.ffn.items())

    def forward(self, cfg: ModelConfig, h: torch.Tensor, positions: torch.Tensor, *,
                specs=None, cache: dict | None = None, impl: str = "cuda"):
        """Returns (h, new_cache); ``cache`` as in ``layers.attention_apply``."""
        attn_out, new_cache = L.attention_apply(
            dict(self.attn.items()), cfg, L.rmsnorm(h, self.norm1), positions=positions,
            causal=True, cache=cache, window=cfg.swa_window)
        h = h + attn_out
        hn = L.rmsnorm(h, self.norm2)
        return h + L.mlp_apply(self.ffn_params(), cfg, hn, specs=specs, impl=impl), new_cache


class LM(nn.Module):
    """The whole model's parameters: embedding, decoder layers, final norm
    and (unless tied) the unembedding, float32 as in the reference."""

    def __init__(self, embed: torch.Tensor, layers: list[DecoderLayer],
                 final_norm: torch.Tensor, unembed: torch.Tensor | None = None):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = nn.Parameter(final_norm)
        self.unembed = None if unembed is None else nn.Parameter(unembed)

    def unembedding(self, cfg: ModelConfig) -> torch.Tensor:
        """(d, Vpad) in the activation dtype."""
        w = self.embed.T if cfg.tie_embeddings else self.unembed
        return w.to(cfg.activation_dtype)

    def embed_tokens(self, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        # the rows the reference gathers from its cast table: the cast commutes.
        # F.embedding, not self.embed[tokens]: the backward of an index is
        # index_put_(accumulate=True), which may add a repeated token's rows in
        # another order on every CUDA run; embedding's backward sums them in a
        # fixed order, so two training runs stay bit-equal.
        return F.embedding(tokens.long(), self.embed).to(cfg.activation_dtype)


def _prepend_layers_axis(axes):
    if isinstance(axes, dict):
        return {k: _prepend_layers_axis(v) for k, v in axes.items()}
    return ("w_layers",) + axes


def _layer_axes(cfg: ModelConfig) -> dict:
    return {
        "attn": L.attention_axes(cfg),
        "ffn": L.mlp_axes(cfg),
        "norm1": ("embed",),
        "norm2": ("embed",),
    }


def lm_axes(cfg: ModelConfig) -> dict:
    """The logical-axis tree of the parameters, in the reference's layout
    (``models.model.param_tree``: every ``layers`` leaf stacked on a leading
    ``w_layers`` axis)."""
    check_family(cfg)
    axes = {
        "embed": ("vocab", "w_embed"),
        "layers": _prepend_layers_axis(_layer_axes(cfg)),
        "final_norm": ("embed",),
    }
    if not cfg.tie_embeddings:
        axes["unembed"] = ("w_embed", "vocab")
    return axes


def lm_init(generator: torch.Generator, cfg: ModelConfig, specs=None, device=None) -> LM:
    """Random weights from ``generator`` (drawn on its device), on ``device``
    (default CUDA)."""
    check_family(cfg)
    dev = resolve_device(device)
    d = cfg.d_model
    embed = L.embed_init(generator, cfg.padded_vocab, d, device=dev)
    layers = [DecoderLayer(L.attention_init(generator, cfg, dev),
                           L.mlp_init(generator, cfg, specs=specs, device=dev),
                           torch.ones(d, device=dev), torch.ones(d, device=dev))
              for _ in range(cfg.num_layers)]
    unembed = None
    if not cfg.tie_embeddings:
        unembed = L._normal(generator, (d, cfg.padded_vocab), d**-0.5, dev)
    return LM(embed, layers, torch.ones(d, device=dev), unembed)


# "dots" saves the outputs of matrix products without batch dimensions, the
# counterpart of jax.checkpoint_policies.dots_with_no_batch_dims_saveable:
# aten.mm / aten.addmm, and aten.bmm with a batch of one, which is how
# torch.einsum writes a contraction without batch dimensions (the attention
# projections). Batched products (attention's QK and PV, the sparse MLP's
# per-tile products) and everything else are recomputed, and so are the CUDA
# kernels, which run outside aten.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS or (op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat``: "none" saves every activation, "full"
    recomputes the whole layer in the backward, "dots" keeps the products'
    outputs (``_dots_policy``). Remat changes no number."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                             _dots_policy)
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, **kw)


def forward(
    params: LM,
    cfg: ModelConfig,
    tokens: torch.Tensor,               # (B, S)
    *,
    specs=None,
    patch_embeds: torch.Tensor | None = None,
    last_only: bool = False,            # prefill: only final-position logits
    impl: str = "cuda",
) -> LMOutputs:
    """Full-sequence forward -> logits (B, S_text, Vpad) (or (B, 1, Vpad))."""
    check_family(cfg)
    dt = cfg.activation_dtype
    h = params.embed_tokens(tokens, cfg)
    n_prefix = 0
    if patch_embeds is not None:
        h = torch.cat([patch_embeds.to(dt), h], dim=1)
        n_prefix = patch_embeds.shape[1]
    positions = torch.arange(h.shape[1], device=h.device)

    def body(layer, h):
        return layer(cfg, h, positions, specs=specs, impl=impl)[0]

    if torch.is_grad_enabled():
        body = _remat(body, cfg)
    for layer in params.layers:
        h = body(layer, h)
    h = L.rmsnorm(h, params.final_norm)
    if n_prefix:
        h = h[:, n_prefix:, :]
    if last_only:
        h = h[:, -1:, :]
    logits = L.mask_pad_logits(h @ params.unembedding(cfg), cfg)
    return LMOutputs(logits=logits, aux_loss=torch.zeros((), device=h.device))


def lm_loss(
    params: LM,
    cfg: ModelConfig,
    batch: dict,
    *,
    specs=None,
    aux_weight: float = 0.01,
    z_weight: float = 1e-4,
    impl: str = "cuda",
) -> tuple[torch.Tensor, dict]:
    """``xent + aux_weight * aux + z_weight * mean(logz^2)`` over ``batch``'s
    ``tokens`` / ``targets`` (and ``patch_embeds`` for the VLM family), the
    logits in float32 and ``logz`` their logsumexp over the padded vocabulary.
    Returns ``(loss, {"xent", "aux", "zloss"})``.

    The reference sums ``logits * one_hot(targets)``; here the target logit
    is gathered. The one-hot form adds exact zeros to it, so the two are
    bit-equal, and the gather spares a (B, S, Vpad) float32 tensor (400 MB
    at cb-paper's training shape).
    """
    out = forward(params, cfg, batch["tokens"], specs=specs,
                  patch_embeds=batch.get("patch_embeds"), impl=impl)
    logits = out.logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, batch["targets"].long()[..., None])[..., 0]
    xent = -torch.mean(tgt - logz)
    zloss = torch.mean(torch.square(logz))
    loss = xent + aux_weight * out.aux_loss + z_weight * zloss
    return loss, {"xent": xent, "aux": out.aux_loss, "zloss": zloss}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    check_family(cfg)
    return L.decode_cache_init(cfg, batch, max_len, cfg.num_layers, device=device)


def decode_state_axes(cfg: ModelConfig) -> dict:
    check_family(cfg)
    return L.CACHE_AXES


@torch.no_grad()
def decode_step(
    params: LM,
    cfg: ModelConfig,
    state: dict,
    tokens: torch.Tensor,     # (B, 1)
    pos: torch.Tensor,        # (B,) int32
    *,
    specs=None,
    impl: str = "cuda",
) -> tuple[torch.Tensor, dict]:
    """One token for every sequence in the batch. Returns (logits, state).

    ``state`` is not written: the step copies its caches once and writes
    this step's k/v into the copy, which the returned state holds.
    """
    check_family(cfg)
    h = params.embed_tokens(tokens, cfg)        # (B, 1, d)
    positions = pos[:, None]                    # (B, 1) absolute
    ck, cv = state["k"].clone(), state["v"].clone()
    for i, layer in enumerate(params.layers):
        h, _ = layer(cfg, h, positions, specs=specs, impl=impl,
                     cache={"k": ck[i], "v": cv[i], "pos": pos})
    h = L.rmsnorm(h, params.final_norm)
    logits = L.mask_pad_logits((h @ params.unembedding(cfg))[:, 0, :], cfg)
    return logits, {"k": ck, "v": cv, "pos": state["pos"] + 1}
