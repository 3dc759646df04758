"""Decoder-only LM of the dense, MoE, SSM and VLM families: init, forward,
loss, decode.

The port of ``repro.models.transformer`` (``src/repro/models/transformer.py``).
The reference stacks every layer's parameters on a leading axis and scans
over them; here each scan step is an ``nn.Module`` in an ``nn.ModuleList``,
driven by a Python loop, each under the remat policy ``cfg.remat`` when
autograd records:

* dense / VLM / MoE: a ``DecoderLayer`` (attention, then the dense or
  CB-sparse SwiGLU, or ``moe.moe_apply``);
* SSM (mamba2): a ``ParameterDict`` ``{"mixer": ..., "norm1": ...}``;
* MoE interleaved every k layers (llama4): a ``ModuleDict`` group of k-1
  dense ``DecoderLayer``s and one MoE ``DecoderLayer``, the reference's
  ``_group_body``.

The hybrid (zamba2) and encoder-decoder (whisper) families wrap these
layers in ``hybrid.py`` / ``encdec.py``.

**On a mesh** (``Model(cfg, mesh=)``: ``DTensor`` parameters) ``forward`` and
``lm_loss`` take the batch as ``DTensor``s split over ``batch`` (or whole on
every rank) and compute on this rank's rows, at the reference's constrain
points (``src/repro/models/transformer.py:216, 247``): the embedding reads
its ``vocab``-split table vocab-parallel (each ``model`` rank looks up the
ids it holds, the rows added over ``model``), the unembedding and the
float32 cross-entropy are vocab-parallel (the log-sum-exp and the target
logit added over ``model``), and the means are over the global batch. Every
family runs there (the SSM mixer in ``ssm.py``, the hybrid and
encoder-decoder wrappers in ``hybrid.py`` / ``encdec.py``). ``decode_step``
on a mesh takes the decode state as ``DTensor``s laid out by
``decode_state_axes`` under the decode rules (``launch.mesh.rules_for``: the
batch over ``data`` where it divides, the KV cache's sequence over
``model``, heads replicated), as the reference's dry run lowers it
(``src/repro/launch/dryrun.py:229-252``); its logits stay split over
``vocab``.
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
from . import moe as moe_mod
from . import sharding as S
from . import ssm as ssm_mod

PORTED_FAMILIES = ("dense", "moe", "ssm", "vlm", "hybrid", "encdec")


class LMOutputs(NamedTuple):
    logits: torch.Tensor
    aux_loss: torch.Tensor


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise errors.InvalidArgError(
            f"unknown family {cfg.family!r} ({cfg.name}); known: {', '.join(PORTED_FAMILIES)}")


def param_dict(tree: dict) -> nn.ParameterDict:
    """A nested dict of tensors as nested ``ParameterDict``s: ``params["a"]["b"]``
    reads as in the reference's functional layers, and the parameters are
    named by their paths (``a.b``)."""
    return nn.ParameterDict({k: param_dict(v) if isinstance(v, dict) else nn.Parameter(v)
                             for k, v in tree.items()})


class DecoderLayer(nn.Module):
    """Pre-norm residual layer: attention, then the dense or CB-sparse SwiGLU,
    or the MoE FFN (``ffn`` holds a ``router``).

    Built from ``layers.attention_init`` and ``layers.mlp_init``'s or
    ``moe.moe_init``'s dicts (a sparse projection is ``{"tiles": t}``); the
    tensors become parameters.
    """

    def __init__(self, attn: dict, ffn: dict, norm1: torch.Tensor, norm2: torch.Tensor,
                 first_expert: int = 0):
        super().__init__()
        self.attn = param_dict(attn)
        self.moe = "router" in ffn
        self.first_expert = first_expert        # the MoE layer's experts held: from here on
        self.sparse = all(isinstance(v, dict) and set(v) == {"tiles"} for v in ffn.values())
        self.ffn = param_dict({k: v["tiles"] for k, v in ffn.items()} if self.sparse else ffn)
        self.norm1 = nn.Parameter(norm1)
        self.norm2 = nn.Parameter(norm2)

    def ffn_params(self) -> dict:
        """The MLP's weights in ``layers.mlp_apply``'s layout."""
        if self.sparse:
            return {k: {"tiles": v} for k, v in self.ffn.items()}
        return dict(self.ffn.items())

    def forward(self, cfg: ModelConfig, h: torch.Tensor, positions: torch.Tensor, *,
                specs=None, cache: dict | None = None, impl: str = "cuda"):
        """Returns (h, aux, new_cache); ``cache`` as in ``layers.attention_apply``,
        ``aux`` the MoE layer's load-balancing loss (0 for a dense layer)."""
        attn_out, new_cache = L.attention_apply(
            dict(self.attn.items()), cfg, L.rmsnorm(h, S.local_param(self.norm1)),
            positions=positions,
            causal=True, cache=cache, window=cfg.swa_window)
        h = h + attn_out
        hn = L.rmsnorm(h, S.local_param(self.norm2))
        if self.moe:
            ffn_out, aux = moe_mod.moe_apply(self.ffn, cfg, hn, self.first_expert)
        else:
            ffn_out = L.mlp_apply(self.ffn_params(), cfg, hn, specs=specs, impl=impl)
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return h + ffn_out, aux, new_cache


class LM(nn.Module):
    """The whole model's parameters: embedding, the scan steps' layers
    (``DecoderLayer``s, SSM ``ParameterDict``s or MoE groups), final norm and
    (unless tied) the unembedding, float32 as in the reference."""

    def __init__(self, embed: torch.Tensor, layers: list[nn.Module],
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
        return embed_tokens(self.embed, tokens, cfg)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The rows the reference gathers from its cast table: the cast commutes.

    F.embedding, not embed[tokens]: the backward of an index is
    index_put_(accumulate=True), which may add a repeated token's rows in
    another order on every CUDA run; embedding's backward sums them in a
    fixed order, so two training runs stay bit-equal.

    A table split over ``model`` by vocab is read vocab-parallel: each rank
    looks up the ids in its range (zeros elsewhere) and the rows are added
    over ``model``, exactly, in float32 before the cast."""
    w = S.local_param(embed)
    if not S.model_sharded(embed):
        return F.embedding(tokens.long(), w).to(cfg.activation_dtype)
    ids, inside = _vocab_ids(tokens, embed.device_mesh, w.shape[0])
    rows = F.embedding(ids, w) * inside[..., None]
    return S.reduce_over(rows, embed.device_mesh, ("model",)).to(cfg.activation_dtype)


def _vocab_ids(ids: torch.Tensor, mesh, v_local: int):
    """Ids shifted into this ``model`` rank's vocab range (clamped), and
    whether each lies in it."""
    local = ids.long() - S.axis_rank(mesh, "model") * v_local
    inside = (local >= 0) & (local < v_local)
    return local.clamp(0, v_local - 1), inside


def _prepend_layers_axis(axes):
    if isinstance(axes, dict):
        return {k: _prepend_layers_axis(v) for k, v in axes.items()}
    return ("w_layers",) + axes


def _moe_group_size(cfg: ModelConfig) -> int | None:
    """k when MoE layers are interleaved every k layers (llama4), else None."""
    if cfg.family == "moe" and cfg.moe_every > 1:
        assert cfg.num_layers % cfg.moe_every == 0
        return cfg.moe_every
    return None


def _layer_axes(cfg: ModelConfig) -> dict:
    if cfg.family == "ssm":
        return {"mixer": ssm_mod.ssm_axes(cfg), "norm1": ("embed",)}
    if _moe_group_size(cfg) is not None:
        return {
            "dense": _prepend_layers_axis(_layer_axes(cfg.scaled(family="dense"))),
            "moe": _layer_axes(cfg.scaled(moe_every=1)),
        }
    return {
        "attn": L.attention_axes(cfg),
        "ffn": moe_mod.moe_axes(cfg) if cfg.family == "moe" else L.mlp_axes(cfg),
        "norm1": ("embed",),
        "norm2": ("embed",),
    }


def lm_axes(cfg: ModelConfig) -> dict:
    """The logical-axis tree of the parameters, in the reference's layout
    (``models.model.param_tree``: every ``layers`` leaf stacked on a leading
    ``w_layers`` axis, a llama4 group's dense layers on a second one)."""
    check_family(cfg)
    axes = {
        "embed": ("vocab", "w_embed"),
        "layers": _prepend_layers_axis(_layer_axes(cfg)),
        "final_norm": ("embed",),
    }
    if not cfg.tie_embeddings:
        axes["unembed"] = ("w_embed", "vocab")
    return axes


def _num_scan_steps(cfg: ModelConfig) -> int:
    k = _moe_group_size(cfg)
    return cfg.num_layers // k if k is not None else cfg.num_layers


def _layer_init(generator: torch.Generator, cfg: ModelConfig, specs, dev,
                expert_shard=None) -> nn.Module:
    """One scan step's parameters: a decoder layer, an SSM layer or an MoE group
    (an MoE layer holding shard ``expert_shard`` of its experts)."""
    d = cfg.d_model
    if cfg.family == "ssm":
        return param_dict({"mixer": ssm_mod.ssm_init(generator, cfg, dev),
                           "norm1": torch.ones(d, device=dev)})
    k = _moe_group_size(cfg)
    if k is not None:
        dense_cfg = cfg.scaled(family="dense")
        return nn.ModuleDict({
            "dense": nn.ModuleList([_layer_init(generator, dense_cfg, specs, dev)
                                    for _ in range(k - 1)]),
            "moe": _layer_init(generator, cfg.scaled(moe_every=1), specs, dev, expert_shard)})
    moe = cfg.family == "moe"
    ffn = (moe_mod.moe_init(generator, cfg, dev, expert_shard) if moe
           else L.mlp_init(generator, cfg, specs=specs, device=dev))
    first = moe_mod.expert_range(cfg, expert_shard)[0] if moe else 0
    return DecoderLayer(L.attention_init(generator, cfg, dev), ffn,
                        torch.ones(d, device=dev), torch.ones(d, device=dev), first)


def lm_init(generator: torch.Generator, cfg: ModelConfig, specs=None, device=None,
            expert_shard: tuple[int, int] | None = None) -> LM:
    """Random weights from ``generator`` (drawn on its device), on ``device``
    (default CUDA); each MoE layer holds shard ``expert_shard = (i, n)`` of its
    experts (``moe.moe_init``), all of them by default."""
    check_family(cfg)
    dev = resolve_device(device)
    d = cfg.d_model
    embed = L.embed_init(generator, cfg.padded_vocab, d, device=dev)
    layers = [_layer_init(generator, cfg, specs, dev, expert_shard)
              for _ in range(_num_scan_steps(cfg))]
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


def remat_block(fn, cfg: ModelConfig):
    """The hybrid and encoder-decoder blocks' remat, the reference's plain
    ``jax.checkpoint`` under any ``cfg.remat`` but "none": the whole block
    recomputed in the backward, when autograd records."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)


def _group_body(group: nn.ModuleDict, cfg: ModelConfig, h: torch.Tensor,
                positions: torch.Tensor, *, specs=None, caches: list | None = None,
                impl: str = "cuda"):
    """One MoE layer group: k-1 dense layers, then one MoE layer. ``caches``:
    the k layers' ``attention_apply`` caches, in order, for decode.
    Returns (h, aux)."""
    dense_cfg = cfg.scaled(family="dense")
    layers = [(lyr, dense_cfg) for lyr in group["dense"]] + \
        [(group["moe"], cfg.scaled(moe_every=1))]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for j, (lyr, lcfg) in enumerate(layers):
        h, aux_j, _ = lyr(lcfg, h, positions, specs=specs, impl=impl,
                          cache=None if caches is None else caches[j])
        aux = aux + aux_j
    return h, aux


def _layer_body(layer: nn.Module, cfg: ModelConfig, h: torch.Tensor, positions: torch.Tensor,
                *, specs=None, impl: str = "cuda"):
    """One scan step of the full-sequence forward. Returns (h, aux)."""
    if cfg.family == "ssm":
        mix, _ = ssm_mod.ssm_apply(layer["mixer"], cfg,
                                   L.rmsnorm(h, S.local_param(layer["norm1"])))
        return h + mix, torch.zeros((), dtype=torch.float32, device=h.device)
    if _moe_group_size(cfg) is not None:
        return _group_body(layer, cfg, h, positions, specs=specs, impl=impl)
    h, aux, _ = layer(cfg, h, positions, specs=specs, impl=impl)
    return h, aux


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
    """Full-sequence forward -> logits (B, S_text, Vpad) (or (B, 1, Vpad)) and
    the MoE layers' aux loss over ``cfg.num_layers``."""
    check_family(cfg)
    dt = cfg.activation_dtype
    mesh = S.param_mesh(params.embed)
    h = params.embed_tokens(S.local_batch(tokens, mesh), cfg)
    n_prefix = 0
    if patch_embeds is not None:
        h = torch.cat([S.local_batch(patch_embeds, mesh).to(dt), h], dim=1)
        n_prefix = patch_embeds.shape[1]
    if mesh is not None:
        h = S.as_dtensor(h, mesh, "batch", "seq", "embed").to_local()
    positions = torch.arange(h.shape[1], device=h.device)

    def body(layer, h):
        return _layer_body(layer, cfg, h, positions, specs=specs, impl=impl)

    if torch.is_grad_enabled():
        body = _remat(body, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for layer in params.layers:
        h, aux_i = body(layer, h)
        aux = aux + aux_i
    h = L.rmsnorm(h, S.local_param(params.final_norm))
    if n_prefix:
        h = h[:, n_prefix:, :]
    if last_only:
        h = h[:, -1:, :]
    logits = _unembed(params, cfg, h)
    return LMOutputs(logits=mesh_logits(logits, _unembed_weight(params, cfg), "seq"),
                     aux_loss=aux / cfg.num_layers)


def mesh_logits(logits: torch.Tensor, w, *dims: str):
    """A rank's logits (batch, ``dims``, vocab) as the ``DTensor`` the
    reference constrains them to (``"batch", ..., "vocab"``: split over
    ``vocab`` where the unembedding ``w`` is); ``logits`` itself off a mesh."""
    mesh = S.param_mesh(w)
    if mesh is None:
        return logits
    return S.as_dtensor(logits, mesh, "batch", *dims, "vocab" if S.model_sharded(w) else None)


def _unembed_weight(params: LM, cfg: ModelConfig):
    return params.embed if cfg.tie_embeddings else params.unembed


def _unembed(params: LM, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    return unembed(_unembed_weight(params, cfg), cfg, h, tied=cfg.tie_embeddings)


def unembed(w, cfg: ModelConfig, h: torch.Tensor, tied: bool = False) -> torch.Tensor:
    """The padded-vocab logits of ``h`` by the unembedding ``w`` (d, Vpad), or
    the embedding (Vpad, d) when ``tied``, in the activation dtype: this
    rank's vocab columns where the weight is split over ``model`` (h's
    gradient summed over it), all of them otherwise."""
    wl = S.local_param(w)
    wl = wl.T if tied else wl
    if not S.model_sharded(w):
        return L.mask_pad_logits(h @ wl.to(cfg.activation_dtype), cfg)
    mesh = w.device_mesh
    logits = S.sum_grad(h, mesh) @ wl.to(cfg.activation_dtype)
    return L.mask_pad_logits(logits, cfg, offset=S.axis_rank(mesh, "model") * wl.shape[1])


def mesh_xent(logits, targets, w) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean cross-entropy, logz) of a mesh's ``DTensor`` logits over the global
    batch: vocab-parallel where the unembedding ``w`` is split over ``model``."""
    mesh = logits.device_mesh
    ll, logz = token_terms(logits.to_local(), S.local_batch(targets, mesh),
                           mesh if S.model_sharded(w) else None)
    return -S.global_mean(ll, mesh), logz


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor):
    """(mean cross-entropy, logz) of ``logits`` taken to float32, ``logz``
    their logsumexp over the padded vocabulary.

    The reference sums ``logits * one_hot(targets)``; here the target logit
    is gathered. The one-hot form adds exact zeros to it, so the two are
    bit-equal, and the gather spares a (B, S, Vpad) float32 tensor (400 MB
    at cb-paper's training shape)."""
    ll, logz = token_terms(logits, targets)
    return -torch.mean(ll), logz


def token_terms(logits: torch.Tensor, targets: torch.Tensor, mesh=None):
    """(target log-likelihood, logz) per token, in float32. With ``mesh``
    the logits are this ``model`` rank's columns of the padded vocabulary:
    the log-sum-exp (about the max over every rank) and the target logit are
    added over ``model``."""
    logits = logits.to(torch.float32)
    if mesh is None:
        logz = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
        return tgt - logz, logz
    with torch.no_grad():
        m = S.all_reduce(logits.amax(dim=-1), mesh, "model", op=torch.distributed.ReduceOp.MAX)
    se = S.reduce_over((logits - m[..., None]).exp().sum(dim=-1), mesh, ("model",))
    logz = se.log() + m
    ids, inside = _vocab_ids(targets, mesh, logits.shape[-1])
    tgt = torch.gather(logits, -1, ids[..., None])[..., 0] * inside
    return S.reduce_over(tgt, mesh, ("model",)) - logz, logz


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
    Returns ``(loss, {"xent", "aux", "zloss"})``; the cross-entropy is
    ``cross_entropy``'s. On a mesh the means are over the global batch and
    every rank returns the same loss.
    """
    out = forward(params, cfg, batch["tokens"], specs=specs,
                  patch_embeds=batch.get("patch_embeds"), impl=impl)
    mesh = S.param_mesh(params.embed)
    if mesh is None:
        xent, logz = cross_entropy(out.logits, batch["targets"])
        zloss = torch.mean(torch.square(logz))
    else:
        xent, logz = mesh_xent(out.logits, batch["targets"], _unembed_weight(params, cfg))
        zloss = S.global_mean(torch.square(logz), mesh)
    loss = xent + aux_weight * out.aux_loss + z_weight * zloss
    return loss, {"xent": xent, "aux": out.aux_loss, "zloss": zloss}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    check_family(cfg)
    if cfg.family == "ssm":
        return ssm_mod.ssm_state_init(cfg, batch, cfg.num_layers, device=device)
    return L.decode_cache_init(cfg, batch, max_len, cfg.num_layers, device=device)


def decode_state_axes(cfg: ModelConfig) -> dict:
    check_family(cfg)
    if cfg.family == "ssm":
        return ssm_mod.SSM_STATE_AXES
    return L.CACHE_AXES


def ssm_layers_decode(layers, cfg: ModelConfig, h: torch.Tensor, ssd: torch.Tensor,
                      conv: torch.Tensor):
    """``ssm_decode_step`` through consecutive SSM layers, each a residual block
    ``{"mixer", "norm1"}`` reading its slice of ``ssd`` / ``conv`` (L, B, ...).
    Returns (h, new ssd, new conv), the states stacked."""
    new_ssd, new_conv = [], []
    for i, layer in enumerate(layers):
        mix, ns = ssm_mod.ssm_decode_step(layer["mixer"], cfg,
                                          L.rmsnorm(h, S.local_param(layer["norm1"])),
                                          {"ssd": ssd[i], "conv": conv[i]})
        h = h + mix
        new_ssd.append(ns["ssd"])
        new_conv.append(ns["conv"])
    return h, torch.stack(new_ssd), torch.stack(new_conv)


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

    ``state`` is not written: the step copies its KV caches once and writes
    this step's k/v into the copy, which the returned state holds; an SSM
    step returns new state tensors. On a mesh (see the module's docstring)
    ``state`` is a tree of ``DTensor``s, ``tokens`` / ``pos`` whole or split
    over ``batch``; the logits come back split over ``vocab``, the state laid
    out as it came.
    """
    check_family(cfg)
    mesh = S.param_mesh(params.embed)
    if mesh is not None:
        tokens, pos = S.local_batch(tokens, mesh), S.local_batch(pos, mesh)
        whole, state = state, S.local_tree(state)
    h = params.embed_tokens(tokens, cfg)        # (B, 1, d)
    if cfg.family == "ssm":
        h, ssd, conv = ssm_layers_decode(params.layers, cfg, h, state["ssd"], state["conv"])
        new_state = {"ssd": ssd, "conv": conv}
    else:
        positions = pos[:, None]                # (B, 1) absolute
        ck, cv = state["k"].clone(), state["v"].clone()
        seq = None if mesh is None else seq_mesh(whole["k"])
        caches = [{"k": ck[i], "v": cv[i], "pos": pos, "seq_mesh": seq}
                  for i in range(cfg.num_layers)]
        k = _moe_group_size(cfg)
        for g, layer in enumerate(params.layers):
            if k is not None:               # caches (L, ...) regrouped as (G, k, ...)
                h, _ = _group_body(layer, cfg, h, positions, specs=specs, impl=impl,
                                   caches=caches[g * k:(g + 1) * k])
            else:
                h, _, _ = layer(cfg, h, positions, specs=specs, impl=impl, cache=caches[g])
        new_state = {"k": ck, "v": cv, "pos": state["pos"] + 1}
    if mesh is None:
        h = L.rmsnorm(h, params.final_norm)
        logits = L.mask_pad_logits((h @ params.unembedding(cfg))[:, 0, :], cfg)
        return logits, new_state
    h = L.rmsnorm(h, S.local_param(params.final_norm))
    logits = mesh_logits(_unembed(params, cfg, h)[:, 0, :], _unembed_weight(params, cfg))
    return logits, S.tree_like(new_state, whole)


def seq_mesh(cache):
    """The mesh whose ``model`` axis splits a KV cache's sequence (dim 2 of the
    stacked (L, B, S, Hkv, dh) ``DTensor``), or None."""
    return cache.device_mesh if S.split_dim(cache) == 2 else None
