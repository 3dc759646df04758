"""Shared layer library: norms, embeddings, RoPE, attention cores, MLPs.

The port of ``repro.models.layers`` (``src/repro/models/layers.py``).
Functional like the reference: ``*_init(generator, cfg, ..., device)``
draws a dict of float32 tensors, ``*_apply(params, ...)`` computes with
them; ``transformer.DecoderLayer`` holds one layer's dicts as parameters.

None of this runs a Pallas kernel in the reference: attention, RoPE and
the norms are XLA there, so plain torch ops are their port, mirrored op for
op with the reference's casts (bfloat16 operands with float32 accumulation
where it asks for ``preferred_element_type=float32``; norms and RoPE in
float32, cast back). The one kernel path is the CB-sparse MLP:
``sparse.linear.cb_linear_apply`` runs ``csrc/cb_spmm.cu`` and the combine
on the card (their plain versions on the CPU). The JAX model calls its
layer's default, the reference SpMM (``impl="reference"``,
``src/repro/sparse/linear.py``), not its Pallas kernel. The logical-axis
trees (``attention_axes``, ``mlp_axes``, ``CACHE_AXES``) are the
reference's.

**On a mesh** (``DTensor`` weights, ``sharding.shard_params``) a layer
computes on this rank's rows of the batch and its part of the weights
(``sharding.local_param``), with the collectives GSPMD places at the
reference's ``constrain`` points written out: attention and the dense MLP
are Megatron-style, q / k / v and gate / up split by columns over
``model`` (their input passes ``sharding.sum_grad``), wo and w_down by
rows, their partial sums added over ``model`` (``sharding.reduce_over``).
The CB-sparse MLP replicates its tiles, as the reference does (``mlp_axes``):
every ``model`` rank runs the same products on its batch rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import errors
from repro_torch.configs.base import ModelConfig
from repro_torch.core.streams import resolve_device
from repro_torch.sparse.linear import cb_linear_apply, cb_spec_random, cb_tiles_init

from . import sharding as S


def _normal(generator: torch.Generator | None, shape: tuple, scale: float,
            device) -> torch.Tensor:
    """float32 normals times ``scale``, drawn on the generator's device and
    placed on ``device``. On the meta device nothing is drawn (``generator``
    may be None): an empty tensor of the shape stands in, as
    ``Model.abstract_init`` needs."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=dev)
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * scale
    return w.to(dev)


# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def rmsnorm_split(x: torch.Tensor, w: torch.Tensor, mesh, width: int,
                  eps: float = 1e-6) -> torch.Tensor:
    """``rmsnorm`` of a dim split over ``mesh``'s ``model`` axis: x and w are
    this rank's parts of it, ``width`` its whole size. The sum of squares is
    added over ``model``, and so is its gradient (each rank's part of the
    output depends on it)."""
    xf = x.float()
    ss = S.reduce_over(S.sum_grad(xf.square().sum(dim=-1, keepdim=True), mesh), mesh,
                       ("model",))
    return (xf * torch.rsqrt(ss / width + eps) * w).to(x.dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, device=None) -> torch.Tensor:
    return _normal(generator, (vocab, d), 0.02, device)


def vocab_logit_mask(vocab_real: int, vocab_padded: int, device=None) -> torch.Tensor:
    """(Vpad,) additive mask: 0 for real ids, -1e9 for padding ids."""
    ids = torch.arange(vocab_padded, device=device)
    return torch.where(ids < vocab_real, 0.0, -1e9).to(torch.float32)


def mask_pad_logits(logits: torch.Tensor, cfg: ModelConfig, offset: int = 0) -> torch.Tensor:
    """Suppress padding-vocab logits (no-op when vocab needs no padding);
    ``logits`` hold the vocab columns from ``offset`` on."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    mask = vocab_logit_mask(cfg.vocab_size, cfg.padded_vocab, logits.device)
    return logits + mask[offset:offset + logits.shape[-1]].to(logits.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """positions (...,) -> cos/sin (..., head_dim/2), float32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device)
                      / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, dh); cos/sin broadcastable (..., S, 1, dh/2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention core (q-chunked, memory-efficient; GQA; optional SWA window)
# ---------------------------------------------------------------------------

def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int | None) -> torch.Tensor:
    """Additive bias (q, k) in float32: 0 allowed, -inf masked."""
    if causal:
        allowed = q_pos[..., :, None] >= k_pos[..., None, :]
    else:
        allowed = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                             device=k_pos.device)
    if window is not None:
        allowed = allowed & (q_pos[..., :, None] - k_pos[..., None, :] < window)
    return torch.where(allowed, 0.0, float("-inf")).to(torch.float32)


def attention_core(
    q: torch.Tensor,            # (B, Sq, H, dh)
    k: torch.Tensor,            # (B, Sk, Hkv, dh)
    v: torch.Tensor,            # (B, Sk, Hkv, dh)
    *,
    causal: bool,
    window: int | None = None,
    q_offset: torch.Tensor | int = 0,     # absolute position of q[0]
    chunk: int = 1024,
    kv_valid_len: torch.Tensor | None = None,   # decode: #valid cache slots (B,)
) -> torch.Tensor:
    """Memory-efficient attention: a loop over q chunks, full-K softmax rows.

    Never materialises the (Sq, Sk) score tensor: per chunk it is
    (chunk, Sk). GQA repeats K/V onto the query heads, as the reference
    does. The products take the reference's numerics: the scaled q is
    rounded to q's dtype, QK and PV multiply those operands and sum in
    float32 (upcasting a bfloat16 operand is exact), the probabilities are
    rounded to v's dtype before PV, and the result to q's. The reference's
    ``unroll`` (a switch of its ``lax.scan`` for cost probes) has no
    counterpart: this loop is plain Python.
    """
    B, Sq, H, dh = q.shape
    _, Sk, Hkv, _ = k.shape
    groups = H // Hkv
    qf = q * dh**-0.5                    # rounded to q's dtype, as in the reference
    k_pos = torch.arange(Sk, device=q.device)
    if groups > 1:
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    kf, vf = k.float(), v.float()

    def one_chunk(q_chunk: torch.Tensor, q_pos: torch.Tensor) -> torch.Tensor:
        logits = torch.einsum("bchd,bshd->bhcs", q_chunk.float(), kf)
        bias = _mask_bias(q_pos, k_pos, causal, window)             # (C, Sk)
        if kv_valid_len is not None:
            valid = k_pos[None, :] < kv_valid_len[:, None]          # (B, Sk)
            bias = bias[None, :, :] + torch.where(valid, 0.0, float("-inf"))[:, None, :]
            logits = logits + bias[:, None, :, :]
        else:
            logits = logits + bias[None, None, :, :]
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhcs,bshd->bchd", probs.to(v.dtype).float(), vf)
        return out.to(q.dtype)

    if Sq <= chunk:
        return one_chunk(qf, q_offset + torch.arange(Sq, device=q.device))
    n_chunks = -(-Sq // chunk)
    if n_chunks * chunk != Sq:
        qf = F.pad(qf, (0, 0, 0, 0, 0, n_chunks * chunk - Sq))
    outs = [one_chunk(qf[:, i * chunk:(i + 1) * chunk],
                      q_offset + i * chunk + torch.arange(chunk, device=q.device))
            for i in range(n_chunks)]
    return torch.cat(outs, dim=1)[:, :Sq]


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

def attention_axes(cfg: ModelConfig) -> dict:
    axes = {
        "wq": ("w_embed", "heads", None),
        "wk": ("w_embed", "kv", None),
        "wv": ("w_embed", "kv", None),
        "wo": ("heads", None, "w_embed"),
    }
    if cfg.qk_norm:
        axes["q_norm"] = (None,)
        axes["k_norm"] = (None,)
    return axes


def attention_init(generator: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    d, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim
    params = {
        "wq": _normal(generator, (d, H, dh), d**-0.5, device),
        "wk": _normal(generator, (d, Hkv, dh), d**-0.5, device),
        "wv": _normal(generator, (d, Hkv, dh), d**-0.5, device),
        "wo": _normal(generator, (H, dh, d), (H * dh) ** -0.5, device),
    }
    if cfg.qk_norm:
        params["q_norm"] = torch.ones((dh,), dtype=torch.float32, device=resolve_device(device))
        params["k_norm"] = torch.ones((dh,), dtype=torch.float32, device=resolve_device(device))
    return params


def attention_apply(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,                  # (B, S, d)
    *,
    positions: torch.Tensor,          # (S,) or (B, S)
    causal: bool = True,
    cache: dict | None = None,        # decode: {"k", "v", "pos"}, + "seq_mesh" when split
    window: int | None = None,
    deltas: dict | None = None,       # whole-shape additions to wq / wk / wv (LoRA)
) -> tuple[torch.Tensor, dict | None]:
    """Self-attention; with ``cache`` one decode step.

    In decode this step's k/v are written into ``cache["k"]`` /
    ``cache["v"]`` in place, and the returned cache holds those same
    tensors: the caller hands in buffers it owns (``transformer.decode_step``
    copies the state it was given once, so that state is never written and
    a retried step starts from the same bits). ``cache["seq_mesh"]`` (a
    mesh) says the caches hold this rank's positions of the cache sequence,
    split over its ``model`` axis (``kv_seq -> model``): ``_decode_split``.
    ``deltas`` are added to the weights (each rank adds its part of them).
    """
    dt = x.dtype
    mesh = S.param_mesh(params["wq"])
    tp = S.model_sharded(params["wq"])          # local heads, Megatron-style
    part = ("model",) if tp else ()
    if tp:
        x = S.sum_grad(x, mesh)

    def weight(name, partial=part):
        w = S.local_param(params[name], partial)
        if deltas is not None:
            w = w + S.part_like(deltas[name], params[name])
        return w.to(dt)

    q = torch.einsum("bsd,dhk->bshk", x, weight("wq", ()))
    k = torch.einsum("bsd,dhk->bshk", x, weight("wk"))
    v = torch.einsum("bsd,dhk->bshk", x, weight("wv"))
    if tp and not S.model_sharded(params["wk"]):
        k, v = _local_kv_heads(k, v, q.shape[2], cfg, mesh)
    if cfg.qk_norm:
        q = rmsnorm(q, S.local_param(params["q_norm"], part))
        k = rmsnorm(k, S.local_param(params["k_norm"], part))
    cos, sin = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
    cos, sin = cos[..., None, :], sin[..., None, :]   # broadcast over heads
    if positions.ndim == 1:
        cos, sin = cos[None], sin[None]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    new_cache = None
    if cache is None:
        out = attention_core(q, k, v, causal=causal, window=window, chunk=cfg.attn_chunk)
    else:
        # decode: append this step's k/v into the (ring) cache
        ck, cv, pos = cache["k"], cache["v"], cache["pos"]   # pos (B,)
        seq_mesh = cache.get("seq_mesh")
        if seq_mesh is not None and S.axis_size(seq_mesh, "model") > 1:
            out, ck, cv = _decode_split(q, k, v, ck, cv, pos, seq_mesh)
        else:
            S_max = ck.shape[1]
            slot = pos % S_max
            ck = _scatter_step(ck, k, slot)
            cv = _scatter_step(cv, v, slot)
            kv_len = torch.clamp(pos + 1, max=S_max)
            out = attention_core(q, ck, cv, causal=False, window=None,
                                 kv_valid_len=kv_len, chunk=cfg.attn_chunk)
        new_cache = {"k": ck, "v": cv, "pos": pos + 1}
    y = torch.einsum("bshk,hkd->bsd", out, S.local_param(params["wo"]).to(dt))
    if tp:
        y = S.reduce_over(y, mesh, ("model",))   # wo's row-parallel partial sums
    return y, new_cache


def _local_kv_heads(k, v, h_local: int, cfg: ModelConfig, mesh):
    """The KV heads this rank's query heads read, where the KV heads could
    not split over ``model`` (fewer than its ranks, or not dividing): q head
    j reads KV head j // (H / Hkv), as ``attention_core``'s repeat does."""
    groups = cfg.num_heads // cfg.num_kv_heads
    q0 = S.axis_rank(mesh, "model") * h_local
    first, last = q0 // groups, (q0 + h_local - 1) // groups
    if not (first == last or (q0 % groups == 0 and h_local % groups == 0)):
        raise errors.InvalidArgError(f"query heads {q0}..{q0 + h_local - 1} of this rank do not "
                                     f"cover whole KV groups of {groups}")
    return k[:, :, first:last + 1], v[:, :, first:last + 1]


def _decode_split(q, k, v, ck, cv, pos, mesh):
    """One decode step's attention over a cache whose sequence is split over
    ``mesh``'s ``model`` axis (flash-decoding): ``model`` rank r holds ring
    slots [r S/M, (r+1) S/M) of every sequence. This step's k/v are written
    by the rank that holds slot ``pos % S`` alone; each rank scores its
    slots (the valid ones by absolute slot, ``kv_valid_len``), and the
    softmax is combined over ``model`` in float32: the row max
    (``all_reduce(MAX)``), the denominator and the probabilities' product
    with v (``all_reduce(SUM)``), the probabilities rounded to v's dtype as
    ``attention_core`` rounds them. Returns (out, ck, cv); q (B, 1, H, dh),
    k / v (B, 1, Hkv, dh), the caches (B, S/M, Hkv, dh) written in place."""
    B, _, H, dh = q.shape
    S_l, Hkv = ck.shape[1], ck.shape[2]
    M, r = S.axis_size(mesh, "model"), S.axis_rank(mesh, "model")
    lo = r * S_l
    slot = (pos % (S_l * M)).long()
    own = ((slot >= lo) & (slot < lo + S_l))[:, None, None]
    at = torch.clamp(slot - lo, 0, S_l - 1)
    rows = torch.arange(B, device=ck.device)
    ck[rows, at] = torch.where(own, k[:, 0], ck[rows, at])
    cv[rows, at] = torch.where(own, v[:, 0], cv[rows, at])
    kv_len = torch.clamp(pos + 1, max=S_l * M)
    valid = (lo + torch.arange(S_l, device=ck.device))[None, :] < kv_len[:, None]   # (B, S_l)

    qf = q * dh**-0.5
    kk, vv = ck, cv
    if H > Hkv:
        kk = kk.repeat_interleave(H // Hkv, dim=2)
        vv = vv.repeat_interleave(H // Hkv, dim=2)
    logits = torch.einsum("bchd,bshd->bhcs", qf.float(), kk.float())
    logits = logits + torch.where(valid, 0.0, float("-inf"))[:, None, None, :]
    m = S.all_reduce(logits.amax(dim=-1, keepdim=True), mesh, "model",
                     op=torch.distributed.ReduceOp.MAX)
    e = torch.exp(logits - m)
    denom = S.all_reduce(e.sum(dim=-1, keepdim=True), mesh, "model")
    probs = (e / denom).to(cv.dtype).float()
    out = S.all_reduce(torch.einsum("bhcs,bshd->bchd", probs, vv.float()), mesh, "model")
    return out.to(q.dtype), ck, cv


def _scatter_step(cache: torch.Tensor, kv: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Write kv (B, 1, Hkv, dh) at per-batch ``slot`` into cache (B, S, Hkv, dh),
    in place; returns ``cache``.

    The reference blends with a one-hot mask (``cache * (1 - oh) + oh *
    kv``) so that a sequence-sharded cache needs no cross-shard scatter.
    For finite values that blend equals this index write bit for bit, but
    for the sign of a zero; on one device the write touches B rows instead
    of the whole cache.
    """
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, slot.long()] = kv[:, 0]
    return cache


CACHE_AXES = {"k": (None, "batch", "kv_seq", "kv", None),
              "v": (None, "batch", "kv_seq", "kv", None),
              "pos": ("batch",)}


def decode_cache_init(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                      device=None) -> dict:
    """Ring-buffer KV cache; SWA archs only keep the window."""
    dev = resolve_device(device)
    window = cfg.swa_window
    S = min(max_len, window) if window else max_len
    shape = (n_layers, batch, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.activation_dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.activation_dtype, device=dev),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


# ---------------------------------------------------------------------------
# MLPs (SwiGLU; dense or CB-sparse)
# ---------------------------------------------------------------------------

def build_mlp_specs(cfg: ModelConfig, seed: int = 42):
    """CB sparsity specs for the SwiGLU projections (numpy only), bit-equal
    to the reference's: one pattern shared by every layer, seeds 42, 43 and
    44 through ``cb_spec_random``."""
    if not cfg.sparse_mlp:
        return None
    d, ff = cfg.d_model, cfg.d_ff

    def mk(i, o, s):
        return cb_spec_random(i, o, block_size=cfg.sparse_block,
                              keep_fraction=cfg.sparse_keep, seed=s)

    return {"gate": mk(d, ff, seed), "up": mk(d, ff, seed + 1), "down": mk(ff, d, seed + 2)}


def mlp_axes(cfg: ModelConfig) -> dict:
    if cfg.sparse_mlp:
        # tiles are small and uniform; replicate (FSDP gains negligible)
        return {
            "gate": {"tiles": (None, None, None)},
            "up": {"tiles": (None, None, None)},
            "down": {"tiles": (None, None, None)},
        }
    return {
        "w_gate": ("w_embed", "mlp"),
        "w_up": ("w_embed", "mlp"),
        "w_down": ("mlp", "w_embed"),
    }


def mlp_init(generator: torch.Generator, cfg: ModelConfig, specs=None, device=None) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.sparse_mlp:
        if specs is None:
            raise errors.InvalidArgError("sparse_mlp requires precomputed specs (build_mlp_specs)")
        return {k: cb_tiles_init(generator, specs[k], device=device)
                for k in ("gate", "up", "down")}
    return {
        "w_gate": _normal(generator, (d, ff), d**-0.5, device),
        "w_up": _normal(generator, (d, ff), d**-0.5, device),
        "w_down": _normal(generator, (ff, d), ff**-0.5, device),
    }


def mlp_apply(params: dict, cfg: ModelConfig, x: torch.Tensor, specs=None,
              impl: str = "cuda") -> torch.Tensor:
    """SwiGLU; CB-sparse products run ``cb_linear_apply`` with ``impl`` on
    x's device (``"cuda"``: the kernel on a CUDA tensor, its plain version
    on a CPU one)."""
    dt = x.dtype
    if cfg.sparse_mlp:
        mesh = S.param_mesh(params["gate"]["tiles"])

        def lin(name, inp):
            # on a mesh: the rows of this rank as a DTensor (the reference's
            # ("batch", "seq", "embed") / ("batch", "seq", "mlp") points); the
            # tiles are replicated, so every model rank runs the same product
            y = cb_linear_apply(params[name], specs[name],
                                S.as_dtensor(inp, mesh, "batch", "seq", None),
                                impl=impl, device=inp.device)
            return y if mesh is None else y.to_local()

        h = F.silu(lin("gate", x)) * lin("up", x)
        return lin("down", h)
    mesh = S.param_mesh(params["w_gate"])
    tp = S.model_sharded(params["w_gate"])     # gate / up by columns, down by rows
    return swiglu(x, params["w_gate"], params["w_up"], params["w_down"], mesh if tp else None)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down, tp_mesh=None) -> torch.Tensor:
    """``(silu(x @ w_gate) * (x @ w_up)) @ w_down`` in x's dtype; with
    ``tp_mesh`` the weights are split over its ``model`` axis (the input's
    gradient and the output summed over it)."""
    dt = x.dtype
    if tp_mesh is not None:
        x = S.sum_grad(x, tp_mesh)
    g = x @ S.local_param(w_gate).to(dt)
    u = x @ S.local_param(w_up).to(dt)
    y = (F.silu(g) * u) @ S.local_param(w_down).to(dt)
    return y if tp_mesh is None else S.reduce_over(y, tp_mesh, ("model",))
