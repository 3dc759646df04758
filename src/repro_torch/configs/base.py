"""Config schema: architectures x input shapes.

One ``ModelConfig`` per assigned architecture (exact public configs in the
sibling modules) and one ``ShapeConfig`` per assigned input shape, the JAX
package's (``src/repro/configs/base.py``) field for field. A (config,
shape) pair fully determines the dry-run cell: ``input_specs`` builds its
inputs as tensors on the meta device (shape and dtype only), and the
launcher picks the train step, prefill or decode from ``shape.kind``. The
one difference: ``activation_dtype`` is a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None      # default d_model // num_heads
    qk_norm: bool = False               # qwen3-style per-head RMSNorm on q,k
    swa_window: Optional[int] = None    # sliding-window attention (mixtral)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_shared_expert: bool = False     # llama4: always-on shared expert
    moe_every: int = 1                  # MoE every k-th layer (llama4: 2)
    moe_groups: int = 1                 # GShard-style dispatch groups:
                                        # capacity is per-group, scatters
                                        # stay shard-local when groups ==
                                        # data width (see §Perf)
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    # --- hybrid (zamba2) ---
    attn_every: int = 0                 # shared attn block every k SSM layers
    shared_attn_lora_rank: int = 0      # per-invocation LoRA on shared block
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    num_frames: int = 0                 # stub conv frontend output length
    # --- VLM (internvl) ---
    num_patches: int = 0                # stub ViT frontend output length
    # --- CB sparsity (the paper's technique as a model feature) ---
    sparse_mlp: bool = False
    sparse_block: int = 128
    sparse_keep: float = 0.25
    # --- numerics / execution ---
    dtype: str = "bfloat16"
    remat: str = "full"                 # none | full | dots
    attn_chunk: int = 1024              # q-chunked attention block
    scan_layers: bool = True            # False = fully unrolled (cost probes)
    attn_unroll: bool = False           # unroll the q-chunk scan (cost probes)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Megatron-style vocab padding: tables padded to a multiple of 256
        so the vocab dim shards evenly over any TP width; pad logits are
        masked to -inf (never predicted, never targeted)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def activation_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)

    # ---- parameter counting (roofline MODEL_FLOPS = 6 N D) --------------
    def param_count(self) -> int:
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        dh = self.resolved_head_dim
        H, Hkv = self.num_heads, self.num_kv_heads
        attn = d * H * dh + 2 * d * Hkv * dh + H * dh * d
        mlp = 3 * d * ff
        if self.family == "moe":
            moe_mlp = 3 * d * ff * self.num_experts + d * self.num_experts
            if self.moe_shared_expert:
                moe_mlp += 3 * d * ff
            k = max(1, self.moe_every)
            # 1 MoE layer per group of k; the other k-1 are dense MLP.
            mlp = (moe_mlp + (k - 1) * 3 * d * ff) / k
        per_layer = attn + mlp + 2 * d
        if self.family == "ssm":
            per_layer = self._ssm_layer_params()
        if self.family == "hybrid":
            n_attn = self.num_layers // max(1, self.attn_every)
            per_layer = self._ssm_layer_params()
            extra = n_attn and (attn + 3 * d * ff + 2 * d)
            return (
                V * d * (1 if self.tie_embeddings else 2)
                + self.num_layers * per_layer
                + extra + d
            )
        total = V * d * (1 if self.tie_embeddings else 2) + self.num_layers * per_layer + d
        if self.family == "encdec":
            total += self.encoder_layers * (attn + 3 * d * ff + 2 * d)
            total += self.num_layers * (attn + 2 * d)  # cross-attn + norm
        return total

    def active_param_count(self) -> int:
        """MoE: only top-k experts' FFN params count as active."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        n_moe_layers = self.num_layers // max(1, self.moe_every)
        inactive = 3 * d * ff * (self.num_experts - self.top_k) * n_moe_layers
        return self.param_count() - inactive

    def _ssm_layer_params(self) -> int:
        d = self.d_model
        d_in = d * self.ssm_expand
        nh = d_in // self.ssm_headdim
        # in_proj -> (z, x, B, C, dt) + conv + out_proj + norm
        return (
            d * (2 * d_in + 2 * self.ssm_state + nh)
            + self.ssm_conv_width * (d_in + 2 * self.ssm_state)
            + d_in * d
            + 2 * nh + d_in + 2 * d
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

SHAPES = {s.name: s for s in [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]}


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention (DESIGN.md §6)."""
    if shape.name == "long_500k":
        sub_quadratic = (
            cfg.family in ("ssm", "hybrid")
            or (cfg.swa_window is not None and cfg.swa_window < shape.seq_len)
        )
        if not sub_quadratic:
            return False, "pure full attention is quadratic at 500k — skipped"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Stand-ins for every model input: meta tensors (no allocation) of the
    reference's shapes and dtypes."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind == "train":
        specs = {"tokens": spec((B, S), i32), "targets": spec((B, S), i32)}
    elif shape.kind == "prefill":
        specs = {"tokens": spec((B, S), i32)}
    else:  # decode: one new token against a seq_len-deep cache
        specs = {"tokens": spec((B, 1), i32), "pos": spec((B,), i32)}
    if cfg.family == "vlm" and shape.kind != "decode":
        specs["patch_embeds"] = spec((B, cfg.num_patches, cfg.d_model), cfg.activation_dtype)
    if cfg.family == "encdec":
        specs["frames"] = spec((B, cfg.num_frames, cfg.d_model), cfg.activation_dtype)
    return specs
