"""zamba2-2.7b [hybrid] — Mamba2 trunk + weight-shared attention blocks
with per-invocation LoRA [arXiv:2411.15242; hf]. 54 Mamba2 layers, one
shared attn+MLP block applied every 6 layers (9 invocations). SSM decode
is O(1)/token, so this arch RUNS long_500k.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,            # Mamba2 layers
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,               # shared-block MLP width
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=128,
    attn_every=6,
    shared_attn_lora_rank=128,
)

SMOKE = CONFIG.scaled(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
    vocab_size=512, ssm_state=32, ssm_headdim=32, ssm_chunk=32,
    attn_every=1, shared_attn_lora_rank=8, attn_chunk=64, remat="none",
)
