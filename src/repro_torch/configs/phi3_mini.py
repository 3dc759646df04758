"""phi3-mini-3.8b [dense] — RoPE + SwiGLU + GQA [arXiv:2404.14219; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
)

SMOKE = CONFIG.scaled(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
    vocab_size=512, attn_chunk=64, remat="none",
)
