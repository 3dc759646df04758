"""qwen3-32b [dense] — qk_norm + GQA [hf:Qwen/Qwen3-8B family; hf].

head_dim is 128 (decoupled from d_model/num_heads = 80) per the public
Qwen3 configs.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,           # GQA
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.scaled(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=1, d_ff=256,
    vocab_size=512, head_dim=32, attn_chunk=64, remat="none",
)
