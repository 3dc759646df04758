"""stablelm-3b [dense] — MHA (kv == heads) [hf:stabilityai/stablelm-2-1_6b; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,          # full MHA
    d_ff=6912,
    vocab_size=50304,
)

SMOKE = CONFIG.scaled(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
    vocab_size=512, attn_chunk=64, remat="none",
)
