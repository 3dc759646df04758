"""granite-8b [dense] — llama-arch code model [arXiv:2405.04324; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,          # GQA
    d_ff=14336,
    vocab_size=49152,
    rope_theta=10_000_000.0,  # granite code long-context rope base
)

# Reduced same-family config for CPU smoke tests.
SMOKE = CONFIG.scaled(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=1, d_ff=256,
    vocab_size=512, attn_chunk=64, remat="none",
)
