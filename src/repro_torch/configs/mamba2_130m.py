"""mamba2-130m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified]. num_heads/num_kv_heads/d_ff are unused by
the SSM family (kept at structural placeholders); the mixer is
d_inner = 2*d_model with headdim 64 -> 24 SSD heads, d_state 128.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=12,             # placeholder (attn-free)
    num_kv_heads=12,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=128,
)

SMOKE = CONFIG.scaled(
    num_layers=2, d_model=128, vocab_size=512, ssm_state=32, ssm_headdim=32,
    ssm_chunk=32, remat="none",
)
