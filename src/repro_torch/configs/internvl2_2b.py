"""internvl2-2b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

The InternViT frontend is a STUB: the caller provides precomputed patch
embeddings (B, 256, d_model) — 448x448 / 14px patches after pixel-shuffle
— prepended to the text sequence. The listed transformer config is the
InternLM2-1.8B language backbone.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,           # GQA
    d_ff=8192,
    vocab_size=92553,
    num_patches=256,
)

SMOKE = CONFIG.scaled(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
    vocab_size=512, num_patches=16, attn_chunk=64, remat="none",
)
