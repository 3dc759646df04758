"""whisper-small [audio/encdec] — 12L encoder + 12L decoder
[arXiv:2212.04356; unverified]. The conv/mel frontend is a STUB:
the caller provides precomputed frame embeddings (B, 1500, d_model).
Positional scheme adapted to RoPE (DESIGN.md §8).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,            # decoder layers
    encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,          # MHA
    d_ff=3072,
    vocab_size=51865,
    num_frames=1500,          # 30 s audio after conv stride 2
)

SMOKE = CONFIG.scaled(
    num_layers=2, encoder_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512, num_frames=64, attn_chunk=64, remat="none",
)
