"""llama4-maverick-400b-a17b [moe] — 128 experts top-1 + shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E family; unverified].

Treated as full attention (the chunked-attention long-context variant is
not claimed here), so long_500k is skipped (DESIGN.md §6).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,           # GQA
    d_ff=8192,                # per-expert FFN width
    vocab_size=202048,
    num_experts=128,
    top_k=1,
    moe_shared_expert=True,   # llama4 early-fusion shared expert
    moe_every=2,              # interleave_moe_layer_step=2 -> 400B total / 17B active
    rope_theta=500_000.0,
    moe_groups=16,            # group-local dispatch (§Perf B)
)

SMOKE = CONFIG.scaled(
    num_layers=4, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
    vocab_size=512, num_experts=4, attn_chunk=64, remat="none",
)
