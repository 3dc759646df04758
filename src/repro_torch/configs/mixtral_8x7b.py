"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf]. SWA (4096 window) makes decode O(window), so this
arch RUNS long_500k.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,           # GQA
    d_ff=14336,               # per-expert FFN width
    vocab_size=32000,
    num_experts=8,
    top_k=2,
    swa_window=4096,
    rope_theta=1_000_000.0,
    # group-local dispatch (capacity per group of tokens): keeps MoE
    # scatters shard-local when groups == the data-axis width (§Perf A)
    moe_groups=16,
)

SMOKE = CONFIG.scaled(
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
    vocab_size=512, num_experts=4, swa_window=32, attn_chunk=64, remat="none",
)
