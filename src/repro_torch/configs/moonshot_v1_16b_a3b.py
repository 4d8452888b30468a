"""moonshot-v1-16b-a3b [moe] -- kimi/moonlight, 64 experts top-6.

48L d_model=2048 16H (MHA kv=16) expert d_ff=1408 vocab=163840
[hf:moonshotai/Moonlight-16B-A3B; hf].
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    moe_experts=64,
    moe_top_k=6,
    moe_d_ff=1408,
)

SMOKE = ArchConfig(
    name="moonshot-v1-16b-a3b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab_size=512,
    moe_experts=8,
    moe_top_k=2,
    moe_d_ff=96,
)
