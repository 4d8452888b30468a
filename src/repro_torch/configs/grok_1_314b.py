"""grok-1-314b [moe] -- 8 experts top-2.

64L d_model=6144 48H (GQA kv=8) expert d_ff=32768 vocab=131072
[hf:xai-org/grok-1; unverified].  8 experts do not divide the 16-wide
model axis; the sharding rules fall back to ffn-dim tensor parallelism
inside each expert (see dist/sharding.py).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    moe_experts=8,
    moe_top_k=2,
    moe_d_ff=32768,
)

SMOKE = ArchConfig(
    name="grok-1-314b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    moe_experts=4,
    moe_top_k=2,
    moe_d_ff=128,
)
