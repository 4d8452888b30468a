"""qwen3-4b [dense] -- qk_norm, GQA.

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936, head_dim 128
[hf:Qwen/Qwen3-8B; hf].
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    head_dim_override=128,
    qk_norm=True,
)

SMOKE = ArchConfig(
    name="qwen3-4b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim_override=16,
    qk_norm=True,
)
