"""codeqwen1.5-7b [dense] -- qwen1.5-arch (qkv bias, MHA).

32L d_model=4096 32H (MHA kv=32) d_ff=13440 vocab=92416
[hf:Qwen/CodeQwen1.5-7B; hf].
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
)

SMOKE = ArchConfig(
    name="codeqwen1.5-7b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    qkv_bias=True,
)
