"""recurrentgemma-9b [hybrid] -- RG-LRU + local attention, 1 attn : 2 rec.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, window 2048
[arXiv:2402.19427; unverified].  38 = 12 full (rec, rec, local) periods + a
trailing (rec, rec) partial period (unrolled).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim_override=256,
    block_pattern=("rglru", "rglru", "local"),
    window=2048,
    rnn_width=4096,
    act="gelu",
    gated_mlp=True,
)

SMOKE = ArchConfig(
    name="recurrentgemma-9b-smoke",
    family="hybrid",
    n_layers=5,  # 1 period + (rec, rec) remainder
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=512,
    head_dim_override=16,
    block_pattern=("rglru", "rglru", "local"),
    window=16,
    rnn_width=64,
    act="gelu",
    gated_mlp=True,
    conv_width=2,
)
