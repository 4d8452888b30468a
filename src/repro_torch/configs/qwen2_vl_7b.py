"""qwen2-vl-7b [vlm] -- M-RoPE, dynamic resolution.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064
[arXiv:2409.12191; hf].  Backbone only: the vision frontend is a stub --
``input_specs`` feeds precomputed patch embeddings; M-RoPE's three position
streams (t/h/w) all receive the text position ids, exactly M-RoPE's
behaviour on text tokens.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    rope="mrope",
    mrope_sections=(16, 24, 24),
    qkv_bias=True,
    embed_inputs=False,
)

SMOKE = ArchConfig(
    name="qwen2-vl-7b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim_override=16,
    rope="mrope",
    mrope_sections=(2, 3, 3),
    qkv_bias=True,
    embed_inputs=False,
)
