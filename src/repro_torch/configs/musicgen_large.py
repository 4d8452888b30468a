"""musicgen-large [audio] -- decoder-only over EnCodec tokens.

48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048
[arXiv:2306.05284; hf].  Backbone only: the EnCodec frontend is a stub --
``input_specs`` feeds precomputed frame embeddings.  Plain (non-gated) GELU
MLP, LayerNorm, sinusoidal positions, per the MusicGen transformer.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    rope="sinusoidal",
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    embed_inputs=False,
)

SMOKE = ArchConfig(
    name="musicgen-large-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=128,
    rope="sinusoidal",
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    embed_inputs=False,
)
