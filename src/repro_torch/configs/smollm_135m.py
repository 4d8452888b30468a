"""smollm-135m [dense] -- llama-arch small.

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M; hf].  Also the ~100M-class model used by
the end-to-end training example.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="smollm-135m-smoke",
    family="dense",
    n_layers=2,
    d_model=48,
    n_heads=3,
    n_kv_heads=1,
    d_ff=96,
    vocab_size=512,
    tie_embeddings=True,
)
