"""xlstm-350m [ssm] -- sLSTM + mLSTM blocks, 7:1 ratio.

24L d_model=1024 4H d_ff=0 vocab=50304 [arXiv:2405.04517; unverified].
d_ff = 0: xLSTM blocks carry their own projections (mLSTM pf=2 up/down,
sLSTM gated FFN pf=4/3); there is no separate MLP block.
"""
from .base import ArchConfig

_PATTERN = ("mlstm",) * 7 + ("slstm",)

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=_PATTERN,
)

SMOKE = ArchConfig(
    name="xlstm-350m-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_ff=0,
    vocab_size=512,
    block_pattern=("mlstm", "slstm"),
    conv_width=2,
)
