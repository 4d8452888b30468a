"""LM serving heads: ``prefill`` and ``decode_step``.

The reference's ``models/lm.py`` serving half in PyTorch (the loss and
the train steps come with the training slice).
"""
from __future__ import annotations

import torch

from .transformer import forward, init_cache  # noqa: F401

__all__ = ["decode_step", "prefill"]


def prefill(params, cfg, inputs):
    """Full-sequence prefill: returns (last-token logits [B, V], cache).

    Only the last position is unembedded (``last_token_only``): logits
    for all T positions would cost ``T x`` the unembed matmul in serving.
    """
    b, t = inputs.shape[:2]
    positions = torch.arange(t, dtype=torch.int32,
                             device=inputs.device).expand(b, t)
    logits, cache, _ = forward(
        params, cfg, inputs, positions=positions, mode="prefill",
        last_token_only=True,
    )
    return logits[:, -1], cache


def decode_step(params, cfg, cache, token, pos: int):
    """One decode step.

    Args:
      token: [B, 1] integer tokens (or [B, 1, D] embeds for stub
        frontends).
      pos: the position of this token.

    Returns (next_token int32 [B, 1], new_cache, logits [B, V]); the
    cache's tensors are written in place.
    """
    b = token.shape[0]
    positions = torch.full((b, 1), int(pos), dtype=torch.int32,
                           device=token.device)
    logits, new_cache, _ = forward(
        params, cfg, token, positions=positions, cache=cache, mode="decode"
    )
    nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    return nxt[:, None], new_cache, logits[:, -1]
