"""Deterministic synthetic token pipeline (the port's copy of the
reference's ``data/tokens.py``; numpy only, so the batches are the
reference's, token for token).

Every batch is a pure function of ``(seed, step, shard)``: any host can
regenerate any shard at any time, which is the property the fault-tolerance
layer relies on (a reassigned or restarted worker never loses data, and
stragglers can be re-balanced without coordination -- see dist/fault.py).

The stream is not uniform noise: tokens follow a Zipf-like marginal with
Markov structure, so cross-entropy actually *decreases* under training.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenStream"]


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1

    def shard_batch(self, step: int, shard: int) -> dict:
        """[batch/n_shards, seq] int32 tokens for (step, shard) -- a pure
        function."""
        assert self.global_batch % self.n_shards == 0
        b = self.global_batch // self.n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence(
                [self.seed, int(step), int(shard), 0xC7]
            )
        )
        v = self.vocab_size
        # Zipf marginal over a small "frequent" head + Markov chain: the
        # next token is (prev * 31 + noise) % head with prob q, else random.
        head = max(8, v // 16)
        toks = np.empty((b, self.seq_len), np.int64)
        toks[:, 0] = rng.zipf(1.5, size=b) % head
        noise = rng.random((b, self.seq_len))
        rand = rng.integers(0, v, size=(b, self.seq_len))
        for t in range(1, self.seq_len):
            follow = (toks[:, t - 1] * 31 + 7) % head
            toks[:, t] = np.where(noise[:, t] < 0.75, follow, rand[:, t])
        return {
            "inputs": toks.astype(np.int32),
            "labels": toks.astype(np.int32),
        }

    def batch(self, step: int) -> dict:
        shards = [
            self.shard_batch(step, s) for s in range(self.n_shards)
        ]
        return {
            k: np.concatenate([s[k] for s in shards], axis=0)
            for k in shards[0]
        }
