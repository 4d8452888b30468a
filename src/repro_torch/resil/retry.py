"""Retry with deterministic exponential backoff + jitter (the port's copy
of the reference's ``resil/retry.py``).

:class:`RetryPolicy` is pure configuration: attempts, backoff curve,
per-item wall-clock budget.  Its jitter is *deterministic* -- drawn
from :func:`repro_torch.resil.inject.hash01` over ``(seed, site, key,
attempt)`` -- so a retried chaos scenario replays with identical
timing decisions, and two workers retrying different slabs still
de-synchronize (different keys, different jitter).

>>> p = RetryPolicy(max_attempts=4, base_delay_s=0.1, backoff=2.0,
...                 jitter=0.0, seed=7)
>>> [round(p.delay_s("stream/load", 3, a), 3) for a in (1, 2, 3)]
[0.1, 0.2, 0.4]

:func:`call_with_retry` drives a callable under a policy.  Retryable
classes default to transient I/O (``OSError`` covers the injected read
errors *and* :class:`~repro_torch.resil.errors.CorruptShardError`, plus
``TimeoutError``); a corrupt shard is special-cased to **one** re-read
-- deterministic on-disk corruption will not heal, a torn read might
-- after which the error propagates for the caller to quarantine.
Every retry bumps ``retries_total{site}`` and drops a ``resil/retry``
trace instant.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .errors import CorruptShardError
from .inject import hash01

__all__ = ["RetryPolicy", "RETRYABLE_IO", "call_with_retry"]

RETRYABLE_IO = (OSError, TimeoutError)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How hard to try: total attempts, backoff, per-item budget.

    ``max_attempts`` counts the first try (``1`` disables retries);
    ``timeout_s`` bounds the wall clock across all attempts of one item
    (e.g. per slab) -- when the budget is spent, the last error
    propagates even if attempts remain.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    backoff: float = 2.0
    jitter: float = 0.5  # +/- fraction of the nominal delay
    timeout_s: float | None = None
    seed: int = 0

    def delay_s(self, site: str, key, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based), jittered."""
        d = self.base_delay_s * self.backoff ** (attempt - 1)
        if self.jitter:
            u = hash01(self.seed, site, key, attempt)
            d *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return max(0.0, d)

    def attempts_for(self, exc: BaseException) -> int:
        """Attempt budget for this failure type (corrupt shard: one
        re-read, then let the caller quarantine)."""
        if isinstance(exc, CorruptShardError):
            return min(2, self.max_attempts)
        return self.max_attempts


def call_with_retry(
    fn: Callable[[int], object],
    *,
    policy: RetryPolicy,
    site: str,
    key=None,
    retryable: tuple = RETRYABLE_IO,
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Callable[[], None] | None = None,
):
    """Run ``fn(attempt)`` under ``policy``; return its first success.

    Non-``retryable`` exceptions propagate immediately (a dead worker
    thread or a solver bug is not something backoff fixes).  When
    attempts or the time budget run out, the *last* exception
    propagates unchanged, so callers keep dispatching on its type.
    """
    t0 = time.monotonic()
    attempt = 0
    while True:
        try:
            return fn(attempt)
        except retryable as e:
            attempt += 1
            out_of_time = (
                policy.timeout_s is not None
                and time.monotonic() - t0 >= policy.timeout_s
            )
            if attempt >= policy.attempts_for(e) or out_of_time:
                raise
            obs_metrics.inc("retries_total", site=site)
            obs_trace.instant(
                "resil/retry", site=site, key=str(key), attempt=attempt,
                error=type(e).__name__,
            )
            if on_retry is not None:
                on_retry()
            d = policy.delay_s(site, key, attempt)
            if d > 0.0:
                sleep(d)
