"""Resilience layer: deterministic chaos + the recovery it validates (the
port's copy of the reference's ``repro.resil``).

* :mod:`~repro_torch.resil.inject` -- a seeded :class:`FaultPlan` fired at
  named sites, pure in ``(seed, site, key, attempt)`` and zero-overhead
  when inactive; the port's ``Reconstructor`` consults ``recon/solve``;
* :mod:`~repro_torch.resil.retry` -- :class:`RetryPolicy` with
  deterministic backoff jitter;
* :mod:`~repro_torch.resil.circuit` -- a per-key :class:`CircuitBreaker`;
* :mod:`~repro_torch.resil.errors` -- the typed failures the above
  dispatch on (:class:`CorruptShardError`, :class:`NonFiniteSolveError`,
  ...).

Depends only on :mod:`repro_torch.obs` (metrics + trace instants), so
every other subsystem can import it without cycles.
"""
from . import inject
from .circuit import CircuitBreaker
from .errors import (
    CorruptShardError,
    DeadlineExceeded,
    InjectedError,
    InjectedIOError,
    InjectedPreemption,
    InjectedThreadDeath,
    NonFiniteSolveError,
)
from .inject import Fault, FaultPlan
from .retry import RETRYABLE_IO, RetryPolicy, call_with_retry

__all__ = [
    "inject",
    "Fault",
    "FaultPlan",
    "RetryPolicy",
    "RETRYABLE_IO",
    "call_with_retry",
    "CircuitBreaker",
    "CorruptShardError",
    "NonFiniteSolveError",
    "DeadlineExceeded",
    "InjectedIOError",
    "InjectedThreadDeath",
    "InjectedError",
    "InjectedPreemption",
]
