"""Typed failures of the resilience layer (the port's copy of the
reference's ``resil/errors.py``).

The retry/quarantine machinery dispatches on exception *type*, so every
failure mode the chaos harness can provoke (and every real one it
models) gets a named class here:

* :class:`CorruptShardError` -- a shard's bytes do not match the crc
  recorded in its store manifest.  An ``OSError`` subclass, so the
  generic transient-I/O retry classes cover it, but the retry loop
  special-cases it to *one* re-read (a deterministic disk corruption
  will not heal, a torn page-cache read might).
* :class:`NonFiniteSolveError` -- the CG solve returned NaN/Inf.  The
  streaming driver retries, then re-solves one precision rung up
  (q8/fp8 -> f32) before quarantining the slab.
* :class:`DeadlineExceeded` -- a serve job ran past its
  ``JobSpec.deadline_s``.
* ``Injected*`` -- raised only by :mod:`repro_torch.resil.inject` when a
  :class:`~repro_torch.resil.inject.FaultPlan` is active; each subclasses the
  real-world exception it stands in for, so recovery code never
  special-cases injection.
"""
from __future__ import annotations

__all__ = [
    "CorruptShardError",
    "NonFiniteSolveError",
    "DeadlineExceeded",
    "InjectedIOError",
    "InjectedThreadDeath",
    "InjectedError",
    "InjectedPreemption",
]


class CorruptShardError(OSError):
    """A store shard failed its manifest crc check."""


class NonFiniteSolveError(FloatingPointError):
    """A solve produced NaN/Inf values."""


class DeadlineExceeded(RuntimeError):
    """A serve job exceeded its ``JobSpec.deadline_s``."""


class InjectedIOError(OSError):
    """A ``kind="io_error"`` fault (stands in for a failed disk read)."""


class InjectedThreadDeath(RuntimeError):
    """A ``kind="thread_death"`` fault (kills the prefetch worker)."""


class InjectedError(RuntimeError):
    """A generic ``kind="error"`` fault (e.g. a plan build failing)."""


class InjectedPreemption(RuntimeError):
    """A ``kind="preempt"`` fault (the job was killed mid-drain)."""
