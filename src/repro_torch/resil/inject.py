"""Deterministic fault injection: seeded plans fired at named sites (the
port's copy of the reference's ``resil/inject.py``).

At the paper's scale (24,576 GPUs, day-long campaigns) "some node is
always slow and something is always failing" -- so the recovery paths
must be *testable*, and testable means deterministic.  A
:class:`FaultPlan` is a pure function of ``(seed, site, key, attempt)``:
the same plan against the same drain injects the same faults at the
same points, every run, on every machine.

Sites are consulted by production code via two module functions:

* :func:`fire` -- raise/delay-style faults (``io_error``, ``slow``,
  ``thread_death``, ``error``, ``preempt``);
* :func:`mutate` -- data faults applied to an array in flight
  (``corrupt`` flips shard bytes, ``nonfinite`` poisons solve output)
  plus all of the above.

Both are **zero-overhead when no plan is active**: one module-attribute
load and a ``None`` check.

The reference's sites (in the port only ``recon/solve`` is wired so far,
in ``core/recon.py``; the others come with streaming and serving):

=================== ======================= ============================
site                key                     kinds that make sense
=================== ======================= ============================
``store/read``      shard start slice       io_error, corrupt, slow
``stream/load``     slab index              io_error, slow, thread_death
``stream/stage``    slab index              io_error, slow
``recon/solve``     scope key (slab index)  nonfinite
``serve/build``     ``None``                error
``stream/after_slab`` slab index            preempt
=================== ======================= ============================

Attempt counting is automatic: each consultation of ``(site, key)``
under an active plan increments that pair's attempt counter, so
``attempts=(0,)`` means "fire the first time only" -- the transient
fault that heals on retry -- and ``attempts=None`` means "fire every
time" -- the poison that exhausts retries.  Keyless call sites (the
solver does not know which slab it is solving) resolve their key from
the innermost :func:`scope` on the current thread.

Every fired fault bumps ``faults_injected_total{site,kind}`` and drops
a ``resil/fault`` trace instant, so a chaos run's artifact shows
exactly what was injected where.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
import time

import numpy as np

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .errors import (
    InjectedError,
    InjectedIOError,
    InjectedPreemption,
    InjectedThreadDeath,
)

__all__ = ["Fault", "FaultPlan", "activate", "active", "fire", "mutate",
           "scope", "hash01"]

KINDS = (
    "io_error", "corrupt", "slow", "thread_death", "nonfinite",
    "error", "preempt",
)

_RAISES = {
    "io_error": InjectedIOError,
    "thread_death": InjectedThreadDeath,
    "error": InjectedError,
    "preempt": InjectedPreemption,
}


def hash01(seed: int, *parts) -> float:
    """Deterministic uniform in ``[0, 1)`` from ``(seed, *parts)``.

    The single entropy source of the whole resilience layer: fault
    byte positions and retry jitter both come from here, so a chaos
    scenario replays bit-identically from its seed.
    """
    msg = ":".join(repr(p) for p in (seed,) + parts).encode()
    u = int.from_bytes(hashlib.sha256(msg).digest()[:8], "big")
    return u / 2.0**64


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injection rule: where, what, and on which attempts.

    ``key=None`` matches any key at the site; ``attempts=None`` fires on
    every consultation (a persistent fault), ``attempts=(0,)`` only on
    the first (a transient one).  ``when`` is an optional attrs match
    against the call site's context (e.g. ``{"precision": "q8"}`` makes
    a ``nonfinite`` fault poison only the quantized rung, so the
    driver's precision escalation can be seen to succeed).
    """

    site: str
    kind: str
    key: object = None
    attempts: tuple | None = (0,)
    delay_s: float = 0.05  # kind="slow" stall length
    flip_bytes: int = 1  # kind="corrupt" bytes to flip
    when: tuple | None = None  # (("attr", value), ...) context match

    def fires(self, key, attempt: int, ctx: dict | None) -> bool:
        if self.key is not None and self.key != key:
            return False
        if self.attempts is not None and attempt not in self.attempts:
            return False
        if self.when is not None:
            ctx = ctx or {}
            if any(ctx.get(k) != v for k, v in self.when):
                return False
        return True


class FaultPlan:
    """A seeded set of :class:`Fault` rules (chain ``.add`` to build)."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._faults: list[Fault] = []

    def add(self, site: str, kind: str, *, key=None, attempts=(0,),
            delay_s: float = 0.05, flip_bytes: int = 1,
            when: dict | None = None) -> "FaultPlan":
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; one of {KINDS}")
        self._faults.append(Fault(
            site=site, kind=kind, key=key,
            attempts=None if attempts is None else tuple(attempts),
            delay_s=float(delay_s), flip_bytes=int(flip_bytes),
            when=None if when is None else tuple(sorted(when.items())),
        ))
        return self

    def faults_at(self, site: str) -> list[Fault]:
        return [f for f in self._faults if f.site == site]

    def __len__(self) -> int:
        return len(self._faults)


class _Active:
    """A plan bound to the registry: per-``(site, key)`` attempt
    counters plus the log of every fault actually fired."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.fired: list[tuple] = []  # (site, key, attempt, kind)
        self._counts: dict = {}
        self._lock = threading.Lock()

    def next_attempt(self, site: str, key) -> int:
        with self._lock:
            n = self._counts.get((site, key), 0)
            self._counts[(site, key)] = n + 1
            return n


# The fast path: one attribute load + None check when nothing is active.
_active_plan: _Active | None = None
_scope = threading.local()


@contextlib.contextmanager
def activate(plan: FaultPlan):
    """Bind ``plan`` to the registry for the duration of the block.

    Attempt counters start fresh per activation (re-running the same
    scenario re-fires the same faults).  Yields the :class:`_Active`
    handle so tests can assert on ``handle.fired``.
    """
    global _active_plan
    if _active_plan is not None:
        raise RuntimeError("a FaultPlan is already active")
    handle = _Active(plan)
    _active_plan = handle
    try:
        yield handle
    finally:
        _active_plan = None


def active() -> bool:
    """Is a plan bound?  (Stores bypass their verified-shard cache when
    injecting, so corruption faults cannot be masked by it.)"""
    return _active_plan is not None


@contextlib.contextmanager
def scope(key):
    """Resolve keyless sites on this thread to ``key`` (e.g. the driver
    wraps each slab's solve so ``recon/solve`` knows its slab index)."""
    prev = getattr(_scope, "key", None)
    _scope.key = key
    try:
        yield
    finally:
        _scope.key = prev


def fire(site: str, key=None, ctx: dict | None = None) -> None:
    """Consult ``site``; may sleep or raise per the active plan."""
    ap = _active_plan
    if ap is None:
        return
    _apply(ap, site, key, ctx, None)


def mutate(site: str, arr, key=None, ctx: dict | None = None):
    """Consult ``site`` with an array in flight; returns it (possibly
    corrupted/poisoned -- always a copy when modified)."""
    ap = _active_plan
    if ap is None:
        return arr
    return _apply(ap, site, key, ctx, arr)


def _apply(ap: _Active, site: str, key, ctx, arr):
    if key is None:
        key = getattr(_scope, "key", None)
    attempt = ap.next_attempt(site, key)
    seed = ap.plan.seed
    for f in ap.plan.faults_at(site):
        if not f.fires(key, attempt, ctx):
            continue
        ap.fired.append((site, key, attempt, f.kind))
        obs_metrics.inc("faults_injected_total", site=site, kind=f.kind)
        obs_trace.instant(
            "resil/fault", site=site, kind=f.kind, key=str(key),
            attempt=attempt,
        )
        if f.kind == "slow":
            time.sleep(f.delay_s)
        elif f.kind in _RAISES:
            raise _RAISES[f.kind](
                f"injected {f.kind} at {site} (key={key!r}, "
                f"attempt={attempt})"
            )
        elif f.kind == "corrupt" and arr is not None:
            arr = _flip(seed, site, key, attempt, arr, f.flip_bytes)
        elif f.kind == "nonfinite" and arr is not None:
            arr = _poison(seed, site, key, attempt, arr)
    return arr


def _flip(seed, site, key, attempt, arr, nbytes: int):
    """Bit-flip ``nbytes`` deterministically chosen bytes of a copy."""
    out = np.array(arr)  # contiguous copy; never mutate the caller's
    buf = out.view(np.uint8).reshape(-1)
    for i in range(nbytes):
        pos = int(hash01(seed, site, key, attempt, i) * buf.size)
        buf[pos % buf.size] ^= 0xFF
    return out

def _poison(seed, site, key, attempt, arr):
    """NaN one deterministically chosen element of a float copy."""
    out = np.array(arr)
    flat = out.reshape(-1)
    flat[int(hash01(seed, site, key, attempt) * flat.size) % flat.size] \
        = np.nan
    return out
