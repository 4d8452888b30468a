"""Per-key circuit breaker (closed -> open -> half-open -> closed); the
port's copy of the reference's ``resil/circuit.py``.

Guards expensive, shared build paths -- the serve plan cache's cold
``build_plan`` + ``Reconstructor`` jit -- from being hammered by a
poison key: after ``threshold`` consecutive failures the key's circuit
*opens* and callers are turned away instantly (the server maps that to
a terminal ``rejected_circuit`` job status) until ``cooldown_s``
elapses, when one *half-open* probe is let through.  A probe success
closes the circuit; a probe failure re-opens it for another cooldown.

The clock is injectable so the state machine is testable (and
doc-testable) without sleeping:

>>> t = {"now": 0.0}
>>> cb = CircuitBreaker(threshold=2, cooldown_s=30.0,
...                     clock=lambda: t["now"])
>>> cb.allow("plan-a")
True
>>> cb.record_failure("plan-a"); cb.state("plan-a")
'closed'
>>> cb.record_failure("plan-a"); cb.state("plan-a")  # trips at 2
'open'
>>> cb.allow("plan-a")
False
>>> t["now"] = 31.0
>>> cb.state("plan-a"), cb.allow("plan-a")  # cooldown over: one probe
('half_open', True)
>>> cb.record_success("plan-a"); cb.state("plan-a")
'closed'
"""
from __future__ import annotations

import threading
import time
from typing import Callable

__all__ = ["CircuitBreaker"]


class CircuitBreaker:
    """Consecutive-failure breaker with cooldown, one circuit per key."""

    def __init__(
        self,
        threshold: int = 3,
        cooldown_s: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._fails: dict = {}  # key -> consecutive failures
        self._open_until: dict = {}  # key -> cooldown deadline
        self._lock = threading.Lock()

    def _state(self, key, now: float) -> str:
        if key in self._open_until:
            return "open" if now < self._open_until[key] else "half_open"
        return "closed"

    def state(self, key) -> str:
        with self._lock:
            return self._state(key, self._clock())

    def allow(self, key) -> bool:
        """May a caller attempt this key right now?"""
        with self._lock:
            return self._state(key, self._clock()) != "open"

    def record_failure(self, key) -> None:
        with self._lock:
            n = self._fails.get(key, 0) + 1
            self._fails[key] = n
            # trips at threshold; a failed half-open probe (already past
            # it) re-opens for another cooldown
            if n >= self.threshold:
                self._open_until[key] = self._clock() + self.cooldown_s

    def record_success(self, key) -> None:
        with self._lock:
            self._fails.pop(key, None)
            self._open_until.pop(key, None)
