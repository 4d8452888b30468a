"""Zero-dependency span tracer: the timing spine of the port.

The port's copy of the reference's ``obs/trace.py``.  The solve's host
paths -- ``Reconstructor.stage_sino`` (``recon/stage``) and
``Reconstructor.reconstruct`` (``recon/x0``, ``recon/solve``,
``recon/unpack``, ``recon/download``) -- time themselves through
:func:`span` instead of ad-hoc ``time.perf_counter()`` pairs, so one run
produces one coherent, nestable, thread-aware timeline on one monotonic
clock.  Design rules, as in the reference:

* **Spans always measure, the tracer optionally records.**  A
  :class:`Span` reads the clock on enter/exit regardless of tracing
  state, but the finished event is appended to the tracer only while
  :func:`enable` is active -- with tracing off the cost is two clock
  reads per span, on paths that run once per solve, never per kernel.
* **Thread-aware lanes.**  Events carry the recording thread plus an
  optional explicit ``lane=``.
* **Nesting is tracked, not inferred.**  Each event records its
  ``depth`` and ``parent`` span name (per-thread stack).
* **Deterministic under a fake clock.**  ``Tracer(clock=...)`` injects
  the time source; tests assert exact timestamps with no ``time.*``
  calls (``tests/test_torch_obs_resil.py``).
* **Device-true timings on demand.**  ``Span.fence(value)`` synchronizes
  the CUDA devices of the tensors in ``value``, so work queued on any of
  their streams (the pipeline's side streams included) cannot end a
  span early; CPU tensors and other values need no wait.
* **One clock with the device trace.**  While ``torch.profiler`` is
  recording, a span also opens a ``record_function`` range of its name,
  so the profiler's trace holds the program's spans beside the kernels
  they launched (whether the tracer records or not).  :func:`range`
  names the solve's phases for the profiler alone: an enqueue's host
  time is not its work's time, so those never reach the tracer.  With
  the profiler off either costs one flag read.

Doctest -- nesting, fake clock, exact math:

>>> t = Tracer(enabled=True, clock=iter([0, 1, 2, 3]).__next__)
>>> with t.span("stream/slab", slab=0):
...     with t.span("stream/solve") as sp:
...         pass
>>> [(e["name"], e["t0"], e["t1"], e["parent"]) for e in t.events]
[('stream/solve', 1, 2, 'stream/slab'), ('stream/slab', 0, 3, None)]
>>> sp.duration_s
1
"""
from __future__ import annotations

import contextlib
import sys
import threading

__all__ = [
    "Span",
    "Tracer",
    "get_tracer",
    "set_tracer",
    "enable",
    "disable",
    "span",
    "instant",
    "range",
    "reset",
]


def _default_clock():
    import time

    return time.perf_counter()


def _profiling() -> bool:
    """Whether ``torch.profiler`` is recording (never, before ``torch``
    is imported)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


class Span:
    """One timed region.  Use as a context manager; read ``duration_s``
    after exit.  An exception propagating through the span is recorded
    in its attrs as ``exception=<type name>`` (the failing span names
    what killed it).  While the profiler records, the span is also a
    ``record_function`` range of its name, closed on any exit."""

    __slots__ = ("name", "attrs", "lane", "t0", "t1", "_tracer", "_range")

    def __init__(self, tracer: "Tracer", name: str, lane, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.lane = lane
        self.attrs = attrs
        self.t0 = None
        self.t1 = None
        self._range = None

    @property
    def duration_s(self):
        """Wall seconds between enter and exit (``None`` while open)."""
        if self.t0 is None or self.t1 is None:
            return None
        return self.t1 - self.t0

    def fence(self, value):
        """Block until the device work behind ``value`` lands (device-true
        span ends): every CUDA device of the tensors in ``value`` (a
        tensor, or lists, tuples and dict values of them) is
        synchronized, every stream of it.  Returns ``value``."""
        import torch

        devices = set()
        stack = [value]
        while stack:
            v = stack.pop()
            if isinstance(v, torch.Tensor):
                if v.device.type == "cuda":
                    devices.add(v.device)
            elif isinstance(v, (list, tuple)):
                stack.extend(v)
            elif isinstance(v, dict):
                stack.extend(v.values())
        for d in devices:
            torch.cuda.synchronize(d)
        return value

    def __enter__(self):
        if _profiling():
            from torch.autograd.profiler import record_function

            self._range = record_function(self.name)
            self._range.__enter__()
        self.t0 = self._tracer._clock()
        self._tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.attrs["exception"] = exc_type.__name__
        self.t1 = self._tracer._clock()
        self._tracer._pop(self)
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        return False


class Tracer:
    """Collects finished spans + instants; exported by ``obs.export``.

    Args:
      enabled: record events (spans still *measure* when ``False``).
      clock: monotonic-seconds callable (default ``time.perf_counter``;
        inject a fake for deterministic tests).
    """

    def __init__(self, enabled: bool = False, clock=None):
        self.enabled = bool(enabled)
        self._clock = clock or _default_clock
        self._lock = threading.Lock()
        self._local = threading.local()
        self.events: list[dict] = []

    # ------------------------------------------------------------------ #
    # recording
    # ------------------------------------------------------------------ #
    def span(self, name: str, *, lane: str | None = None, **attrs) -> Span:
        """A nestable timed region; see :class:`Span`."""
        return Span(self, name, lane, attrs)

    def instant(self, name: str, *, lane: str | None = None, **attrs):
        """A zero-duration marker event (Chrome ``ph="i"``): annotations
        like the modeled exchange volumes a solve just implied."""
        if not self.enabled:
            return
        now = self._clock()
        th = threading.current_thread()
        with self._lock:
            self.events.append(
                {
                    "name": name,
                    "t0": now,
                    "t1": now,
                    "lane": lane,
                    "thread": th.name,
                    "thread_id": th.ident,
                    "depth": len(self._stack()),
                    "parent": self._stack()[-1].name
                    if self._stack() else None,
                    "attrs": dict(attrs),
                    "kind": "instant",
                }
            )

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, sp: Span):
        if self.enabled:
            self._stack().append(sp)

    def _pop(self, sp: Span):
        if not self.enabled:
            return
        st = self._stack()
        parent = None
        if st and st[-1] is sp:
            st.pop()
            parent = st[-1].name if st else None
        th = threading.current_thread()
        with self._lock:
            self.events.append(
                {
                    "name": sp.name,
                    "t0": sp.t0,
                    "t1": sp.t1,
                    "lane": sp.lane,
                    "thread": th.name,
                    "thread_id": th.ident,
                    "depth": len(st),
                    "parent": parent,
                    "attrs": dict(sp.attrs),
                    "kind": "span",
                }
            )

    # ------------------------------------------------------------------ #
    # interrogation
    # ------------------------------------------------------------------ #
    def spans(self, name: str | None = None) -> list[dict]:
        """Finished span events (optionally filtered by exact name)."""
        with self._lock:
            evs = [e for e in self.events if e["kind"] == "span"]
        if name is not None:
            evs = [e for e in evs if e["name"] == name]
        return evs

    def total_s(self, name: str) -> float:
        """Summed duration of every span with ``name``."""
        return sum(e["t1"] - e["t0"] for e in self.spans(name))

    def reset(self):
        with self._lock:
            self.events.clear()


# --------------------------------------------------------------------- #
# the process-default tracer (what the instrumented hot paths use)
# --------------------------------------------------------------------- #
_tracer = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-default tracer (tests); returns the old one."""
    global _tracer
    old, _tracer = _tracer, tracer
    return old


def enable(clock=None) -> Tracer:
    """Turn on recording on the default tracer (fresh event list)."""
    global _tracer
    _tracer = Tracer(enabled=True, clock=clock)
    return _tracer


def disable() -> Tracer:
    """Stop recording (spans keep measuring for their callers)."""
    _tracer.enabled = False
    return _tracer


def reset():
    _tracer.reset()


def span(name: str, *, lane: str | None = None, **attrs) -> Span:
    """A span on the process-default tracer (the instrumentation entry
    point: ``with span("stream/solve", slab=j0) as sp: ...``)."""
    return _tracer.span(name, lane=lane, **attrs)


def instant(name: str, *, lane: str | None = None, **attrs):
    """An instant marker on the process-default tracer."""
    _tracer.instant(name, lane=lane, **attrs)


_NO_RANGE = contextlib.nullcontext()


def range(name: str):  # noqa: A001 (the builtin is not used in this module)
    """A ``record_function`` range named ``name`` while ``torch.profiler``
    records, else one shared no-op context manager (no allocation, no
    clock read).  Never recorded by the tracer: it names the device work
    that the code inside enqueues (``with range("solve/dot"): ...``)."""
    if not _profiling():
        return _NO_RANGE
    from torch.autograd.profiler import record_function

    return record_function(name)
