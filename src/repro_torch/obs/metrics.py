"""Metrics registry: counters / gauges / histograms + Prometheus text.

The numeric side of the observability spine (the port's copy of the
reference's ``obs/metrics.py``): where :mod:`~repro_torch.obs.trace`
answers *when*, this answers *how much*.  Zero dependencies; label sets
are plain kwargs; rendering follows the Prometheus text exposition format
(``# TYPE`` headers, sorted series, so two identical registries render
byte-identical text).  In the port the fault injector bumps
``faults_injected_total{site,kind}`` and the retry loop
``retries_total{site}``.

Doctest -- deterministic exposition:

>>> m = Metrics()
>>> m.inc("jobs_total", 2, status="done")
>>> m.inc("jobs_total", status="failed")
>>> m.set_gauge("queue_depth", 3)
>>> m.observe("solve_seconds", 0.5, buckets=(0.1, 1.0))
>>> print(m.render_prometheus())
# TYPE jobs_total counter
jobs_total{status="done"} 2
jobs_total{status="failed"} 1
# TYPE queue_depth gauge
queue_depth 3
# TYPE solve_seconds histogram
solve_seconds_bucket{le="0.1"} 0
solve_seconds_bucket{le="1"} 1
solve_seconds_bucket{le="+Inf"} 1
solve_seconds_sum 0.5
solve_seconds_count 1
"""
from __future__ import annotations

import threading

__all__ = [
    "Metrics",
    "get_metrics",
    "set_metrics",
    "inc",
    "set_gauge",
    "observe",
    "render_prometheus",
    "reset",
]

DEFAULT_BUCKETS = (0.001, 0.01, 0.1, 1.0, 10.0, 60.0)


def _fmt(v: float) -> str:
    """Prometheus-style number: integers without the trailing ``.0``."""
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def _key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _series(name: str, labels: tuple) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class Metrics:
    """A registry of counters, gauges and histograms (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> {label key tuple -> value}
        self._counters: dict[str, dict] = {}
        self._gauges: dict[str, dict] = {}
        # name -> {label key tuple -> {"buckets": tuple, "counts": list,
        #                              "sum": float, "count": int}}
        self._hists: dict[str, dict] = {}

    # ------------------------------------------------------------------ #
    # writes
    # ------------------------------------------------------------------ #
    def inc(self, name: str, value: float = 1.0, **labels):
        """Add ``value`` (>= 0) to the counter series."""
        if value < 0:
            raise ValueError(f"counter {name} cannot decrease ({value})")
        with self._lock:
            s = self._counters.setdefault(name, {})
            k = _key(labels)
            s[k] = s.get(k, 0.0) + float(value)

    def set_gauge(self, name: str, value: float, **labels):
        with self._lock:
            self._gauges.setdefault(name, {})[_key(labels)] = float(value)

    def observe(self, name: str, value: float, buckets=None, **labels):
        """Record one observation into the histogram series.  ``buckets``
        are upper bounds (ascending); fixed per series at first use."""
        with self._lock:
            s = self._hists.setdefault(name, {})
            k = _key(labels)
            h = s.get(k)
            if h is None:
                bs = tuple(buckets if buckets is not None
                           else DEFAULT_BUCKETS)
                h = s[k] = {"buckets": bs, "counts": [0] * len(bs),
                            "sum": 0.0, "count": 0}
            v = float(value)
            for i, ub in enumerate(h["buckets"]):
                if v <= ub:
                    h["counts"][i] += 1
            h["sum"] += v
            h["count"] += 1

    # ------------------------------------------------------------------ #
    # reads
    # ------------------------------------------------------------------ #
    def get(self, name: str, **labels) -> float:
        """Current value of a counter or gauge series (0 if unseen)."""
        k = _key(labels)
        with self._lock:
            if name in self._counters:
                return self._counters[name].get(k, 0.0)
            if name in self._gauges:
                return self._gauges[name].get(k, 0.0)
        return 0.0

    def snapshot(self) -> dict:
        """Plain-dict copy: ``{"counters": {series: v}, "gauges": ...}``
        (series rendered as the Prometheus sample name)."""
        with self._lock:
            out = {"counters": {}, "gauges": {}, "histograms": {}}
            for name, s in self._counters.items():
                for k, v in s.items():
                    out["counters"][_series(name, k)] = v
            for name, s in self._gauges.items():
                for k, v in s.items():
                    out["gauges"][_series(name, k)] = v
            for name, s in self._hists.items():
                for k, h in s.items():
                    out["histograms"][_series(name, k)] = {
                        "sum": h["sum"], "count": h["count"],
                    }
            return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (sorted: byte-deterministic)."""
        lines: list[str] = []
        with self._lock:
            for name in sorted(self._counters):
                lines.append(f"# TYPE {name} counter")
                for k in sorted(self._counters[name]):
                    lines.append(
                        f"{_series(name, k)} "
                        f"{_fmt(self._counters[name][k])}"
                    )
            for name in sorted(self._gauges):
                lines.append(f"# TYPE {name} gauge")
                for k in sorted(self._gauges[name]):
                    lines.append(
                        f"{_series(name, k)} "
                        f"{_fmt(self._gauges[name][k])}"
                    )
            for name in sorted(self._hists):
                lines.append(f"# TYPE {name} histogram")
                for k in sorted(self._hists[name]):
                    h = self._hists[name][k]
                    # counts are already cumulative (observe increments
                    # every bucket whose upper bound admits the value)
                    for ub, c in zip(h["buckets"], h["counts"]):
                        lines.append(
                            f"{_series(name + '_bucket', k + (('le', _fmt(ub)),))} {c}"
                        )
                    lines.append(
                        f"{_series(name + '_bucket', k + (('le', '+Inf'),))} "
                        f"{h['count']}"
                    )
                    lines.append(
                        f"{_series(name + '_sum', k)} {_fmt(h['sum'])}"
                    )
                    lines.append(
                        f"{_series(name + '_count', k)} {h['count']}"
                    )
        return "\n".join(lines)

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


_metrics = Metrics()


def get_metrics() -> Metrics:
    return _metrics


def set_metrics(metrics: Metrics) -> Metrics:
    """Swap the process-default registry (tests); returns the old one."""
    global _metrics
    old, _metrics = _metrics, metrics
    return old


def inc(name: str, value: float = 1.0, **labels):
    _metrics.inc(name, value, **labels)


def set_gauge(name: str, value: float, **labels):
    _metrics.set_gauge(name, value, **labels)


def observe(name: str, value: float, buckets=None, **labels):
    _metrics.observe(name, value, buckets=buckets, **labels)


def render_prometheus() -> str:
    return _metrics.render_prometheus()


def reset():
    _metrics.reset()
