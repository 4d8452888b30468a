"""repro_torch.obs: unified tracing + metrics spine (the port's copy of
the reference's ``repro.obs``).

* :mod:`~repro_torch.obs.trace` -- nestable, thread-aware spans on one
  monotonic clock (``with span("recon/solve", iters=30): ...``);
  ``Span.fence`` waits for the CUDA devices of a tensor; while
  ``torch.profiler`` records, spans and the solve's phase ranges
  (``with range("solve/dot"): ...``) are profiler ranges too.
* :mod:`~repro_torch.obs.metrics` -- counters / gauges / histograms with
  a Prometheus text exposition.
* :mod:`~repro_torch.obs.export` -- Chrome trace-event JSON (Perfetto) +
  schema validation against the packaged ``chrome_trace.schema.json``.
* :mod:`~repro_torch.obs.drift` -- modeled-vs-measured per-phase drift
  report joining span totals against the traffic / comm-volume models,
  priced with the H100's rates.
"""
from .drift import drift_report, measured_phases, modeled_phases
from .export import (
    chrome_trace,
    load_schema,
    validate_chrome_trace,
    write_chrome_trace,
)
from .metrics import Metrics, get_metrics, set_metrics
from .trace import (
    Span,
    Tracer,
    disable,
    enable,
    get_tracer,
    instant,
    range,  # not in __all__, which names the reference package's exports
    set_tracer,
    span,
)

__all__ = [
    "Span",
    "Tracer",
    "get_tracer",
    "set_tracer",
    "enable",
    "disable",
    "span",
    "instant",
    "Metrics",
    "get_metrics",
    "set_metrics",
    "chrome_trace",
    "write_chrome_trace",
    "load_schema",
    "validate_chrome_trace",
    "drift_report",
    "measured_phases",
    "modeled_phases",
]
