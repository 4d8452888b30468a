"""repro_torch.obs: unified tracing + metrics spine (the port's copy of
the reference's ``repro.obs``, without ``drift``).

* :mod:`~repro_torch.obs.trace` -- nestable, thread-aware spans on one
  monotonic clock (``with span("recon/solve", iters=30): ...``);
  ``Span.fence`` waits for the CUDA devices of a tensor.
* :mod:`~repro_torch.obs.metrics` -- counters / gauges / histograms with
  a Prometheus text exposition.
* :mod:`~repro_torch.obs.export` -- Chrome trace-event JSON (Perfetto) +
  schema validation against the packaged ``chrome_trace.schema.json``.

The modeled-vs-measured drift report waits for the H100 hardware table
and the comm-volume model it joins spans against (ROADMAP.md queue 1).
"""
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
]
