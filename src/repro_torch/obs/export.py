"""Exporters: Chrome trace-event JSON (Perfetto) + schema validation.

``chrome_trace`` (the port's copy of the reference's ``obs/export.py``)
turns a :class:`~repro_torch.obs.trace.Tracer`'s events into
the Chrome trace-event JSON format (the ``{"traceEvents": [...]}``
object form), which https://ui.perfetto.dev loads directly:

* spans become complete events (``ph="X"``, ``ts``/``dur`` in
  microseconds, timestamps rebased to the earliest event so traces are
  origin-independent);
* instants become ``ph="i"`` markers;
* lanes become Chrome *threads*: one ``tid`` per recording thread by
  default, or per explicit ``lane=``,
  each named by a ``ph="M"`` ``thread_name`` metadata event and sorted
  deterministically.

``validate_chrome_trace`` checks a document against the checked-in
schema ``chrome_trace.schema.json`` with a dependency-free subset
validator (type / required / properties / items / enum / minimum),
plus the semantic rule a type-level schema cannot express: every
``"X"`` event must carry ``ts`` and ``dur``.  ``launch/recon.py
--trace`` writes with :func:`write_chrome_trace`, and
``tests/test_torch_obs_resil.py`` validates what it writes.
"""
from __future__ import annotations

import json
import os

from .trace import Tracer

__all__ = [
    "chrome_trace",
    "write_chrome_trace",
    "load_schema",
    "validate_chrome_trace",
    "SchemaError",
]

SCHEMA_PATH = os.path.join(
    os.path.dirname(__file__), "chrome_trace.schema.json"
)


def chrome_trace(tracer: Tracer) -> dict:
    """Tracer events -> Chrome trace-event JSON object (Perfetto-ready)."""
    with tracer._lock:
        events = list(tracer.events)
    lanes: dict[str, int] = {}

    def lane_of(e) -> str:
        return e["lane"] if e["lane"] is not None else (
            f"{e['thread']} ({e['thread_id']})"
        )

    for e in events:
        lanes.setdefault(lane_of(e), 0)
    for i, name in enumerate(sorted(lanes), start=1):
        lanes[name] = i
    t_origin = min((e["t0"] for e in events), default=0.0)

    out: list[dict] = []
    for name in sorted(lanes):
        out.append(
            {
                "ph": "M",
                "pid": 1,
                "tid": lanes[name],
                "name": "thread_name",
                "args": {"name": name},
            }
        )
    for e in events:
        args = dict(e["attrs"])
        if e["parent"] is not None:
            args["parent"] = e["parent"]
        rec = {
            "pid": 1,
            "tid": lanes[lane_of(e)],
            "name": e["name"],
            "cat": e["name"].split("/", 1)[0],
            "ts": (e["t0"] - t_origin) * 1e6,
            "args": args,
        }
        if e["kind"] == "instant":
            rec["ph"] = "i"
            rec["s"] = "t"
        else:
            rec["ph"] = "X"
            rec["dur"] = (e["t1"] - e["t0"]) * 1e6
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, tracer: Tracer | None = None) -> str:
    """Serialize the tracer (default: process tracer) to ``path``."""
    if tracer is None:
        from .trace import get_tracer

        tracer = get_tracer()
    doc = chrome_trace(tracer)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return path


# --------------------------------------------------------------------- #
# schema validation (dependency-free subset of JSON Schema)
# --------------------------------------------------------------------- #
class SchemaError(ValueError):
    """A document does not satisfy the trace schema."""


def load_schema(path: str | None = None) -> dict:
    with open(path or SCHEMA_PATH) as f:
        return json.load(f)


_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "number": (int, float),
    "integer": int,
    "boolean": bool,
}


def _check(doc, schema: dict, where: str):
    typ = schema.get("type")
    if typ is not None:
        py = _TYPES[typ]
        ok = isinstance(doc, py) and not (
            typ in ("number", "integer") and isinstance(doc, bool)
        )
        if not ok:
            raise SchemaError(f"{where}: expected {typ}, got "
                              f"{type(doc).__name__}")
    if "enum" in schema and doc not in schema["enum"]:
        raise SchemaError(f"{where}: {doc!r} not in {schema['enum']}")
    if "minimum" in schema and isinstance(doc, (int, float)) \
            and not isinstance(doc, bool) and doc < schema["minimum"]:
        raise SchemaError(f"{where}: {doc} < minimum "
                          f"{schema['minimum']}")
    if isinstance(doc, dict):
        for req in schema.get("required", ()):
            if req not in doc:
                raise SchemaError(f"{where}: missing required key "
                                  f"{req!r}")
        for key, sub in schema.get("properties", {}).items():
            if key in doc:
                _check(doc[key], sub, f"{where}.{key}")
    if isinstance(doc, list) and "items" in schema:
        for i, item in enumerate(doc):
            _check(item, schema["items"], f"{where}[{i}]")


def validate_chrome_trace(doc: dict, schema: dict | None = None):
    """Raise :class:`SchemaError` unless ``doc`` satisfies the checked-in
    trace schema + the X-events-carry-ts/dur semantic rule.  Returns
    ``doc`` so calls chain."""
    _check(doc, schema or load_schema(), "$")
    for i, e in enumerate(doc.get("traceEvents", [])):
        if e.get("ph") == "X" and ("ts" not in e or "dur" not in e):
            raise SchemaError(
                f"$.traceEvents[{i}]: complete event missing ts/dur"
            )
        if e.get("ph") == "i" and "ts" not in e:
            raise SchemaError(
                f"$.traceEvents[{i}]: instant event missing ts"
            )
    return doc
