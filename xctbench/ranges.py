"""What the program's spans and ranges say: the staging layer's spans in
the window, and the device time of the solve's phases in the profiler
trace.

The program (``repro_torch.obs.trace``) names its host steps with spans
(``recon/stage``, ``recon/x0``, ``recon/solve``, ``recon/download``,
``recon/unpack``), which the tracer records and which are profiler
ranges while ``torch.profiler`` records, and the solve's phases with
profiler ranges alone (``solve/spmm``, ``solve/reduce``,
``solve/scale``, ``solve/dot``, ``solve/update``).

A device operation (kernel, copy, fill) of the trace belongs to the
range that launched it: the runtime call with the same
``args.correlation``, and on that call's thread the innermost
``user_annotation`` named ``solve/*`` or ``recon/*`` open at the call's
start.  An operation whose launch is not in the trace belongs to none.
The stretch read is ``devtrace``'s: the first to the last
``xctbench/solve`` marker.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import sys
from collections import defaultdict
from pathlib import Path

from .devtrace import _DEVICE, _HOST_COPY, MARKER, SPMM, union

__all__ = ["PREFIXES", "Op", "ops", "run_ops", "span_ms",
           "phase_ms_per_iter", "hidden_share", "summary"]

PREFIXES = ("solve/", "recon/")
_LAUNCH = ("cuda_runtime", "cuda_driver")
_TOP = 5


@dataclasses.dataclass(frozen=True)
class Op:
    """One device operation of the profiled stretch (times in us)."""

    ts: float
    dur: float
    name: str
    cat: str
    stream: int | None
    owner: str | None  # the range that launched it

    @property
    def spmm(self) -> bool:
        return self.cat == "kernel" and SPMM in self.name

    @property
    def glue(self) -> bool:
        """What ``glue_ms_per_iter`` counts: neither an SpMM kernel nor
        a copy between host and device."""
        return not self.spmm and not (self.cat == "gpu_memcpy" and any(
            k in self.name for k in _HOST_COPY))


def _owners(annotations, launches) -> dict:
    """``{launch index: innermost open range}`` for one thread:
    ``annotations`` ``(start, end, name)`` properly nested,
    ``launches`` ``(start, index)``."""
    annotations = sorted(annotations, key=lambda a: (a[0], -a[1]))
    out, open_, k = {}, [], 0
    for t, i in sorted(launches):
        while k < len(annotations) and annotations[k][0] <= t:
            open_.append(annotations[k])
            k += 1
        # the ranges open at t, outermost first: the last started is the
        # innermost
        open_ = [a for a in open_ if a[1] >= t]
        out[i] = open_[-1][2] if open_ else None
    return out


@functools.lru_cache(maxsize=2)
def _parse(path: str, mtime_ns: int, size: int):
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    solves = [e for e in events if e.get("name") == MARKER
              and e.get("cat") == "user_annotation"]
    if not solves:
        return None
    w0 = min(e["ts"] for e in solves)
    w1 = max(e["ts"] + e["dur"] for e in solves)
    work = [e for e in events if e.get("cat") in _DEVICE
            and w0 <= e["ts"] < w1]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in _LAUNCH
              and "correlation" in e.get("args", {})}
    annotations, launches = defaultdict(list), defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and \
                e["name"].startswith(PREFIXES):
            annotations[e.get("pid"), e.get("tid")].append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))
    for i, e in enumerate(work):
        call = launch.get(e.get("args", {}).get("correlation"))
        if call is not None:
            launches[call.get("pid"), call.get("tid")].append((call["ts"], i))
    owner = {}
    for thread, calls in launches.items():
        owner.update(_owners(annotations.get(thread, []), calls))
    return tuple(
        Op(e["ts"], e["dur"], e["name"], e["cat"],
           e.get("args", {}).get("stream"), owner.get(i))
        for i, e in enumerate(work))


def ops(path) -> tuple | None:
    """The device operations of the profiled stretch of the trace at
    ``path``, each with the range that launched it; ``None`` without a
    solve marker.  Parsed once per file as it stands on disk."""
    st = os.stat(path)
    return _parse(str(Path(path).resolve()), st.st_mtime_ns, st.st_size)




def span_ms(run, name: str) -> float | None:
    """Mean milliseconds of the window's ``name`` spans on the program's
    tracer; ``None`` unless there is one for each of the window's calls.

    Relies on the harness's order: it enables the tracer before the
    warm-up and resets it after, and after the window only disables it,
    so the spans are the window's and the profiled calls add none."""
    from repro_torch.obs.trace import get_tracer

    spans = get_tracer().spans(name)
    if not run.calls or len(spans) != len(run.calls):
        return None
    return 1e3 * sum(e["t1"] - e["t0"] for e in spans) / len(spans)


def run_ops(run) -> tuple | None:
    """:func:`ops` of the trace the harness wrote for this run (``None``
    unless this run profiled)."""
    if run.profile is None:
        return None
    path = (run.cell.bench_dir.parent / "build" / "xctbench" / "trace"
            / f"{run.cell.name}.json")
    return ops(path) if path.exists() else None


def phase_ms_per_iter(run, phases) -> float | None:
    """Device milliseconds of the operations launched inside the ranges
    ``phases`` per CG iteration per minibatch, normalized as
    ``glue_ms_per_iter`` is; ``None`` where none was launched there."""
    got = [o for o in run_ops(run) or () if o.owner in phases]
    if not got:
        return None
    cfg = run.cell.config
    minibatches = run.cell.traffic["slab_slices"] // cfg["fuse"]
    return 1e-3 * sum(o.dur for o in got) / (
        run.profile["solves"] * minibatches * cfg["iters"])


def _length(spans) -> float:
    return sum(hi - lo for lo, hi in spans)


def _overlap(a, b) -> float:
    """Length of the intersection of two unions (sorted, disjoint)."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def hidden_share(ops_) -> float | None:
    """Percent of the reduce phase's device time (the union of the
    operations launched inside ``solve/reduce``) during which an SpMM
    kernel also ran; ``None`` where nothing was launched there."""
    mine = union((o.ts, o.ts + o.dur) for o in ops_
                 if o.owner == "solve/reduce")
    if not mine:
        return None
    spmm = union((o.ts, o.ts + o.dur) for o in ops_ if o.spmm)
    return 100.0 * _overlap(mine, spmm) / _length(mine)


def summary(path) -> dict | None:
    """The glue's device seconds by the range that launched it, the
    shares of it inside a ``solve/*`` range and inside any range, the
    busiest operations left outside every ``solve/*`` range, the streams
    of each phase, and the reduce phase's hidden share."""
    got = ops(path)
    if got is None:
        return None
    glue = [o for o in got if o.glue]
    by_owner: dict = defaultdict(float)
    streams: dict = defaultdict(lambda: defaultdict(float))
    rest: dict = defaultdict(float)
    for o in glue:
        by_owner[str(o.owner)] += o.dur / 1e6
        if o.owner is None or not o.owner.startswith("solve/"):
            rest[f"{o.owner}: {o.name}"] += o.dur / 1e6
    for o in got:
        streams[str(o.owner)][str(o.stream)] += o.dur / 1e6
    total = sum(by_owner.values()) or float("nan")
    solve = sum(s for k, s in by_owner.items() if k.startswith("solve/"))
    return dict(
        glue_s=sum(by_owner.values()),
        glue_by_range_s=dict(sorted(by_owner.items())),
        glue_in_solve_ranges=solve / total,
        glue_in_any_range=(total - by_owner.get("None", 0.0)) / total,
        glue_outside_solve_ranges=sorted(rest.items(),
                                         key=lambda kv: -kv[1])[:_TOP],
        streams_by_range_s={k: dict(v) for k, v in sorted(streams.items())},
        reduce_hidden_share=hidden_share(got),
    )


if __name__ == "__main__":
    for p in sys.argv[1:]:
        print(json.dumps({"trace": p, **(summary(p) or {})}, indent=1))
