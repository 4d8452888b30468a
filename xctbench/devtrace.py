"""What a profiler trace of a few solves says about the device.

Reads the Chrome trace ``torch.profiler`` exports.  The profiled stretch
runs from the start of the first ``xctbench/solve`` range to the end of
the last.  Device work is every kernel, copy and fill; it overlaps
across streams, so busy time is the length of the union of its
intervals, never their sum.  The copies between host and device (the
sinogram's upload and the volume's download, the staging layer's) are
counted apart from the rest of the device's work.
"""
from __future__ import annotations

import json
from collections import defaultdict

__all__ = ["MARKER", "SPMM", "union", "read_trace"]

MARKER = "xctbench/solve"
SPMM = "xct_spmm"
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_COPY = ("HtoD", "DtoH")  # in the names of host <-> device copies
_HOST = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_TOP = 10


def union(spans) -> list:
    """(start, end) intervals -> their union, sorted and merged."""
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _label(host, t) -> str:
    """The innermost host range open at time ``t`` (what the host was
    doing while the device idled)."""
    best = None
    for lo, hi, name in host:
        if lo > t:
            break
        if hi >= t and (best is None or hi - lo < best[1] - best[0]):
            best = (lo, hi, name)
    return best[2] if best else "host: outside torch ops (NumPy, Python)"


def read_trace(path) -> dict | None:
    """``{window_s, busy_s, spmm_s, copy_s, other_s, device_ops,
    idle_gaps}`` of the profiled stretch, ``None`` when the trace holds no
    solve or no device work.  ``spmm_s`` is the device time of the SpMM
    kernels, ``copy_s`` that of the copies between host and device,
    ``other_s`` that of the rest; ``device_ops`` are the (name, seconds)
    of the busiest device operations, ``idle_gaps`` the longest gaps in
    the device's union, each named by what the host was doing."""
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
    if not work:
        return None
    busy = union((e["ts"], min(e["ts"] + e["dur"], w1)) for e in work)
    spmm = [e for e in work if e.get("cat") == "kernel"
            and SPMM in e["name"]]
    by_name: dict = defaultdict(float)
    for e in work:
        by_name[e["name"]] += e["dur"]
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in _HOST and e.get("name") != MARKER)
    # the idle gaps: (w0, first start), (each end, next start), (last
    # end, w1)
    edges = [w0] + [t for span in busy for t in span] + [w1]
    gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])
    spmm_us = sum(e["dur"] for e in spmm)
    copy_us = sum(e["dur"] for e in work if e.get("cat") == "gpu_memcpy"
                  and any(k in e["name"] for k in _HOST_COPY))
    return dict(
        window_s=(w1 - w0) / 1e6,
        busy_s=sum(hi - lo for lo, hi in busy) / 1e6,
        spmm_s=spmm_us / 1e6,
        copy_s=copy_us / 1e6,
        other_s=(sum(e["dur"] for e in work) - spmm_us - copy_us) / 1e6,
        device_ops=[[name[:200], us / 1e6] for name, us in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:_TOP]],
        idle_gaps=[[_label(host, (lo + hi) / 2)[:200], (hi - lo) / 1e6]
                   for lo, hi in gaps[:_TOP]],
    )
