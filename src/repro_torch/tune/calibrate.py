"""Calibrate the per-copy issue overhead of the window staging.

The port's counterpart of the reference's ``calibrate_per_copy_overhead``
(``benchmarks/bench_spmm.py``): the same contig-against-strided
micro-sweep, through the port's ``kernels.ops.apply_operator`` -- the
class-sorted kernel, row 1 -- on the card, timed with CUDA events.  Its
result is what ``kernels.traffic.dma_issue_seconds`` multiplies: seconds
per *modeled* issue (``ops.dma_issue_count``, one per run-length
segment).  Row 1 turns a modeled issue into one ``cp.async.bulk`` where
the segment's rows span 256 B or more, and otherwise into one 16-byte
``cp.async`` per 16 bytes; at the sweep's F=8 half-precision rows (16 B
a row) the strided table's length-1 segments are one ``cp.async`` each,
the contiguous table's long runs one bulk copy each.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.recon import resolve_device
from ..kernels.ops import (
    apply_operator,
    dma_issue_count,
    sort_segments_by_class,
    winmap_segments,
)
from ..kernels.traffic import spmm_traffic

__all__ = ["calibrate_per_copy_overhead"]


def _seconds(fn, reps: int, device: torch.device) -> float:
    """Seconds per call: CUDA events around ``reps`` launches on the card
    (after a warm-up), the median host time of ``reps`` calls on the
    CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def calibrate_per_copy_overhead(
    device=None, *, buf: int = 256, b: int = 4096, s: int = 2, r: int = 32,
    k: int = 32, f: int = 8, reps: int = 50,
) -> dict:
    """Measure the per-copy issue overhead with a controlled micro-sweep.

    Two synthetic winmaps with IDENTICAL shape and byte volume but
    opposite run structure drive the same kernel: ``contig`` (arange ->
    one run a stage) vs ``strided`` (lo/hi interleave -> every run is
    length 1, BUF issues per window).  Same bytes moved, so the time
    delta divided by the issue-count delta isolates the fixed cost of
    issuing one copy:

        per_copy_overhead = (t_hi - t_lo) / (issues_hi - issues_lo)

    ``device`` defaults to ``cuda`` (a missing card raises).  On the card
    the result is tagged ``overhead_source="measured"``.  On the CPU the
    kernel's plain version runs, which issues no copy at all: the number
    is still returned (the calibration plumbing runs end to end) but
    tagged ``"measured-interpret"``, as the reference tags its Pallas
    interpret mode, and the traffic model is told so
    (``spmm_traffic(..., interpret_timed=True)`` warns).  The defaults
    size the sweep for the card (B=4096 row-blocks, so the delta stands
    above launch noise); tests on the CPU pass small shapes.

    Returns a dict with ``per_copy_overhead_s``, ``overhead_source``,
    and the raw sweep points (``{contig,strided}_{issues,seconds}``).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    inds = torch.from_numpy(
        rng.integers(0, buf, size=(b, s, r, k)).astype(np.int16)).to(dev)
    vals = torch.from_numpy(
        rng.random(size=(b, s, r, k)).astype(np.float16)).to(dev)
    x = torch.from_numpy(
        rng.normal(size=(buf, f)).astype(np.float16)).to(dev)
    contig = np.broadcast_to(
        np.arange(buf, dtype=np.int32), (b, s, buf)).copy()
    half = buf // 2
    strided = np.empty(buf, np.int32)
    strided[0::2] = np.arange(half, dtype=np.int32)
    strided[1::2] = half + np.arange(buf - half, dtype=np.int32)
    strided = np.broadcast_to(strided, (b, s, buf)).copy()
    pts = {}
    for tag, wm in (("contig", contig), ("strided", strided)):
        segs, off = sort_segments_by_class(winmap_segments(wm), buf)
        w, sg, so = (torch.from_numpy(a).to(dev) for a in (wm, segs, off))

        def call(w=w, sg=sg, so=so):
            return apply_operator(inds, vals, w, x, staging="fused",
                                  dma="coalesced", winsegs=sg, segoff=so)

        pts[tag] = {
            "issues": dma_issue_count(segs),
            "seconds": _seconds(call, reps, dev),
        }
    d_issues = pts["strided"]["issues"] - pts["contig"]["issues"]
    d_t = pts["strided"]["seconds"] - pts["contig"]["seconds"]
    overhead = max(d_t, 0.0) / max(d_issues, 1)
    interpret = dev.type != "cuda"
    if interpret:
        # fires the shared model's warning once per calibration: these
        # seconds must not rank dma modes
        spmm_traffic(b, s, r, k, buf, f, interpret_timed=True)
    return {
        "per_copy_overhead_s": float(overhead),
        "overhead_source": "measured-interpret" if interpret else "measured",
        **{f"{t}_{m}": pts[t][m] for t in pts for m in pts[t]},
    }
