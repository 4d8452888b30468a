"""One device-memory traffic model for the blocked-ELL SpMM (the port's
copy of the reference's ``kernels/traffic.py``).

It counts what one fused minibatch moves and computes: bytes, FLOPs and
copy issues, a model of the work that holds for any device.  The one
time it carries is :data:`PER_COPY_OVERHEAD_S`, the per-copy issue
overhead measured on the H100 (``tune.calibrate``), which
:func:`dma_issue_seconds` multiplies by the modeled issues.  The stream
scheduler (``stream.scheduler.suggest_slab``) reads it for the modeled
traffic of one slab.

Per minibatch of ``F`` fused slices, one device's shard moves:

  operator     B*S*R*K slots x (2 B index + ``sb`` B value)  -- one pass
  descriptors  what the window staging reads to address its copies:
               B*S*BUF window ids x 4 B (per-row copy path and the
               gather baseline's gather), or B*S*NSEG x 12 B
               ``{src, dst, len}`` segments (coalesced path -- with the
               run-extension slot order NSEG ~ 1.2 BUF**0.6, so this is
               LESS descriptor traffic on top of the issue-count win;
               under the legacy ``slot_order="first_seen"`` layout NSEG
               ~ 0.62 BUF and the segment table was slightly MORE
               descriptor traffic, the price of cutting the issue count;
               both terms are priced honestly)
  window       staging="fused":  B*S*BUF*F*sb  (each window row crosses
               device memory once, copied straight into the kernel's
               shared-memory ring)
               staging="gather": 2 x B*S*BUF*F*sb  (the gather writes
               the [B, S, BUF, F] tensor to device memory, the kernel
               reads it back -- the extra full pass the fused path
               deletes)
  band out     B*R*F x 4 B fp32, written by the kernel and read by the
               reduction scatter

Bytes alone do not price the buffer-load loop: every issued copy also
pays a fixed descriptor/issue overhead, which is why the kernel
coalesces run-length segments (one strided copy per run) instead of
copying row by row.  ``dma_issues`` counts the copies and
:func:`dma_issue_seconds` prices the whole transfer as

    t = issues * per_copy_overhead + bytes / bandwidth

with both rates given by the caller.

Doctest -- the fused path strictly raises arithmetic intensity (the
point of staging windows inside the kernel; both at
``dma="per_row"`` so the descriptor terms match):

>>> g = spmm_traffic(8, 2, 64, 64, 768, 16, storage_bytes=2,
...                  staging="gather", dma="per_row")
>>> u = spmm_traffic(8, 2, 64, 64, 768, 16, storage_bytes=2,
...                  staging="fused", dma="per_row")
>>> u["hbm_bytes"] < g["hbm_bytes"]
True
>>> u["intensity"] > g["intensity"]
True
>>> g["hbm_bytes"] - u["hbm_bytes"] == g["window_bytes"] // 2
True

and coalescing strictly drops the modeled issue count (the point of
the coalesced copies); slot reordering drops it
further still (the point of the run-extension layout):

>>> c = spmm_traffic(8, 2, 64, 64, 768, 16, storage_bytes=2)
>>> c["dma_issues"] < u["dma_issues"]
True
>>> u["dma_issues"] == 8 * 2 * 768.0
True
>>> c["winmap_bytes"] == 8 * 2 * est_segments_per_stage(768) * 12.0
True
>>> legacy = spmm_traffic(8, 2, 64, 64, 768, 16, storage_bytes=2,
...                       slot_order="first_seen")
>>> c["dma_issues"] < legacy["dma_issues"]
True

Quantized operator values (``vals_bytes=1``: int8/fp8 + the int32
per-(block, stage) scale table) shrink the dominant operator stream --
3 B/nnz slot vs 4 B at f16 -- and raise intensity accordingly:

>>> q = spmm_traffic(8, 2, 64, 64, 768, 16, storage_bytes=2,
...                  vals_bytes=1)
>>> q["operator_bytes"] == 8 * 2 * 64 * 64 * 3.0 + 8 * 2 * 4.0
True
>>> q["operator_bytes"] < c["operator_bytes"]
True
>>> q["intensity"] > c["intensity"]
True
"""
from __future__ import annotations

import math

import numpy as np

__all__ = [
    "spmm_traffic",
    "staged_window_bytes",
    "dma_issue_seconds",
    "est_segments_per_stage",
    "op_segments_per_stage",
    "DMA_MODES",
    "PER_COPY_OVERHEAD_S",
]

STAGINGS = ("fused", "gather")
DMA_MODES = ("coalesced", "per_row")

# Seconds per modeled copy issue of the window staging, as throughput over
# the whole card: the median of seven runs of
# tune.calibrate.calibrate_per_copy_overhead (B=4096 row-blocks, F=8
# half-precision rows, one 16-byte cp.async a length-1 segment against
# one cp.async.bulk a stage) on an NVIDIA H100 80GB HBM3 at a power limit
# of 700.00 W.  The reference's 1e-7 s was priced for another device's
# copy engine.
PER_COPY_OVERHEAD_S = 3.22e-11


def staged_window_bytes(s: int, buf: int, f: int,
                        storage_bytes: int) -> int:
    """Transient device-memory bytes of ONE row-block's gathered windows.

    Only the legacy gather path allocates this ``[S, BUF, F]`` tensor
    (per row-block of the scan chunk); the fused kernel's staging lives
    in shared memory (see ``xct_spmm.smem_bytes``).
    """
    return s * buf * f * storage_bytes


def est_segments_per_stage(buf: int, slot_order: str = "runs") -> int:
    """Analytic decomposed-segment count for one stage's window.

    For abstract plans (``estimate_plan``) no winmap exists to run-length
    encode, so the sweeps need a model.  The count depends on the plan's
    ``slot_order`` (see ``core.partition.PartitionConfig``):

    ``"runs"``
        Slots are assigned by greedy run extension over the
        Hilbert-sorted column set, so winmap entries form long
        ``{src, dst, len}`` runs and the segment count grows sublinearly
        with the window: measured means on built plans at n in [32, 64]
        sit on ``~1.2 x BUF**0.6`` (8 plan shapes, BUF 72-424, est/real
        in [0.5, 2] pinned by ``tests/test_kernel_spmm.py::
        test_est_segments_calibrated``).

    ``"first_seen"``
        Legacy CSR-position layout: a stage samples its columns strided
        (slot position, not curve position), so runs stay short --
        measured means are 0.40-0.75 x BUF; the model uses the measured
        mid-band 0.62 x BUF.
    """
    if slot_order == "first_seen":
        return int(min(buf, max(1, math.ceil(0.62 * buf))))
    if slot_order != "runs":
        raise ValueError(
            f"unknown slot_order {slot_order!r}; one of ('runs', 'first_seen')"
        )
    return int(min(buf, max(1, math.ceil(1.2 * buf ** 0.6))))


def op_segments_per_stage(op) -> float | None:
    """Segments-per-stage of an operator shard, for the issue model.

    Real shards carry ``winsegs`` tables (``ops.winmap_segments``): the
    *measured mean* non-pad segment count per stage.  Abstract shards
    (``estimate_plan``, whose leaves are ``core.partition.ShapeSpec``)
    carry only the table shape: its capacity, which came from
    :func:`est_segments_per_stage`.  Returns ``None`` when the
    operator predates the tables (falls back to the analytic model).
    """
    from ..core.partition import ShapeSpec

    ws = getattr(op, "winsegs", None)
    if ws is None:
        return None
    if isinstance(ws, ShapeSpec):  # estimate_plan's abstract leaves
        return float(ws.shape[-2])
    arr = np.asarray(ws)
    if arr.dtype == object or arr.ndim < 2:
        return float(ws.shape[-2])
    return float((arr[..., 2] > 0).sum(axis=-1).mean())


def dma_issue_seconds(
    issues: float,
    bytes_: float,
    bandwidth: float,
    per_copy_overhead: float,
) -> float:
    """Seconds to move ``bytes_`` in ``issues`` async copies:
    ``issues x per_copy_overhead + bytes / bandwidth``.  The first term
    is what run-length coalescing shrinks (issues: B*S*BUF per-row ->
    B*S*NSEG) without touching the second.  Both rates are the caller's
    (the H100's: ``PER_COPY_OVERHEAD_S`` and ``launch.hardware.HW``); an
    overhead of ``None`` (a device not measured) raises."""
    if per_copy_overhead is None:
        raise ValueError(
            "per_copy_overhead is not measured on this device; pass "
            "one (seconds per issued copy)"
        )
    return float(issues) * per_copy_overhead + float(bytes_) / bandwidth


def spmm_traffic(
    b: int,
    s: int,
    r: int,
    k: int,
    buf: int,
    f: int,
    *,
    storage_bytes: int = 2,
    vals_bytes: int | None = None,
    staging: str = "fused",
    dma: str = "coalesced",
    segments_per_stage: float | None = None,
    slot_order: str = "runs",
    interpret_timed: bool = False,
) -> dict:
    """Device-memory bytes + FLOPs of one fused-minibatch SpMM over one
    shard.

    Returns a dict with the per-term byte counts, their sum
    (``hbm_bytes``), the slot FLOPs (``flops`` = 2 per nnz slot per
    slice), the arithmetic intensity (``intensity``, FLOP/B), and the
    DMA issue count of the window staging (``dma_issues``): one copy
    per winmap row (``dma="per_row"``), one per run-length segment
    (``dma="coalesced"``; measured ``segments_per_stage`` from
    ``ops.winmap_segments`` when available, else the analytic
    :func:`est_segments_per_stage` for the plan's ``slot_order``), or
    one window copy per stage for the gather baseline (the gather stages
    its windows in bulk).

    ``vals_bytes`` is the width of the packed operator *values*
    (``Precision.vals_bytes``); ``None`` means same as the vector
    ``storage_bytes`` (every pre-quantization policy).  A 1-byte width
    adds the int32 per-(block, stage) dequantization-scale table to the
    descriptor stream (4 B per stage -- the scales ride scalar
    prefetch, but they still cross device memory once).

    ``interpret_timed=True`` declares that any wall-clock numbers the
    caller plans to compare against this model were taken off the card
    (the plain PyTorch version on the CPU, tagged
    ``"measured-interpret"`` as the reference tags its Pallas interpret
    mode), where no copy is issued at all and a per-copy cost is an
    artifact of the emulation.  The model warns once per call: do not
    RANK dma modes on such timings -- :func:`dma_issue_seconds` over the
    modeled issue counts is the authority (the autotuner's modeled tier
    does exactly that).
    """
    if interpret_timed:
        import warnings

        warnings.warn(
            "spmm_traffic: timings taken off the card (interpret: the "
            "plain PyTorch version) issue no async copies -- per-copy cost "
            "there is an emulation artifact.  Do not rank dma modes on "
            "those timings; use dma_issue_seconds over the modeled issue "
            "counts instead.",
            RuntimeWarning,
            stacklevel=2,
        )
    if staging not in STAGINGS:
        raise ValueError(
            f"unknown staging {staging!r}; one of {STAGINGS}"
        )
    if dma not in DMA_MODES:
        raise ValueError(f"unknown dma {dma!r}; one of {DMA_MODES}")
    slots = float(b) * s * r * k
    win_entries = float(b) * s * buf
    passes = 1 if staging == "fused" else 2
    seg = (
        float(segments_per_stage)
        if segments_per_stage is not None
        else float(est_segments_per_stage(buf, slot_order))
    )
    if staging == "gather":
        issues = float(b) * s  # one [BUF, F] window copy per stage
        desc_bytes = win_entries * 4  # the gather reads the winmap
    elif dma == "per_row":
        issues = win_entries
        desc_bytes = win_entries * 4  # int32 winmap prefetch
    else:
        issues = float(b) * s * seg
        desc_bytes = float(b) * s * seg * 12  # {src, dst, len} int32
    vb = storage_bytes if vals_bytes is None else vals_bytes
    scale_bytes = float(b) * s * 4 if vb == 1 else 0.0
    out = {
        "operator_bytes": slots * (2 + vb) + scale_bytes,
        "winmap_bytes": desc_bytes,
        "window_bytes": win_entries * storage_bytes * f * passes,
        "out_bytes": float(b) * r * f * 4 * 2,
        "flops": 2.0 * slots * f,
        "dma_issues": issues,
    }
    out["hbm_bytes"] = (
        out["operator_bytes"] + out["winmap_bytes"]
        + out["window_bytes"] + out["out_bytes"]
    )
    out["intensity"] = out["flops"] / out["hbm_bytes"]
    return out
