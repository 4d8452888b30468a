"""Drift detection: join measured span totals against the cost models
(the port's copy of the reference's ``obs/drift.py``, priced with the
H100's rates, ``launch.hardware.HW``).

The repo prices every design decision with closed-form models --
``kernels.traffic.spmm_traffic`` (device-memory bytes + copy issues),
``kernels.traffic.dma_issue_seconds`` (issue overhead),
``launch.xct_perf.comm_volume`` over ``CommPlan.resolve`` (wire bytes by
link class) -- and the autotuner's modeled tier picks configs from them
alone.  This module asks the follow-up question the ROADMAP's *measured
tier* needs answered: **does the wall clock agree?**

:func:`drift_report` joins two sides:

* **measured** -- span totals from :mod:`~repro_torch.obs.trace`, summed per
  phase via the span taxonomy (``stream/solve`` and ``recon/solve`` ->
  ``solve``; ``stream/load`` -> ``load``; ``stream/stage`` /
  ``stream/upload`` / ``recon/stage`` -> ``upload``).  A span nested
  inside a same-phase parent is skipped, so a ``recon/solve`` inside a
  ``stream/solve`` is never double-counted.
* **modeled** -- per-phase seconds from the same models the autotuner
  sums (:func:`modeled_phases`): ``hbm`` (bytes / bandwidth),
  ``dma_issue`` (issues x per-copy overhead -- the calibrated passport
  value when one is given, with its ``overhead_source`` provenance
  recorded in the report), ``exchange_ici`` / ``exchange_dci`` (wire
  bytes / link bandwidth), and their sum ``solve``.

The solve phase is measured directly and flagged when
``measured / modeled`` leaves ``[1/(1+threshold), 1+threshold]``.  One
host span cannot split device time into sub-phases, so the sub-rows
carry their modeled *share* of the measured solve
(``source="attributed"``): the breakdown Perfetto shows next to the
flag, not an independent measurement -- exactly the input a future
``autotune(measure=...)`` wall-clock re-ranking consumes.  ``load`` /
``upload`` have no model yet and are reported measured-only.

Doctest -- deterministic join under a fake clock and injected model:

>>> from .trace import Tracer
>>> t = Tracer(enabled=True, clock=iter([0.0, 2.0, 2.0, 2.5]).__next__)
>>> with t.span("stream/solve"):
...     pass
>>> with t.span("stream/load"):
...     pass
>>> rep = drift_report(t, modeled={"solve": 1.0, "hbm": 0.5,
...                                "dma_issue": 0.3, "exchange_ici": 0.2,
...                                "exchange_dci": 0.0}, threshold=0.5)
>>> solve = rep.row("solve")
>>> (solve.measured_s, solve.modeled_s, solve.ratio, solve.flagged)
(2.0, 1.0, 2.0, True)
>>> rep.row("dma_issue").measured_s  # 0.3 share of the measured 2.0 s
0.6
>>> rep.row("load").measured_s, rep.row("load").modeled_s
(0.5, None)
>>> [r.phase for r in rep.rows if r.flagged]
['solve']
"""
from __future__ import annotations

import dataclasses
import json

from .trace import Tracer

__all__ = [
    "PHASES",
    "SPAN_PHASE",
    "DriftRow",
    "DriftReport",
    "measured_phases",
    "modeled_phases",
    "drift_report",
]

# report rows, in render order: solve first (the directly measured
# total), its modeled decomposition next, the un-modeled staging rungs
# last
PHASES = (
    "solve", "hbm", "dma_issue", "exchange_ici", "exchange_dci",
    "load", "upload",
)

# span name -> phase (the reference's taxonomy)
SPAN_PHASE = {
    "stream/solve": "solve",
    "recon/solve": "solve",
    "serve/solve": "solve",
    "stream/load": "load",
    "serve/load": "load",
    "stream/stage": "upload",
    "stream/upload": "upload",
    "recon/stage": "upload",
}


@dataclasses.dataclass(frozen=True)
class DriftRow:
    """One phase of the modeled-vs-measured join."""

    phase: str
    measured_s: float | None
    modeled_s: float | None
    ratio: float | None  # measured / modeled (None when either missing)
    share: float | None  # modeled share of the solve (sub-phases only)
    source: str | None  # "span" | "attributed" | None (unmeasured)
    flagged: bool


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """Per-phase drift rows + the provenance that priced the model."""

    rows: tuple
    threshold: float
    overhead_source: str
    per_copy_overhead_s: float

    def row(self, phase: str) -> DriftRow:
        for r in self.rows:
            if r.phase == phase:
                return r
        raise KeyError(phase)

    @property
    def flagged(self) -> list:
        return [r for r in self.rows if r.flagged]

    def render(self) -> str:
        """Human-readable table (what ``launch.recon --trace`` prints)."""
        def num(v):
            return "-" if v is None else f"{v:.4g}"

        lines = [
            f"drift report (threshold {self.threshold:g}, per-copy "
            f"overhead {self.per_copy_overhead_s:g}s "
            f"[{self.overhead_source}])",
            f"{'phase':<14}{'measured_s':>12}{'modeled_s':>12}"
            f"{'ratio':>9}  source",
        ]
        for r in self.rows:
            tag = "  DRIFT" if r.flagged else ""
            lines.append(
                f"{r.phase:<14}{num(r.measured_s):>12}"
                f"{num(r.modeled_s):>12}{num(r.ratio):>9}  "
                f"{r.source or '-'}{tag}"
            )
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps(
            {
                "threshold": self.threshold,
                "overhead_source": self.overhead_source,
                "per_copy_overhead_s": self.per_copy_overhead_s,
                "rows": [dataclasses.asdict(r) for r in self.rows],
            },
            indent=1,
            sort_keys=True,
        )


def measured_phases(spans) -> dict:
    """Sum span durations per phase (``Tracer`` or its event list).

    A span whose recorded ``parent`` maps to the same phase is skipped:
    nested same-phase spans (``recon/solve`` inside ``stream/solve``)
    count once, at the outermost level.  Spans carrying a truthy
    ``retry`` attr are skipped too: the models price one attempt per
    slab, so retried attempts (the resilience layer's ``retry=<n>``
    metadata, n >= 1) would inflate the measured side of the join.
    """
    events = spans.spans() if isinstance(spans, Tracer) else [
        e for e in spans if e.get("kind", "span") == "span"
    ]
    out: dict = {}
    for e in events:
        phase = SPAN_PHASE.get(e["name"])
        if phase is None:
            continue
        if SPAN_PHASE.get(e.get("parent")) == phase:
            continue  # same-phase child: already counted by its parent
        if e.get("attrs", {}).get("retry"):
            continue  # a retried attempt: the model prices one try
        out[phase] = out.get(phase, 0.0) + (e["t1"] - e["t0"])
    return out


def modeled_phases(
    rec,
    *,
    iters: int,
    n_slices: int,
    per_copy_overhead_s: float | None = None,
    passport=None,
) -> tuple[dict, dict]:
    """Per-phase modeled seconds of one CG solve on ``rec``'s plan.

    Uses the exact model stack the autotuner's modeled tier sums
    (``repro_torch.tune.autotune.modeled_objective``): per fused minibatch,
    each operator moves ``spmm_traffic`` bytes over ``HW.hbm_bw`` and
    issues ``dma_issues`` copies at the per-copy overhead (the
    passport's calibrated value when given), and each reduction moves
    ``comm_volume`` bytes over the link-class bandwidths.  CGNR applies
    each operator ``iters + 1`` times (one ``A``/``A^T`` pair per
    iteration plus the initial residual/normal pair -- see
    ``core.solver.cgnr``).

    Returns ``(phases, meta)``: phase -> seconds (``solve`` is the sum
    of the four sub-phases) and the overhead provenance.
    """
    from ..kernels.traffic import (
        PER_COPY_OVERHEAD_S,
        op_segments_per_stage,
        spmm_traffic,
    )
    from ..launch.hardware import HW
    from ..launch.xct_perf import comm_volume

    overhead = per_copy_overhead_s
    source = "default" if overhead is None else "measured"
    if passport is not None and overhead is None:
        overhead = getattr(passport, "per_copy_overhead_s", None)
        source = getattr(passport, "overhead_source", "default")
    if overhead is None:
        overhead = PER_COPY_OVERHEAD_S
        source = "default"

    cfg, pol, plan = rec.cfg, rec.policy, rec.plan
    granule = rec.n_batch * cfg.fuse
    if n_slices % granule:
        raise ValueError(
            f"n_slices={n_slices} not a multiple of the solve granule "
            f"{granule}"
        )
    minis = n_slices // granule  # fused minibatches per application
    apps = iters + 1  # operator applications per CG solve (per op)

    issue_s = hbm_s = 0.0
    for op in (plan.proj, plan.back):
        _, b, s, r, k = op.inds.shape
        t = spmm_traffic(
            b, s, r, k, op.winmap.shape[-1], cfg.fuse,
            storage_bytes=pol.storage_bytes,
            vals_bytes=pol.vals_bytes,
            staging=cfg.staging,
            dma=cfg.dma,
            segments_per_stage=op_segments_per_stage(op),
        )
        issue_s += t["dma_issues"] * overhead * minis * apps
        hbm_s += t["hbm_bytes"] / HW.hbm_bw * minis * apps
    wire = comm_volume(
        plan, cfg.comm_mode, cfg.fuse, pol.comm_bytes, rec.topology,
        wire=cfg.wire,
    )
    ici_s = wire["ici"] / HW.ici_bw * minis * apps
    dci_s = wire["dci"] / HW.dci_bw * minis * apps
    phases = {
        "hbm": hbm_s,
        "dma_issue": issue_s,
        "exchange_ici": ici_s,
        "exchange_dci": dci_s,
    }
    phases["solve"] = sum(phases.values())
    return phases, {
        "overhead_source": source,
        "per_copy_overhead_s": float(overhead),
    }


def drift_report(
    spans,
    *,
    rec=None,
    iters: int | None = None,
    n_slices: int | None = None,
    modeled: dict | None = None,
    threshold: float = 0.5,
    per_copy_overhead_s: float | None = None,
    passport=None,
) -> DriftReport:
    """Join measured span totals against modeled phase predictions.

    Args:
      spans: a :class:`~repro_torch.obs.trace.Tracer` or its event list.
      rec / iters / n_slices: price the model from a live
        ``Reconstructor`` (:func:`modeled_phases`).
      modeled: inject the phase model directly (``{"solve": s, ...}``;
        sub-phases optional) -- tests and doctests use this for
        determinism; overrides ``rec``.
      threshold: flag a *directly measured* phase when
        ``measured / modeled`` falls outside
        ``[1/(1+threshold), 1+threshold]``.
      per_copy_overhead_s / passport: overhead provenance for the
        model (see :func:`modeled_phases`).
    """
    meta = {"overhead_source": "injected", "per_copy_overhead_s": 0.0}
    if modeled is None:
        if rec is None or iters is None or n_slices is None:
            raise ValueError(
                "pass either modeled= or all of rec=/iters=/n_slices="
            )
        modeled, meta = modeled_phases(
            rec, iters=iters, n_slices=n_slices,
            per_copy_overhead_s=per_copy_overhead_s, passport=passport,
        )
    measured = measured_phases(spans)
    solve_modeled = modeled.get("solve")
    solve_measured = measured.get("solve")

    rows: list[DriftRow] = []
    for phase in PHASES:
        mod = modeled.get(phase)
        if phase in ("load", "upload"):
            mod = modeled.get(phase)  # measured-only unless injected
            mea = measured.get(phase)
            src = "span" if mea is not None else None
        elif phase == "solve":
            mea, src = solve_measured, (
                "span" if solve_measured is not None else None
            )
        else:
            # attributed: modeled share of the measured solve total
            if (
                mod is None or solve_modeled in (None, 0.0)
                or solve_measured is None
            ):
                mea, src = None, None
            else:
                mea = solve_measured * (mod / solve_modeled)
                src = "attributed"
        ratio = (
            mea / mod
            if mea is not None and mod not in (None, 0.0)
            else None
        )
        share = (
            mod / solve_modeled
            if phase not in ("solve", "load", "upload")
            and mod is not None and solve_modeled not in (None, 0.0)
            else None
        )
        flagged = bool(
            src == "span"
            and ratio is not None
            and not (1.0 / (1.0 + threshold) <= ratio <= 1.0 + threshold)
        )
        rows.append(
            DriftRow(
                phase=phase, measured_s=mea, modeled_s=mod,
                ratio=ratio, share=share, source=src, flagged=flagged,
            )
        )
    return DriftReport(
        rows=tuple(rows),
        threshold=float(threshold),
        overhead_source=meta["overhead_source"],
        per_copy_overhead_s=meta["per_copy_overhead_s"],
    )
