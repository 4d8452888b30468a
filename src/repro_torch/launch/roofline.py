"""Three-term roofline and the markdown tables of dry-run results.

:func:`roofline` prices one step's per-device FLOPs, device-memory bytes
and link bytes against a card's rates (``launch.hardware.HW``, the
H100's, unless ``hw`` is given) and names the term that dominates.
:func:`emit` turns a JSON list of dry-run records (``launch.dryrun
--out``) into a markdown table:

  PYTHONPATH=src python -m repro_torch.launch.roofline \
      results/dryrun_xct.json [more.json ...]

>>> rf = roofline(2 * 989e12, 3.35e12, 0.0, 0.0, 989e12)
>>> rf["dominant"], rf["t_step"], rf["roofline_fraction"]
('compute', 2.0, 0.5)
"""
from __future__ import annotations

import json
import sys

from . import hardware

__all__ = ["roofline", "fmt_row", "HEADER", "emit"]


def roofline(
    flops_dev: float,
    hbm_bytes_dev: float,
    ici_bytes_dev: float,
    dci_bytes_dev: float,
    useful_flops_dev: float,
    hw: hardware.Hardware | None = None,
    hbm_bytes_analytic: float | None = None,
) -> dict:
    """Three-term roofline (seconds) + dominant term + MFU-style fraction.

    ``compute`` is ``flops_dev`` over the peak rate, ``memory``
    ``hbm_bytes_dev`` over the device-memory rate, ``collective`` the
    link bytes over their rates.  With ``hbm_bytes_analytic`` a second
    memory term (``memory_analytic``) and the step time, dominant term
    and fraction it implies (``*_adj``) are reported beside them.
    ``hw=None`` reads ``launch.hardware.HW`` at call time.
    """
    hw = hardware.HW if hw is None else hw
    t_comp = flops_dev / hw.peak_flops
    t_mem = hbm_bytes_dev / hw.hbm_bw
    t_coll = ici_bytes_dev / hw.ici_bw + dci_bytes_dev / hw.dci_bw
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    t_step = max(terms.values())
    useful_t = useful_flops_dev / hw.peak_flops
    out = {
        **terms,
        "dominant": dominant,
        "t_step": t_step,
        "model_flops_ratio": (
            useful_flops_dev / flops_dev if flops_dev else 0.0
        ),
        "roofline_fraction": useful_t / t_step if t_step else 0.0,
    }
    if hbm_bytes_analytic is not None:
        t_mem_a = hbm_bytes_analytic / hw.hbm_bw
        adj = {"compute": t_comp, "memory": t_mem_a, "collective": t_coll}
        out["memory_analytic"] = t_mem_a
        out["dominant_adj"] = max(adj, key=adj.get)
        out["t_step_adj"] = max(adj.values())
        out["roofline_fraction_adj"] = (
            useful_t / out["t_step_adj"] if out["t_step_adj"] else 0.0
        )
    return out


def fmt_row(r):
    if r["status"] != "ok":
        return (
            f"| {r.get('arch','?'):22s} | {r.get('shape','?'):12s} | "
            f"{r['status']} ||||||||"
        )
    rf = r["roofline"]
    return (
        f"| {r['arch']:22s} | {r['shape']:12s} "
        f"| {rf['compute']:9.3f} | {rf['memory']:9.2f} "
        f"| {rf.get('memory_analytic', 0):9.4f} "
        f"| {rf['collective']:9.3f} | {rf.get('dominant_adj', '?'):10s} "
        f"| {rf.get('t_step_adj', 0):8.3f} "
        f"| {rf['model_flops_ratio']:5.2f} "
        f"| {rf.get('roofline_fraction_adj', 0):6.3f} |"
    )


HEADER = (
    "| arch | shape | compute s | mem(HLO) s | mem(analytic) s | "
    "collective s | dominant | t_step s | MF ratio | roofline frac |\n"
    "|---|---|---|---|---|---|---|---|---|---|"
)


def emit(path):
    with open(path) as f:
        rows = json.load(f)
    print(f"\n### {path}\n")
    print(HEADER)
    for r in rows:
        print(fmt_row(r))
    ok = [r for r in rows if r["status"] == "ok"]
    if ok:
        fr = [r["roofline"].get("roofline_fraction_adj", 0) for r in ok]
        print(
            f"\n{len(ok)} ok / {len(rows)} cells; "
            f"roofline fraction: min {min(fr):.3f} "
            f"median {sorted(fr)[len(fr)//2]:.3f} max {max(fr):.3f}"
        )


if __name__ == "__main__":
    for p in sys.argv[1:]:
        emit(p)
