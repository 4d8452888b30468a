"""XCT §Perf sweep: comm ladder x fusing factor at the paper's scale.

Iterates the paper's own levers on the paper's own workload using the
slot-exact cost model (``launch.dryrun.xct_analytic``'s terms), priced
with the H100's rates (``launch.hardware.HW``) and its measured per-copy
overhead (``kernels.traffic.PER_COPY_OVERHEAD_S``) -- no device needed,
so the full design space is swept: communication mode
(direct / rs / hier / sparse / hier-sparse) x fusing factor F x
precision.

  PYTHONPATH=src python -m repro_torch.launch.xct_perf

writes ``results/xct_perf_sweep_torch.json`` and prints the table.
The autotuner, the drift report and ``Reconstructor._emit_exchange``
price the exchange with ``comm_volume``.

Wire volumes are not computed here: every byte count flows from
``dist.CommPlan``'s per-link-class volume model, with the sparse-mode
table capacities supplied by ``core.partition.exchange_volume_params``.
``sweep_topology`` builds the meshless production ladder (a 16-wide fast
"socket" level, a fast level filling the pod, a slow level across pods
of 256).

>>> from repro_torch.core.geometry import XCTGeometry
>>> from repro_torch.core.partition import PartitionConfig, estimate_plan
>>> plan = estimate_plan(XCTGeometry(n=64, n_angles=48),
...                      PartitionConfig(n_data=512))
>>> topo = sweep_topology(512)
>>> print(topo.describe())
Topology over 512 devices
  socket: axis 'model' x16 (ici)
    node: axis 'data' x16 (ici)
  global: axis 'pod' x2 (dci)
>>> direct = comm_volume(plan, "direct", fuse=16, comm_bytes=2, topo=topo)
>>> hier = comm_volume(plan, "hier", fuse=16, comm_bytes=2, topo=topo)
>>> direct["dci"], hier["dci"]  # the ladder: 1/(socket*node) crosses
(1048576.0, 4096.0)
"""
from __future__ import annotations

import json
import os

from ..configs.xct_datasets import DATASETS
from ..core.geometry import XCTGeometry
from ..core.partition import (
    PartitionConfig,
    default_socket,
    estimate_plan,
    exchange_volume_params,
)
from ..dist import MODES, Topology
from ..kernels import traffic
from ..kernels.traffic import (
    dma_issue_seconds,
    op_segments_per_stage,
    spmm_traffic,
)
from . import hardware

__all__ = ["comm_volume", "sweep_topology", "sweep", "main"]

OUT = os.path.join("results", "xct_perf_sweep_torch.json")


def sweep_topology(p_data: int, fast: int = 16, pod: int = 256) -> Topology:
    """Meshless production ladder for ``p_data`` in-slice devices.

    A ``fast``-wide minor fast-link socket, a major fast-link node level
    filling the pod, and a slow level across pods when ``p_data`` spills
    past one pod.
    """
    f = min(fast, p_data)
    mid = max(1, min(p_data // f, pod // f))
    rest = p_data // (f * mid)
    if f * mid * rest != p_data:
        raise ValueError(
            f"p_data={p_data} does not factor into the production "
            f"ladder (fast={fast}, pod={pod}); got {f}x{mid}x{rest}"
        )
    sizes = [("model", f, "ici")]
    if mid > 1:
        sizes.append(("data", mid, "ici"))
    if rest > 1:
        sizes.append(("pod", rest, "dci"))
    return Topology.from_sizes(sizes)


def comm_volume(plan, mode: str, fuse: int, comm_bytes: int,
                topo: Topology, wire: str = "native") -> dict:
    """Per-device wire bytes per reduction, by link class, from CommPlan.

    Sums the proj and back operators' per-link volumes under ``topo``'s
    ladder; the table capacities for the sparse modes come from
    ``core.partition.exchange_volume_params`` (exact when the plan holds
    real shards, analytic for ``estimate_plan`` abstractions).
    ``wire="q8"`` (hier-sparse only) prices the int8-compressed slow-axis
    hop of ``dist.collectives.sparse_exchange``.
    """
    out = {"ici": 0.0, "dci": 0.0}
    for op in (plan.proj, plan.back):
        dense = float(op.n_rows_pad) * fuse * comm_bytes
        # the dense modes ignore the table capacities -- skip building
        # the (possibly exact, O(P^2 V)) exchange tables for them
        params = (
            exchange_volume_params(op, topo)
            if mode in ("sparse", "hier-sparse") else {}
        )
        cp = topo.plan(mode, wire=wire, comm_bytes=comm_bytes, **params)
        for link, b in cp.wire_bytes_by_link(dense).items():
            out[link] = out.get(link, 0.0) + b
    return out


def sweep(dataset="xct-brain", p_data=512, iters=30, staging="fused",
          dma="coalesced", precision="mixed", wire="native", *,
          hw=None, per_copy_overhead=None):
    """Full mode x fuse sweep of the analytic cost model.

    ``staging`` selects the SpMM memory-traffic model: the default
    in-kernel staging moves each window row over device memory once; the
    ``"gather"`` baseline pays the extra staged-window round trip
    (``kernels.traffic.spmm_traffic`` is the shared formula).  ``dma``
    selects the window-copy issue model: run-length coalescing issues
    O(NSEG) copies per stage, the ``"per_row"`` baseline O(BUF) -- the
    memory term prices both as ``issues x per_copy_overhead + bytes /
    bw`` (``kernels.traffic.dma_issue_seconds``).  ``precision`` names
    the policy whose storage/vals/comm widths price the traffic;
    ``wire="q8"`` additionally compresses the hier-sparse slow hop
    (skipped for modes without one).  ``hw`` and ``per_copy_overhead``
    default to the H100's (``launch.hardware.HW``,
    ``kernels.traffic.PER_COPY_OVERHEAD_S``), read at call time.
    """
    from ..core.precision import get_policy

    hw = hardware.HW if hw is None else hw
    overhead = (traffic.PER_COPY_OVERHEAD_S if per_copy_overhead is None
                else per_copy_overhead)
    ds = DATASETS[dataset]
    geo = XCTGeometry(n=ds.n, n_angles=ds.k)
    topo = sweep_topology(p_data)
    pcfg = PartitionConfig(
        n_data=p_data, tile=32, rows_per_block=64, nnz_per_stage=64,
        socket=default_socket(p_data, topo.levels[0].size),
    )
    plan = estimate_plan(geo, pcfg)
    pol = get_policy(precision)
    rows = []
    nnz_total = geo.n_rays * 1.195 * ds.n
    for mode in MODES:
        mode_wire = wire if mode == "hier-sparse" else "native"
        for fuse in (1, 4, 16, 64):
            sb = pol.storage_bytes
            flops = 0.0
            hbm = 0.0
            issues = 0.0
            for op in (plan.proj, plan.back):
                _, b, s, r, k = op.inds.shape
                t = spmm_traffic(
                    b, s, r, k, op.winmap.shape[-1], fuse,
                    storage_bytes=sb, vals_bytes=pol.vals_bytes,
                    staging=staging, dma=dma,
                    segments_per_stage=op_segments_per_stage(op),
                )
                flops += iters * t["flops"]
                hbm += iters * t["hbm_bytes"]
                issues += iters * t["dma_issues"]
            cv = comm_volume(
                plan, mode, fuse, pol.comm_bytes, topo, wire=mode_wire
            )
            t_comp = flops / hw.peak_flops
            t_mem = dma_issue_seconds(issues, hbm, hw.hbm_bw, overhead)
            t_coll = iters * (
                cv["ici"] / hw.ici_bw + cv["dci"] / hw.dci_bw
            )
            useful = 4.0 * nnz_total * fuse * iters / p_data
            t_step = max(t_comp, t_mem, t_coll)
            rows.append({
                "dataset": dataset, "mode": mode, "fuse": fuse,
                "t_compute": t_comp, "t_memory": t_mem,
                "t_collective": t_coll, "dma_issues": issues,
                "dominant": max(
                    (("compute", t_comp), ("memory", t_mem),
                     ("collective", t_coll)), key=lambda kv: kv[1],
                )[0],
                "t_per_slice_ms": 1e3 * t_step / fuse,
                "roofline_fraction": (
                    useful / hw.peak_flops
                ) / t_step,
            })
    return rows


def table(rows) -> str:
    """The sweep's rows as the reference's text table."""
    lines = [f"{'mode':12s} {'F':>3s} {'comp_s':>8s} {'mem_s':>8s} "
             f"{'coll_s':>8s} {'dom':>10s} {'ms/slice':>9s} {'frac':>6s}"]
    for r in rows:
        lines.append(
            f"{r['mode']:12s} {r['fuse']:3d} {r['t_compute']:8.3f} "
            f"{r['t_memory']:8.3f} {r['t_collective']:8.3f} "
            f"{r['dominant']:>10s} {r['t_per_slice_ms']:9.2f} "
            f"{r['roofline_fraction']:6.3f}"
        )
    return "\n".join(lines)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    rows = sweep()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(table(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
