"""Dry run at the paper's scale: the XCT CG step on placeholder devices.

No arrays are allocated: ``Reconstructor(..., abstract=True)`` binds
every operator shard and exchange table of an ``estimate_plan`` plan as a
fake tensor on a placeholder of its rank's device
(``launch.mesh.make_production_mesh``: 256 or 512 of them), and
``Reconstructor.lower_cg`` runs the port's own CG solve on fake inputs
(``core.lowering``).  What it returns is the counterpart of the
reference's compiled memory analysis and HLO collectives: each rank's
bound, input, temporary and peak bytes, and the bytes of every copy
between devices by link class.

Usage:
  python -m repro_torch.launch.dryrun --xct xct-brain [--multi-pod] \
      [--out results.json]
  python -m repro_torch.launch.dryrun --socket-sweep [--xct xct-brain]

The LM cells of the reference's dry run (``--arch``, ``--shape``,
``--all``, ``--hints``) are not ported yet: the LM substrate comes in a
later slice, and those flags exit with code 2.

The XCT cells pair the traced numbers with ``xct_analytic``, a
slot-exact cost model over the static blocked-ELL shapes.  Its wire
volumes are not hand-rolled here: they flow from ``dist.CommPlan``'s
per-link-class model, resolved against the cell's ``dist.Topology`` (so
the dry run and the §Perf sweep can never disagree about what a mode
ships over ICI vs DCI).

Example -- the analytic model is pure accounting, usable without any
devices attached (a meshless two-level ladder, one CG iteration):

>>> from repro_torch.core.geometry import XCTGeometry
>>> from repro_torch.core.partition import PartitionConfig, estimate_plan
>>> from repro_torch.core.recon import ReconConfig
>>> from repro_torch.dist import Topology
>>> plan = estimate_plan(
...     XCTGeometry(n=512, n_angles=256),
...     PartitionConfig(n_data=16, tile=32, rows_per_block=64,
...                     nnz_per_stage=64),
... )
>>> topo = Topology.from_sizes([("model", 8, "ici"), ("data", 2, "dci")])
>>> an = xct_analytic(
...     plan, ReconConfig(precision="mixed", comm_mode="hier"), topo,
...     fuse=4, iters=1,
... )
>>> sorted(an) == ['dci_dev', 'dma_issues_dev', 'flops_dev', 'hbm_dev',
...                'ici_dev']
True
>>> an["dci_dev"] == an["ici_dev"] / 8  # ladder: 1/|socket| crosses DCI
True
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

from ..configs.xct_datasets import DATASETS
from . import hardware
from .mesh import make_fake_mesh, make_production_mesh
from .roofline import roofline

__all__ = [
    "cell_mesh",
    "lower_xct_cell",
    "socket_sweep",
    "xct_analytic",
    "main",
]


def cell_mesh(dataset: str, multi_pod: bool):
    """``(mesh, data_axes, batch_axes, p_data)`` of a dataset's dry-run
    cell: the paper's strategy, data parallelism over ``p_data`` devices
    (the dataset's, up to the pod: 256, or 512 across two pods) and batch
    parallelism over slices on the rest.

    Where ``p_data`` is below the pod's 256 (xct-shale, xct-chip: 64) the
    pod's ``"data"`` axis is split into ``("batch", "data")``, so that the
    data axes hold ``p_data`` devices and ``"batch"`` carries the other
    replicas; the device numbering is the production mesh's.  (The
    reference binds such a plan to all 256 devices of the pod and
    raises.)

    >>> mesh, data, batch, p = cell_mesh("xct-shale", multi_pod=False)
    >>> mesh.shape, data, batch, p
    ({'batch': 4, 'data': 4, 'model': 16}, ('model', 'data'), ('batch',), 64)
    >>> cell_mesh("xct-brain", multi_pod=True)[1:]
    (('model', 'data', 'pod'), (), 512)
    """
    ds = DATASETS[dataset]
    mesh = make_production_mesh(multi_pod=multi_pod)
    fast = mesh.shape["model"]
    pod = mesh.shape["data"] * fast
    p_data = min(ds.p_data, mesh.size)
    if multi_pod and p_data >= 512:
        return mesh, ("model", "data", "pod"), (), p_data
    p_data = min(p_data, pod)
    batch = ("pod",) if multi_pod else ()
    if p_data < pod:
        data = p_data // fast
        if data * fast != p_data or mesh.shape["data"] % data:
            raise ValueError(
                f"p_data={p_data} does not tile a {mesh.shape} mesh"
            )
        shape = (mesh.shape["data"] // data, data, fast)
        names = ("batch", "data", "model")
        if multi_pod:
            shape, names = (mesh.shape["pod"],) + shape, ("pod",) + names
        mesh = make_fake_mesh(shape, names)
        batch = batch + ("batch",)
    return mesh, ("model", "data"), batch, p_data


def lower_xct_cell(dataset: str, multi_pod: bool, iters: int = 2, *,
                   use_ref: bool = True, hw=None) -> dict:
    """Dry-run the XCT CG step at full dataset scale (abstract shards).

    The reference's cell: ``PartitionConfig(tile=32, rows_per_block=64,
    nnz_per_stage=64)`` with the socket-aware layout, ``mixed_bf16``,
    ``hier``, ``fuse=16``, one fused minibatch per batch group, ``iters``
    CG iterations, the oracle's path (``use_ref=True``: its gathered
    window is what the reference's XLA program materializes; ``False``
    runs the kernel path, whose SpMM temp is the kernel's output band).
    ``hw`` (default ``launch.hardware.HW``) prices the roofline.

    The record has the reference's keys, with ``collectives_traced``
    (:meth:`~repro_torch.core.lowering.LoweredCG.collectives`) in the
    place of ``collectives_hlo``; ``rank0_bytes`` is rank 0's peak (its
    shards, its rows of the CG vectors and the run's temporaries) and
    ``card_bytes`` the card's memory (``hw.hbm_bytes``).
    """
    from ..core.geometry import XCTGeometry
    from ..core.partition import (
        PartitionConfig, default_socket, estimate_plan,
    )
    from ..core.recon import ReconConfig, Reconstructor
    from ..dist import Topology

    hw = hardware.HW if hw is None else hw
    ds = DATASETS[dataset]
    mesh, data_axes, batch_axes, p_data = cell_mesh(dataset, multi_pod)
    geo = XCTGeometry(n=ds.n, n_angles=ds.k)
    pcfg = PartitionConfig(
        n_data=p_data, tile=32, rows_per_block=64, nnz_per_stage=64,
        socket=default_socket(p_data, mesh.shape["model"]),
    )
    plan = estimate_plan(geo, pcfg)
    rcfg = ReconConfig(precision="mixed_bf16", comm_mode="hier", fuse=16,
                       use_ref=use_ref)
    topo = Topology.from_mesh(
        mesh, data_axes=data_axes, batch_axes=batch_axes
    )
    rec = Reconstructor(plan, rcfg, topology=topo, abstract=True)
    n_batch = rec.n_batch
    y_slices = rcfg.fuse * n_batch  # one fused I/O batch per batch group
    t0 = time.time()
    lowered = rec.lower_cg(y_slices, iters=iters)
    t1 = time.time()
    mem = lowered.memory_analysis()
    coll = lowered.collectives()
    an = xct_analytic(plan, rcfg, topo, y_slices // n_batch, iters)
    # useful flops: 2 flops/nnz * 2 ops (proj+back) * fuse slices * iters
    nnz_total = geo.n_rays * 1.195 * ds.n
    useful = 4.0 * nnz_total * (y_slices // n_batch) * iters / p_data
    rf = roofline(
        an["flops_dev"], an["hbm_dev"], an["ici_dev"],
        an["dci_dev"] if multi_pod else 0.0,
        useful, hw=hw, hbm_bytes_analytic=an["hbm_dev"],
    )
    return {
        "status": "ok", "arch": dataset, "shape": f"cg{iters}x{y_slices}sl",
        "mesh": "2x16x16" if multi_pod else "16x16",
        "comm_mode": rcfg.comm_mode,
        "compile_s": round(t1 - t0, 1),
        "p_data": p_data,
        "memory": {
            "temp_bytes": mem.temp_size_in_bytes,
            "arg_bytes": mem.argument_size_in_bytes,
            "input_bytes": mem.input_size_in_bytes,
            "out_bytes": mem.output_size_in_bytes,
            "peak_bytes": mem.peak_size_in_bytes,
            "rank": mem.rank,
            # the most any rank but rank 0 holds, beside rank0's peak
            "peak_others": int(max(mem.per_rank["peak"][1:], default=0)),
            "rank0": mem.rank0,
            "notes": lowered.notes,
        },
        "flops_per_dev": an["flops_dev"],
        "hbm_bytes_per_dev": an["hbm_dev"],
        "ici_bytes_per_dev": an["ici_dev"],
        "dci_bytes_per_dev": an["dci_dev"] if multi_pod else 0.0,
        "collectives_traced": coll,
        "analytic": an,
        "roofline": rf,
        "rank0_bytes": mem.rank0["peak"],
        "card_bytes": hw.hbm_bytes,
    }


def socket_sweep(
    dataset: str = "xct-brain",
    p_data: int = 512,
    fuse: int = 16,
    comm_bytes: int = 2,
) -> dict:
    """``PartitionConfig(socket=1)`` vs ``socket=fast`` at the paper's scale.

    Compares the modeled hier-sparse wire volume of the legacy scattered
    chunk layout (socket members' footprints ~ independent draws) against
    the socket-aware layout (members own consecutive Hilbert chunks;
    adjacent-chunk union model, ``core.partition.estimate_hier_sparse``)
    at production scale, on the production ladder
    (``xct_perf.sweep_topology``).  The winner is what
    ``core.partition.default_socket`` hands every caller.

    >>> sw = socket_sweep()
    >>> sw["fast"]
    16
    >>> sw["socket=16"]["dci"] < sw["socket=1"]["dci"]
    True
    >>> sw["winner"]
    16
    """
    from ..core.geometry import XCTGeometry
    from ..core.partition import PartitionConfig, estimate_plan
    from .xct_perf import comm_volume, sweep_topology

    ds = DATASETS[dataset]
    geo = XCTGeometry(n=ds.n, n_angles=ds.k)
    topo = sweep_topology(p_data)
    fast = topo.levels[0].size
    out = {"dataset": dataset, "p_data": p_data, "fast": fast}
    for socket in (1, fast):
        plan = estimate_plan(
            geo,
            PartitionConfig(
                n_data=p_data, tile=32, rows_per_block=64,
                nnz_per_stage=64, socket=socket,
            ),
        )
        out[f"socket={socket}"] = comm_volume(
            plan, "hier-sparse", fuse, comm_bytes, topo
        )
    key = "dci" if out[f"socket={fast}"]["dci"] else "ici"
    out["winner"] = (
        fast
        if out[f"socket={fast}"][key] < out["socket=1"][key]
        else 1
    )
    return out


def xct_analytic(plan, rcfg, topo, fuse: int, iters: int) -> dict:
    """Slot-exact per-device cost model for the XCT CG step.

    FLOPs and bytes come from the static blocked-ELL shapes through the
    shared ``kernels.traffic.spmm_traffic`` model (2 FLOPs per nnz slot
    per fused slice, the operator's slot bytes, and the staging term
    matching ``rcfg.staging`` -- the default in-kernel staging has no
    device-memory window round trip, so modeled arithmetic intensity is
    strictly higher than the gather baseline).  The exchange volume per
    reduction is whatever ``topo.plan(rcfg.comm_mode)`` models for each
    link class -- one source of truth shared with the runtime
    collectives.

    ``dma_issues_dev`` counts the window-staging copies the kernel
    issues (one per run-length segment under the default
    ``rcfg.dma="coalesced"``, one per winmap row under ``"per_row"``)
    so rooflines can price the fixed per-copy overhead with
    ``kernels.traffic.dma_issue_seconds``.
    """
    from ..core.partition import exchange_volume_params
    from ..core.precision import get_policy
    from ..kernels.traffic import op_segments_per_stage, spmm_traffic

    pol = get_policy(rcfg.precision)
    sb, cb = pol.storage_bytes, pol.comm_bytes
    wire = getattr(rcfg, "wire", "native")
    out = {"flops_dev": 0.0, "hbm_dev": 0.0, "ici_dev": 0.0,
           "dci_dev": 0.0, "dma_issues_dev": 0.0}
    for op in (plan.proj, plan.back):
        _, b, s, r, k = op.inds.shape
        segs = op_segments_per_stage(op)
        t = spmm_traffic(
            b, s, r, k, op.winmap.shape[-1], fuse, storage_bytes=sb,
            vals_bytes=pol.vals_bytes,
            staging=getattr(rcfg, "staging", "fused"),
            dma=getattr(rcfg, "dma", "coalesced"),
            segments_per_stage=segs,
        )
        out["flops_dev"] += iters * t["flops"]
        out["hbm_dev"] += iters * t["hbm_bytes"]
        out["dma_issues_dev"] += iters * t["dma_issues"]
        dense = float(op.n_rows_pad) * fuse * cb
        params = (
            exchange_volume_params(op, topo)
            if rcfg.comm_mode in ("sparse", "hier-sparse") else {}
        )
        wl = topo.plan(
            rcfg.comm_mode, wire=wire, comm_bytes=cb, **params
        ).wire_bytes_by_link(dense)
        out["ici_dev"] += iters * wl.get("ici", 0.0)
        out["dci_dev"] += iters * wl.get("dci", 0.0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--xct", help="dataset of launch.dryrun's XCT cell")
    ap.add_argument(
        "--socket-sweep", action="store_true",
        help="socket=1 vs socket=fast hier-sparse volume at xct scale",
    )
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--kernel-path", action="store_true",
                    help="trace the kernel path instead of the oracle's")
    ap.add_argument("--out", default=None)
    for flag in ("--arch", "--shape"):
        ap.add_argument(flag, help="LM cell: not ported yet")
    for flag in ("--all", "--hints"):
        ap.add_argument(flag, action="store_true",
                        help="LM cells: not ported yet")
    args = ap.parse_args(argv)
    if args.arch or args.shape or args.all or args.hints:
        print("dryrun: the LM cells (--arch, --shape, --all, --hints) are "
              "not ported yet; the LM substrate is ROADMAP.md queue 1",
              file=sys.stderr)
        return 2
    if not (args.xct or args.socket_sweep):
        ap.error("give --xct DATASET or --socket-sweep")

    results = []

    def run(fn, *a, **kw):
        try:
            r = fn(*a, **kw)
        except Exception as e:  # noqa: BLE001 -- record & continue
            r = {
                "status": f"error: {type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:],
            }
        results.append(r)
        print(json.dumps(r, default=str))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1, default=str)

    if args.socket_sweep:
        run(socket_sweep, args.xct or "xct-brain")
    else:
        run(lower_xct_cell, args.xct, args.multi_pod,
            use_ref=not args.kernel_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
