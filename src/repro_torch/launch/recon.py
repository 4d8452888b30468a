"""XCT reconstruction driver (the paper's workload) on one or more GPUs.

  PYTHONPATH=src python -m repro_torch.launch.recon --n 64 --angles 48 \
      --slices 8 --iters 20 --precision mixed --comm hier

``--device cpu`` runs the kernel's plain PyTorch version on the CPU.
``--p-data P`` splits each slice over P ranks on a ``(1, P)`` mesh
``("data", "model")``, the data axis ``"model"``: the first P cards, or P
ranks sharing the CPU under ``--device cpu``; ``--comm`` picks the
partial-data reduction among them.  ``--trace OUT.json`` records the
``repro_torch.obs`` spans of the run, writes them as a Chrome
trace-event JSON (load it at ui.perfetto.dev) and prints the
modeled-vs-measured drift report (``obs.drift``, priced with the H100's
rates).  ``--tune-dir DIR`` applies this machine's tuning passport
(``repro_torch.tune``, by hardware fingerprint) to every knob the
command line left at its default.

Out-of-core streaming (``repro_torch.stream``): simulate the sinogram
straight into an on-disk slab store, then drain it through the solver
under a byte budget -- the volume never materializes in host RAM:

  PYTHONPATH=src python -m repro_torch.launch.recon --n 64 --slices 32 \
      --stream --mem-budget 64

A drain that quarantines a slab exits with code 3; a resume with the
same ``--workdir`` re-attempts it.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from ..core.geometry import XCTGeometry, build_system_matrix
from ..core.partition import PartitionConfig, build_plan, default_socket
from ..core.recon import ReconConfig, Reconstructor, resolve_device
from ..data.phantom import phantom_slices, simulate_measurements
from ..dist import Topology
from ..obs import drift as obs_drift
from ..obs import export as obs_export
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..tune.passport import resolve_passport
from .mesh import make_mesh

MODES = ("direct", "rs", "hier", "sparse", "hier-sparse")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--angles", type=int, default=48)
    ap.add_argument("--slices", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--p-data", type=int, default=1)
    ap.add_argument("--fuse", type=int, default=4)
    ap.add_argument("--precision", default="mixed")
    ap.add_argument("--comm", default="hier", choices=MODES)
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--dma", default="coalesced", choices=("coalesced", "per_row"),
        help="window staging mode of the fused kernel",
    )
    ap.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="cuda runs the hand-written kernel; cpu its plain version",
    )
    ap.add_argument(
        "--stream", action="store_true",
        help="out-of-core slab streaming through repro_torch.stream",
    )
    ap.add_argument(
        "--mem-budget", type=float, default=256.0,
        help="MiB budget for --stream slab sizing (operator + slabs)",
    )
    ap.add_argument(
        "--workdir", default=None,
        help="store + resume-manifest dir for --stream (default: temp)",
    )
    ap.add_argument(
        "--device-upload", default="overlap",
        choices=("overlap", "sync"),
        help="--stream: upload slab i+1 to the device in the prefetch "
             "thread, on a CUDA stream of its own (overlap), or on the "
             "critical path (sync)",
    )
    ap.add_argument(
        "--max-retries", type=int, default=2,
        help="--stream: transient-failure retries per slab before "
             "quarantine (resil.RetryPolicy; total tries = retries + 1)",
    )
    ap.add_argument(
        "--fail-fast", action="store_true",
        help="--stream: re-raise the first slab failure instead of "
             "retrying / quarantining (debugging)",
    )
    ap.add_argument(
        "--trace", default=None, metavar="OUT.json",
        help="record repro_torch.obs spans, write a Chrome trace-event "
             "JSON (load it at ui.perfetto.dev) and print the "
             "modeled-vs-measured drift report",
    )
    ap.add_argument(
        "--tune-dir", default=None,
        help="directory of repro_torch.tune passports; this machine's "
             "passport (by hardware fingerprint) fills every knob the "
             "command line left at its default",
    )
    args = ap.parse_args(argv)

    if args.p_data < 1:
        ap.error("--p-data must be at least 1")
    # Passport knobs apply ONLY where the flag still holds its parser
    # default: an explicit command-line choice always beats the tuner.
    tuned: dict = {}
    if args.tune_dir:
        pp = resolve_passport(args.tune_dir)
        if pp is not None:
            tuned = dict(pp.knobs)
            for flag in ("fuse", "precision", "comm", "dma"):
                knob = {"comm": "comm_mode"}.get(flag, flag)
                if knob in tuned and \
                        getattr(args, flag) == ap.get_default(flag):
                    setattr(args, flag, tuned[knob])
            print(f"tuning passport {pp.fingerprint} applied "
                  f"({args.tune_dir})")
    geo, a, rec = _bind(args, tuned)
    if not args.trace:
        return _solve(args, geo, a, rec)
    old = obs_trace.get_tracer()
    tracer = obs_trace.enable()
    try:
        return _solve(args, geo, a, rec)
    finally:
        # written for a partial drain (exit code 3) too, as the reference
        # writes it before it exits
        obs_trace.set_tracer(old)
        _finish_trace(args, tracer, rec)


def _finish_trace(args, tracer, rec):
    """--trace epilogue: write the Perfetto JSON + print drift."""
    obs_export.write_chrome_trace(args.trace, tracer)
    print(f"trace written to {args.trace} (load at ui.perfetto.dev)")
    try:
        report = obs_drift.drift_report(
            tracer, rec=rec, iters=args.iters, n_slices=args.slices,
        )
        print(report.render())
    except ValueError as e:  # e.g. odd slice counts -- trace still lands
        print(f"drift report unavailable: {e}")


def _bind(args, tuned):
    """Build the plan and bind it as the arguments (and the passport's
    plan-level knobs) say; returns ``(geo, a, rec)``."""
    # devices first, before minutes of host build: a missing card or too
    # few cards raise here and never move the run to the CPU
    device = resolve_device(args.device)
    topology = None
    if args.p_data > 1:
        mesh = make_mesh(
            (1, args.p_data), ("data", "model"),
            devices=[device] * args.p_data if device.type == "cpu" else None,
        )
        topology = Topology.from_mesh(mesh)
        print(topology.describe())
    geo = XCTGeometry(n=args.n, n_angles=args.angles)
    print(f"building system matrix ({geo.n_rays} rays x {geo.n_vox} vox)")
    a = build_system_matrix(geo)
    # the reference's tile 8, R=K=32, "runs" slot order unless the
    # passport tuned them, and the socket-aware chunk layout for the one
    # P-wide level
    plan = build_plan(
        geo,
        PartitionConfig(
            n_data=args.p_data,
            tile=tuned.get("tile", 8),
            rows_per_block=tuned.get("rows_per_block", 32),
            nnz_per_stage=tuned.get("nnz_per_stage", 32),
            socket=default_socket(args.p_data, args.p_data),
            slot_order=tuned.get("slot_order", "runs"),
        ),
        a=a,
    )
    # the wire knob only exists on the hier-sparse ladder; drop it if a
    # command-line --comm override moved off the mode the passport tuned
    wire = tuned.get("wire", "native") if args.comm == "hier-sparse" \
        else "native"
    cfg = ReconConfig(
        precision=args.precision, comm_mode=args.comm, fuse=args.fuse,
        dma=args.dma, wire=wire,
    )
    if topology is None:
        rec = Reconstructor(plan, cfg=cfg, device=device)
    else:
        rec = Reconstructor(plan, cfg=cfg, topology=topology)
    return geo, a, rec


def _solve(args, geo, a, rec):
    """Solve in memory, or stream with ``--stream``."""
    if args.stream:
        return _run_streaming(args, geo, a, rec)

    x_true = phantom_slices(args.n, args.slices, seed=args.seed)
    sino = simulate_measurements(a, x_true, noise=args.noise,
                                 seed=args.seed)
    t0 = time.time()
    x, res = rec.reconstruct(sino, iters=args.iters)
    dt = time.time() - t0
    rel = np.linalg.norm(x - x_true, axis=0) / np.linalg.norm(
        x_true, axis=0
    )
    print(
        f"{args.iters} CG iters on {args.slices} slices in {dt:.1f}s | "
        f"rel err mean {rel.mean():.4f} | residual "
        f"{res[0,0]:.3e} -> {res[-1,0]:.3e}"
    )
    return x, res


def _run_streaming(args, geo, a, rec):
    """Simulate -> store -> budgeted slab drain -> slab-wise QA."""
    from ..resil import RetryPolicy
    from ..stream import SlabStore, reconstruct_streaming, simulate_to_store

    workdir = args.workdir or tempfile.mkdtemp(prefix="xct_stream_")
    granule = rec.n_batch * rec.cfg.fuse
    sino_store = SlabStore.create(
        os.path.join(workdir, "sino"), geo.n_rays, args.slices, granule
    )
    print(
        f"simulating {args.slices} slices into {sino_store.directory} "
        f"({granule}-slice writer slabs)"
    )
    simulate_to_store(
        a, args.n, sino_store, noise=args.noise, seed=args.seed
    )
    budget = int(args.mem_budget * 2**20)
    t0 = time.time()
    result = reconstruct_streaming(
        rec, sino_store, os.path.join(workdir, "vol"),
        iters=args.iters, mem_budget=budget,
        ckpt_dir=os.path.join(workdir, "ckpt"),
        device_upload=args.device_upload,
        retry=RetryPolicy(max_attempts=max(args.max_retries, 0) + 1),
        fail_fast=args.fail_fast,
    )
    dt = time.time() - t0
    # slab-wise QA: the full volume never lives in host memory.
    # Quarantined slabs have no shard on disk -- skip them.
    failed = set(result.failed_slabs)
    errs = []
    for j0, j1 in result.volume.slabs():
        if j0 in failed:
            continue
        x_true = phantom_slices(
            args.n, args.slices, seed=args.seed, start=j0, stop=j1
        )
        x = result.volume.read(j0, j1)
        errs.append(
            np.linalg.norm(x - x_true, axis=0)
            / np.linalg.norm(x_true, axis=0)
        )
    rel = np.concatenate(errs) if errs else np.asarray([np.nan])
    split = ""
    if result.solved:
        split = (
            f" | per-slab load/upload/solve "
            f"{np.mean(result.load_s) * 1e3:.0f}/"
            f"{np.mean(result.upload_s) * 1e3:.0f}/"
            f"{np.mean(result.solve_s) * 1e3:.0f} ms"
            + (" (upload hidden)" if result.upload_overlapped else "")
        )
    print(
        f"streamed {args.slices} slices in "
        f"{len(result.solved)} slab(s) of {result.y_slab} "
        f"(budget {args.mem_budget:.0f} MiB, skipped "
        f"{len(result.skipped)} via resume manifest) in {dt:.1f}s | "
        f"{args.slices / dt:.1f} slices/s | rel err mean "
        f"{rel.mean():.4f}" + split
    )
    if result.retries:
        print(f"absorbed {result.retries} transient retr"
              f"{'y' if result.retries == 1 else 'ies'}")
    if result.escalated:
        peak = obs_metrics.get_metrics().get("stream_escalation_peak_bytes")
        print(f"escalated slab(s) at j0={result.escalated} one precision "
              "rung up" + (f" (peak device memory {peak / 2**30:.2f} GiB "
                           "after binding it)" if peak else ""))
    if result.failed_slabs:
        print(
            f"PARTIAL: quarantined slab(s) at j0={result.failed_slabs} "
            f"-- resume with the same --workdir to re-attempt"
        )
        raise SystemExit(3)
    return result, rel


if __name__ == "__main__":
    main()
