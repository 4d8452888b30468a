"""XCT reconstruction driver (the paper's workload) on one or more GPUs.

  PYTHONPATH=src python -m repro_torch.launch.recon --n 64 --angles 48 \
      --slices 8 --iters 20 --precision mixed --comm hier

``--device cpu`` runs the kernel's plain PyTorch version on the CPU.
``--p-data P`` splits each slice over P ranks on a ``(1, P)`` mesh
``("data", "model")``, the data axis ``"model"``: the first P cards, or P
ranks sharing the CPU under ``--device cpu``; ``--comm`` picks the
partial-data reduction among them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..core.geometry import XCTGeometry, build_system_matrix
from ..core.partition import PartitionConfig, build_plan, default_socket
from ..core.recon import ReconConfig, Reconstructor, resolve_device
from ..data.phantom import phantom_slices, simulate_measurements
from ..dist import Topology
from .mesh import make_mesh

MODES = ("direct", "rs", "hier", "sparse", "hier-sparse")

# options of the reference driver that the port does not run yet
_NOT_PORTED = {
    "stream": "--stream (out-of-core streaming): ROADMAP.md queue 1, stream/",
    "trace": "--trace (observability spans): ROADMAP.md queue 1, "
             "tuning/observability hooks",
    "tune_dir": "--tune-dir (tuning passports): ROADMAP.md queue 1, "
                "tuning/observability hooks",
}


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
    ap.add_argument("--stream", action="store_true",
                    help="not ported yet")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="not ported yet")
    ap.add_argument("--tune-dir", default=None, help="not ported yet")
    args = ap.parse_args(argv)

    for flag, why in _NOT_PORTED.items():
        if getattr(args, flag):
            ap.error(f"{why} is not ported yet")
    if args.p_data < 1:
        ap.error("--p-data must be at least 1")

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
    # the reference's tile 8, R=K=32, "runs" slot order, and the
    # socket-aware chunk layout for the one P-wide level
    plan = build_plan(
        geo,
        PartitionConfig(
            n_data=args.p_data,
            socket=default_socket(args.p_data, args.p_data),
        ),
        a=a,
    )
    cfg = ReconConfig(
        precision=args.precision, comm_mode=args.comm, fuse=args.fuse,
        dma=args.dma,
    )
    if topology is None:
        rec = Reconstructor(plan, cfg=cfg, device=device)
    else:
        rec = Reconstructor(plan, cfg=cfg, topology=topology)

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


if __name__ == "__main__":
    main()
