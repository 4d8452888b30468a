#!/usr/bin/env python3
"""Time CG solves of two checkouts of the port on one GPU, in turns.

    python3 tools/solve_ab.py --source parent=PATH [--source LABEL=PATH ...]
        [--n 256] [--angles 192] [--slices 32] [--iters 30] [--reps 3]
        [--order parent,this,this,parent] [--work DIR] [--out DIR]

Builds one system matrix and its one-rank and four-rank plans
(``PartitionConfig()`` and ``PartitionConfig(n_data=4, socket=2)``)
once, with this checkout's code, and saves them under ``--work`` as
``.npz`` (``plan_to_arrays``; both packages read them the same).  Then,
for each label of ``--order`` in turn (``this`` is this checkout's ``src/``), a
fresh process imports that checkout's ``repro_torch``, rebuilds the plans
from the files and times 30-iteration ``mixed`` solves on one rank and
on four ranks of a 2x2 mesh of the card (``hier`` and ``hier-sparse``),
``--reps`` each after one warm-up, on the host clock around
``Reconstructor.reconstruct``; the solutions of each checkout are hashed
so that a change of bits shows.  Prints one line per measurement and
writes every record, with the card's name and power limit, to
``--out/solve_ab.json`` (default: ``--work``).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CELLS = (("p1", 1, "hier"), ("p4_hier", 4, "hier"),
         ("p4_hier-sparse", 4, "hier-sparse"))


def build(n, angles, slices, out: Path):
    """The plans and the phantom's sinogram, saved under ``out``."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.geometry import XCTGeometry, build_system_matrix
    from repro_torch.core.partition import (
        PartitionConfig, build_plan, plan_to_arrays,
    )
    from repro_torch.data.phantom import phantom_slices, simulate_measurements

    geo = XCTGeometry(n=n, n_angles=angles)
    t0 = time.perf_counter()
    a = build_system_matrix(geo)
    for ranks, cfg in ((1, PartitionConfig()),
                       (4, PartitionConfig(n_data=4, socket=2))):
        plan = build_plan(geo, cfg, a=a)
        np.savez(out / f"plan{ranks}.npz", **plan_to_arrays(plan))
    sino = simulate_measurements(a, phantom_slices(n, slices, seed=0), seed=0)
    np.save(out / "sino.npy", sino.astype(np.float32))
    return time.perf_counter() - t0


def measure(args):
    """One checkout's records (run in a process of its own)."""
    import numpy as np
    import torch

    sys.path.insert(0, str(Path(args.src) / "src"))
    from repro_torch.core.geometry import XCTGeometry
    from repro_torch.core.partition import PartitionConfig, plan_from_arrays
    from repro_torch.core.recon import ReconConfig, Reconstructor
    from repro_torch.dist import Topology
    from repro_torch.launch.mesh import make_mesh

    work = Path(args.work)
    geo = XCTGeometry(n=args.n, n_angles=args.angles)
    sino = np.load(work / "sino.npy")
    dev = torch.device("cuda")
    recs = {}
    for key, ranks, mode in CELLS:
        cfg = (PartitionConfig() if ranks == 1
               else PartitionConfig(n_data=4, socket=2))
        plan = plan_from_arrays(dict(np.load(work / f"plan{ranks}.npz")),
                                geo, cfg)
        kw = {"device": dev}
        if ranks > 1:
            kw = {"topology": Topology.from_mesh(
                make_mesh((2, 2), ("data", "model"), devices=[dev] * 4),
                data_axes=("model", "data"), batch_axes=())}
        rec = Reconstructor(plan, ReconConfig(precision="mixed",
                                              comm_mode=mode, fuse=16), **kw)
        x, res = rec.reconstruct(sino, iters=args.iters)  # warm-up
        walls = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, res = rec.reconstruct(sino, iters=args.iters)
            walls.append(time.perf_counter() - t0)
        recs[key] = {"walls": walls, "median": float(np.median(walls)),
                     "sha256": hashlib.sha256(
                         x.tobytes() + res.tobytes()).hexdigest()[:16]}
        del rec
        torch.cuda.empty_cache()
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=PATH of another checkout's root")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--angles", type=int, default=192)
    ap.add_argument("--slices", type=int, default=32)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--order", default="parent,this,this,parent")
    ap.add_argument("--work", default=str(ROOT / "build" / "solve_ab"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--measure", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--src", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:  # the child: one checkout
        print(json.dumps(measure(args)))
        return 0

    work = Path(args.work).resolve()
    work.mkdir(parents=True, exist_ok=True)
    out = Path(args.out or work).resolve()
    out.mkdir(parents=True, exist_ok=True)
    sources = {label: str(Path(path).resolve()) for label, path in
               (s.split("=", 1) for s in args.source)}
    sources["this"] = str(ROOT)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t_build = build(args.n, args.angles, args.slices, work)
    print(f"card: {card} | plans built in {t_build:.1f} s (n={args.n}, "
          f"{args.angles} angles, {args.slices} slices)", flush=True)
    turns = []
    for label in args.order.split(","):
        env = dict(os.environ, PYTHONPATH=str(Path(sources[label]) / "src"))
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--measure", "1",
             "--src", sources[label], "--work", str(work), "--n", str(args.n),
             "--angles", str(args.angles), "--iters", str(args.iters),
             "--reps", str(args.reps)],
            capture_output=True, text=True, env=env, cwd=sources[label])
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        recs = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append({"label": label, **recs})
        print(f"{label}: " + " | ".join(
            f"{k} median {v['median']:.4f} s "
            f"({', '.join(f'{w:.4f}' for w in v['walls'])}) bits "
            f"{v['sha256']}" for k, v in recs.items()), flush=True)
    (out / "solve_ab.json").write_text(json.dumps(
        {"card": card, "n": args.n, "angles": args.angles,
         "slices": args.slices, "iters": args.iters, "turns": turns},
        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
