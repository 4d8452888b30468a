#!/usr/bin/env python3
"""Readings for the limits of the check: sound runs, the control, faults.

    python3 xctbench/calibrate.py --cell shale-mixed.slab128 \\
        --seeds 101-112 --control-seeds 201-203 --fault-seeds 301-303 \\
        [--faults stopped_after_1,steepest_descent] [--seconds 2] \\
        [--out FILE]

In one process, the cell's set-up loaded once: one short run of the
cell (``harness.run_cell``, a window of ``--seconds``, long enough for
one call per slab of the pool) per seed under the configuration's
precision; then under its ``control`` (the next precision down, a path
of the program's own) on the control seeds; then with each planted
fault (``faults.py``) on the fault seeds.  Prints one JSON line per run
with every reading of ``check.judge`` and writes them all to ``--out``.
A limit is set from these: above the largest sound reading, below the
smallest reading of the control or of a fault.  Needs a card unless
``--device cpu``.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _seeds(text: str) -> list:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def readings(root, cell_name, runs, seconds, device="cuda"):
    """Yields one dict per ``(precision, fault, seed)`` of ``runs``
    (``precision`` ``None``: the configuration's; ``fault`` ``None``:
    none)."""
    from xctbench import cache, faults
    from xctbench.harness import BENCH, load_cell, run_cell

    root = Path(root)
    cell = load_cell(root, cell_name)
    inputs = cache.setup_inputs(cell.config, root / "build" / BENCH,
                                root / "src" / "repro_torch")
    for precision, fault, seed in runs:
        with faults.planted(fault):
            out = run_cell(root, cell_name, seed, seconds, False,
                           device=device, precision=precision,
                           inputs=inputs)
        yield dict(cell=cell_name,
                   precision=precision or cell.config["precision"],
                   fault=fault, seed=seed, correct=out["correct"],
                   attempted=out["attempted"], failed=out["failed"],
                   solve_s=out["window"].get("wall_median_s"),
                   check_s=out["setup"]["check_s"], **out["readings"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cell", required=True)
    p.add_argument("--seeds", default="", help="e.g. 101-112")
    p.add_argument("--control-seeds", default="", help="e.g. 201-203")
    p.add_argument("--fault-seeds", default="", help="e.g. 301-303")
    p.add_argument("--faults", default="stopped_after_1,stopped_after_10,"
                   "stopped_after_20,steepest_descent")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        q for q in sys.path if Path(q or ".").resolve() != ROOT / "xctbench"]
    from xctbench.harness import load_cell

    control = load_cell(ROOT, args.cell).config["control"]
    runs = ([(None, None, s) for s in _seeds(args.seeds)]
            + [(control, None, s) for s in _seeds(args.control_seeds)]
            + [(None, f, s) for f in filter(None, args.faults.split(","))
               for s in _seeds(args.fault_seeds)])
    lines = []
    for r in readings(ROOT, args.cell, runs, args.seconds, args.device):
        print(json.dumps(r), flush=True)
        lines.append(r)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
