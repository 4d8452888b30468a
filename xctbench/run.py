#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch``.

    python3 xctbench/run.py --workload shale-mixed.slab128 --seed 7 \\
        --seconds 40 --trace 0

from the root of a checkout, on a machine with the cards the cell asks
for (``BENCHMARK.json``).  Set-up (the plan and the benchmark's matrix,
cached under ``build/xctbench/``; the inputs from ``--seed``; the
warm-up) is ``setup_s``; then one caller sends ``reconstruct`` calls for
``--seconds``; then every answer is checked against the plain reference.
The last line of standard output is the result as one JSON object; the
numbers checked, each beside its limit, are the last lines of standard
error.  ``--trace 1`` reports the per-layer metrics instead of the
end-to-end ones, from spans in the window and a profiler trace of a few
calls after it.

Exits 2 without a card (it never falls back to the CPU), and 3 when the
JAX package or JAX was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    with open(ROOT / "BENCHMARK.json") as f:
        manifest = json.load(f)
    chips = next(w["chips"] for w in manifest["workloads"]
                 if w["name"] == args.workload)
    # build and kernel caches at fixed paths inside the checkout
    cache = ROOT / "build" / "xctbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"

    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"xctbench: {args.workload} needs {chips} CUDA device(s), "
              f"{found} available", file=sys.stderr)
        return 2
    # import the benchmark as a package and the program from src/
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        q for q in sys.path if Path(q or ".").resolve() != ROOT / "xctbench"]
    from xctbench.harness import forbidden_modules, run_cell

    out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace), t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"xctbench: loaded {bad}: the benchmark measures repro_torch "
              "alone", file=sys.stderr)
        return 3
    for name, n in out["check"].items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
