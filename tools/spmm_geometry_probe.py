#!/usr/bin/env python3
"""Time the fused CUDA SpMM stagings at both ring sizes, on one GPU.

    python3 tools/spmm_geometry_probe.py [--n 512] [--angles 384] [--reps 20]
        [--source LABEL=PATH ...] [--out DIR]

Builds the projector and backprojector shards as ``chip_smoke.py`` does,
then times rows 1, 2 and 3 of ``csrc/xct_spmm.cu`` per application at
F=16 (f16 windows; f16 values with f32 compute, int8 values with
exponents, and row 1 at f32/f32 too) with the ring ``launch_geometry``
sizes for 2 and for 3 CTAs per SM, and marks the one it takes.  Each
``--source`` names another version of the kernel source (for example the
parent commit's, from ``git show``) that is built beside this one and
timed in the same turns, so that two versions are compared on one card
in one run.  Every output must equal the production wrapper's bit for
bit.  The entries are called through their C ABI with the geometry
given; nothing in the wrapper is switched.  Prints one line per
measurement, and writes the records, with the card's name and power
limit, and each build's ``ptxas`` log into ``--out`` (``build/probe``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

# mangled MODE of each staging in xct_spmm_kernel<MODE, ...>
MODES = {"sorted": "Li0E", "unsorted": "Li1E", "per_row": "Li2E"}
# mangled <V, S, C, Q> of the timed pairs
PAIRS = {"f16": r"6__halfS\d*_fLb0E", "i8": r"a6__halffLb1E",
         "f32": r"fffLb0E"}


def _bind(lib, xs):
    for entry in xs.ENTRIES:
        name = xs._entry_name(*entry)
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        occ = getattr(lib, name + "_occupancy")
        occ.argtypes = [ctypes.POINTER(ctypes.c_int)]
        occ.restype = ctypes.c_int
    return lib


def build_all(xs, sources):
    """``{label: (ctypes library, ptxas log)}``: this checkout's kernel
    (label ``this``) and each ``LABEL=PATH`` source, compiled at once."""
    build = ROOT / "build" / "probe"
    build.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, path in sources:
        so = build / f"libxct_spmm_{label}.so"
        cmd = [xs._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(so), str(path)]
        procs[label] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    path, _, log = xs.build()
    if not log:  # built before this run: build it again for its log
        path.unlink()
        path, _, log = xs.build()
    libs = {"this": (xs._library(), log)}
    for label, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc ({label}) failed:\n{out}")
        libs[label] = (_bind(ctypes.CDLL(str(so)), xs), out)
    return libs


def registers(log, staging, pair):
    """ptxas's register count of xct_spmm_kernel<MODE, pair> (None where
    the log names no such entry)."""
    pat = re.compile(rf"xct_spmm_kernelI{MODES[staging]}{PAIRS[pair]}")
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and pat.search(line):
            for nxt in lines[i + 1:i + 6]:
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    return int(m.group(1))
    return None


def main():
    import numpy as np
    import torch

    from repro_torch.kernels import xct_spmm as xs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=cs.N)
    ap.add_argument("--angles", type=int, default=cs.ANGLES)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--source", action="append", default=[],
                    metavar="LABEL=PATH",
                    help="another kernel source to time beside this one")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "probe",
                    help="directory for the records and ptxas logs")
    args = ap.parse_args()
    sources = [tuple(a.split("=", 1)) for a in args.source]
    if not torch.cuda.is_available():
        print("spmm_geometry_probe: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    card = cs.card_line()
    cs.log(f"card: {card}")
    libs = build_all(xs, sources)
    _, _, plan = cs.build_problem(args.n, args.angles)
    f16, f32 = torch.float16, torch.float32
    records = []
    for name in ("proj", "back"):
        op = getattr(plan, name)
        t = cs.operator_tensors(op, device)
        b, s, r, k = t["inds"].shape
        buf = t["winmap"].shape[-1]
        x32 = torch.from_numpy(np.random.default_rng(3).normal(
            size=(op.n_cols_pad, cs.FUSE)).astype(np.float32)).to(device)
        unsorted = cs.unsorted_table(t["winmap"], device)
        q8, e8 = cs.quantized(op, torch.int8, device)
        cases = []
        for staging, table, segoff in (
            ("sorted", t["winsegs"], t["segoff"]),
            ("unsorted", unsorted, None),
            ("per_row", t["winmap"], None),
        ):
            cases.append((staging, "f16", t["vals"].to(f16), x32.to(f16),
                          None, table, segoff))
            cases.append((staging, "i8", q8, x32.to(f16), e8, table, segoff))
            if staging == "sorted":
                cases.append((staging, "f32", t["vals"].to(f32), x32, None,
                              table, segoff))
        for staging, pair, vals, x, scales, table, segoff in cases:
            kw = dict(scales=scales)
            if staging != "per_row":
                kw.update(winsegs=table, segoff=segoff)
            ref = xs.spmm_block_ell(t["inds"], vals, t["winmap"], x, **kw)
            nseg = table.shape[-2] if staging != "per_row" else 0
            noff = segoff.shape[-1] if segoff is not None else 0
            sb = x.element_size()
            entry = xs._entry_name(staging, vals.dtype, x.dtype, f32)
            for ctas in (2, 3):
                geo = xs._sized_for(ctas, staging, s, r, k, buf, cs.FUSE, sb)
                for label, (lib, log) in libs.items():
                    fn = getattr(lib, entry)
                    occ = ctypes.c_int(0)
                    getattr(lib, entry + "_occupancy")(ctypes.byref(occ))
                    chosen = xs.launch_geometry(staging, s, r, k, buf,
                                                cs.FUSE, sb,
                                                resident=occ.value)
                    out = torch.empty_like(ref)

                    def launch(fn=fn, geo=geo, out=out):
                        err = fn(
                            t["inds"].data_ptr(), vals.data_ptr(),
                            x.data_ptr(), table.data_ptr(),
                            None if segoff is None else segoff.data_ptr(),
                            None if scales is None else scales.data_ptr(),
                            out.data_ptr(), b, s, r, k, buf, cs.FUSE, nseg,
                            noff, geo.depth, geo.inflight, geo.cluster,
                            torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"{entry}: cudaError {err}")

                    launch()
                    torch.cuda.synchronize()
                    if not torch.equal(out, ref):
                        raise AssertionError(
                            f"{entry} ({label}, ring for {ctas} CTAs) "
                            "differs from the wrapper's output")
                    ms = cs.cuda_ms(launch, args.reps)
                    rec = dict(operator=name, staging=staging, pair=pair,
                               source=label, ring_ctas=ctas,
                               taken=geo == chosen,
                               registers=registers(log, staging, pair),
                               resident=occ.value, inflight=geo.inflight,
                               depth=geo.depth, smem=geo.smem, ms=ms)
                    records.append(rec)
                    cs.log(f"probe {name} {staging} {pair} {label}: "
                           f"{rec['registers']} registers, {occ.value} CTAs "
                           f"resident; ring for {ctas} CTAs (P={geo.inflight}"
                           f", D={geo.depth}, {geo.smem} B"
                           f"{', taken' if rec['taken'] else ''}): "
                           f"{ms:.4f} ms")
        del t, unsorted, q8, e8
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "spmm_geometry_probe.json").write_text(json.dumps(
        dict(card=card, records=records), indent=1))
    for label, (_, log) in libs.items():
        (args.out / f"spmm_geometry_probe_ptxas_{label}.txt").write_text(log)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
