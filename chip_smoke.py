#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases, each fatal on failure:

1. the card (``nvidia-smi``) and the build of ``csrc/xct_spmm.cu``;
2. every CUDA kernel against its plain PyTorch version, on the kernel
   test sweep and on the n=512 projector and backprojector shards: the
   class-sorted kernel (row 1) for every (storage, compute) pair the
   float policies use; the unsorted-segment (row 2), per-row (row 3) and
   pre-gathered window (row 4) kernels, which must also give row 1's
   output bit for bit; and the quantized kernels (row 1q, int8 and fp8
   values on the three fused stagings), which must equal their plain
   version and row 1's f32 kernel on the dequantized values;
3. the main path: ``Reconstructor`` at n=512, 384 angles, 32 slices,
   ``fuse=16``, 30 CGNR iterations under ``mixed``, ``single``, ``q8``
   and ``fp8``; 5-iteration ``mixed`` solves under ``dma="per_row"`` and
   ``staging="gather"`` that must equal the default solve bit for bit;
   one ``apply_operator`` per shard on unsorted segment tables; mixed
   and q8 solves with ``overlap=False`` and ``overlap=True`` (the side
   stream) in turns, three each, timed and all required to give the
   first solve's bits; a (2, 1) ``("data", "model")`` mesh of
   the card, two batch groups on the same plan, whose projections must
   equal one group's bit for bit and whose solve's difference from the
   P=1 solve is printed; the ``recon/solve`` span beside a host timer;
   with every kernel's launch count read around the phase;
4. profiled mixed and q8 solves: device time by kernel and the idle
   share (run after phase 5: a profiler session slows later launches);
   per CUDA stream the device work's count and time, the time during
   which an SpMM kernel and another stream's work ran at once, and the
   ordered scatter's ``index_add_`` and gather calls;
5. per-application times of every kernel, its plain version and
   ``torch.sparse.mm`` (cuSPARSE, used here only as a yardstick) beside
   the memory-bandwidth bound (rows 2 and 3 with the table they read);
   row 1q on the class-sorted, unsorted and per-row tables; row 4
   chunked as ``apply_operator`` runs it (the gather aside), with the
   device time of those launches (``torch.profiler``); the solves' wall
   time and peak memory;
6. the partial-data exchange over a mesh: the same system matrix planned
   for four ranks (``PartitionConfig(n_data=4, socket=2)``) on a 2x2
   ``DeviceMesh`` of this one card, data axes ``("model", "data")``;
   rows 1 and 1q against their plain versions on every rank's shard;
   one projection and backprojection under each of the five reduction
   modes and the int8 wire against the one-rank path; 30-iteration
   solves under ``mixed`` (``hier``, ``sparse``, ``hier-sparse``) and
   ``q8`` over the int8 wire, with their launch counts and their scatter
   tables' multiplicities; every solve runs twice, then three times
   each with ``overlap=False`` and ``overlap=True`` in turns, timed, all
   required to give the first run's bits; and profiled ``hier-sparse``
   solves with and without the side stream beside phase 4's.

The last lines are a ``kernels`` JSON object, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N, ANGLES, SLICES, FUSE, ITERS = 512, 384, 32, 16, 30
SWEEP = [  # (B, S, R, K, BUF, C, F): the kernel test sweep
    (1, 1, 8, 8, 16, 64, 1),
    (2, 2, 16, 8, 32, 128, 4),
    (3, 1, 32, 16, 64, 256, 8),
    (2, 3, 8, 32, 40, 96, 16),
    (5, 2, 16, 16, 24, 64, 2),
    # S=7 against 4 stages in flight and clusters of 2-7 CTAs; K=12 and
    # F=3 (no 16-byte rows); R=32 with F=64
    (3, 7, 32, 32, 64, 256, 16),
    (2, 9, 16, 12, 24, 64, 3),
    (3, 5, 32, 16, 48, 128, 64),
    # an odd BUF: most stages' winmap rows start off a 16-byte boundary
    (2, 5, 16, 16, 37, 128, 16),
]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
AB_ITERS = 5  # iterations of the staging A/B solves
MODES = ("direct", "rs", "hier", "sparse", "hier-sparse")
# phase 6's solves: (key, precision, comm mode, wire)
MESH_SOLVES = (
    ("p4_hier_mixed", "mixed", "hier", "native"),
    ("p4_sparse_mixed", "mixed", "sparse", "native"),
    ("p4_hier-sparse_mixed", "mixed", "hier-sparse", "native"),
    ("p4_hier-sparse_q8_wire-q8", "q8", "hier-sparse", "q8"),
)
# the kernels redesigned for Hopper, tagged in the kernels line with the
# change that redesigned them
REDESIGNED = {"row1": "PR 13", "row1q": "PR 13", "row2": "PR 14",
              "row3": "PR 14", "row4": "PR 13"}
# the five kernels: (key, name, replaces) -- the Pallas kernel body each
# replaces in src/repro/kernels/xct_spmm.py
KERNELS = (
    ("row1", "spmm_block_ell", "src/repro/kernels/xct_spmm.py:249"),
    ("row1q", "spmm_block_ell[scales]", "src/repro/kernels/xct_spmm.py:133"),
    ("row2", "spmm_block_ell[unsorted]", "src/repro/kernels/xct_spmm.py:193"),
    ("row3", "spmm_block_ell[per_row]", "src/repro/kernels/xct_spmm.py:141"),
    ("row4", "spmm_block_ell_staged", "src/repro/kernels/xct_spmm.py:327"),
)


def log(*parts):
    print(*parts, flush=True)


def tolerance(storage):
    import torch

    return 1e-5 if storage in (torch.float32, torch.float64) else 2e-2


def pair_name(storage, compute):
    short = {"float64": "f64", "float32": "f32", "float16": "f16",
             "bfloat16": "bf16"}
    return (f"{short[str(storage).split('.')[-1]]}/"
            f"{short[str(compute).split('.')[-1]]}")


def compare(out, plain, storage):
    """(max abs error, passes) under allclose(rtol=tol, atol=tol)."""
    import torch

    tol = tolerance(storage)
    diff = (out - plain).abs()
    ok = bool((diff <= tol + tol * plain.abs()).all())
    return float(diff.max()), ok, tol


def random_shard(shape, storage, device, seed):
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    b, s, r, k, buf, c, f = shape
    rng = np.random.default_rng(seed)
    inds = rng.integers(0, buf, size=(b, s, r, k)).astype(np.int16)
    vals = (rng.random((b, s, r, k)) * (rng.random((b, s, r, k)) > 0.3)
            ).astype(np.float32)
    winmap = rng.integers(0, c, size=(b, s, buf)).astype(np.int32)
    x = rng.normal(size=(c, f)).astype(np.float32)
    segs, off = ops.sort_segments_by_class(ops.winmap_segments(winmap), buf)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return (t(inds), t(vals).to(storage), t(winmap), t(x).to(storage),
            t(segs), t(off))


def unsorted_table(winmap, device):
    """Row 2's input: the run-order segment table, without class offsets."""
    import torch

    from repro_torch.kernels import ops

    return torch.from_numpy(
        ops.winmap_segments(winmap.cpu().numpy())
    ).to(device)


def check_sweep(device):
    """Phase 2a: every kernel on the sweep shapes.  Returns
    {kernel key: max abs error against its plain version}."""
    import numpy as np
    import torch

    from repro_torch.core import precision as prec
    from repro_torch.kernels import xct_spmm as xs

    worst = dict.fromkeys((key for key, _, _ in KERNELS), 0.0)
    for storage, compute in xs.KERNEL_PAIRS:
        errs = dict.fromkeys(("row1", "row2", "row3", "row4"), 0.0)
        for i, shape in enumerate(SWEEP):
            inds, vals, winmap, x, segs, off = random_shard(
                shape, storage, device, seed=i
            )
            unsorted = unsorted_table(winmap, device)
            window = x[winmap.long()]
            kw = dict(compute_dtype=compute)
            outs = {
                "row1": xs.spmm_block_ell(inds, vals, winmap, x, winsegs=segs,
                                          segoff=off, **kw),
                "row2": xs.spmm_block_ell(inds, vals, winmap, x,
                                          winsegs=unsorted, **kw),
                "row3": xs.spmm_block_ell(inds, vals, winmap, x, **kw),
                "row4": xs.spmm_block_ell_staged(inds, vals, window, **kw),
            }
            plain = xs.spmm_block_ell_plain(inds, vals, winmap, x, **kw)
            plains = {
                "row1": plain, "row3": plain,
                "row2": xs.spmm_block_ell_plain(inds, vals, winmap, x,
                                                winsegs=unsorted, **kw),
                "row4": xs.spmm_block_ell_staged_plain(inds, vals, window,
                                                       **kw),
            }
            for key, out in outs.items():
                err, ok, tol = compare(out, plains[key], storage)
                if not ok:
                    raise AssertionError(
                        f"{key} kernel {pair_name(storage, compute)} "
                        f"disagrees with its plain version on {shape}: max "
                        f"err {err}"
                    )
                if not torch.equal(out, outs["row1"]):
                    raise AssertionError(
                        f"{key} kernel {pair_name(storage, compute)} is not "
                        f"row 1's output bit for bit on {shape}"
                    )
                errs[key] = max(errs[key], err)
        log(f"sweep {pair_name(storage, compute)}: max abs err vs plain "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (tolerance {tol:g}, {len(SWEEP)} shapes); rows 2-4 == "
            "row 1 bit for bit")
        for key, err in errs.items():
            worst[key] = max(worst[key], err)
    for qdtype in xs.QUANT_DTYPES:
        for i, shape in enumerate(SWEEP):
            inds, vals, winmap, x, segs, off = random_shard(
                shape, torch.float32, device, seed=100 + i
            )
            b, s = shape[:2]
            octaves = np.random.default_rng(200 + i).integers(
                -6, 7, size=(b, s, 1, 1)
            )
            vals = vals * torch.from_numpy(np.exp2(octaves)).to(vals)
            q, e = (t.to(device) for t in prec.quantize_block_vals(
                vals.cpu(), qdtype))
            x16 = x.to(torch.float16)
            ref = xs.spmm_block_ell(inds, prec.dequantize_block_vals(q, e),
                                    winmap, x16.float(), winsegs=segs,
                                    segoff=off)
            unsorted = unsorted_table(winmap, device)
            for tables in (dict(winsegs=segs, segoff=off),
                           dict(winsegs=unsorted), {}):
                out = xs.spmm_block_ell(inds, q, winmap, x16, scales=e,
                                        **tables)
                plain = xs.spmm_block_ell_plain(
                    inds, q, winmap, x16, scales=e,
                    winsegs=None if "segoff" in tables
                    else tables.get("winsegs"),
                )
                if not (torch.equal(out, plain) and torch.equal(out, ref)):
                    raise AssertionError(
                        f"quantized kernel ({qdtype}, tables "
                        f"{sorted(tables)}) differs from its plain version "
                        f"or from row 1 on the dequantized values, {shape}"
                    )
        log(f"sweep quantized {str(qdtype).split('.')[-1]}: sorted, "
            "unsorted and per-row kernels == plain == row 1 f32/f32 on the "
            f"dequantized values, bit for bit ({len(SWEEP)} shapes)")
    return worst


def operator_tensors(op, device, p=0):
    """Rank ``p``'s shard of an operator on ``device``."""
    import torch

    t = lambda a: torch.from_numpy(a[p]).to(device)  # noqa: E731
    return {
        "inds": t(op.inds), "vals": t(op.vals), "winmap": t(op.winmap),
        "winsegs": t(op.winsegs), "segoff": t(op.segoff),
    }


def quantized(op, qdtype, device, p=0):
    """The bound form of rank ``p``'s shard under q8/fp8: packed values
    and exponents, quantized on the host as ``Reconstructor`` does."""
    import torch

    from repro_torch.core import precision as prec

    q, e = prec.quantize_block_vals(torch.from_numpy(op.vals[p]), qdtype)
    return q.to(device), e.to(device)


def check_shards(plan, device):
    """Phase 2b: every kernel on the slice's proj and back shards.  Rows
    1-4 for every pair through ``apply_operator``; row 1q for int8 and
    fp8 on the three fused stagings.  Returns {kernel key: max abs error
    against its plain version, at f16/f32 (row 1q: q8 and fp8)}."""
    import numpy as np
    import torch

    from repro_torch.core import precision as prec
    from repro_torch.kernels import ops
    from repro_torch.kernels import xct_spmm as xs

    errs = dict.fromkeys((key for key, _, _ in KERNELS), 0.0)
    for name in ("proj", "back"):
        op = getattr(plan, name)
        t = operator_tensors(op, device)
        _, b, s, r, k = op.inds.shape
        buf = op.winmap.shape[-1]
        # each entry's launch geometry: the ring sized for the CTAs per
        # SM its staging wants and its registers allow
        for staging in ("sorted", "unsorted", "per_row", "staged"):
            for storage, compute in xs.KERNEL_PAIRS[:3]:
                sb = torch.empty((), dtype=storage).element_size()
                resident = (xs._resident(xs._entry_name(
                    staging, storage, storage, compute))
                    if device.type == "cuda" else None)
                geo = xs.launch_geometry(staging, s, r, k, buf, FUSE, sb,
                                         resident=resident)
                log(f"geometry {name} {staging} {sb} B window values, "
                    f"{resident} CTAs resident: {geo}")
        unsorted = unsorted_table(t["winmap"], device)
        x = torch.from_numpy(
            np.random.default_rng(7).normal(
                size=(op.n_cols_pad, FUSE)
            ).astype(np.float32)
        ).to(device)
        args = (t["inds"], t["winmap"])
        for storage, compute in xs.KERNEL_PAIRS:
            vals = t["vals"].to(storage)
            kw = dict(storage_dtype=storage, compute_dtype=compute)

            def apply(**mode):
                return ops.apply_operator(args[0], vals, args[1], x, **kw,
                                          **mode)

            out = apply(winsegs=t["winsegs"], segoff=t["segoff"])
            plain = xs.spmm_block_ell_plain(
                t["inds"], vals, t["winmap"], x.to(storage),
                compute_dtype=compute,
            ).reshape(out.shape)
            err, ok, tol = compare(out, plain, storage)
            log(f"shard {name} {pair_name(storage, compute)}: max abs err "
                f"{err:.3e} (tolerance {tol:g}, max |out| "
                f"{float(plain.abs().max()):.3e})")
            if not ok:
                raise AssertionError(
                    f"kernel disagrees with its plain version on the {name} "
                    f"shard at {pair_name(storage, compute)}"
                )
            others = {"row2": apply(winsegs=unsorted),
                      "row3": apply(dma="per_row"),
                      "row4": apply(staging="gather")}
            for key, other in others.items():
                if not torch.equal(other, out):
                    raise AssertionError(
                        f"{key} is not row 1's output bit for bit on the "
                        f"{name} shard at {pair_name(storage, compute)}"
                    )
            mixed = (storage, compute) == (torch.float16, torch.float32)
            if mixed:
                xs_ = x.to(storage)
                window = xs_[t["winmap"].long()]
                plains = {
                    "row1": plain, "row3": plain,
                    "row2": xs.spmm_block_ell_plain(
                        t["inds"], vals, t["winmap"], xs_,
                        compute_dtype=compute, winsegs=unsorted,
                    ).reshape(out.shape),
                    "row4": xs.spmm_block_ell_staged_plain(
                        t["inds"], vals, window, compute_dtype=compute,
                    ).reshape(out.shape),
                }
                del window
                for key, ref in plains.items():
                    got = out if key == "row1" else others[key]
                    e_, ok, _ = compare(got, ref, storage)
                    if not ok:
                        raise AssertionError(
                            f"{key} disagrees with its plain version on the "
                            f"{name} shard"
                        )
                    errs[key] = max(errs[key], e_)
            log(f"shard {name} {pair_name(storage, compute)}: unsorted "
                "(row 2), per-row (row 3) and gather (row 4) == row 1 bit "
                "for bit" + (" and within tolerance of their plain versions"
                             if mixed else ""))
            del out, plain, others
        x16 = x.to(torch.float16)
        for qdtype in xs.QUANT_DTYPES:
            q, e = quantized(op, qdtype, device)
            ref = xs.spmm_block_ell(
                t["inds"], prec.dequantize_block_vals(q, e), t["winmap"],
                x16.float(), winsegs=t["winsegs"], segoff=t["segoff"],
            )
            for tables in (dict(winsegs=t["winsegs"], segoff=t["segoff"]),
                           dict(winsegs=unsorted), {}):
                out = xs.spmm_block_ell(t["inds"], q, t["winmap"], x16,
                                        scales=e, **tables)
                plain = xs.spmm_block_ell_plain(
                    t["inds"], q, t["winmap"], x16, scales=e,
                    winsegs=None if "segoff" in tables
                    else tables.get("winsegs"),
                )
                err = float((out - plain).abs().max())
                if not (torch.equal(out, plain) and torch.equal(out, ref)):
                    raise AssertionError(
                        f"quantized kernel ({qdtype}, tables "
                        f"{sorted(tables)}) on the {name} shard differs from "
                        f"its plain version (max err {err}) or from row 1 "
                        "on the dequantized values"
                    )
                errs["row1q"] = max(errs["row1q"], err)
            log(f"shard {name} quantized {str(qdtype).split('.')[-1]}: "
                "sorted, unsorted and per-row kernels == plain == row 1 "
                "f32/f32 on the dequantized values, bit for bit (max |out| "
                f"{float(ref.abs().max()):.3e})")
            del q, e, ref, out, plain
        del t
    return errs


def build_problem(n, angles):
    from repro_torch.core.geometry import XCTGeometry, build_system_matrix
    from repro_torch.core.partition import PartitionConfig, build_plan

    geo = XCTGeometry(n=n, n_angles=angles)
    t0 = time.perf_counter()
    a = build_system_matrix(geo)
    t_a = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = build_plan(geo, PartitionConfig(), a=a)
    t_plan = time.perf_counter() - t0
    for name in ("proj", "back"):
        op = getattr(plan, name)
        log(f"plan {name}: shards {list(op.inds.shape)} BUF "
            f"{op.winmap.shape[-1]} NSEG {op.winsegs.shape[-2]} nnz "
            f"{op.nnz} hbm_bytes(2 B vals) {op.hbm_bytes(2)}")
    log(f"host build: system matrix {t_a:.1f} s, plan {t_plan:.1f} s "
        f"(n={n}, {angles} angles, {a.nnz} nnz)")
    return geo, a, plan


def main_path(plan, a, device, slices=SLICES, fuse=FUSE, iters=ITERS,
              ab_iters=AB_ITERS):
    """Phase 3.  Returns the solve records; the caller reads the launch
    counts around it."""
    import numpy as np
    import torch

    from repro_torch.core.precision import get_policy
    from repro_torch.core.recon import ReconConfig, Reconstructor
    from repro_torch.data.phantom import phantom_slices, simulate_measurements
    from repro_torch.kernels import ops
    from repro_torch.kernels import xct_spmm as xs

    n = plan.geo.n
    x_true = phantom_slices(n, slices, seed=0)
    sino = simulate_measurements(a, x_true, seed=0)
    cuda = device.type == "cuda"
    runs = {}

    def solve(precision, n_iters, **extra):
        rec = Reconstructor(
            plan, cfg=ReconConfig(precision=precision, fuse=fuse, **extra),
            device=device,
        )
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = dict(xs.LAUNCHES)
        t0 = time.perf_counter()
        x, res = rec.reconstruct(sino, iters=n_iters)
        wall = time.perf_counter() - t0
        count = {k: v - before[k] for k, v in xs.LAUNCHES.items()
                 if v != before[k]}
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        rel = np.linalg.norm(x - x_true, axis=0) / np.linalg.norm(
            x_true, axis=0
        )
        label = "/".join([precision] + [f"{k}={v}" for k, v in extra.items()])
        log(f"solve {label}: {n_iters} iters x {slices} slices in "
            f"{wall:.2f} s | rel err mean {rel.mean():.4f} | residual "
            f"{res[0].mean():.4e} -> {res[-1].mean():.4e} | kernel "
            f"launches {count} | peak device memory {peak / 2**30:.2f} GiB")
        if not np.isfinite(x).all():
            raise AssertionError(f"{label}: non-finite solution")
        if x.shape != x_true.shape or res.shape != (n_iters, slices):
            raise AssertionError(f"{label}: shapes {x.shape} {res.shape}")
        return rec, x, res, dict(rel=float(rel.mean()), wall_s=wall,
                                 peak_bytes=int(peak), launches=count)

    expected = 2 * (iters + 1) * (slices // fuse)
    solutions = {}
    for precision in ("mixed", "single", "q8", "fp8"):
        rec, x, res, runs[precision] = solve(precision, iters)
        solutions[precision] = (x, res)
        if precision == "mixed":
            runs["scatter_depths"] = rec.scatter_depths()
            log("scatter tables P=1: " + ", ".join(
                f"{k} largest multiplicity {m}"
                for k, (m, _) in runs["scatter_depths"].items()))
        if not (res[-1] < 0.05 * res[0]).all():
            raise AssertionError(f"{precision}: residual did not fall 20x")
        key = "sorted_q" if get_policy(precision).quantized else "sorted"
        if cuda and runs[precision]["launches"] != {key: expected}:
            raise AssertionError(
                f"{precision}: launches {runs[precision]['launches']}, "
                f"expected {{{key!r}: 2*(iters+1)*(slices/fuse) = "
                f"{expected}}}"
            )
        if precision == "single":
            yhat = rec.project(x_true)
            ref = a @ x_true
            err = np.abs(yhat - ref)
            bound = 2e-4 * np.abs(ref) + 2e-4 * np.abs(ref).max()
            log(f"project vs scipy A @ x: max abs err {err.max():.3e} "
                f"(max |A x| {np.abs(ref).max():.3e}, rtol 2e-4, "
                f"atol 2e-4*max|A x|)")
            if not (err <= bound).all():
                raise AssertionError("project disagrees with scipy A @ x")
        del rec
    for precision in ("mixed", "q8", "fp8"):
        if not runs[precision]["rel"] < runs["single"]["rel"] + 0.03:
            raise AssertionError(
                f"{precision} rel err {runs[precision]['rel']:.4f} is not "
                f"within +0.03 of single's {runs['single']['rel']:.4f}"
            )

    # the staging A/B: the same windows, so the same bits
    ab_expected = 2 * (ab_iters + 1) * (slices // fuse)
    chunks = sum(
        -(-op.inds.shape[1] // ops._gather_blocks_per_call(
            op.inds.shape[1], op.inds.shape[2], op.winmap.shape[-1], fuse, 2))
        for op in (plan.proj, plan.back)
    )
    base = None
    for label, extra, want in (
        ("default", {}, {"sorted": ab_expected}),
        ("per_row", {"dma": "per_row"}, {"per_row": ab_expected}),
        ("gather", {"staging": "gather"},
         {"staged": ab_expected // 2 * chunks}),
    ):
        rec, x, res, runs[f"mixed_{label}"] = solve("mixed", ab_iters,
                                                    **extra)
        del rec
        if cuda and runs[f"mixed_{label}"]["launches"] != want:
            raise AssertionError(
                f"mixed/{label}: launches {runs[f'mixed_{label}']['launches']}"
                f", expected {want}"
            )
        if base is None:
            base = (x, res)
        elif not (np.array_equal(x, base[0]) and np.array_equal(res, base[1])):
            raise AssertionError(
                f"mixed/{label}: solution differs from the default solve"
            )
    log(f"staging A/B: per_row and gather {ab_iters}-iteration solutions == "
        "the default solve, bit for bit")

    # row 2: one projection and one backprojection on unsorted tables
    rng = np.random.default_rng(11)
    for name in ("proj", "back"):
        op = getattr(plan, name)
        t = operator_tensors(op, device)
        x = torch.from_numpy(
            rng.normal(size=(op.n_cols_pad, fuse)).astype(np.float32)
        ).to(device)
        out = ops.apply_operator(t["inds"], t["vals"], t["winmap"], x,
                                 winsegs=unsorted_table(t["winmap"], device))
        ref = ops.apply_operator(t["inds"], t["vals"], t["winmap"], x,
                                 winsegs=t["winsegs"], segoff=t["segoff"])
        if not torch.equal(out, ref):
            raise AssertionError(f"unsorted tables: {name} differs from "
                                 "the class-sorted path")
        del t
    log("apply_operator on unsorted tables (row 2): proj and back == the "
        "class-sorted path, bit for bit")

    # the pipeline's overlap: the reduce phase on a side stream must give
    # the serial order's bits; the solves above ran with overlap=True
    for precision in ("mixed", "q8"):
        recs = [Reconstructor(plan, cfg=ReconConfig(
            precision=precision, fuse=fuse, overlap=overlap), device=device)
            for overlap in (False, True)]
        runs[f"{precision}_overlap"] = overlap_walls(
            recs, sino, iters, solutions[precision], f"{precision} P=1")
        del recs
    runs["batch"] = batch_path(plan, device, sino, solutions["mixed"],
                               slices, fuse, iters)
    runs["span"] = span_timing(plan, sino, device, fuse, iters)
    return runs


def overlap_walls(recs, sino, iters, want, label, rounds=3):
    """Solve with each of ``recs`` (overlap off, on) in turns, ``rounds``
    times; every solution must have ``want``'s bits.  Returns the wall
    seconds per setting."""
    import numpy as np

    walls = {"off": [], "on": []}
    for _ in range(rounds):
        for rec in recs:
            t0 = time.perf_counter()
            x, res = rec.reconstruct(sino, iters=iters)
            walls["on" if rec.cfg.overlap else "off"].append(
                time.perf_counter() - t0)
            if not (np.array_equal(x, want[0])
                    and np.array_equal(res, want[1])):
                raise AssertionError(f"{label}: overlap={rec.cfg.overlap} "
                                     "differs from the first solve")
    log(f"overlap {label}: {iters}-iteration solves in turns, wall s with "
        f"the side stream {[round(w, 3) for w in walls['on']]} (median "
        f"{np.median(walls['on']):.3f}), serial "
        f"{[round(w, 3) for w in walls['off']]} (median "
        f"{np.median(walls['off']):.3f}); all bit-equal")
    return walls


def batch_path(plan, device, sino, p1, slices, fuse, iters):
    """Phase 3: a (2, 1) ("data", "model") mesh of the one card, two batch
    groups of one rank on the P=1 plan.  With 32 slices and fuse 16 each
    group computes one of the one-group solve's minibatches, so its
    projections must equal the one-group ones bit for bit.  The solve's
    CG dots sum 16 columns per group where the one-group solve's sum 32,
    in another order, so its difference from the P=1 solve is printed,
    not required to be 0."""
    import numpy as np

    from repro_torch.core.recon import ReconConfig, Reconstructor
    from repro_torch.data.phantom import phantom_slices
    from repro_torch.dist import Topology
    from repro_torch.launch.mesh import make_mesh

    topo = Topology.from_mesh(make_mesh((2, 1), ("data", "model"),
                                        devices=[device] * 2))
    cfg = ReconConfig(precision="mixed", fuse=fuse)
    rec = Reconstructor(plan, cfg=cfg, topology=topo)
    one = Reconstructor(plan, cfg=cfg, device=device)
    x_true = phantom_slices(plan.geo.n, slices, seed=0)
    for fn, inp in (("project", x_true), ("backproject", sino)):
        if not np.array_equal(getattr(rec, fn)(inp), getattr(one, fn)(inp)):
            raise AssertionError(f"batch groups: {fn} differs from one group")
    del one
    t0 = time.perf_counter()
    x, res = rec.reconstruct(sino, iters=iters)
    wall = time.perf_counter() - t0
    diff = float(np.abs(x - p1[0]).max())
    rel = np.linalg.norm(x - x_true, axis=0) / np.linalg.norm(x_true, axis=0)
    log(f"batch (2, 1) mesh, n_batch={rec.n_batch}: project and backproject "
        f"== one group bit for bit; {iters}-iteration mixed solve in "
        f"{wall:.2f} s, rel err mean {rel.mean():.4f}, max abs diff from the "
        f"P=1 solve {diff:.3e} (max |x| {float(np.abs(p1[0]).max()):.3e}; "
        "the CG dots sum 16 columns, not 32, in another order), residual "
        f"max abs diff {float(np.abs(res - p1[1]).max()):.3e}")
    if not (np.isfinite(x).all() and (res[-1] < 0.05 * res[0]).all()):
        raise AssertionError("batch solve: non-finite or residual did not "
                             "fall 20x")
    return dict(wall_s=wall, rel=float(rel.mean()), max_abs_diff=diff)


def span_timing(plan, sino, device, fuse, iters):
    """Phase 3: the ``recon/solve`` span's duration beside a host timer
    around the same mixed solve."""
    from repro_torch.core.recon import ReconConfig, Reconstructor
    from repro_torch.obs import trace

    rec = Reconstructor(plan, cfg=ReconConfig(fuse=fuse), device=device)
    staged = rec.stage_sino(sino)
    old = trace.get_tracer()
    tracer = trace.enable()
    try:
        t0 = time.perf_counter()
        rec.reconstruct(staged, iters=iters)
        wall = time.perf_counter() - t0
    finally:
        trace.set_tracer(old)
    (ev,) = tracer.spans("recon/solve")
    span_s = ev["t1"] - ev["t0"]
    log(f"span recon/solve: {span_s:.4f} s (fenced) inside a host timer of "
        f"{wall:.4f} s around reconstruct (which adds the download and "
        "unpacking)")
    if not 0 < span_s <= wall:
        raise AssertionError("recon/solve span outside the host timer")
    return dict(span_s=span_s, wall_s=wall)


MESH_CFG = dict(n_data=4, socket=2)  # phase 6's PartitionConfig fields


def build_mesh_plan(geo, a):
    """Phase 6's plan: the main path's matrix, tile, R and K over four
    ranks in the socket-aware layout, and its exchange tables' sizes."""
    from repro_torch.core.partition import (
        PartitionConfig,
        build_hier_sparse_exchange,
        build_plan,
        build_sparse_exchange,
    )

    t0 = time.perf_counter()
    plan = build_plan(geo, PartitionConfig(**MESH_CFG), a=a)
    t_plan = time.perf_counter() - t0
    tables = {}
    for name in ("proj", "back"):
        op = getattr(plan, name)
        t0 = time.perf_counter()
        _, _, v = build_sparse_exchange(op)
        t_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, _, _, w, v2 = build_hier_sparse_exchange(op, 2)
        t_h = time.perf_counter() - t0
        tables[name] = dict(V=v, W=w, V2=v2, sparse_s=t_s, hier_s=t_h)
        log(f"mesh plan {name}: shards {list(op.inds.shape)} BUF "
            f"{op.winmap.shape[-1]} rows per rank {op.rows_per_dev} | sparse "
            f"V {v} ({t_s:.1f} s) | hier-sparse W {w} V2 {v2} ({t_h:.1f} s)")
    log(f"host build: P=4 plan {t_plan:.1f} s (n={geo.n}, socket=2)")
    return plan, dict(plan_s=t_plan, **tables)


def check_mesh_shards(plan, device):
    """Phase 6a: rows 1 and 1q on every rank's proj and back shard of the
    P=4 plan, the shapes the mesh path launches them at: row 1 for every
    (storage, compute) pair, row 1q for int8 and fp8 on the class-sorted
    tables, each against its plain version.  Returns ({kernel key: max abs
    error}, [per-shard records with row 1's mixed time and bound])."""
    import numpy as np
    import torch

    from repro_torch.core import precision as prec
    from repro_torch.kernels import xct_spmm as xs

    errs = {"row1": 0.0, "row1q": 0.0}
    shards = []
    for name in ("proj", "back"):
        op = getattr(plan, name)
        n_ranks, b, s, r, k = op.inds.shape
        for p in range(n_ranks):
            t = operator_tensors(op, device, p)
            x32 = torch.from_numpy(
                np.random.default_rng(11 + p).normal(
                    size=(op.cols_per_dev, FUSE)
                ).astype(np.float32)
            ).to(device)
            tables = dict(winsegs=t["winsegs"], segoff=t["segoff"])
            worst = {}
            for storage, compute in xs.KERNEL_PAIRS:
                vals, x = t["vals"].to(storage), x32.to(storage)
                out = xs.spmm_block_ell(t["inds"], vals, t["winmap"], x,
                                        compute_dtype=compute, **tables)
                plain = xs.spmm_block_ell_plain(t["inds"], vals, t["winmap"],
                                                x, compute_dtype=compute)
                err, ok, tol = compare(out, plain, storage)
                if not ok:
                    raise AssertionError(
                        f"row 1 disagrees with its plain version on rank "
                        f"{p}'s {name} shard at {pair_name(storage, compute)}"
                        f": max err {err}"
                    )
                worst[pair_name(storage, compute)] = err
                errs["row1"] = max(errs["row1"], err)
            x16 = x32.to(torch.float16)
            for qdtype in xs.QUANT_DTYPES:
                q, e = quantized(op, qdtype, device, p)
                out = xs.spmm_block_ell(t["inds"], q, t["winmap"], x16,
                                        scales=e, **tables)
                plain = xs.spmm_block_ell_plain(t["inds"], q, t["winmap"],
                                                x16, scales=e)
                err = float((out - plain).abs().max())
                if not torch.equal(out, plain):
                    raise AssertionError(
                        f"row 1q ({qdtype}) differs from its plain version "
                        f"on rank {p}'s {name} shard: max err {err}"
                    )
                worst[str(qdtype).split(".")[-1]] = err
                errs["row1q"] = max(errs["row1q"], err)
            rec = dict(operator=name, rank=p, shape=[b, s, r, k],
                       buf=int(op.winmap.shape[-1]), max_abs_err=worst)
            if device.type == "cuda":
                vals = t["vals"].to(torch.float16)
                rec["ms"] = cuda_ms(lambda: xs.spmm_block_ell(
                    t["inds"], vals, t["winmap"], x16,
                    compute_dtype=torch.float32, **tables), 20)
                rec.update(bound(b * s * r * k, 2, op.cols_per_dev * FUSE * 2,
                                 b * r * FUSE * 4))
            shards.append(rec)
            log(f"mesh shard {name} rank {p} {[b, s, r, k]} BUF "
                f"{rec['buf']}: max abs err vs plain "
                + ", ".join(f"{k_} {v:.3e}" for k_, v in worst.items())
                + " (row 1 at the pairs' tolerances, row 1q exact)"
                + (f" | row 1 mixed {rec['ms']:.4f} ms, bound "
                   f"{rec['bound_ms']:.4f} ms" if "ms" in rec else ""))
            del t
    return errs, shards


def mesh_topology(device):
    """Four ranks on one card: a 2x2 ``DeviceMesh`` of ``device``, data
    axes ("model", "data") -- a socket level of 2, a node level of 2."""
    from repro_torch.dist import Topology
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), devices=[device] * 4)
    topo = Topology.from_mesh(mesh, data_axes=("model", "data"),
                              batch_axes=())
    log(f"{mesh!r}\n{topo.describe()}")
    return topo


def mesh_path(plan1, plan4, a, device, runs_p1, slices=SLICES, fuse=FUSE,
              iters=ITERS):
    """Phase 6: one application under each mode, then the 30-iteration
    solves, over four ranks of one card.  Returns (checks, solves); the
    caller reads the launch counts around it."""
    import numpy as np
    import torch

    from repro_torch.core.recon import ReconConfig, Reconstructor
    from repro_torch.data.phantom import phantom_slices, simulate_measurements
    from repro_torch.kernels import xct_spmm as xs

    topo = mesh_topology(device)
    n = plan1.geo.n
    x_true = phantom_slices(n, slices, seed=0)
    sino = simulate_measurements(a, x_true, seed=0)
    cuda = device.type == "cuda"
    card = topo.rank_devices()[0]

    def bind(precision, mode="direct", wire="native", plan=plan4,
             overlap=True):
        cfg = ReconConfig(precision=precision, comm_mode=mode, wire=wire,
                          fuse=fuse, overlap=overlap)
        if plan is plan1:
            return Reconstructor(plan, cfg=cfg, device=device)
        rec = Reconstructor(plan, cfg=cfg, topology=topo)
        where = {t.device for arrs in rec._arrays for t in arrs.values()}
        if rec.devices != [card] * 4 or where != {card}:
            raise AssertionError(f"rank arrays on {where}, not {card}")
        return rec

    def apply_once(rec):
        return rec.project(x_true), rec.backproject(sino)

    def rel(got, ref):
        return float(np.abs(got - ref).max() / np.abs(ref).max())

    checks = {}

    def check(label, got, ref, tol):
        errs = [rel(g, r) for g, r in zip(got, ref)]
        checks[label] = dict(project=errs[0], backproject=errs[1], tol=tol)
        log(f"mesh check {label}: project {errs[0]:.3e}, backproject "
            f"{errs[1]:.3e} of max|ref| (tolerance {tol:g})")
        if not max(errs) < tol:
            raise AssertionError(f"mesh check {label} fails its tolerance")

    p1 = apply_once(bind("single", plan=plan1))
    outs = {}
    for precision in ("single", "mixed"):
        for mode in MODES:
            before = dict(xs.LAUNCHES)
            outs[precision, mode] = apply_once(bind(precision, mode))
            count = {k: v - before[k] for k, v in xs.LAUNCHES.items()
                     if v != before[k]}
            # 4 ranks x (slices / fuse) minibatches x 2 applications
            want = {"sorted": 4 * (slices // fuse) * 2}
            if cuda and count != want:
                raise AssertionError(f"{precision}/{mode}: launches "
                                     f"{count}, expected {want}")
            if precision == "single":
                check(f"P=4 {mode} single vs P=1 single",
                      outs[precision, mode], p1, 1e-4)
            elif mode != "direct":
                check(f"P=4 {mode} mixed vs P=4 direct mixed",
                      outs[precision, mode], outs["mixed", "direct"], 5e-3)
    check("P=4 hier-sparse single vs P=4 direct single",
          outs["single", "hier-sparse"], outs["single", "direct"], 2e-6)
    for precision in ("mixed", "q8"):
        got = apply_once(bind(precision, "hier-sparse", "q8"))
        check(f"P=4 hier-sparse wire=q8 {precision} vs P=4 direct mixed",
              got, outs["mixed", "direct"], 2.5e-2)
    del outs, p1

    solves = {}
    expected = 4 * (slices // fuse) * 2 * (iters + 1)

    def run(rec, key, mode, wire, precision):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = dict(xs.LAUNCHES)
        t0 = time.perf_counter()
        x, res = rec.reconstruct(sino, iters=iters)
        wall = time.perf_counter() - t0
        count = {k: v - before[k] for k, v in xs.LAUNCHES.items()
                 if v != before[k]}
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        err = np.linalg.norm(x - x_true, axis=0) / np.linalg.norm(
            x_true, axis=0)
        # the int8 wire is held to PERF.md's limit for reduced precision
        # (single + 0.03); a native wire to its own policy's P=1 solve
        base = "single" if wire == "q8" else precision
        ref = runs_p1[base]["rel"]
        if wire == "q8":
            ok, limit = err.mean() <= ref + 0.03, f"<= {ref + 0.03:.4f}"
        else:
            ok, limit = abs(err.mean() - ref) <= 0.01, f"{ref:.4f} +- 0.01"
        log(f"solve {key}: {iters} iters x {slices} slices over 4 ranks in "
            f"{wall:.2f} s | rel err mean {err.mean():.4f} (P=1 {base} "
            f"{ref:.4f}, limit {limit}) | residual {res[0].mean():.4e} -> "
            f"{res[-1].mean():.4e} | kernel launches {count} | peak device "
            f"memory {peak / 2**30:.2f} GiB")
        if not np.isfinite(x).all() or x.shape != x_true.shape:
            raise AssertionError(f"{key}: non-finite or misshapen solution")
        if not (res[-1] < 0.05 * res[0]).all():
            raise AssertionError(f"{key}: residual did not fall 20x")
        if not ok:
            raise AssertionError(f"{key}: rel err {err.mean():.4f} against "
                                 f"the P=1 solve's {ref:.4f}")
        kernel = "sorted_q" if rec.policy.quantized else "sorted"
        if cuda and count != {kernel: expected}:
            raise AssertionError(f"{key}: launches {count}, expected "
                                 f"{{{kernel!r}: {expected}}}")
        return x, res, dict(rel=float(err.mean()), wall_s=wall,
                            peak_bytes=int(peak), launches=count,
                            comm_mode=mode, wire=wire, precision=precision,
                            ranks=4, overlap=rec.cfg.overlap)

    for key, precision, mode, wire in MESH_SOLVES:
        rec = bind(precision, mode, wire)
        depths = rec.scatter_depths()
        log(f"scatter tables {key}: " + ", ".join(
            f"{k} largest multiplicity {m}, passes over 4 ranks {n}"
            for k, (m, n) in depths.items()))
        x, res, solves[key] = run(rec, key, mode, wire, precision)
        solves[key]["scatter_depths"] = depths
        # a second run must give the first's bits: the ordered
        # scatter-adds leave nothing to the atomics' order
        x2, res2, _ = run(rec, key + " again", mode, wire, precision)
        equal = np.array_equal(x, x2) and np.array_equal(res, res2)
        log(f"solve {key}: two runs bit-equal: {equal}")
        if not equal:
            raise AssertionError(f"{key}: two runs differ")
        serial = bind(precision, mode, wire, overlap=False)
        solves[key]["walls"] = overlap_walls(
            [serial, rec], sino, iters, (x, res), key)
        del rec, serial
    return checks, solves


def dev_us(e):
    """Device time of one ``key_averages()`` row, in microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0
    )


def device_ms(fn, name="xct_spmm_kernel"):
    """Device time of the kernels named ``name`` in one call of ``fn``
    (torch.profiler): the kernels' own time, without the host's gaps
    between launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(dev_us(e) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and name in e.key) / 1e3


def profile_solve(plan, a, device, precision="mixed", slices=SLICES,
                  fuse=FUSE, iters=ITERS, topology=None, rows=8, **extra):
    """Phase 4: where a solve's device time goes (torch.profiler); with
    ``topology`` the ranks of a mesh (``device`` is then unused) and
    ``extra`` ReconConfig fields such as ``comm_mode``.

    Returns {wall_s, device_s, busy_share, top: [(name, ms, calls)]};
    device_s is None when the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.recon import ReconConfig, Reconstructor
    from repro_torch.data.phantom import phantom_slices, simulate_measurements

    x_true = phantom_slices(plan.geo.n, slices, seed=0)
    cfg = ReconConfig(precision=precision, fuse=fuse, **extra)
    rec = (Reconstructor(plan, cfg=cfg, device=device) if topology is None
           else Reconstructor(plan, cfg=cfg, topology=topology))
    label = "/".join([precision] + [
        f"{k}={v}" if isinstance(v, bool) else str(v)
        for k, v in extra.items()]) + (
        "" if topology is None else f" P={topology.n_data}")
    staged = rec.stage_sino(simulate_measurements(a, x_true, seed=0))
    rec.reconstruct(staged, iters=1)  # warm-up outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rec.reconstruct(staged, iters=iters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device-side events only (kernels, copies): an operator's row
    # repeats the time of the kernels it launched
    events = sorted(
        ((e.key, dev_us(e) / 1e3, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
        key=lambda r: -r[1],
    )
    device_s = sum(r[1] for r in events) / 1e3 if events else None
    if device_s is None:
        log(f"profile {label} solve: no device time in the trace (not "
            "measured)")
    else:
        log(f"profile {label} solve (profiler on): wall {wall:.3f} s, "
            f"device busy {device_s:.3f} s, idle share "
            f"{1 - device_s / wall:.3f}")
        for name, ms, calls in events[:rows]:
            log(f"  {ms:9.2f} ms {calls:6d} calls  {name[:90]}")
    return dict(wall_s=wall, device_s=device_s,
                busy_share=None if device_s is None else device_s / wall,
                top=[[n[:90], ms, c] for n, ms, c in events[:rows]],
                streams=stream_breakdown(prof, label))


def _union(spans):
    """Sorted (start, end) intervals -> their union, merged."""
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _overlap_us(a, b):
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def stream_breakdown(prof, label):
    """From the profiler's trace: per CUDA stream the device work's count
    and ms (kernels, copies, fills); the ms during which an SpMM kernel
    and device work of another stream ran at once; and the ordered
    scatter's ``index_add_`` and gather kernels."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    work = [e for e in doc.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in (
                "kernel", "gpu_memcpy", "gpu_memset")
            and "stream" in e.get("args", {})]
    if not work:
        log(f"streams {label}: no device events with a stream in the trace "
            "(not measured)")
        return None
    spmm = [e for e in work if "xct_spmm" in e["name"]]
    main = spmm[0]["args"]["stream"] if spmm else None
    per = {}
    for e in work:
        st = per.setdefault(e["args"]["stream"], dict(count=0, ms=0.0))
        st["count"] += 1
        st["ms"] += e["dur"] / 1e3
    spans = {}
    for e in work:
        spans.setdefault(e["args"]["stream"] == main, []).append(
            (e["ts"], e["ts"] + e["dur"]))
    both_ms = _overlap_us(
        _union((e["ts"], e["ts"] + e["dur"]) for e in spmm),
        _union(spans.get(False, [])),
    ) / 1e3
    kinds = {"index_add_": ("indexFunc", "index_add"),
             "gather": ("indexSelect", "index_select", "gather_kernel")}
    calls = {}
    for kind, keys in kinds.items():
        hit = [e for e in work if e.get("cat") == "kernel"
               and any(k in e["name"] for k in keys)]
        calls[kind] = dict(count=len(hit),
                           ms=sum(e["dur"] for e in hit) / 1e3)
    log(f"streams {label}: " + "; ".join(
        f"stream {k}{' (SpMM)' if k == main else ''}: {v['count']} device "
        f"ops, {v['ms']:.2f} ms" for k, v in sorted(per.items()))
        + f" | SpMM beside another stream's work {both_ms:.2f} ms | "
        + ", ".join(f"{k} {v['count']} calls {v['ms']:.2f} ms"
                    for k, v in calls.items()))
    return dict(per_stream={str(k): v for k, v in per.items()},
                spmm_stream=main, spmm_beside_other_ms=both_ms, **calls)


def cuda_ms(fn, reps, warm=2):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(slots, vals_bytes, x_bytes, out_bytes, extra=0):
    """The least time for one application: the bytes each input is read
    once and the output written once over the device-memory rate, or 2
    flops per slot per column over the f32 rate, whichever is larger."""
    moved = slots * (2 + vals_bytes) + x_bytes + out_bytes + extra
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    flops_ms = 2 * slots * FUSE / F32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, flops_ms),
                bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                bytes=moved, flops_ms=flops_ms)


def ell_csr(t, vals, n_cols):
    """The shard as a CSR matrix [B*R, C] holding ``vals`` (f32): one
    ``torch.sparse.mm`` with it computes the kernels' function."""
    import torch

    inds, winmap = t["inds"], t["winmap"]
    b, s, r, k = inds.shape
    cols = torch.gather(winmap.long(), 2, inds.long().reshape(b, s, r * k))
    rows = (torch.arange(b, device=inds.device)[:, None, None] * r
            + torch.arange(r, device=inds.device).repeat_interleave(k)
            [None, None, :]).expand(b, s, r * k)
    v = vals.reshape(b, s, r * k)
    keep = v != 0
    coo = torch.sparse_coo_tensor(
        torch.stack([rows[keep], cols[keep]]), v[keep].float(),
        size=(b * r, n_cols),
    ).coalesce()
    return coo.to_sparse_csr()


def times(plan, a, device):
    """Phase 5: per-application times at F=16 of every kernel on proj and
    back, its plain version, the library yardstick and its bound.
    Returns {kernel key: {variant: {operator: record}}}."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from repro_torch.core import precision as prec
    from repro_torch.kernels import ops
    from repro_torch.kernels import xct_spmm as xs

    out = {key: {} for key, _, _ in KERNELS}
    mats = {"proj": a, "back": sp.csr_matrix(a.T)}
    profiled = []
    f16, f32 = torch.float16, torch.float32

    def record(key, variant, name, k_ms, p_ms, lib_ms, bnd, **more):
        rec = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, **bnd, **more)
        out[key].setdefault(variant, {})[name] = rec
        log(f"time {key} {variant} {name} F={FUSE}: kernel {k_ms:.4f} ms | "
            f"plain {p_ms:.3f} ms | torch.sparse.mm {lib_ms:.4f} ms | bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bytes'] / 1e9:.3f} GB at "
            f"3.35 TB/s; operations {bnd['flops_ms']:.4f} ms at 67 TFLOP/s) "
            f"| roofline share {bnd['bound_ms'] / k_ms:.3f}"
            + "".join(f" | {k} {v}" for k, v in more.items()))

    for name in ("proj", "back"):
        op = getattr(plan, name)
        t = operator_tensors(op, device)
        _, b, s, r, k = op.inds.shape
        slots = b * s * r * k
        out_bytes = b * r * FUSE * 4
        x32 = torch.from_numpy(
            np.random.default_rng(3).normal(
                size=(op.n_cols_pad, FUSE)
            ).astype(np.float32)
        ).to(device)
        x16 = x32.to(f16)
        m = mats[name].tocsr()
        csr = torch.sparse_csr_tensor(
            torch.from_numpy(m.indptr.astype(np.int64)),
            torch.from_numpy(m.indices.astype(np.int64)),
            torch.from_numpy(m.data.astype(np.float32)),
            size=m.shape, device=device, check_invariants=False,
        )
        xd = torch.from_numpy(
            np.random.default_rng(4).normal(
                size=(m.shape[1], FUSE)
            ).astype(np.float32)
        ).to(device)
        lib_ms = cuda_ms(lambda: torch.sparse.mm(csr, xd), 20)
        del csr

        # row 1 under mixed and single
        for variant, storage in (("mixed", f16), ("single", f32)):
            vals = t["vals"].to(storage)
            x = x32.to(storage)
            sb = x.element_size()
            k_ms = cuda_ms(lambda: xs.spmm_block_ell(
                t["inds"], vals, t["winmap"], x, compute_dtype=f32,
                winsegs=t["winsegs"], segoff=t["segoff"]), 20)
            p_ms = cuda_ms(lambda: xs.spmm_block_ell_plain(
                t["inds"], vals, t["winmap"], x, compute_dtype=f32), 3,
                warm=1)
            record("row1", variant, name, k_ms, p_ms, lib_ms,
                   bound(slots, sb, op.n_cols_pad * FUSE * sb, out_bytes))

        vals = t["vals"].to(f16)
        x_bytes = op.n_cols_pad * FUSE * 2
        # rows 2 and 3 read their table too: every slot of the unsorted
        # segment table, every winmap entry
        unsorted = unsorted_table(t["winmap"], device)
        table_bytes = {"row2": unsorted.numel() * 4,
                       "row3": t["winmap"].numel() * 4}
        # row 2: unsorted segment table
        k_ms = cuda_ms(lambda: xs.spmm_block_ell(
            t["inds"], vals, t["winmap"], x16, winsegs=unsorted), 20)
        p_ms = cuda_ms(lambda: xs.spmm_block_ell_plain(
            t["inds"], vals, t["winmap"], x16, winsegs=unsorted), 3, warm=1)
        record("row2", "mixed", name, k_ms, p_ms, lib_ms,
               bound(slots, 2, x_bytes, out_bytes, extra=table_bytes["row2"]),
               table_bytes=table_bytes["row2"])
        # row 3: one copy per window row
        k_ms = cuda_ms(lambda: xs.spmm_block_ell(
            t["inds"], vals, t["winmap"], x16), 20)
        p_ms = cuda_ms(lambda: xs.spmm_block_ell_plain(
            t["inds"], vals, t["winmap"], x16), 3, warm=1)
        record("row3", "mixed", name, k_ms, p_ms, lib_ms,
               bound(slots, 2, x_bytes, out_bytes, extra=table_bytes["row3"]),
               table_bytes=table_bytes["row3"])
        # row 4: windows gathered into device memory, 64 MB chunks
        buf = op.winmap.shape[-1]
        bpc = ops._gather_blocks_per_call(b, s, buf, FUSE, 2)
        spans = [(lo, min(b, lo + bpc)) for lo in range(0, b, bpc)]
        window = x16[t["winmap"].long()]  # the whole [B, S, BUF, F] tensor

        def chunk_loop(inds=t["inds"], vals=vals, window=window, spans=spans):
            """apply_operator's gather loop without the gather: each chunk
            sliced and launched"""
            return [xs.spmm_block_ell_staged(inds[lo:hi], vals[lo:hi],
                                             window[lo:hi])
                    for lo, hi in spans]

        k_ms = cuda_ms(chunk_loop, 10)
        one_ms = cuda_ms(lambda: xs.spmm_block_ell_staged(
            t["inds"], vals, window), 10)
        g_ms = cuda_ms(lambda: [x16[t["winmap"][lo:hi].long()]
                                for lo, hi in spans], 10)
        a_ms = cuda_ms(lambda: ops.apply_operator(
            t["inds"], vals, t["winmap"], x16, staging="gather"), 10)
        p_ms = cuda_ms(lambda: xs.spmm_block_ell_staged_plain(
            t["inds"], vals, window), 3, warm=1)
        record("row4", "mixed", name, k_ms, p_ms, lib_ms,
               bound(slots, 2, x_bytes, out_bytes, extra=window.numel() * 2),
               launches_per_apply=len(spans), rows_per_chunk=bpc,
               gather_ms=round(g_ms, 4), one_launch_ms=round(one_ms, 4),
               apply_operator_ms=round(a_ms, 4))
        # the chunked loop's device time, taken after every other timing:
        # a profiler session leaves each later launch slower on the host
        profiled.append((name, chunk_loop))
        del window
        # row 1q: int8 and fp8 values on the class-sorted staging, then
        # on rows 2 and 3's tables
        for variant, qdtype in (("q8", torch.int8),
                                ("fp8", torch.float8_e4m3fn)):
            q, e = quantized(op, qdtype, device)
            qcsr = ell_csr(t, prec.dequantize_block_vals(q, e),
                           op.n_cols_pad)
            q_lib_ms = cuda_ms(lambda: torch.sparse.mm(qcsr, x32), 20)
            del qcsr
            for staging, tables, table in (
                ("", dict(winsegs=t["winsegs"], segoff=t["segoff"]), 0),
                ("_unsorted", dict(winsegs=unsorted), table_bytes["row2"]),
                ("_per_row", {}, table_bytes["row3"]),
            ):
                k_ms = cuda_ms(lambda: xs.spmm_block_ell(
                    t["inds"], q, t["winmap"], x16, scales=e, **tables), 20)
                if staging != "_per_row":  # per_row's plain is sorted's
                    p_ms = cuda_ms(lambda: xs.spmm_block_ell_plain(
                        t["inds"], q, t["winmap"], x16, scales=e,
                        winsegs=tables.get("winsegs") if staging else None),
                        3, warm=1)
                record("row1q", variant + staging, name, k_ms, p_ms, q_lib_ms,
                       bound(slots, 1, x_bytes, out_bytes,
                             extra=b * s * 4 + table))
            del q, e
        del t, unsorted
    for name, chunk_loop in profiled:
        dev_ms = device_ms(chunk_loop)
        out["row4"]["mixed"][name]["device_ms"] = round(dev_ms, 4)
        log(f"time row4 mixed {name}: device time of the chunked launches "
            f"{dev_ms:.4f} ms (torch.profiler)")
    return out


def entry(key, name, replaces, launches, err, per_operator):
    """One element of the ``kernels`` line: proj + back per application."""
    first = next(iter(per_operator.values()))
    total = {f: first["proj"][f] + first["back"][f]
             for f in ("ms", "plain_ms", "bound_ms", "library_ms")}
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/csrc/xct_spmm.cu",
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        **total, "bound_by": first["proj"]["bound_by"],
        **({"redesigned": REDESIGNED[key]} if key in REDESIGNED else {}),
        "per_operator": per_operator,
    }


def card_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import xct_spmm as xs

    device = torch.device("cuda")
    start = time.perf_counter()
    card = card_line()
    log(f"card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    path, secs, build_log = xs.build()
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {secs:.1f} s, {len(xs.ENTRIES)} entries)")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    def phase(name):
        log(f"[{time.perf_counter() - start:7.1f} s] {name}")

    phase("phase 2a: the kernel sweep")
    sweep_errs = check_sweep(device)
    geo, a, plan = build_problem(N, ANGLES)
    phase("phase 2b: the n=512 shards")
    shard_errs = check_shards(plan, device)
    phase("phase 3: the main path")
    xs.reset_launches()
    runs = main_path(plan, a, device)
    launches = dict(xs.LAUNCHES)
    log(f"main path launches per kernel: {launches} (spmm_block_ell "
        f"{xs.spmm_block_ell.launches}, spmm_block_ell_staged "
        f"{xs.spmm_block_ell_staged.launches})")
    counts = {
        "row1": launches["sorted"],
        "row1q": launches["sorted_q"] + launches["unsorted_q"]
        + launches["per_row_q"],
        "row2": launches["unsorted"], "row3": launches["per_row"],
        "row4": launches["staged"],
    }
    missing = [key for key, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    phase("phase 6: the exchange over a mesh")
    plan4, mesh_tables = build_mesh_plan(geo, a)
    mesh_errs, mesh_shards = check_mesh_shards(plan4, device)
    xs.reset_launches()
    mesh_checks, mesh_solves = mesh_path(plan, plan4, a, device, runs)
    mesh_launches = dict(xs.LAUNCHES)
    log(f"mesh path launches per kernel: {mesh_launches}")
    if mesh_launches["sorted"] == 0 or mesh_launches["sorted_q"] == 0:
        raise AssertionError("rows 1 and 1q must both run on the mesh path")
    counts["row1"] += mesh_launches["sorted"]
    counts["row1q"] += mesh_launches["sorted_q"]
    runs.update(mesh_solves)
    # phase 5 before phase 4: a torch.profiler session leaves every later
    # launch slower on the host, which the chunked row 4 would measure
    phase("phase 5: times")
    timing = times(plan, a, device)
    phase("phase 4: profiles")
    profiles = {p: profile_solve(plan, a, device, precision=p)
                for p in ("mixed", "q8")}
    for key, overlap in (("p4_hier-sparse_mixed", True),
                         ("p4_hier-sparse_mixed_serial", False)):
        profiles[key] = profile_solve(
            plan4, a, device, precision="mixed",
            topology=mesh_topology(device), rows=16,
            comm_mode="hier-sparse", overlap=overlap,
        )
    kernels = []
    for key, name, replaces in KERNELS:
        kernels.append(entry(
            key, name, replaces, counts[key],
            max(sweep_errs[key], shard_errs[key], mesh_errs.get(key, 0.0)),
            timing[key],
        ))
    kernels[0]["solves"] = runs
    kernels[0]["profiles"] = profiles
    kernels[0]["mesh"] = dict(checks=mesh_checks, tables=mesh_tables,
                              launches=mesh_launches, shards=mesh_shards)
    phase("done")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
