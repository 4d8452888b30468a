#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases, each fatal on failure:

1. the card (``nvidia-smi``) and the build of ``csrc/xct_spmm.cu``;
2. the CUDA kernel against its plain PyTorch version, for every
   (storage, compute) pair the float policies use, on the kernel test
   sweep and on the n=512 projector and backprojector shards;
3. the main path: ``Reconstructor`` at n=512, 384 angles, 32 slices,
   ``fuse=16``, 30 CGNR iterations, under ``mixed`` and ``single``, with
   the kernel's launch count read around each solve;
4. a profiled mixed solve: device time by kernel and the idle share;
5. per-application times of the kernel, its plain version and
   ``torch.sparse.mm`` (cuSPARSE, used here only as a yardstick) beside
   the memory-bandwidth bound; the solve's wall time and peak memory.

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
]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


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


def check_sweep(device):
    """Phase 2a: every kernel pair on the sweep shapes."""
    from repro_torch.kernels import xct_spmm as xs

    for storage, compute in xs.KERNEL_PAIRS:
        worst = 0.0
        for i, shape in enumerate(SWEEP):
            inds, vals, winmap, x, segs, off = random_shard(
                shape, storage, device, seed=i
            )
            out = xs.spmm_block_ell(inds, vals, winmap, x,
                                    compute_dtype=compute,
                                    winsegs=segs, segoff=off)
            plain = xs.spmm_block_ell_plain(inds, vals, winmap, x,
                                            compute_dtype=compute)
            err, ok, tol = compare(out, plain, storage)
            if not ok:
                raise AssertionError(
                    f"kernel {pair_name(storage, compute)} disagrees with "
                    f"its plain version on {shape}: max err {err}"
                )
            worst = max(worst, err)
        log(f"sweep {pair_name(storage, compute)}: max abs err {worst:.3e} "
            f"(tolerance {tol:g}, {len(SWEEP)} shapes)")


def operator_tensors(op, device):
    import torch

    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return {
        "inds": t(op.inds[0]), "vals": t(op.vals[0]),
        "winmap": t(op.winmap[0]), "winsegs": t(op.winsegs[0]),
        "segoff": t(op.segoff[0]),
    }


def check_shards(plan, device):
    """Phase 2b: every kernel pair on the slice's proj and back shards,
    one apply_operator each.  Returns {operator: max abs err at f16/f32}."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import xct_spmm as xs

    errs = {}
    for name in ("proj", "back"):
        op = getattr(plan, name)
        t = operator_tensors(op, device)
        x = torch.from_numpy(
            np.random.default_rng(7).normal(
                size=(op.n_cols_pad, FUSE)
            ).astype(np.float32)
        ).to(device)
        for storage, compute in xs.KERNEL_PAIRS:
            vals = t["vals"].to(storage)
            out = ops.apply_operator(
                t["inds"], vals, t["winmap"], x, storage_dtype=storage,
                compute_dtype=compute, winsegs=t["winsegs"],
                segoff=t["segoff"],
            )
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
            if (storage, compute) == (torch.float16, torch.float32):
                errs[name] = err
            del out, plain
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


def main_path(plan, a, device, slices=SLICES, fuse=FUSE, iters=ITERS):
    """Phase 3.  Returns launches per solve and the solve records."""
    import numpy as np
    import torch

    from repro_torch.core.recon import ReconConfig, Reconstructor
    from repro_torch.data.phantom import phantom_slices, simulate_measurements
    from repro_torch.kernels import xct_spmm as xs

    n = plan.geo.n
    x_true = phantom_slices(n, slices, seed=0)
    sino = simulate_measurements(a, x_true, seed=0)
    expected = 2 * (iters + 1) * (slices // fuse)
    runs = {}
    launches = 0
    for precision in ("mixed", "single"):
        rec = Reconstructor(
            plan, cfg=ReconConfig(precision=precision, fuse=fuse),
            device=device,
        )
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        xs.spmm_block_ell.launches = 0
        t0 = time.perf_counter()
        x, res = rec.reconstruct(sino, iters=iters)
        wall = time.perf_counter() - t0
        count = xs.spmm_block_ell.launches
        launches += count
        peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
                else 0)
        rel = np.linalg.norm(x - x_true, axis=0) / np.linalg.norm(
            x_true, axis=0
        )
        runs[precision] = dict(rel=float(rel.mean()), wall_s=wall,
                               peak_bytes=int(peak), launches=count)
        log(f"solve {precision}: {iters} iters x {slices} slices in "
            f"{wall:.2f} s | rel err mean {rel.mean():.4f} | residual "
            f"{res[0].mean():.4e} -> {res[-1].mean():.4e} | kernel "
            f"launches {count} | peak device memory {peak / 2**30:.2f} GiB")
        if not np.isfinite(x).all():
            raise AssertionError(f"{precision}: non-finite solution")
        if x.shape != x_true.shape or res.shape != (iters, slices):
            raise AssertionError(f"{precision}: shapes {x.shape} {res.shape}")
        if not (res[-1] < 0.05 * res[0]).all():
            raise AssertionError(f"{precision}: residual did not fall 20x")
        if device.type == "cuda" and count != expected:
            raise AssertionError(
                f"{precision}: {count} kernel launches, expected "
                f"2*(iters+1)*(slices/fuse) = {expected}"
            )
        if precision == "single":
            xs.spmm_block_ell.launches = 0
            yhat = rec.project(x_true)
            launches += xs.spmm_block_ell.launches
            ref = a @ x_true
            err = np.abs(yhat - ref)
            bound = 2e-4 * np.abs(ref) + 2e-4 * np.abs(ref).max()
            log(f"project vs scipy A @ x: max abs err {err.max():.3e} "
                f"(max |A x| {np.abs(ref).max():.3e}, rtol 2e-4, "
                f"atol 2e-4*max|A x|)")
            if not (err <= bound).all():
                raise AssertionError("project disagrees with scipy A @ x")
        del rec
    if not runs["mixed"]["rel"] < runs["single"]["rel"] + 0.03:
        raise AssertionError(
            f"mixed rel err {runs['mixed']['rel']:.4f} is not within +0.03 "
            f"of single's {runs['single']['rel']:.4f}"
        )
    return launches, runs


def profile_solve(plan, a, device, slices=SLICES, fuse=FUSE, iters=ITERS):
    """Phase 4: where a mixed solve's device time goes (torch.profiler).

    Returns {wall_s, device_s, busy_share, top: [(name, ms, calls)]};
    device_s is None when the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.recon import ReconConfig, Reconstructor
    from repro_torch.data.phantom import phantom_slices, simulate_measurements

    x_true = phantom_slices(plan.geo.n, slices, seed=0)
    rec = Reconstructor(plan, cfg=ReconConfig(precision="mixed", fuse=fuse),
                        device=device)
    staged = rec.stage_sino(simulate_measurements(a, x_true, seed=0))
    rec.reconstruct(staged, iters=1)  # warm-up outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rec.reconstruct(staged, iters=iters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0
        )

    # device-side events only (kernels, copies): an operator's row
    # repeats the time of the kernels it launched
    rows = sorted(
        ((e.key, dev_us(e) / 1e3, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
        key=lambda r: -r[1],
    )
    device_s = sum(r[1] for r in rows) / 1e3 if rows else None
    if device_s is None:
        log("profile mixed solve: no device time in the trace (not measured)")
    else:
        log(f"profile mixed solve (profiler on): wall {wall:.3f} s, device "
            f"busy {device_s:.3f} s, idle share {1 - device_s / wall:.3f}")
        for name, ms, calls in rows[:8]:
            log(f"  {ms:9.2f} ms {calls:6d} calls  {name[:90]}")
    return dict(wall_s=wall, device_s=device_s,
                busy_share=None if device_s is None else device_s / wall,
                top=[[n[:90], ms, c] for n, ms, c in rows[:8]])


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


def times(plan, a, device, storage, compute):
    """Phase 5: per-application times at F=16 for proj and back."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from repro_torch.kernels import xct_spmm as xs

    out = {}
    mats = {"proj": a, "back": sp.csr_matrix(a.T)}
    for name in ("proj", "back"):
        op = getattr(plan, name)
        t = operator_tensors(op, device)
        vals = t["vals"].to(storage)
        x = torch.from_numpy(
            np.random.default_rng(3).normal(
                size=(op.n_cols_pad, FUSE)
            ).astype(np.float32)
        ).to(device, storage)

        def kernel():
            return xs.spmm_block_ell(
                t["inds"], vals, t["winmap"], x, compute_dtype=compute,
                winsegs=t["winsegs"], segoff=t["segoff"],
            )

        def plain():
            return xs.spmm_block_ell_plain(
                t["inds"], vals, t["winmap"], x, compute_dtype=compute
            )

        k_ms = cuda_ms(kernel, 20)
        p_ms = cuda_ms(plain, 3, warm=1)
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
        _, b, s, r, k = op.inds.shape
        slots = b * s * r * k
        sb = torch.tensor([], dtype=storage).element_size()
        moved = slots * (2 + sb) + op.n_cols_pad * FUSE * sb + b * r * FUSE * 4
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        flops_ms = 2 * slots * FUSE / F32_FLOP_PER_S * 1e3
        out[name] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                         bound_ms=max(bytes_ms, flops_ms),
                         bound_by="bytes" if bytes_ms >= flops_ms
                         else "operations",
                         bytes=moved, slots=slots)
        log(f"time {name} {pair_name(storage, compute)} F={FUSE}: kernel "
            f"{k_ms:.4f} ms | plain {p_ms:.3f} ms | torch.sparse.mm "
            f"(cuSPARSE, f32 CSR) {lib_ms:.4f} ms | bound {bytes_ms:.4f} ms "
            f"({moved / 1e9:.3f} GB at 3.35 TB/s; operations "
            f"{flops_ms:.4f} ms at 67 TFLOP/s) | roofline share "
            f"{max(bytes_ms, flops_ms) / k_ms:.3f}")
        del t, csr
    return out


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
    card = card_line()
    log(f"card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    path, secs, build_log = xs.build()
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {secs:.1f} s)")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    check_sweep(device)
    geo, a, plan = build_problem(N, ANGLES)
    shard_errs = check_shards(plan, device)
    launches, runs = main_path(plan, a, device)
    runs["mixed"]["profile"] = profile_solve(plan, a, device)
    timing = {
        "mixed": times(plan, a, device, torch.float16, torch.float32),
        "single": times(plan, a, device, torch.float32, torch.float32),
    }
    t = timing["mixed"]
    entry = {
        "name": "spmm_block_ell",
        "route": "cuda",
        "source": "src/repro_torch/csrc/xct_spmm.cu",
        "replaces": "src/repro/kernels/xct_spmm.py:249",
        "launches": launches,
        "max_abs_err": max(shard_errs.values()),
        # one projector plus one backprojector application at F=16,
        # f16 storage / f32 compute (the mixed policy)
        "ms": t["proj"]["ms"] + t["back"]["ms"],
        "plain_ms": t["proj"]["plain_ms"] + t["back"]["plain_ms"],
        "bound_ms": t["proj"]["bound_ms"] + t["back"]["bound_ms"],
        "bound_by": t["proj"]["bound_by"],
        "library_ms": t["proj"]["library_ms"] + t["back"]["library_ms"],
        "per_operator": timing,
        "solves": runs,
    }
    log(json.dumps({"kernels": [entry]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
