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
   the card, two batch groups on the same plan, whose projections and
   solve must equal one group's bit for bit (the CG dots sum in f64);
   the ``recon/solve`` span beside a host timer;
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
   solves with and without the side stream beside phase 4's;
7. out-of-core streaming of the main path's plan: 64 slices simulated
   into an on-disk slab store in 16-slice writer slabs, drained by
   ``reconstruct_streaming`` under a byte budget that ``suggest_slab``
   sizes to 16-slice slabs (``mixed``, 30 iterations, the next slab
   loaded and uploaded in the prefetch thread while one solves); every
   slab must equal ``Reconstructor.reconstruct`` of the same 16 slices
   bit for bit, the drain must give the same volume with the upload on
   the critical path and with prefetch off, after a preemption and
   resume from the checkpoint, and with one transient read error
   absorbed by one retry; the peak device memory beside the budget model
   and the per-slab load, upload and solve times are printed;
8. the reconstruction service (``repro_torch.serve``) on the card: a
   ``ReconServer`` (8 GiB budget) whose plan cache is seeded with phase
   3's plan (geometry A, ``mixed``), serving phase 7's store; a second
   geometry B (n=256, 192 angles) and B under ``q8`` (C) are built cold
   by the server.  Wave 1 serves A and B, wave 2 three A jobs (one
   through a read that fails once) and C, then the background scheduler
   serves B and A.  Every A volume must equal wave 1's and the in-memory
   solve of its slices bit for bit, B's background volume wave 1's; the
   cache must build three plans and every later batch but C's first be
   warm; C's residual must fall below 0.05 of its first.  Per job the
   queue, load, upload and solve seconds and the queue-to-first-slab,
   jobs per second, the cache and peak memory over wave 2 are printed.
   Then tuning and drift: the per-copy overhead calibrated on the card,
   the autotuner on A at xct-shale's depth, its passport found by this
   card's fingerprint, one A job whose slab the passport caps, and the
   CLI with ``--tune-dir`` and ``--trace`` printing the drift report.

9. the dry run (``launch.dryrun``, ``Reconstructor(abstract=True)``):
   (a) phase 3's plan (mixed, ``fuse=16``, the kernel path) lowered on
   fake tensors with ``lower_cg`` for 2 iterations, during which row 1
   must launch no time; a real reconstructor bound on the card, whose
   tensors' bytes must equal the abstract argument bytes, then the same
   CG function on real inputs, its ``max_memory_allocated`` printed
   beside the abstract peak, and rows 1 and 4 through their wrappers
   (direct launches) against the custom ops registered for the trace;
   (b) the same for phase 6's
   four-rank plan, a fake 2x2 mesh against the card's 2x2 mesh, rank by
   rank; (c) on the host: the §Perf sweep's rows, modeled with the
   H100's rates and printed on their own lines (kept out of the kernels
   line), and the dry-run cell of every Table II dataset on one pod and of xct-brain on
   two, on the oracle's path (the reference's cell) and the kernel path,
   each in a process of its own started before (a): the busiest rank's
   and rank 0's bytes against the card's memory, and the traced bytes
   between devices beside the modeled ones.  The CG vectors are sharded
   per rank, so on the kernel path rank 0 must hold no more than 1.05x
   the busiest other rank, and xct-brain on one pod must fit the card;
10. LM serving (``repro_torch.models``, ``launch.lm_serve``): qwen3-4b
   at its full published width and depth from seeded weights on the
   card: (a) the cache invariant (prefill 32 tokens, decode token 32,
   against the forward over 33) held to the reference's bound with f32
   activations and measured in bf16, with the count of layer 0's
   q-projection outputs that cuBLAS rounds differently for the decode's
   4 rows alone than inside the forward's 132; (b) the first two layers, copied
   to the host, against the card: bf16 prefill logits within 2e-2 of
   max|.| and equal f32 greedy tokens; (c) every architecture's SMOKE
   config on the card, the cache invariant in bf16 and recurrentgemma's
   window past its wrap; (d) the serve loop (batch 4, prompt 32, 16
   tokens) twice, with its prefill seconds, decode tokens per second
   and peak memory.  No SpMM kernel may launch here;
11. LM training (``models.lm``, ``opt``, ``data.tokens``, ``ckpt``):
   smollm-135m at its full published width from seeded weights, 8 x 128
   token batches: (a) 25 AdamW steps must take the loss down by 0.5;
   (b) one step at 2 layers, card against host (f32: loss 1e-4, every
   gradient leaf 1e-3 of its max; bf16: loss 2e-2); (c) the paper's
   hierarchical bf16 gradient sync on a (pod=2, data=2, model=1) mesh of
   this card against the spmd step (loss 1e-4, synced gradients 2**-7
   of max|g|, parameters 5e-3) with the wire bytes per level; (d) a
   checkpoint at step 10 restored bit for bit and resumed to step 15
   within the spread of two uninterrupted runs; (e) step seconds,
   tokens per second and peak memory of the spmd and hier steps beside
   the card's name and power limit.  No SpMM kernel may launch here;
12. the LM dry run (``launch.dryrun.lower_lm_cell``, ``core.lowering``):
   (a) ``remat`` on the card: smollm-135m at full width, one step's loss
   and gradients on 2 x 4096 tokens under ``"none"``, ``"full"`` and
   ``"dots"``, equal bit for bit, with each one's peak memory; (b) the
   same three programs, phase 10's qwen3-4b prefill (4 x 32) and decode
   step and phase 11's spmd step, each traced on one placeholder: the
   argument bytes must equal those bound on the card and the traced peak
   lie within 10% of ``max_memory_allocated``; (c) on the host, in
   processes of their own started before phase 10: qwen3-4b
   ``train_4k`` (one pod and two), ``prefill_32k`` and ``decode_32k``,
   smollm-135m ``train_4k``, recurrentgemma-9b ``long_500k`` and
   xlstm-350m ``train_4k`` (time FD), each ``ok``, with the busiest
   rank's and rank 0's peak against the card, the bytes between devices
   by link class, the dominant roofline term and the trace's seconds
   (printed, kept out of the kernels line).  No SpMM kernel may launch;
13. tensor parallelism over ``model`` (``dist.sharding.place_state``,
   ``models.transformer.forward_group``, the split steps), every mesh
   position the card: (a) qwen3-4b at full width served from its state
   laid out on a (1, 1, 4) mesh, f32 prefill logits within 1e-4 of
   max|logit| of the one-device prefill, with the bf16 greedy tokens'
   agreement, tokens per second and peak printed; (b) smollm-135m at
   full width, the split spmd step on (1, 1, 3) against one device (f32,
   loss and gradients within 1e-4 of max|g|) and the hier step on (1, 2,
   3) with its seconds, tokens per second and peak; (c) the split step
   traced on one placeholder against the card (argument bytes equal,
   peak within 10% of ``max_memory_allocated``, as 12b); (d) phase 12c's qwen3-4b
   ``train_4k`` cells (one pod, two): rank 0 fits the card, FLOPs per
   device at most twice the useful FLOPs, no ``replicate`` copy.  The
   host cells of phase 12c start with the script.  No SpMM kernel may
   launch.

At f32/f32 row 1 must equal its plain version bit for bit (phase 2):
both round the step once, as one fused multiply-add.

The last lines are a ``kernels`` JSON object, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
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
    # R=K=64, the autotuner's other block shape (phase 8's CLI may run it)
    (2, 3, 64, 64, 96, 256, 16),
]
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
            if (storage, compute) == (torch.float32, torch.float32) and \
                    not torch.equal(outs["row1"], plain):
                raise AssertionError(
                    f"row 1 f32/f32 is not its plain version bit for bit "
                    f"on {shape}: the step must round once")
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
            "row 1 bit for bit"
            + ("; row 1 == plain bit for bit"
               if (storage, compute) == (torch.float32, torch.float32)
               else ""))
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
            if (storage, compute) == (torch.float32, torch.float32):
                if not torch.equal(out, plain):
                    raise AssertionError(
                        f"row 1 f32/f32 is not its plain version bit for "
                        f"bit on the {name} shard")
                log(f"shard {name} f32/f32: row 1 == its plain version, bit "
                    "for bit (the step rounds once)")
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


def build_problem(n, angles, beside=None):
    """The system matrix and the one-rank plan.  ``beside``, if given, is
    called with ``(geo, a)`` as soon as the matrix is built: ``main``
    starts phase 6's plan build there on a thread, so that the two host
    builds run side by side (numpy holds the GIL little)."""
    from repro_torch.core.geometry import XCTGeometry, build_system_matrix
    from repro_torch.core.partition import PartitionConfig, build_plan

    geo = XCTGeometry(n=n, n_angles=angles)
    t0 = time.perf_counter()
    a = build_system_matrix(geo)
    t_a = time.perf_counter() - t0
    if beside is not None:
        beside(geo, a)
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
    projections must equal the one-group ones bit for bit, and so must
    its solve: the CG dots sum in f64, whatever the column count."""
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
        f"P=1 solve {diff:.3e} (max |x| {float(np.abs(p1[0]).max()):.3e}), "
        f"residual max abs diff {float(np.abs(res - p1[1]).max()):.3e}")
    if not (np.isfinite(x).all() and (res[-1] < 0.05 * res[0]).all()):
        raise AssertionError("batch solve: non-finite or residual did not "
                             "fall 20x")
    # the CG dots sum in f64, so summing 16 columns per group where the
    # one-group solve sums 32 leaves the bits alone
    if not (np.array_equal(x, p1[0]) and np.array_equal(res, p1[1])):
        raise AssertionError("batch solve differs from the P=1 solve")
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


STREAM_SLICES, WRITER_SLAB = 64, 16  # phase 7's volume and store shards


def stream_path(plan, a, device, tmp, slices=STREAM_SLICES, fuse=FUSE,
                iters=ITERS, writer_slab=WRITER_SLAB):
    """Phase 7: the main path's plan streamed slab by slab from disk, the
    store and the drains' volumes under the directory ``tmp``.  Returns
    the phase's record and the sinogram store (phase 8 serves from it);
    the caller reads the launch counts around it."""
    import os

    import numpy as np
    import torch

    from repro_torch.core.recon import ReconConfig, Reconstructor
    from repro_torch.data.phantom import phantom_slices
    from repro_torch.obs import trace as obs_trace
    from repro_torch.resil import (
        FaultPlan,
        InjectedPreemption,
        RetryPolicy,
        inject,
    )
    from repro_torch.stream import (
        SlabStore,
        reconstruct_streaming,
        simulate_to_store,
        suggest_slab,
    )

    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    n = plan.geo.n
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rec = Reconstructor(plan, cfg=ReconConfig(precision="mixed", fuse=fuse),
                        device=device)
    bind_peak = torch.cuda.max_memory_allocated() if cuda else 0
    model = suggest_slab(plan, rec.cfg, rec.topology, 1 << 50)
    # room for 1.25 slabs of fuse slices: suggest_slab rounds down to one
    room = fuse + fuse // 4
    budget = model.fixed_bytes + room * model.per_slice_bytes
    sp = suggest_slab(plan, rec.cfg, rec.topology, budget, n_slices=slices)
    log(f"stream plan: budget {budget} B = fixed {sp.fixed_bytes} + {room} x "
        f"per-slice {sp.per_slice_bytes} -> y_slab {sp.y_slab}, slab_bytes "
        f"{sp.slab_bytes}, smem_bytes {sp.smem_bytes} per SM, modeled "
        f"traffic {sp.slab_hbm_bytes / 1e9:.3f} GB and "
        f"{sp.slab_flops / 1e9:.3f} GFLOP per slab iteration")
    if sp.y_slab != fuse:
        raise AssertionError(f"suggest_slab gave y_slab {sp.y_slab}, not "
                             f"{fuse}")
    out = dict(budget=budget, y_slab=sp.y_slab, slab_bytes=sp.slab_bytes,
               fixed_bytes=sp.fixed_bytes, per_slice_bytes=sp.per_slice_bytes,
               smem_bytes=sp.smem_bytes, bind_peak_bytes=int(bind_peak))
    quick = RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0)
    store = SlabStore.create(os.path.join(tmp, "sino"), plan.geo.n_rays,
                             slices, writer_slab)
    t0 = time.perf_counter()
    simulate_to_store(a, n, store, seed=0)
    out["simulate_s"] = time.perf_counter() - t0
    mem = {}
    for j0, j1 in store.slabs():
        mem[j0] = rec.reconstruct(store.read(j0, j1), iters=iters)

    def drain(tag, **kw):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = reconstruct_streaming(rec, store, os.path.join(tmp, tag),
                                    iters=iters, mem_budget=budget, **kw)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        if res.failed_slabs or not res.complete:
            raise AssertionError(f"stream {tag}: quarantined "
                                 f"{res.failed_slabs}, complete "
                                 f"{res.complete}")
        return res, wall, peak

    old = obs_trace.get_tracer()
    tracer = obs_trace.enable()
    try:
        res, wall, peak = drain("overlap")
    finally:
        obs_trace.set_tracer(old)
    # where the drain's wall goes, by span (the load and stage spans
    # run on the prefetch thread, beside the others)
    spans = {name: tracer.total_s(name) for name in (
        "stream/slab", "stream/solve", "stream/write", "stream/load",
        "stream/stage", "recon/solve")}
    for j0, j1 in res.volume.slabs():
        x, r = mem[j0]
        if not (np.array_equal(res.volume.read(j0, j1), x)
                and np.array_equal(res.resnorms[:, j0:j1], r)):
            raise AssertionError(f"streamed slab [{j0}, {j1}) differs "
                                 "from the in-memory solve")
    volume = res.volume.to_array()
    x_true = phantom_slices(n, slices, seed=0)
    rel = np.linalg.norm(volume - x_true, axis=0) / np.linalg.norm(
        x_true, axis=0)
    solve_sum = float(np.sum(res.solve_s))
    out.update(
        slabs=len(res.solved), wall_s=wall, load_s=res.load_s,
        upload_s=res.upload_s, solve_s=res.solve_s, slab_s=res.slab_s,
        solve_sum_s=solve_sum, slices_per_s=slices / wall,
        peak_bytes=int(peak), rel=float(rel.mean()), spans_s=spans,
    )
    log(f"stream overlap: {len(res.solved)} slabs of {res.y_slab} in "
        f"{wall:.3f} s ({slices / wall:.1f} slices/s), sum of slab solves "
        f"{solve_sum:.3f} s | per slab load "
        f"{[round(t, 4) for t in res.load_s]} upload "
        f"{[round(t, 4) for t in res.upload_s]} solve "
        f"{[round(t, 4) for t in res.solve_s]} s | rel err mean "
        f"{rel.mean():.4f} | every slab == the in-memory solve of its "
        f"{sp.y_slab} slices, bit for bit")
    log(f"stream critical path per slab {[round(t, 4) for t in res.slab_s]}"
        " s; span totals " + ", ".join(
            f"{k} {v:.4f} s" for k, v in spans.items()))
    ref_bytes = (sp.slab_bytes - sp.extra_fixed_bytes
                 - sp.y_slab * sp.extra_per_slice_bytes)
    out["reference_slab_bytes"] = ref_bytes
    log(f"stream memory: peak device memory over the drain {peak} B "
        f"({peak / 2**30:.3f} GiB) against slab_bytes {sp.slab_bytes} B "
        f"(ratio {peak / sp.slab_bytes:.3f}; fixed {sp.fixed_bytes}, "
        f"{sp.y_slab} x per-slice {sp.y_slab * sp.per_slice_bytes}; the "
        f"reference's terms alone {ref_bytes} B, ratio "
        f"{peak / ref_bytes:.3f}; the port's extras "
        f"{sp.extra_fixed_bytes} B fixed, {sp.extra_per_slice_bytes} B "
        f"a slice); at bind {bind_peak} B; smem_bytes {sp.smem_bytes} "
        "per SM")
    walls = {"overlap": wall}
    for tag, kw in (("sync", dict(device_upload="sync")),
                    ("no_prefetch", dict(overlap=False))):
        other, walls[tag], _ = drain(tag, **kw)
        if not np.array_equal(other.volume.to_array(), volume):
            raise AssertionError(f"stream {tag}: volume differs from "
                                 "the overlapped drain")
        log(f"stream {tag}: {walls[tag]:.3f} s, upload "
            f"{[round(t, 4) for t in other.upload_s]} solve "
            f"{[round(t, 4) for t in other.solve_s]} s; volume == the "
            "overlapped drain, bit for bit")
    out["walls_s"] = walls
    ck = os.path.join(tmp, "ck")
    with inject.activate(FaultPlan(seed=1).add(
            "stream/after_slab", "preempt", key=1, attempts=(0,))):
        try:
            drain("resume", ckpt_dir=ck, checkpoint_every=1)
        except InjectedPreemption:
            pass
        else:
            raise AssertionError("the preemption after slab 1 did not "
                                 "stop the drain")
    rest, _, _ = drain("resume", ckpt_dir=ck)
    if rest.skipped != [0, sp.y_slab] or not np.array_equal(
            rest.volume.to_array(), volume):
        raise AssertionError(f"resume: skipped {rest.skipped}, or the "
                             "volume differs from the uninterrupted one")
    log(f"stream resume: preempted after slab 1, resumed skipping "
        f"{rest.skipped}, solving {rest.solved}; volume == the "
        "uninterrupted drain, bit for bit")
    with inject.activate(FaultPlan(seed=2).add(
            "store/read", "io_error", key=writer_slab, attempts=(0,))):
        healed, _, _ = drain("transient", retry=quick)
    if healed.retries != 1 or not np.array_equal(
            healed.volume.to_array(), volume):
        raise AssertionError(f"transient io_error: {healed.retries} "
                             "retries, or the volume differs")
    log("stream transient: one io_error at store/read absorbed by "
        f"{healed.retries} retry; volume == the clean drain, bit for bit")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"stream phase: {out['phase_s']:.1f} s (simulation "
        f"{out['simulate_s']:.1f} s)")
    return out, store


SERVE_BUDGET = 8 << 30  # phase 8's server: bytes for operators + slabs
SERVE_B = (256, 192)  # phase 8's second beamline geometry: n, angles
TUNE_SLICES = 1792  # xct-shale's volume depth, which phase 7 cuts to 64


class FlakyStore:
    """A sinogram store whose first ``read`` fails with an ``OSError``:
    a transient disk fault the server's retry policy must absorb."""

    def __init__(self, store):
        self.store, self.rows, self.n_slices = store, store.rows, store.n_slices
        self.failed = 0

    def read(self, j0, j1):
        if not self.failed:
            self.failed += 1
            raise OSError(f"transient read fault at [{j0}, {j1})")
        return self.store.read(j0, j1)


def serve_path(plan, device, store, tmp, fuse=FUSE, iters=ITERS):
    """Phase 8, the service: a ``ReconServer`` on the card with phase 3's
    plan seeded into its cache (geometry A), a second geometry (B) and B
    under q8 (C) built cold by the server; two waves of jobs, then the
    background scheduler.  Returns the phase's record and the server's
    A job volume; the caller reads the launch counts around it."""
    import os

    import numpy as np
    import torch

    from repro_torch.core.geometry import XCTGeometry, build_system_matrix
    from repro_torch.core.partition import PartitionConfig, plan_key
    from repro_torch.core.recon import ReconConfig, Reconstructor
    from repro_torch.data.phantom import phantom_slices, simulate_measurements
    from repro_torch.resil import RetryPolicy
    from repro_torch.serve import JobSpec, ReconServer

    t_phase = time.perf_counter()
    geo_a = plan.geo
    cfg_a = ReconConfig(precision="mixed", fuse=fuse)
    cfg_c = ReconConfig(precision="q8", fuse=fuse)
    geo_b = XCTGeometry(n=SERVE_B[0], n_angles=SERVE_B[1])
    t0 = time.perf_counter()
    a_b = build_system_matrix(geo_b)
    sino_b = simulate_measurements(a_b, phantom_slices(geo_b.n, 32, seed=1),
                                   seed=1)
    sim_b_s = time.perf_counter() - t0
    del a_b
    srv = ReconServer(SERVE_BUDGET, device=device,
                      workdir=os.path.join(tmp, "serve"), max_batch=4,
                      fair_share=2)
    key_a = plan_key(geo_a, PartitionConfig(), recon=cfg_a)

    def seed_a():
        rec = Reconstructor(plan, cfg_a, device)
        vb = rec.policy.vals_bytes
        return (plan, rec, plan.proj.hbm_bytes(value_bytes=vb)
                + plan.back.hbm_bytes(value_bytes=vb))

    t0 = time.perf_counter()
    srv.cache.get_or_build(key_a, seed_a)
    seed_s = time.perf_counter() - t0
    rec_a = srv.cache.peek(key_a).rec
    quick = RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0)

    def job_a(sino=store, **kw):
        kw.setdefault("y_slab", fuse)
        return JobSpec(geo=geo_a, sino=sino, rcfg=cfg_a, iters=iters,
                       tenant="a", **kw)

    def job_b(rcfg=cfg_a):
        return JobSpec(geo=geo_b, sino=sino_b, rcfg=rcfg, iters=iters,
                       tenant="b")

    def wave(tag, specs):
        """Submit ``specs`` and drain; every job must finish."""
        t0 = time.perf_counter()
        jobs = [srv.submit(s) for s in specs]
        srv.drain()
        wall = time.perf_counter() - t0
        bad = [(j.id, j.status, j.error) for j in jobs if j.status != "done"]
        if bad:
            raise AssertionError(f"serve {tag}: jobs not done: {bad}")
        return jobs, wall

    def report(tag, jobs, wall):
        rows = []
        for j in jobs:
            t = j.telemetry
            rows.append(dict(
                job=j.id, key=j.plan_key[:12], cold=t.plan_cold,
                y_slab=j.y_slab, slabs=t.n_slabs, queue_s=t.queue_s,
                first_slab_s=t.first_slab_s, load_s=t.load_s,
                upload_s=t.upload_s, solve_s=t.solve_s, total_s=t.total_s,
                retries=t.retries))
            log(f"serve {tag} job {j.id} ({j.spec.tenant}, key "
                f"{j.plan_key[:12]}, {'cold' if t.plan_cold else 'warm'}): "
                f"{t.n_slabs} slabs of {j.y_slab} | queue {t.queue_s:.4f} s, "
                f"queue-to-first-slab {t.first_slab_s:.4f} s, load "
                f"{t.load_s:.4f} s, upload {t.upload_s:.4f} s, solve "
                f"{t.solve_s:.4f} s, total {t.total_s:.4f} s, retries "
                f"{t.retries}")
        log(f"serve {tag}: {len(jobs)} jobs in {wall:.3f} s "
            f"({len(jobs) / wall:.3f} jobs/s)")
        return dict(jobs=rows, wall_s=wall, jobs_per_s=len(jobs) / wall)

    def same(tag, job, want):
        if not np.array_equal(job.volume.to_array(), want):
            raise AssertionError(f"serve {tag}: job {job.id}'s volume "
                                 "differs from its twin")

    out = dict(budget=SERVE_BUDGET, simulate_b_s=sim_b_s, seed_s=seed_s)
    # wave 1: A warm (seeded), B cold
    (w1_a, w1_b), wall = wave("wave 1", [job_a(), job_b()])
    out["wave1"] = report("wave 1", [w1_a, w1_b], wall)
    vol_a, vol_b = w1_a.volume.to_array(), w1_b.volume.to_array()
    x, _ = rec_a.reconstruct(store.read(0, fuse), iters=iters)
    if not np.array_equal(vol_a[:, :fuse], x):
        raise AssertionError("serve: A's first slab differs from the "
                             "in-memory solve of its slices")
    log(f"serve wave 1: A's first {fuse} slices == Reconstructor."
        "reconstruct in memory, bit for bit")
    # wave 2: three A jobs on the same store (one through a read that
    # fails once) and C, B's geometry under q8, cold
    flaky = FlakyStore(store)
    specs = [job_a(), job_a(sino=flaky, retry=quick), job_b(cfg_c), job_a()]
    n_batches = len(srv.batches)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    w2, wall = wave("wave 2", specs)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    out["wave2"] = report("wave 2", w2, wall)
    for j in (w2[0], w2[1], w2[3]):
        same("wave 2", j, vol_a)
    if w2[1].telemetry.retries != 1 or flaky.failed != 1:
        raise AssertionError(f"serve: the flaky read retried "
                             f"{w2[1].telemetry.retries} times")
    res_c = w2[2].resnorms
    if not (res_c[-1] < 0.05 * res_c[0]).all():
        raise AssertionError("serve: C's residual did not fall below 0.05 "
                             "of its first")
    batches = srv.batches[n_batches:]
    working = max(sum(srv._costs[i].working_bytes for i in b["jobs"])
                  for b in batches)
    model = srv.cache.bytes + working
    out["wave2"].update(
        batches=[dict(jobs=b["jobs"], cold=b["cold"]) for b in batches],
        peak_bytes=int(peak), cache_bytes=int(srv.cache.bytes),
        batch_working_bytes=int(working),
        c_residual_ratio=float((res_c[-1] / res_c[0]).max()))
    log(f"serve wave 2: batches {[(b['jobs'], b['cold']) for b in batches]}; "
        f"the three A volumes == wave 1's, bit for bit (one after "
        f"{w2[1].telemetry.retries} retry); C's residual ratio at most "
        f"{out['wave2']['c_residual_ratio']:.4f}")
    log(f"serve memory: peak device memory over wave 2 {peak} B "
        f"({peak / 2**30:.3f} GiB) against the cache's {srv.cache.bytes} B "
        f"+ the largest batch's working set {working} B = {model} B "
        f"(ratio {peak / model:.3f})")
    # the background scheduler thread: B and A again
    srv.start()
    try:
        t0 = time.perf_counter()
        bg = [srv.submit(job_b()), srv.submit(job_a())]
        for j in bg:
            if not j.wait(timeout=600) or j.status != "done":
                raise AssertionError(f"serve background: job {j.id} "
                                     f"{j.status} {j.error}")
        wall = time.perf_counter() - t0
    finally:
        srv.stop()
    out["background"] = report("background", bg, wall)
    same("background", bg[0], vol_b)
    same("background", bg[1], vol_a)
    later = srv.batches[n_batches:]
    cold = [b["cold"] for b in later]
    if cold.count(True) != 1 or srv.cache.stats()["builds"] != 3:
        raise AssertionError(f"serve: builds {srv.cache.stats()}, batch "
                             f"cold flags {cold}")
    ratio = w1_b.telemetry.first_slab_s / bg[0].telemetry.first_slab_s
    stats = srv.stats()
    jobs_text = [ln for ln in srv.metrics_text().splitlines()
                 if ln.startswith("serve_jobs_total")]
    out.update(stats=stats, warm_cold_ratio=ratio,
               serve_jobs_total=jobs_text)
    log(f"serve background: B and A on the scheduler thread == their wave "
        f"1 twins, bit for bit; B's queue-to-first-slab cold "
        f"{w1_b.telemetry.first_slab_s:.4f} s / warm "
        f"{bg[0].telemetry.first_slab_s:.4f} s = {ratio:.1f}x")
    log(f"serve cache: {srv.cache.stats()}, hit rate "
        f"{srv.cache.hit_rate:.3f}; " + "; ".join(jobs_text))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"serve phase: {out['phase_s']:.1f} s (B's matrix and sinogram "
        f"{sim_b_s:.1f} s, A's seed {seed_s:.1f} s)")
    return out, srv, vol_a


def tune_path(plan, device, store, srv, vol_a, fuse=FUSE, iters=ITERS):
    """Phase 8, tuning and drift: the per-copy overhead calibrated on the
    card, the autotuner on the A geometry, its passport saved and found
    by this card's fingerprint, one A job priced with it, and the CLI
    with ``--tune-dir`` and ``--trace`` in a process of its own."""
    import os
    import tempfile

    import numpy as np

    from repro_torch.core.partition import PartitionConfig
    from repro_torch.core.recon import ReconConfig
    from repro_torch.serve import AdmissionController, JobSpec
    from repro_torch.tune import (
        autotune,
        calibrate_per_copy_overhead,
        describe_hardware,
        resolve_passport,
        save_passport,
    )

    t_phase = time.perf_counter()
    cal = calibrate_per_copy_overhead(device)
    log(f"tune calibration: contig {cal['contig_issues']} issues in "
        f"{cal['contig_seconds'] * 1e6:.2f} us, strided "
        f"{cal['strided_issues']} issues in "
        f"{cal['strided_seconds'] * 1e6:.2f} us -> "
        f"{cal['per_copy_overhead_s']:.4g} s per modeled issue "
        f"[{cal['overhead_source']}]")
    t0 = time.perf_counter()
    passport, trials = autotune(
        plan.geo, mem_budget=SERVE_BUDGET, n_slices=TUNE_SLICES, fuse=fuse,
        per_copy_overhead_s=cal["per_copy_overhead_s"],
        overhead_source="measured")
    tune_s = time.perf_counter() - t0
    obj = passport.objective
    base = obj.get("baseline", {})
    log(f"tune autotune: {len(trials)} trials "
        f"({sum(t['feasible'] for t in trials)} feasible) in {tune_s:.1f} s; "
        f"knobs {passport.knobs}; modeled {obj['total_seconds']:.5g} s "
        f"(issue {obj['dma_issue_seconds']:.4g}, memory "
        f"{obj['hbm_seconds']:.4g}) against the default's "
        f"{base.get('total_seconds', float('nan')):.5g} s (issue "
        f"{base.get('dma_issue_seconds', float('nan')):.4g}, memory "
        f"{base.get('hbm_seconds', float('nan')):.4g})")
    # the objective is modeled seconds: on the log line above, not in the
    # kernels line
    out = dict(calibration=cal, tune_s=tune_s, knobs=passport.knobs,
               hardware=describe_hardware())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as tdir:
        path = save_passport(passport, tdir)
        found = resolve_passport(tdir)
        if found != passport:
            raise AssertionError(f"tune: {path} not found under this card's "
                                 f"fingerprint {describe_hardware()}")
        log(f"tune passport: {os.path.basename(path)} found under "
            f"{describe_hardware()}")
        # one A job priced with the passport: its y_slab cap
        free = srv.admission
        srv.admission = AdmissionController(
            free.mem_budget, free.topology, fair_share=free.fair_share,
            passport=found)
        try:
            spec = JobSpec(geo=plan.geo, sino=store, iters=iters,
                           rcfg=ReconConfig(precision="mixed", fuse=fuse),
                           tenant="a")
            untuned = free.price(plan.geo, PartitionConfig(), spec.rcfg,
                                 store.n_slices, plan=plan)
            job = srv.submit(spec)
            srv.drain()
        finally:
            srv.admission = free
        cap = found.knobs["y_slab"]
        want = min(untuned.y_slab, max(fuse, cap // fuse * fuse))
        if job.status != "done" or job.y_slab != want:
            raise AssertionError(f"tune: the passport's job {job.status}, "
                                 f"y_slab {job.y_slab} (want {want})")
        if not np.array_equal(job.volume.to_array(), vol_a):
            raise AssertionError("tune: the passport's A job differs from "
                                 "wave 1's")
        log(f"tune admission: the passport's y_slab cap {cap} -> an A job "
            f"of {job.y_slab}-slice slabs (untuned {untuned.y_slab}); volume "
            "== wave 1's, bit for bit")
        out.update(y_slab_cap=cap, y_slab=job.y_slab,
                   y_slab_untuned=untuned.y_slab)
        trace_path = os.path.join(tdir, "t.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.recon", "--n", "64",
               "--angles", "48", "--slices", "16", "--fuse", "4", "--iters",
               "10", "--tune-dir", tdir, "--trace", trace_path]
        if device.type != "cuda":  # a rehearsal on the CPU
            cmd += ["--device", "cpu"]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                              cwd=str(ROOT), timeout=300)
        cli_s = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            log(f"  cli: {line}")
        if proc.returncode != 0 or "drift report (" not in proc.stdout \
                or "tuning passport" not in proc.stdout:
            raise AssertionError(f"tune CLI exit {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        out.update(cli_s=cli_s, cli_stdout=proc.stdout.splitlines())
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"tune phase: {out['phase_s']:.1f} s (the CLI {cli_s:.1f} s)")
    return out


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
    log(f"host build: P=4 plan {t_plan:.1f} s (n={geo.n}, socket=2, "
        "beside the one-rank plan's build)")
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


DRY_ITERS = 2  # the reference's dry-run CG iterations
# phase 9c's cells: (dataset, multi_pod); every one on both paths
DRY_CELLS = (("xct-shale", False), ("xct-chip", False),
             ("xct-charcoal", False), ("xct-brain", False),
             ("xct-brain", True))


def bound_bytes(rec):
    """Per rank, the bytes of the tensors ``rec`` bound on the card: each
    storage's ``nbytes`` (a scatter table's passes are three tensors)."""
    from repro_torch.dist.collectives import ScatterPasses

    out = []
    for arrs in rec._arrays:
        tensors = []
        for t in arrs.values():
            tensors += ([t.first, t.dst, t.src]
                        if isinstance(t, ScatterPasses) else [t])
        out.append(sum({id(t.untyped_storage()): t.untyped_storage().nbytes()
                        for t in tensors}.values()))
    return out


def dispatch_cost(arrs, cols, device, reps=50):
    """The wrappers, which launch directly on real tensors, against the
    custom ops registered for the abstract trace, called on the same real
    tensors, in turns: row 1 on the proj shard of ``arrs`` (mixed) and
    row 4 on one chunk of it as ``apply_operator(staging="gather")``
    launches it.  CUDA-event ms per call and host microseconds per call
    (the enqueue).  The launches are not the main path's."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import xct_spmm as xs

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((cols, FUSE), generator=gen).to(device, torch.float16)
    inds, vals, winmap = (arrs[f"proj_{k}"] for k in ("inds", "vals",
                                                      "winmap"))
    segs, off = arrs["proj_winsegs"], arrs["proj_segoff"]
    b, s, _, _ = inds.shape
    bpc = ops._gather_blocks_per_call(b, s, winmap.shape[-1], FUSE, 2)
    window = x[winmap[:bpc].long()]
    f32 = torch.float32
    ops_ = torch.ops.repro_torch
    ways = {
        "row1 custom op": lambda: ops_.spmm_block_ell(
            inds, vals, winmap, x, f32, segs, off, None),
        "row1 wrapper": lambda: xs.spmm_block_ell(
            inds, vals, winmap, x, compute_dtype=f32, winsegs=segs,
            segoff=off),
        "row4 chunk custom op": lambda: ops_.spmm_block_ell_staged(
            inds[:bpc], vals[:bpc], window, f32),
        "row4 chunk wrapper": lambda: xs.spmm_block_ell_staged(
            inds[:bpc], vals[:bpc], window, compute_dtype=f32),
    }
    out = {k: {"ms": [], "host_us": []} for k in ways}
    for row, n in (("row1", reps), ("row4 chunk", 4 * reps)):
        for how in ("custom op", "wrapper", "wrapper", "custom op"):
            name = f"{row} {how}"
            fn = ways[name]
            fn()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
            t0 = time.perf_counter()
            start.record()
            for _ in range(n):
                fn()
            host = (time.perf_counter() - t0) / n * 1e6
            end.record()
            torch.cuda.synchronize()
            out[name]["ms"].append(start.elapsed_time(end) / n)
            out[name]["host_us"].append(host)
    log(f"dispatch (row 4 chunk: {bpc} of {b} row-blocks): " + " | ".join(
        f"{k}: " + ", ".join(f"{m:.4f}" for m in v["ms"]) + " ms, host "
        + ", ".join(f"{h:.1f}" for h in v["host_us"]) + " us a call"
        for k, v in out.items()))
    return out


def start_dry_cells(tmp):
    """Phase 9c's cells, each a ``launch.dryrun`` process of its own on
    the host, on the oracle's path (the reference's cell) and the kernel
    path; they run beside phases 9a and 9b."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for ds, multi in DRY_CELLS:
        for path in ("oracle", "kernel"):
            out = Path(tmp) / f"{ds}_{int(multi)}_{path}.json"
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--xct", ds, "--out", str(out)]
            cmd += ["--multi-pod"] if multi else []
            cmd += ["--kernel-path"] if path == "kernel" else []
            procs.append(((ds, multi, path), out, subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True)))
    return procs


def dry_run(plan, plan4, a, device, procs):
    """Phase 9: the dry run.  (a) phase 3's plan lowered on fake tensors
    against a real reconstructor on the card; (b) phase 6's four-rank plan
    on a fake 2x2 mesh against the card's 2x2 mesh; (c) the paper's
    datasets at 256 and 512 devices on the host.  Returns the records and
    row 1's real launches."""
    import numpy as np
    import torch

    from repro_torch.core.recon import ReconConfig, Reconstructor
    from repro_torch.data.phantom import phantom_slices, simulate_measurements
    from repro_torch.dist import Topology
    from repro_torch.kernels import xct_spmm as xs
    from repro_torch.launch import xct_perf
    from repro_torch.launch.mesh import make_fake_mesh

    out, real_launches = {}, 0
    total = torch.cuda.get_device_properties(device).total_memory
    sino = simulate_measurements(a, phantom_slices(plan.geo.n, FUSE, seed=0),
                                 seed=0)
    cfg = ReconConfig(precision="mixed", comm_mode="hier", fuse=FUSE)
    for key, p_plan in (("a", plan), ("b", plan4)):
        if key == "a":
            fake_kw, real_kw = {}, {"device": device}
        else:
            fake_kw = {"topology": Topology.from_mesh(
                make_fake_mesh((2, 2), ("data", "model")),
                data_axes=("model", "data"), batch_axes=())}
            real_kw = {"topology": mesh_topology(device)}
        xs.reset_launches()
        t0 = time.perf_counter()
        lowered = Reconstructor(p_plan, cfg, abstract=True,
                                **fake_kw).lower_cg(FUSE, DRY_ITERS)
        t_trace = time.perf_counter() - t0
        torch.cuda.synchronize()
        traced = dict(xs.LAUNCHES, wrapper=xs.spmm_block_ell.launches)
        if any(traced.values()):
            raise AssertionError(f"9{key}: kernels launched under the "
                                 f"trace: {traced}")
        mem = lowered.memory_analysis()
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        real = Reconstructor(p_plan, cfg, **real_kw)
        bound = bound_bytes(real)
        fake_args = [int(v) for v in mem.per_rank["argument"]]
        if fake_args != bound:
            raise AssertionError(f"9{key}: abstract argument bytes "
                                 f"{fake_args} != bound on the card {bound}")
        staged = real.stage_sino(sino)
        x0 = real._shard(np.zeros((real.tomo_pad, FUSE), np.float32))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            x, _ = real._solve(staged.y, x0, DRY_ITERS)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        if not all(torch.isfinite(t).all() for t in x.parts):
            raise AssertionError(f"9{key}: the real solve is not finite")
        real_launches += xs.LAUNCHES["sorted"]
        solve_launches = dict(xs.LAUNCHES)
        if key == "a":
            out["dispatch"] = dispatch_cost(real._arrays[0],
                                            p_plan.proj.cols_per_dev, device)
        abstract_peak = int(sum(dict(zip(lowered.devices,
                                         mem.per_rank["peak"])).values()))
        rec = dict(trace_s=round(t_trace, 3), argument=bound,
                   abstract_peak=abstract_peak, real_peak=int(peak),
                   ratio=peak / abstract_peak, rank0=mem.rank0,
                   launches=solve_launches,
                   collectives=lowered.collectives())
        log(f"dry run 9{key}: {len(bound)} rank(s), hier, {FUSE} slices, "
            f"{DRY_ITERS} iters: trace {t_trace:.2f} s, no launch | "
            f"argument bytes {bound} == bound on the card | peak "
            f"max_memory_allocated {peak} against abstract {abstract_peak}"
            f" (sum over the fake devices): ratio {peak / abstract_peak:.4f}"
            f" | rank 0 {mem.rank0} | real solve launches row 1 "
            f"{solve_launches['sorted']}")
        out[key] = rec
        del real, staged, x0, x
    out["a"]["in_range"] = 0.8 <= out["a"]["ratio"] <= 1.25
    rows = xct_perf.sweep()
    # modeled from the datasheet rates: printed, kept out of the kernels line
    log("sweep (xct-brain, 512 devices, H100 rates, 30 iterations, "
        "modeled):\n" + xct_perf.table(rows))
    cells = {}
    for (ds, multi, path), path_json, proc in procs:
        _, err = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"9c {ds} {path}: exit {proc.returncode}"
                                 f"\n{err[-2000:]}")
        rec = json.loads(path_json.read_text())[0]
        if rec["status"] != "ok":
            raise AssertionError(f"9c {ds} {path}: {rec['status']}")
        mem, coll, an = rec["memory"], rec["collectives_traced"], \
            rec["analytic"]
        tag = f"{ds}{' 2 pods' if multi else ''} {path}"
        busiest = mem["peak_bytes"]
        fits = busiest <= total
        log(f"dry run 9c {tag}: p_data {rec['p_data']} {rec['shape']} trace "
            f"{rec['compile_s']} s | busiest rank {mem['rank']} "
            f"{busiest} B, rank 0 {rec['rank0_bytes']} B (argument "
            f"{mem['rank0']['argument']}, input {mem['rank0']['input']}, "
            f"temp {mem['rank0']['temp']}), every other rank at most "
            f"{mem['peak_others']} B, against total_memory {total} B: "
            f"{'fits' if fits else 'does NOT fit'} | traced per rank ici "
            f"{coll['ici_bytes']:.6g} dci {coll['dci_bytes']:.6g} B (by "
            "kind, ici/dci: " + ", ".join(
                f"{k} {v['ici_bytes']:.6g}/{v['dci_bytes']:.6g}"
                for k, v in coll["by_kind"].items())
            + f") against modeled ici_dev {an['ici_dev']:.6g} dci_dev "
            f"{an['dci_dev']:.6g} B; rank 0 sent {coll['rank0_sent']} B")
        if (ds, multi, path) == ("xct-brain", False, "kernel") and not fits:
            raise AssertionError(f"9c {tag}: the busiest rank's {busiest} B "
                                 f"do not fit the card's {total} B")
        if path == "kernel" and rec["rank0_bytes"] > 1.05 * max(
                mem["peak_others"], 1):
            raise AssertionError(f"9c {tag}: rank 0 holds "
                                 f"{rec['rank0_bytes']} B, above 1.05 x "
                                 f"the other ranks' {mem['peak_others']} B")
        cells[tag] = dict(
            p_data=rec["p_data"], shape=rec["shape"],
            trace_s=rec["compile_s"], busiest=busiest,
            busiest_rank=mem["rank"], rank0=mem["rank0"],
            peak_others=mem["peak_others"], fits=fits,
            traced_ici=coll["ici_bytes"], traced_dci=coll["dci_bytes"],
            by_kind=coll["by_kind"], card_bytes=total)
    out["cells"] = cells
    return out, real_launches


LM_ARCH = "qwen3-4b"  # phase 10's model, at its full published width
LM_BATCH, LM_PROMPT, LM_GEN = 4, 32, 16  # the reference CLI's serving run
LM_CPU_LAYERS, LM_GREEDY = 2, 4  # (b): depth on the host, greedy steps


def lm_close(got, want, tol):
    """The reference's ``assert_allclose(rtol=tol, atol=tol)``: (max abs
    difference, max of ``|d| - tol * |want|``, passes)."""
    d = (got.float() - want.float()).abs()
    excess = float((d - tol * want.float().abs()).max())
    return float(d.max()), excess, excess <= tol


def lm_invariant(params, cfg, inputs, t):
    """Prefill ``t`` tokens and decode token ``t`` against the forward
    over ``t + 1``: both logits at position ``t``."""
    import torch

    from repro_torch.models.lm import decode_step, prefill
    from repro_torch.models.transformer import forward

    b = inputs.shape[0]
    pos = torch.arange(t + 1, device=inputs.device).expand(b, t + 1)
    ref, _, _ = forward(params, cfg, inputs, positions=pos)
    _, cache = prefill(params, cfg, inputs[:, :t])
    _, _, dec = decode_step(params, cfg, cache, inputs[:, t:t + 1], t)
    return dec, ref[:, t]


def lm_greedy(params, cfg, prompts, steps):
    """The prefill's argmax and ``steps`` greedy decode steps: [B, 1 +
    steps] tokens on the host."""
    import torch

    from repro_torch.models.lm import decode_step, prefill

    logits, cache = prefill(params, cfg, prompts)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    out = [tok]
    for i in range(steps):
        tok, cache, _ = decode_step(params, cfg, cache, tok,
                                    prompts.shape[1] + i)
        out.append(tok)
    return torch.cat(out, 1).cpu()


def lm_path(device):
    """Phase 10, LM serving on the card: qwen3-4b at full width from
    seeded weights.  (a) the cache invariant over all 36 layers, held to
    the reference's bound with f32 activations and caches, and measured
    in the default bf16 (whose GEMMs over 4 rows and over 132 round
    differently, a few elements a layer at first: printed, not held);
    (b) the
    card against the port's CPU path on the first two layers (the same
    weights, copied to the host): bf16 prefill logits and f32 greedy
    tokens; (c) every architecture's SMOKE config on the card, and
    recurrentgemma's sliding window past its wrap; (d) the serve loop of
    ``launch.lm_serve`` (batch 4, prompt 32, 16 tokens), twice, with its
    prefill seconds, decode tokens per second and peak bytes."""
    import copy
    import dataclasses

    import torch

    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.launch import lm_serve
    from repro_torch.models.lm import prefill
    from repro_torch.models.transformer import LMParams, init_params

    t_phase = time.perf_counter()
    out = {"arch": LM_ARCH, "batch": LM_BATCH, "prompt": LM_PROMPT,
           "gen": LM_GEN}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg = get_config(LM_ARCH, max_cache=LM_PROMPT + LM_GEN)
    gen = torch.Generator(device).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    out["init_s"] = time.perf_counter() - t0
    out["params"] = n_params
    out["param_bytes"] = torch.cuda.memory_allocated() - base
    log(f"lm 10: {LM_ARCH} {cfg.n_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads} head_dim {cfg.head_dim} d_ff "
        f"{cfg.d_ff} vocab {cfg.vocab_size}: {n_params} parameters, "
        f"{out['param_bytes']} B in f32, made in {out['init_s']:.2f} s")
    toks = lm_serve.make_prompts(cfg, LM_BATCH, LM_PROMPT + 1, gen)

    # (a) the cache invariant at full width: f32 activations held to the
    # reference's bound; the default bf16 measured
    out["a"] = {}
    for tag, acfg in (("f32", dataclasses.replace(
            cfg, activation_dtype=torch.float32,
            cache_dtype=torch.float32)), ("bf16", cfg)):
        dec, ref = lm_invariant(params, acfg, toks, LM_PROMPT)
        err, excess, ok = lm_close(dec, ref, 2e-2)
        out["a"][tag] = dict(max_abs=err, max_excess=excess, allclose=ok,
                             ref_max=float(ref.abs().max()),
                             finite=bool(torch.isfinite(dec).all()))
        log(f"lm 10a {tag}: decode token {LM_PROMPT} after a {LM_PROMPT}-"
            f"token prefill against the forward over {LM_PROMPT + 1}: max "
            f"abs difference {err:.6g} (max |logit| "
            f"{out['a'][tag]['ref_max']:.4g}), allclose(rtol=2e-2, "
            f"atol=2e-2) {'holds' if ok else 'does not hold'}")
    # the cause of the bf16 gap on the CPU (ROADMAP.md, fault B): a GEMM
    # whose rounding of a row depends on the call's row count; here
    # cuBLAS's, at layer 0's q projection, the decode's 4 rows alone
    # against the same rows inside the forward's 132 (measured, not held:
    # the reference has no counterpart on the card)
    from repro_torch.models import layers as L

    with torch.no_grad():
        p0 = params.layers[0]
        x0 = params.embed[toks].to(cfg.activation_dtype)
        h = L.norm_apply(p0["ln1"], x0, cfg.norm_eps)
        q_all = L.dot(h, p0["attn"]["wq"])
        q_dec = L.dot(h[:, LM_PROMPT:LM_PROMPT + 1].contiguous(),
                      p0["attn"]["wq"])
        differ = int((q_dec != q_all[:, LM_PROMPT:LM_PROMPT + 1]).sum())
    out["a"]["bf16"]["q_rows_differ"] = differ
    out["a"]["bf16"]["q_outputs"] = q_dec.numel()
    log(f"lm 10a bf16: layer 0's q projection on cuBLAS, the decode's "
        f"{LM_BATCH} rows alone against the same rows inside the forward's "
        f"{LM_BATCH * (LM_PROMPT + 1)}: {differ} of {q_dec.numel()} outputs "
        f"differ in their bits")
    a32 = out["a"]["f32"]
    if a32["max_abs"] > 2e-2 or not (a32["finite"]
                                     and out["a"]["bf16"]["finite"]):
        raise AssertionError(f"10a: the cache invariant fails: {out['a']}")

    # (b) the same weights, first two layers, card against host
    cfg2 = dataclasses.replace(cfg, n_layers=LM_CPU_LAYERS)
    p2 = LMParams(params.embed, params.unembed, params.final_norm,
                  list(params.layers[:LM_CPU_LAYERS]))
    t0 = time.perf_counter()
    host = copy.deepcopy(p2).to("cpu")
    prompts = toks[:, :LM_PROMPT]
    card_logits, _ = prefill(p2, cfg2, prompts)
    host_logits, _ = prefill(host, cfg2, prompts.cpu())
    rel = float((card_logits.cpu() - host_logits).abs().max()
                / host_logits.abs().max())
    f32 = dataclasses.replace(cfg2, activation_dtype=torch.float32,
                              cache_dtype=torch.float32)
    card_tok = lm_greedy(p2, f32, prompts, LM_GREEDY)
    host_tok = lm_greedy(host, f32, prompts.cpu(), LM_GREEDY)
    bf_agree = float((lm_greedy(p2, cfg2, prompts, LM_GREEDY)
                      == lm_greedy(host, cfg2, prompts.cpu(), LM_GREEDY)
                      ).float().mean())
    out["b"] = dict(layers=LM_CPU_LAYERS, prefill_rel=rel,
                    f32_tokens_equal=bool(torch.equal(card_tok, host_tok)),
                    bf16_tokens_agree=bf_agree,
                    seconds=time.perf_counter() - t0)
    log(f"lm 10b: {LM_CPU_LAYERS} layers at full width, card against the "
        f"host: bf16 prefill logits max abs difference / max|.| {rel:.6g} "
        f"(bound 2e-2); f32 greedy tokens (prefill + {LM_GREEDY} steps) "
        f"{'equal' if out['b']['f32_tokens_equal'] else 'DIFFER'}; bf16 "
        f"greedy tokens agree on {bf_agree:.3f} ({out['b']['seconds']:.1f} s)")
    if rel > 2e-2 or not out["b"]["f32_tokens_equal"]:
        raise AssertionError(f"10b: card and host differ: {out['b']}")
    del host, p2

    # (c) every architecture's SMOKE config on the card
    out["c"] = {}
    for name in ARCH_NAMES:
        scfg = get_config(name, smoke=True, max_cache=32,
                          moe_capacity_factor=8.0)
        sp = init_params(scfg, torch.Generator(device).manual_seed(1))
        x = lm_serve.make_prompts(scfg, 2, 25, gen)
        rec = dict(zip(("max_abs", "max_excess", "ok"),
                       lm_close(*lm_invariant(sp, scfg, x, 24), 2e-2)))
        if name == "recurrentgemma-9b":
            t_long = scfg.window + 9
            x = lm_serve.make_prompts(scfg, 2, t_long + 1, gen)
            rec["wrap"] = dict(zip(
                ("max_abs", "max_excess", "ok"),
                lm_close(*lm_invariant(sp, scfg, x, t_long), 3e-2)))
            rec["ok"] = rec["ok"] and rec["wrap"]["ok"]
        out["c"][name] = rec
    log("lm 10c: SMOKE configs on the card, decode against forward "
        "(allclose 2e-2; the window wrap 3e-2), max abs: " + ", ".join(
            f"{k} {v['max_abs']:.3g}"
            + (f" (wrap {v['wrap']['max_abs']:.3g})" if "wrap" in v else "")
            for k, v in out["c"].items()))
    bad = [k for k, v in out["c"].items() if not v["ok"]]
    if bad:
        raise AssertionError(f"10c: the cache invariant fails for {bad}")

    # (d) the serve loop, as launch.lm_serve runs it
    out["d"] = []
    for run in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prompts = lm_serve.make_prompts(cfg, LM_BATCH, LM_PROMPT, gen)
        rec = lm_serve.serve(params, cfg, prompts, LM_GEN, gen)
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        rec["tokens_shape"] = list(rec.pop("tokens").shape)
        if rec["tokens_shape"] != [LM_BATCH, LM_GEN]:
            raise AssertionError(f"10d: tokens {rec['tokens_shape']}")
        out["d"].append(rec)
        log(f"lm 10d run {run + 1}: prefill {rec['prefill_s']:.4f} s, "
            f"decode {rec['decode_s']:.4f} s = {rec['tok_s']:.1f} tok/s "
            f"({LM_BATCH} x {LM_GEN - 1} tokens), peak "
            f"max_memory_allocated {rec['peak_bytes']} B")
    del params
    gc.collect()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"lm phase: {out['phase_s']:.1f} s")
    return out


TRAIN_ARCH = "smollm-135m"  # phase 11's model, at its full published width
TRAIN_BATCH, TRAIN_SEQ = 8, 128  # the reference CLI's defaults
TRAIN_STEPS, TRAIN_LR = 25, 1e-3  # (a): AdamW steps and learning rate
TRAIN_CPU_LAYERS = 2  # (b): depth of the card-against-host step
TRAIN_SAVE, TRAIN_RESUME_TO = 10, 15  # (d): checkpoint step, resumed end
HIER_MESH = (2, 2, 1)  # (c): ("pod", "data", "model"), every rank the card


def train_run(cfg, params, device, steps, start=0, opt_state=None,
              mgr=None, state_tree=None, keep=None):
    """AdamW steps ``start .. steps - 1`` of ``make_train_step`` on the
    ``TokenStream`` batches; returns ``(params, opt_state, losses,
    seconds)``, each step timed on the host clock between two device
    synchronizations.  ``mgr`` saves ``state_tree(...)`` after each step
    it asks for, and ``keep`` (a dict) gets a copy of the tree saved at
    step ``keep["step"]`` under ``"tree"``, on the host."""
    import torch

    from repro_torch.data.tokens import TokenStream
    from repro_torch.models.lm import make_train_step
    from repro_torch.opt import AdamW, leaves

    opt = AdamW(lr=TRAIN_LR)
    step = make_train_step(cfg, opt)
    stream = TokenStream(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    if opt_state is None:
        opt_state = opt.init(params)
    losses, secs = [], []
    for s in range(start, steps):
        batch = stream.batch(s)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize(device)
        secs.append(time.perf_counter() - t0)
        if mgr is not None:
            tree = state_tree(params, opt_state, s + 1)
            if mgr.maybe_save(s + 1, tree) and keep is not None \
                    and keep["step"] == s + 1:
                # on the host, so that the peak stays the step's own
                keep["tree"] = [t.detach().to("cpu", copy=True)
                                for t in leaves(tree)]
    return params, opt_state, losses, secs


def train_path(device, card):
    """Phase 11, LM training on the card: smollm-135m at its full
    published width (30 layers, d_model 576, 9/3 heads, d_ff 1536, vocab
    49152, tied embeddings) from seeded weights, f32 parameters and bf16
    activations, ``TokenStream`` batches of 8 x 128 tokens.  (a) 25
    AdamW steps (lr 1e-3) must take the loss down by at least 0.5; (b)
    one step's loss and gradients at 2 layers of full width, the card
    against the host: f32 activations 1e-4 (loss, relative) and 1e-3 of
    each leaf's max|.|, bf16 the loss within 2e-2; (c) the paper's
    gradient sync on a (pod=2, data=2, model=1) mesh of this card against
    the spmd step on the same global batch (AdamW without clip, lr 1e-3;
    f32 activations, so that only the bf16 cast separates them): loss
    1e-4, each synced gradient leaf within 2**-7 of its max|g|,
    parameters 5e-3; printed beside it, the bytes each rank hands the
    ladder (f32, ``step.wire_dtype``) with the plan's modeled bytes per
    level, and the synced gradients' error had bf16 gone through the
    ladder's sums (the paper's wire, which the port does not carry);
    (d) a save at step 10 through ``CheckpointManager``, restored bit for
    bit into fresh tensors and run to step 15, against two uninterrupted
    runs; (e) the median step seconds over steps 5-25, tokens per second
    and ``max_memory_allocated``, for the spmd and the hier step."""
    import copy
    import dataclasses
    import statistics

    import torch

    from repro_torch.ckpt.checkpoint import (
        CheckpointManager, latest_step, restore,
    )
    from repro_torch.configs import get_config
    from repro_torch.core.precision import qcast
    from repro_torch.data.tokens import TokenStream
    from repro_torch.dist.collectives import hierarchical_psum
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import load_state, state_tree
    from repro_torch.models import lm
    from repro_torch.models.transformer import LMParams, init_params
    from repro_torch.opt import AdamW, leaves

    t_phase = time.perf_counter()
    out = {"arch": TRAIN_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "lr": TRAIN_LR, "card": card}
    gc.collect()
    cfg = get_config(TRAIN_ARCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def fresh():
        return init_params(cfg, torch.Generator(device).manual_seed(0))

    params0 = fresh()
    n_params = sum(p.numel() for p in params0.parameters())
    out["params"] = n_params
    log(f"train 11: {TRAIN_ARCH} {cfg.n_layers} layers d_model "
        f"{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} d_ff "
        f"{cfg.d_ff} vocab {cfg.vocab_size} tied "
        f"{cfg.tie_embeddings}: {n_params} parameters (f32), "
        f"activations {cfg.activation_dtype}")

    # (a) + (d) run 1 + (e): 25 steps, saving at step 10
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as ck:
        mgr = CheckpointManager(ck, every=TRAIN_SAVE, keep=3)
        kept = {"step": TRAIN_SAVE}
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        _, _, losses, secs = train_run(cfg, params0, device, TRAIN_STEPS,
                                       mgr=mgr, state_tree=state_tree,
                                       keep=kept)
        peak = torch.cuda.max_memory_allocated(device)
        drop = losses[0] - losses[-1]
        out["a"] = dict(losses=losses, first=losses[0], final=losses[-1],
                        drop=drop)
        log(f"train 11a: {TRAIN_STEPS} spmd steps, loss {losses[0]:.6f} "
            f"-> {losses[-1]:.6f} (drop {drop:.6f}, bound >= 0.5); "
            f"every 6th: {[round(x, 4) for x in losses[::6]]}")
        if not drop >= 0.5 or not all(map(math.isfinite, losses)):
            raise AssertionError(f"11a: the loss does not fall: {losses}")
        med = statistics.median(secs[5:])
        out["e"] = dict(step_s=med, tokens_per_s=tokens / med,
                        peak_bytes=peak, step_s_all=secs)
        log(f"train 11e: spmd step median {med:.6f} s over steps 5-"
            f"{TRAIN_STEPS} ({tokens / med:.1f} tokens/s), first step "
            f"{secs[0]:.3f} s, peak max_memory_allocated {peak} B | "
            f"{card}")

        # (d) the checkpoint at step 10, restored into fresh tensors
        at = latest_step(ck)
        like = state_tree(params0, AdamW(lr=TRAIN_LR).init(params0), 0)
        tree = restore(ck, TRAIN_SAVE, like, device=device)
        got = leaves(tree)
        equal = len(got) == len(kept["tree"]) and all(
            a.dtype == b.dtype and torch.equal(a, b.to(a.device))
            for a, b in zip(got, kept["tree"]))
        p10, o10, step10 = load_state(
            tree, params0, AdamW(lr=TRAIN_LR).init(params0))
        equal = equal and step10 == TRAIN_SAVE
        del kept
    _, _, resumed, _ = train_run(cfg, p10, device, TRAIN_RESUME_TO,
                                 start=TRAIN_SAVE, opt_state=o10)
    _, _, again, _ = train_run(cfg, fresh(), device, TRAIN_RESUME_TO)
    ref_a, ref_b = losses[TRAIN_RESUME_TO - 1], again[-1]
    spread = abs(ref_a - ref_b)
    gap = abs(resumed[-1] - ref_a)
    out["d"] = dict(restored_equal=equal, latest_saved=at,
                    resumed=resumed[-1], uninterrupted=[ref_a, ref_b],
                    spread=spread, gap=gap)
    log(f"train 11d: saved at step {TRAIN_SAVE} (latest saved {at}), "
        f"restored "
        f"{'bit for bit' if equal else 'WITH DIFFERENCES'}; step "
        f"{TRAIN_RESUME_TO} loss resumed {resumed[-1]:.9g}, uninterrupted "
        f"{ref_a:.9g} / {ref_b:.9g} (spread {spread:.3g}, resumed gap "
        f"{gap:.3g})")
    if not equal:
        raise AssertionError(f"11d: the restored state differs: {out['d']}")
    if gap > spread:
        raise AssertionError(f"11d: the resumed run leaves the spread of "
                             f"two uninterrupted runs: {out['d']}")

    # (b) one step at 2 layers of full width, card against host
    cfg2 = dataclasses.replace(cfg, n_layers=TRAIN_CPU_LAYERS)
    p2 = LMParams(params0.embed, params0.unembed, params0.final_norm,
                  list(params0.layers[:TRAIN_CPU_LAYERS]))
    host = copy.deepcopy(p2).to("cpu")
    batch = TokenStream(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                        seed=0).batch(0)
    out["b"] = {}
    for tag, c in (("f32", dataclasses.replace(
            cfg2, activation_dtype=torch.float32)), ("bf16", cfg2)):
        lc, _, gc_ = lm._value_and_grad(p2, c, batch)
        lh, _, gh = lm._value_and_grad(host, c, batch)
        lrel = abs(float(lc) - float(lh)) / abs(float(lh))
        grel = max(float((a.cpu() - b).abs().max() / b.abs().max())
                   for a, b in zip(gc_, gh))
        out["b"][tag] = dict(loss_card=float(lc), loss_host=float(lh),
                             loss_rel=lrel, grad_rel=grel)
        log(f"train 11b {tag}: {TRAIN_CPU_LAYERS} layers at full width, "
            f"card against host: loss {float(lc):.7f} / {float(lh):.7f} "
            f"(rel {lrel:.3g}), gradients max |diff| / leaf max "
            f"{grel:.3g}")
    b32, b16 = out["b"]["f32"], out["b"]["bf16"]
    if b32["loss_rel"] > 1e-4 or b32["grad_rel"] > 1e-3 or \
            b16["loss_rel"] > 2e-2:
        raise AssertionError(f"11b: card and host differ: {out['b']}")
    del host, p2

    # (c) the hierarchical bf16 gradient sync on a mesh of this card
    mesh = make_mesh(HIER_MESH, ("pod", "data", "model"),
                     devices=[device] * math.prod(HIER_MESH))
    c32 = dataclasses.replace(cfg, activation_dtype=torch.float32)
    opt = AdamW(lr=1e-3, grad_clip=0.0)
    hier = lm.make_hier_train_step(c32, opt, mesh)
    _, _, g_spmd = lm._value_and_grad(params0, c32, batch)
    _, _, g_hier = hier.sync(params0, batch)
    gworst = max(float((a - b).abs().max() / b.abs().max())
                 for a, b in zip(g_hier, g_spmd))
    del g_hier
    n_grad = sum(g.numel() for g in g_spmd)
    buf = n_grad * torch.finfo(hier.wire_dtype).bits // 8
    # the paper's wire, bf16 through the ladder's sums: the same casts as
    # the step's, reduced in bf16; printed, not held
    ndp = hier.topology.n_data
    rows = TRAIN_BATCH // ndp
    ranks = [lm._value_and_grad(params0, c32, {
        k: v[r * rows:(r + 1) * rows] for k, v in batch.items()})[2]
        for r in range(ndp)]
    casts = [qcast([g[j] for g in ranks], torch.bfloat16, adaptive=True)
             for j in range(len(g_spmd))]
    del ranks
    summed = hierarchical_psum(
        [torch.cat([c[r].reshape(-1) for c, _ in casts]) for r in range(ndp)],
        hier.topology, mode="hier")[0]
    cerr, start = [], 0
    for (_, inv), b in zip(casts, g_spmd):
        a = summed[start:start + b.numel()].reshape(b.shape).float() * (
            inv[0] / ndp)
        start += b.numel()
        cerr.append(float((a - b).abs().max() / b.abs().max()))
    del casts, summed, g_spmd
    p_s, _, m_s = lm.make_train_step(c32, opt)(params0, opt.init(params0),
                                               batch)
    p_h, _, m_h = hier(params0, opt.init(params0), batch)
    dloss = abs(float(m_s["loss"]) - float(m_h["loss"]))
    dpar = max(float((a - b).abs().max())
               for a, b in zip(leaves(p_s), leaves(p_h)))
    del p_s, p_h
    over = sum(e > 2 ** -7 for e in cerr)
    out["c"] = dict(mesh=dict(mesh.shape), loss_spmd=float(m_s["loss"]),
                    loss_hier=float(m_h["loss"]), dloss=dloss,
                    grad_rel=gworst, dparams=dpar,
                    bf16_ladder_grad_rel=max(cerr),
                    bf16_ladder_leaves_over=over)
    log(f"train 11c: hier on {dict(mesh.shape)} of the card against spmd: "
        f"loss {float(m_s['loss']):.7f} / {float(m_h['loss']):.7f} (diff "
        f"{dloss:.3g}, bound 1e-4), synced gradients max |diff| / leaf "
        f"max|g| {gworst:.4g} (bound 2**-7 = {2 ** -7:.4g}), parameters "
        f"max |diff| {dpar:.3g} (bound 5e-3); had bf16 gone through the "
        f"ladder's sums (not the port's wire, not held): {max(cerr):.4g}, "
        f"{over} of {len(cerr)} leaves over 2**-7")
    axes = [lv.axis for lv in hier.topology.levels]
    log(f"train 11c: each rank hands the ladder {buf} B ({n_grad} values "
        f"of {hier.wire_dtype}); modeled bytes per level "
        f"(plan.level_bytes): "
        f"{dict(zip(axes, hier.plan.level_bytes(buf)))}")
    log("train 11c: " + hier.topology.describe().replace("\n", " | ")
        + " || " + hier.plan.describe().replace("\n", " | "))
    if dloss > 1e-4 or gworst > 2 ** -7 or dpar > 5e-3:
        raise AssertionError(f"11c: hier and spmd differ: {out['c']}")

    # (e) the hier step's time, default bf16 activations
    hier16 = lm.make_hier_train_step(cfg, AdamW(lr=TRAIN_LR), mesh)
    stream = TokenStream(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    p, st = params0, AdamW(lr=TRAIN_LR).init(params0)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    hsecs, hl = [], []
    for s in range(TRAIN_STEPS):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        p, st, m = hier16(p, st, stream.batch(s))
        hl.append(float(m["loss"]))
        torch.cuda.synchronize(device)
        hsecs.append(time.perf_counter() - t0)
    hpeak = torch.cuda.max_memory_allocated(device)
    hmed = statistics.median(hsecs[5:])
    out["e"]["hier"] = dict(step_s=hmed, tokens_per_s=tokens / hmed,
                            peak_bytes=hpeak, step_s_all=hsecs, losses=hl)
    log(f"train 11e: hier step on {dict(mesh.shape)} of the card median "
        f"{hmed:.6f} s over steps 5-{TRAIN_STEPS} "
        f"({tokens / hmed:.1f} tokens/s), peak max_memory_allocated "
        f"{hpeak} B, losses {[round(x, 4) for x in hl]} | {card}")
    if not all(map(math.isfinite, hl)):
        raise AssertionError(f"11e: the hier step diverges: {hl}")
    del p, st, params0
    gc.collect()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"train phase: {out['phase_s']:.1f} s")
    return out


TP_SERVE_MESH = (1, 1, 4)  # 13a: ("pod", "data", "model") on the card
TP_TRAIN_MESH, TP_HIER_MESH = (1, 1, 3), (1, 2, 3)  # 13b, 13c
TP_HIER_STEPS = 6  # 13b: hier steps, timed from the third


def card_mesh(shape, device):
    """A ``("pod", "data", "model")`` mesh whose every position is the
    card."""
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, ("pod", "data", "model"),
                     devices=[device] * math.prod(shape))


def tp_path(device):
    """Phase 13, tensor parallelism over ``model`` on the card, every
    position of a mesh the card.  (a) qwen3-4b at full width served from
    its state laid out on a (1, 1, 4) mesh (``dist.sharding
    .place_state``): f32 prefill logits within 1e-4 of max|logit| of the
    one-device prefill on phase 10's weights and prompts; the bf16
    greedy tokens' agreement with the one-device ones, tokens per second
    and the peak printed.  (b) smollm-135m at full width: the split spmd
    step on (1, 1, 3) against the one-device step, f32, loss and every
    gradient leaf within 1e-4 of max|g|; the hier step on (1, 2, 3) from
    its laid-out state, seconds, tokens per second and peak printed.
    (c) the split smollm step traced on one placeholder: its argument
    bytes equal the card's and its peak lies within 10% of
    ``max_memory_allocated``, 12b's band."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.dist.sharding import place_state
    from repro_torch.launch import lm_serve
    from repro_torch.launch.dryrun import _tensors
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.models import lm
    from repro_torch.models.transformer import init_params
    from repro_torch.opt import AdamW

    t_phase = time.perf_counter()
    out = {}

    # (a) serving from a laid-out state
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(LM_ARCH, max_cache=LM_PROMPT + LM_GEN)
    f32 = dataclasses.replace(cfg, activation_dtype=torch.float32,
                              cache_dtype=torch.float32)
    gen = torch.Generator(device).manual_seed(0)
    params = init_params(cfg, gen)
    toks = lm_serve.make_prompts(cfg, LM_BATCH, LM_PROMPT + 1, gen)
    prompts = toks[:, :LM_PROMPT]
    one_logits, _ = lm.prefill(params, f32, prompts)
    one_tokens = lm_greedy(params, cfg, prompts, LM_GEN - 1)
    mesh = card_mesh(TP_SERVE_MESH, device)
    t0 = time.perf_counter()
    placed, _ = place_state(params, None, mesh)
    del params
    gc.collect()
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    tp_logits, _ = lm.prefill(placed, f32, prompts)
    rel = float((tp_logits - one_logits).abs().max()
                / one_logits.abs().max())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = lm_serve.serve(placed, cfg, prompts, LM_GEN, gen)
    agree = float((torch.from_numpy(rec["tokens"]) == one_tokens)
                  .float().mean())
    split = sum(1 for pl in placed.leaves if pl.model_dim() is not None)
    out["a"] = dict(mesh=list(TP_SERVE_MESH), f32_prefill_rel=rel,
                    bf16_tokens_agree=agree, prefill_s=rec["prefill_s"],
                    decode_s=rec["decode_s"], tok_s=rec["tok_s"],
                    peak_bytes=torch.cuda.max_memory_allocated(),
                    place_s=place_s, split_leaves=split,
                    leaves=len(placed.leaves),
                    rank_bytes=[placed.bytes_at((0, 0, r))
                                for r in range(TP_SERVE_MESH[2])])
    log(f"tp 13a: {LM_ARCH} on a {TP_SERVE_MESH} mesh of the card "
        f"({split} of {len(placed.leaves)} leaves split; bytes per position "
        f"{out['a']['rank_bytes']}, laid out in {place_s:.2f} s): f32 "
        f"prefill logits max abs difference / max|.| {rel:.6g} against one "
        f"device (bound 1e-4); bf16 greedy tokens agree on {agree:.3f}; "
        f"prefill {rec['prefill_s']:.4f} s, {rec['tok_s']:.1f} tok/s, peak "
        f"max_memory_allocated {out['a']['peak_bytes']} B")
    if rel > 1e-4:
        raise AssertionError(f"13a: split prefill differs: {rel}")
    del placed, one_logits, tp_logits
    gc.collect()

    # (b) training split over model
    tcfg = get_config(TRAIN_ARCH)
    t32 = dataclasses.replace(tcfg, activation_dtype=torch.float32)
    params = init_params(tcfg, torch.Generator(device).manual_seed(0))
    stream = TokenStream(tcfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batch = stream.batch(0)
    l1, _, g1 = lm._value_and_grad(params, t32, batch)
    opt = AdamW(lr=TRAIN_LR)
    spmd = lm.make_train_step(t32, opt, card_mesh(TP_TRAIN_MESH, device))
    l2, _, g2 = spmd.sync(params, batch)
    loss_rel = abs(float(l1) - float(l2)) / abs(float(l1))
    grad_rel = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(g2, g1))
    del g1, g2
    log(f"tp 13b: {TRAIN_ARCH} split spmd step on {TP_TRAIN_MESH} against "
        f"one device (f32, {TRAIN_BATCH} x {TRAIN_SEQ}): loss {float(l2):.6f}"
        f" rel {loss_rel:.3g}, gradients max |d| / max|g| {grad_rel:.3g} "
        "(bound 1e-4)")
    if loss_rel > 1e-4 or grad_rel > 1e-4:
        raise AssertionError(f"13b: split step differs: {loss_rel} "
                             f"{grad_rel}")
    hmesh = card_mesh(TP_HIER_MESH, device)
    pp, po = place_state(params, opt.init(params), hmesh)
    hier = lm.make_hier_train_step(tcfg, opt, hmesh)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, losses = [], []
    for i in range(TP_HIER_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pp, po, m = hier(pp, po, stream.batch(i))
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    step_s = sorted(secs[2:])[len(secs[2:]) // 2]
    out["b"] = dict(loss_rel=loss_rel, grad_rel=grad_rel,
                    hier_mesh=list(TP_HIER_MESH), hier_step_s=step_s,
                    hier_tok_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
                    hier_peak_bytes=torch.cuda.max_memory_allocated(),
                    hier_losses=losses)
    log(f"tp 13b: hier step on {TP_HIER_MESH} from the laid-out state: "
        f"median step {step_s:.4f} s over steps 3-{TP_HIER_STEPS} = "
        f"{out['b']['hier_tok_s']:.1f} tokens/s, peak max_memory_allocated "
        f"{out['b']['hier_peak_bytes']} B; losses "
        + ", ".join(f"{x:.4f}" for x in losses))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"13b: hier losses {losses}")
    del pp, po, hier, params
    gc.collect()

    # (c) the split step traced on one placeholder against the card
    from repro_torch.core.lowering import FakeTrace, storage_bytes
    from repro_torch.models.layers import Unseeded
    from repro_torch.placement import FakeDevice

    def build(dev, gen, mesh):
        params = init_params(tcfg, gen)
        pp, po = place_state(params, opt.init(params), mesh)
        del params
        if isinstance(gen, torch.Generator):
            data = {k: torch.randint(0, tcfg.vocab_size,
                                     (TRAIN_BATCH, TRAIN_SEQ), generator=gen,
                                     device=dev) for k in ("inputs", "labels")}
        else:
            data = {k: torch.empty((TRAIN_BATCH, TRAIN_SEQ),
                                   dtype=torch.int64, device=dev)
                    for k in ("inputs", "labels")}
        step = lm.make_train_step(tcfg, opt, mesh)
        return (lambda: step(pp, po, data)), (pp, po, data)

    fn, args = build(device, torch.Generator(device).manual_seed(2),
                     card_mesh(TP_TRAIN_MESH, device))
    arg_c = storage_bytes(_tensors(args))
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() - arg_c
    torch.cuda.reset_peak_memory_stats()
    res = fn()
    torch.cuda.synchronize()
    peak_c = torch.cuda.max_memory_allocated() - base
    del fn, args, res
    gc.collect()
    fake = FakeDevice("cuda", 0)
    fmesh = DeviceMesh(np.array([fake] * math.prod(TP_TRAIN_MESH),
                                dtype=object).reshape(TP_TRAIN_MESH),
                       ("pod", "data", "model"))
    trace = FakeTrace({fake: {}})
    t0 = time.perf_counter()
    with trace.binding():
        fn, args = build(fake, Unseeded(fake), fmesh)
    bound = _tensors(args)
    with trace.running(bound, grad=True):
        res = fn()
        peak_t = trace.peak[fake]
    del res
    arg_t = storage_bytes(bound)
    ratio = peak_c / peak_t
    out["c"] = dict(arg_bytes=arg_c, traced_arg_bytes=arg_t,
                    peak_bytes=peak_c, traced_peak=peak_t, ratio=ratio,
                    trace_s=time.perf_counter() - t0)
    log(f"tp 13c: split {TRAIN_ARCH} step on {TP_TRAIN_MESH}, traced on one "
        f"placeholder ({out['c']['trace_s']:.1f} s): arguments {arg_t} B "
        f"against the card's {arg_c}; peak traced {peak_t} B, "
        f"max_memory_allocated {peak_c} B: ratio {ratio:.4f} (band 1 +- "
        f"{DRY_BAND}, as 12b)")
    if arg_t != arg_c or abs(ratio - 1) > DRY_BAND:
        raise AssertionError(f"13c: trace against card: {out['c']}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"tp phase 13 (a-c): {out['phase_s']:.1f} s")
    return out


def tp_cells(cells):
    """Phase 13d: qwen3-4b ``train_4k`` on one pod and on two, from phase
    12c's host traces of the split step: rank 0's peak against the
    card, ``flops_per_dev`` against twice the reference's useful FLOPs
    per device (``_useful_flops``), and no ``replicate`` copy."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import _useful_flops

    out = {}
    seq, batch, kind = SHAPES["train_4k"]
    for tag, n_dev in (("qwen3-4b train_4k", 256),
                       ("qwen3-4b train_4k 2 pods", 512)):
        c = cells[tag]
        useful = _useful_flops(get_config("qwen3-4b"), kind, batch * seq,
                               n_dev)
        out[tag] = dict(rank0=c["rank0"], fits=c["fits"],
                        flops_per_dev=c["flops_per_dev"], useful=useful,
                        by_kind=c["by_kind"])
        log(f"tp 13d {tag}: rank 0 peak {c['rank0']} B "
            f"({'fits' if c['fits'] else 'does NOT fit'} the card), "
            f"flops/dev {c['flops_per_dev']:.6g} = "
            f"{c['flops_per_dev'] / useful:.3f} x useful {useful:.6g}; "
            "copies by kind (count, bytes a rank): " + ", ".join(
                f"{k} {v['count']}, {v['bytes']:.6g}"
                for k, v in c["by_kind"].items()))
        if not c["fits"] or c["flops_per_dev"] > 2 * useful \
                or "replicate" in c["by_kind"]:
            raise AssertionError(f"13d {tag}: {out[tag]}")
    return out


# phase 12c's cells: (arch, shape, multi_pod), traced on the host
LM_DRY_CELLS = (("qwen3-4b", "train_4k", False),
                ("qwen3-4b", "prefill_32k", False),
                ("qwen3-4b", "decode_32k", False),
                ("smollm-135m", "train_4k", False),
                ("recurrentgemma-9b", "long_500k", False),
                ("xlstm-350m", "train_4k", False),
                ("qwen3-4b", "train_4k", True))
# (a): a sixteenth of a train_4k rank's rows; at 2 rows "none" does not
# fit the card (PERF.md, PR 22)
REMAT_BATCH, REMAT_SEQ = 1, 4096
DRY_BAND = 0.10  # (b): traced peak against max_memory_allocated


def start_lm_cells(tmp):
    """Phase 12c's cells, each a ``launch.dryrun`` process of its own on
    the host, started before the card's LM phases."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape, multi in LM_DRY_CELLS:
        out = Path(tmp) / f"{arch}_{shape}_{int(multi)}.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", str(out)]
        cmd += ["--multi-pod"] if multi else []
        procs.append(((arch, shape, multi), out, subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)))
    return procs


def tensor_leaves(tree):
    """The tensors among a tree's leaves (``opt.tree``; a cache's ``pos``
    is an int)."""
    import torch

    from repro_torch.opt import leaves

    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


def traced_program(build, grad):
    """``build(device, gen) -> (fn, args)`` on one placeholder under a
    ``FakeTrace`` (``gen`` a ``layers.Unseeded``): the argument bytes and
    the trace's peak of ``fn()``, with its seconds."""
    from repro_torch.core.lowering import FakeTrace, storage_bytes
    from repro_torch.models.layers import Unseeded
    from repro_torch.placement import FakeDevice

    dev = FakeDevice("cuda", 0)
    trace = FakeTrace({dev: {}})
    t0 = time.perf_counter()
    with trace.binding():
        fn, args = build(dev, Unseeded(dev))
    bound = tensor_leaves(args)
    with trace.running(bound, grad=grad):
        out = fn()
        peak = trace.peak[dev]
    del out
    return storage_bytes(bound), peak, time.perf_counter() - t0


def card_program(fn, args):
    """``fn()`` on the card: the bytes of ``args`` bound there, and
    ``max_memory_allocated`` over the run above what else was allocated
    (the arguments included, as the trace counts them); the outputs."""
    import torch

    from repro_torch.core.lowering import storage_bytes

    arg = storage_bytes(tensor_leaves(args))
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() - arg
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return arg, torch.cuda.max_memory_allocated() - base, out


def lm_dry_path(device, procs):
    """Phase 12, the LM dry run held against the card.  (a) ``remat`` on
    the card: smollm-135m at full width, one step's loss and gradients
    on 2 x 4096 tokens under ``"none"``, ``"full"`` and ``"dots"``, equal
    bit for bit, each with its peak; (b) the trace on one placeholder of
    the programs the card runs, (a)'s three, phase 10's qwen3-4b prefill
    (4 x 32) and decode step and phase 11's spmd step (smollm-135m, 8 x
    128): the argument bytes equal to the bytes bound on the card, the
    traced peak within ``DRY_BAND`` of ``max_memory_allocated``; (c) the
    production cells of ``LM_DRY_CELLS``, traced on the host in their own
    processes: the busiest rank's and rank 0's peak against the card,
    the bytes between devices by link class, the dominant roofline term
    and the trace's seconds (printed, kept out of the kernels line)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.opt import AdamW

    t_phase = time.perf_counter()
    total = torch.cuda.get_device_properties(device).total_memory
    out = {"a": {}, "b": {}}

    def tokens(cfg, shape, gen, dev):
        if isinstance(gen, torch.Generator):
            return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                 device=dev)
        return torch.empty(shape, dtype=torch.int64, device=dev)

    def remat_build(mode, rows=REMAT_BATCH):
        cfg = get_config(TRAIN_ARCH, remat=mode)

        def build(dev, gen):
            params = init_params(cfg, gen)
            batch = {k: tokens(cfg, (rows, REMAT_SEQ), gen, dev)
                     for k in ("inputs", "labels")}
            return (lambda: lm._value_and_grad(params, cfg, batch)), (
                params, batch)
        return build

    # what twice the rows would take, traced (a host number, not held)
    for mode in ("none", "full"):
        _, p2, _ = traced_program(remat_build(mode, 2 * REMAT_BATCH), True)
        log(f"dry 12a: traced peak at {2 * REMAT_BATCH} x {REMAT_SEQ} "
            f"tokens, remat {mode!r}: {p2} B against total_memory {total} B")
    # (a) remat on the card, one set of weights and one batch
    gen = torch.Generator(device).manual_seed(0)
    _, (params, batch) = remat_build("none")(device, gen)
    got = {}
    for mode in ("none", "full", "dots"):
        cfg = get_config(TRAIN_ARCH, remat=mode)
        arg, peak, res = card_program(
            lambda: lm._value_and_grad(params, cfg, batch), (params, batch))
        loss, _, grads = res
        got[mode] = (loss, grads)
        out["a"][mode] = dict(loss=float(loss), peak_bytes=peak,
                              arg_bytes=arg)
        log(f"dry 12a: {TRAIN_ARCH} full width, loss and gradients of "
            f"{REMAT_BATCH} x {REMAT_SEQ} tokens, remat {mode!r}: loss "
            f"{float(loss):.7f}, max_memory_allocated {peak} B "
            f"(arguments {arg} B)")
    for mode in ("full", "dots"):
        same = torch.equal(got[mode][0], got["none"][0]) and all(
            torch.equal(a, b) for a, b in zip(got[mode][1], got["none"][1]))
        out["a"][mode]["bits_equal_none"] = same
        if not same:
            raise AssertionError(f"12a: remat {mode!r} leaves the bits of "
                                 f"'none'")
    log("dry 12a: 'full' and 'dots' give 'none''s loss and "
        f"{len(got['none'][1])} gradient leaves bit for bit")
    del got, res, loss, grads

    # (b) the same programs traced on one placeholder, and phase 10's and
    # 11's, against the card
    def check(name, build, grad, card):
        arg_t, peak_t, secs = traced_program(build, grad)
        arg_c, peak_c = card
        ratio = peak_c / peak_t
        out["b"][name] = dict(arg_bytes=arg_c, args_equal=arg_t == arg_c,
                              card_peak=peak_c, ratio=ratio)
        log(f"dry 12b {name}: argument bytes traced {arg_t} / on the card "
            f"{arg_c}; peak traced {peak_t} B, max_memory_allocated "
            f"{peak_c} B: ratio {ratio:.4f} (band 1 +- {DRY_BAND}); "
            f"trace {secs:.2f} s")
        if arg_t != arg_c:
            raise AssertionError(f"12b {name}: argument bytes {arg_t} != "
                                 f"{arg_c} on the card")
        if abs(ratio - 1) > DRY_BAND:
            raise AssertionError(f"12b {name}: the traced peak {peak_t} is "
                                 f"{ratio:.4f} x the card's {peak_c}")

    for mode in ("none", "full", "dots"):
        a = out["a"][mode]
        check(f"remat {mode}", remat_build(mode), True,
              (a["arg_bytes"], a["peak_bytes"]))

    tcfg = get_config(TRAIN_ARCH)
    opt = AdamW(lr=TRAIN_LR)

    def spmd_build(dev, gen):
        params = init_params(tcfg, gen)
        state = opt.init(params)
        batch = {k: tokens(tcfg, (TRAIN_BATCH, TRAIN_SEQ), gen, dev)
                 for k in ("inputs", "labels")}
        step = lm.make_train_step(tcfg, opt)
        return (lambda: step(params, state, batch)), (params, state, batch)

    del params, batch
    fn, args = spmd_build(device, gen)
    arg, peak, res = card_program(fn, args)
    del fn, args, res
    check("spmd step", spmd_build, True, (arg, peak))

    qcfg = get_config(LM_ARCH, max_cache=LM_PROMPT + LM_GEN)

    def prefill_build(dev, gen):
        params = init_params(qcfg, gen)
        prompts = tokens(qcfg, (LM_BATCH, LM_PROMPT), gen, dev)
        return (lambda: lm.prefill(params, qcfg, prompts)), (params,
                                                             prompts)

    def decode_build(dev, gen, params=None, cache=None):
        if params is None:
            params = init_params(qcfg, gen)
            cache = init_cache(qcfg, LM_BATCH, dev)
            for c in cache:
                if "pos" in c:
                    c["pos"] = LM_PROMPT
        token = tokens(qcfg, (LM_BATCH, 1), gen, dev)
        return (lambda: lm.decode_step(params, qcfg, cache, token,
                                       LM_PROMPT)), (params, cache, token)

    fn, args = prefill_build(device, gen)
    arg, peak, (_, cache) = card_program(fn, args)
    check("qwen3-4b prefill", prefill_build, False, (arg, peak))
    fn, args = decode_build(device, gen, args[0], cache)
    arg, peak, res = card_program(fn, args)
    check("qwen3-4b decode", decode_build, False, (arg, peak))
    del fn, args, res, cache
    gc.collect()

    # (c) the production cells, traced on the host
    cells = {}
    for (arch, shape, multi), path_json, proc in procs:
        _, err = proc.communicate(timeout=900)
        tag = f"{arch} {shape}{' 2 pods' if multi else ''}"
        if proc.returncode != 0:
            raise AssertionError(f"12c {tag}: exit {proc.returncode}\n"
                                 f"{err[-2000:]}")
        rec = json.loads(path_json.read_text())[0]
        if rec["status"] != "ok":
            raise AssertionError(f"12c {tag}: {rec['status']}\n"
                                 f"{rec.get('trace', '')}")
        mem, coll, rf = rec["memory"], rec["collectives"], rec["roofline"]
        busiest = mem["peak_bytes"]
        fits = busiest <= total
        cells[tag] = dict(busiest=busiest, rank0=mem["rank0"]["peak"],
                          fits=fits, ici=coll["ici_bytes"],
                          dci=coll["dci_bytes"], dominant=rf["dominant"],
                          trace_s=rec["trace_s"],
                          cost_source=rec["cost_source"],
                          flops_per_dev=rec["flops_per_dev"],
                          by_kind=coll["by_kind"])
        log(f"dry 12c {tag} (traced on the host, {rec['cost_source']}, "
            f"{rec['cell']['ranks']} rank(s) of {rec['mesh']}): busiest "
            f"rank {mem['rank']} peak {busiest} B, rank 0 "
            f"{mem['rank0']['peak']} B (arguments "
            f"{mem['rank0']['argument']} B), against total_memory {total}"
            f" B: {'fits' if fits else 'does NOT fit'} | per rank ici "
            f"{coll['ici_bytes']:.6g} dci {coll['dci_bytes']:.6g} B (by "
            "kind: " + ", ".join(
                f"{k} {v['ici_bytes']:.6g}/{v['dci_bytes']:.6g}"
                for k, v in coll["by_kind"].items())
            + f") | flops/dev {rec['flops_per_dev']:.6g}, bytes/dev "
            f"{rec['hbm_bytes_per_dev']:.6g}: dominant {rf['dominant']} "
            f"({rf['t_step']:.4g} s at the H100's datasheet rates) | "
            f"trace {rec['trace_s']} s")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"dry phase 12: {out['phase_s']:.1f} s")
    return out, cells


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
    flops per slot per column over the f32 rate (outside the tensor
    cores), whichever is larger; both rates are the H100's
    (``repro_torch.launch.hardware.HW``)."""
    from repro_torch.launch.hardware import HW

    moved = slots * (2 + vals_bytes) + x_bytes + out_bytes + extra
    bytes_ms = moved / HW.hbm_bw * 1e3
    flops_ms = 2 * slots * FUSE / HW.f32_flops * 1e3
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
    # phase 12c's cells trace on the host beside every card phase
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_dry_") as tmp:
        lm_procs = start_lm_cells(tmp)
        try:
            return phases(device, card, start, xs, lm_procs)
        finally:
            for *_, proc in lm_procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()


def phases(device, card, start, xs, lm_procs):
    """Phases 2 to 13 on the card, then the last lines."""
    import torch

    def phase(name):
        log(f"[{time.perf_counter() - start:7.1f} s] {name}")

    phase("phase 2a: the kernel sweep")
    sweep_errs = check_sweep(device)
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    mesh_build = []
    geo, a, plan = build_problem(
        N, ANGLES, beside=lambda g, m: mesh_build.append(
            pool.submit(build_mesh_plan, g, m)))
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
    plan4, mesh_tables = mesh_build[0].result()
    pool.shutdown()
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_") as tmp:
        phase("phase 7: out-of-core streaming")
        xs.reset_launches()
        stream, store = stream_path(plan, a, device, tmp)
        stream["launches"] = dict(xs.LAUNCHES)
        log(f"stream path launches per kernel: {stream['launches']}")
        if stream["launches"]["sorted"] == 0:
            raise AssertionError("row 1 must run on the streaming path")
        counts["row1"] += stream["launches"]["sorted"]
        phase("phase 8: the service")
        xs.reset_launches()
        serve, srv, vol_a = serve_path(plan, device, store, tmp)
        serve["launches"] = dict(xs.LAUNCHES)
        log(f"serve path launches per kernel: {serve['launches']}")
        if serve["launches"]["sorted"] == 0 or \
                serve["launches"]["sorted_q"] == 0:
            raise AssertionError("rows 1 and 1q must both run on the "
                                 "serve path")
        counts["row1"] += serve["launches"]["sorted"]
        counts["row1q"] += serve["launches"]["sorted_q"]
        phase("phase 8: tuning and drift")
        serve["tune"] = tune_path(plan, device, store, srv, vol_a)
        del srv, vol_a, store
        gc.collect()  # the served plans leave the card before phase 5
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dry_") as tmp:
        phase("phase 9: the dry run")
        procs = start_dry_cells(tmp)
        try:
            dry, dry_launches = dry_run(plan, plan4, a, device, procs)
        finally:
            for *_, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    if dry_launches == 0:
        raise AssertionError("row 1 must run in phase 9's real solves")
    counts["row1"] += dry_launches
    phase("phase 10: LM serving")
    xs.reset_launches()
    lm = lm_path(device)
    if any(xs.LAUNCHES.values()):
        raise AssertionError(f"the LM path launched an SpMM "
                             f"kernel: {dict(xs.LAUNCHES)}")
    phase("phase 11: LM training")
    xs.reset_launches()
    train = train_path(device, card)
    if any(xs.LAUNCHES.values()):
        raise AssertionError(f"the training path launched an SpMM "
                             f"kernel: {dict(xs.LAUNCHES)}")
    # phase 13's card work before phase 12, whose host cells (started
    # with the script) it waits for
    phase("phase 13: tensor parallelism over model")
    xs.reset_launches()
    tp = tp_path(device)
    if any(xs.LAUNCHES.values()):
        raise AssertionError(f"the split LM path launched an SpMM "
                             f"kernel: {dict(xs.LAUNCHES)}")
    phase("phase 12: the LM dry run")
    xs.reset_launches()
    lm_dry, lm_cells = lm_dry_path(device, lm_procs)
    if any(xs.LAUNCHES.values()):
        raise AssertionError(f"the LM dry run launched an SpMM "
                             f"kernel: {dict(xs.LAUNCHES)}")
    phase("phase 13d: the split step's production cells")
    tp["d"] = tp_cells(lm_cells)
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
    kernels[0]["stream"] = stream
    kernels[0]["serve"] = serve
    kernels[0]["dry_run"] = dry
    kernels[0]["lm"] = lm
    kernels[0]["train"] = train
    kernels[0]["lm_dry_run"] = lm_dry
    kernels[0]["tp"] = tp
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
