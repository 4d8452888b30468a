"""Shard-local projection/backprojection dispatch + the window-segment builder.

``apply_operator`` is the single-device (shard-local) fused
projection/backprojection.  The default path (``staging="fused"``,
``dma="coalesced"``) hands the whole local slab to
``xct_spmm.spmm_block_ell``, whose CUDA kernel stages each stage's
window in shared memory from the class-sorted run-length segment table
built here (``winmap_segments`` + ``sort_segments_by_class``, byte for
byte the reference's tables).  ``dma="per_row"`` stages one row per
``winmap`` entry, and a segment table without class offsets runs the
unsorted-segment kernel; both are the reference's A/B baselines.
``staging="gather"`` keeps the reference's legacy two-pass path: a
plain gather materializes the ``[B, S, BUF, F]`` windows in device
memory, chunked over row-blocks under a ~64 MB transient budget, and
``xct_spmm.spmm_block_ell_staged`` consumes them.  On CPU tensors every
path runs the kernels' plain PyTorch versions.  ``use_ref=True`` swaps
in the oracle of ``ref.py`` so every higher layer can be validated with
one flag.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.precision import dequantize_block_vals
from . import ref
from .xct_spmm import _dma_classes, spmm_block_ell, spmm_block_ell_staged

__all__ = [
    "apply_operator",
    "check_supported",
    "winmap_segments",
    "sort_segments_by_class",
    "segment_histogram",
    "dma_issue_count",
    "staged_window_bytes",
    "STAGINGS",
    "DMA_MODES",
]

STAGINGS = ("fused", "gather")
DMA_MODES = ("coalesced", "per_row")


def winmap_segments(winmap, pad_to: int = 8) -> np.ndarray:
    """Run-length encode a ``[..., BUF]`` winmap into DMA segments.

    Every maximal run of *consecutive* source rows in a stage's window
    (``winmap[..., j+1] == winmap[..., j] + 1``) becomes one coalesced
    copy ``x[src : src+len] -> win[dst : dst+len]``; runs are then split
    into power-of-two pieces (largest first) because Pallas DMA extents
    are static -- the kernel unrolls over the possible length classes
    and issues each piece with one ``pl.when``-guarded copy.  Hilbert
    ordering (``core.partition``) keeps runs long, so a production
    stage's window moves in O(NSEG) issues instead of O(BUF).

    Args:
      winmap: ``[..., BUF]`` int array of device-local input column ids
        (any leading batch dims; the shards use ``[B, S, BUF]``).
      pad_to: pad the per-stage segment capacity to a multiple of this.

    Returns:
      ``[..., NSEG, 3]`` int32: ``{src_start, dst_start, len}`` per
      segment, ``len`` a power of two; pad slots have ``len == 0`` (the
      kernel skips them).  NSEG is the max decomposed-segment count over
      all leading indices, padded to ``pad_to``.
    """
    wm = np.asarray(winmap)
    if wm.ndim < 1:
        raise ValueError("winmap must have a trailing BUF dimension")
    lead, buf = wm.shape[:-1], wm.shape[-1]
    flat = wm.reshape(-1, buf).astype(np.int64)
    n = flat.shape[0]
    if n == 0:
        return np.zeros((*lead, pad_to, 3), np.int32)
    # fully vectorized (plan builds call this for every shard): run
    # boundaries, then one fill pass per power-of-two length class
    isbrk = np.ones((n, buf), bool)
    if buf > 1:
        isbrk[:, 1:] = np.diff(flat, axis=1) != 1
    row_id, st = np.nonzero(isbrk)  # runs, row-major order
    en = np.empty_like(st)
    en[:-1] = st[1:]
    en[-1] = buf
    en[np.flatnonzero(np.diff(row_id))] = buf  # last run of each row
    length = en - st
    src0 = flat[row_id, st]
    nbits = int(buf).bit_length()
    counts = np.zeros_like(length)  # popcount = decomposed pieces/run
    for b in range(nbits):
        counts += (length >> b) & 1
    # piece slot = (pieces of prior runs in the row) + (larger pieces
    # of this run): largest-first order, matching the kernel's classes
    cum = np.cumsum(counts) - counts
    firsts = np.concatenate(([0], np.flatnonzero(np.diff(row_id)) + 1))
    runs_per_row = np.diff(np.append(firsts, row_id.size))
    run_off = cum - np.repeat(cum[firsts], runs_per_row)
    totals = np.add.reduceat(counts, firsts)
    nseg = pad_to * -(-int(totals.max()) // pad_to)
    out = np.zeros((n, nseg, 3), np.int32)
    for b in range(nbits):
        sel = ((length >> b) & 1) == 1
        if not sel.any():
            continue
        ln = length[sel]
        off = (ln >> (b + 1)) << (b + 1)  # sum of the larger pieces
        rank = np.zeros_like(ln)
        for b2 in range(b + 1, nbits):
            rank += (ln >> b2) & 1
        slot = run_off[sel] + rank
        out[row_id[sel], slot, 0] = src0[sel] + off
        out[row_id[sel], slot, 1] = st[sel] + off
        out[row_id[sel], slot, 2] = 1 << b
    return out.reshape(*lead, nseg, 3)


def sort_segments_by_class(
    winsegs, buf: int
) -> tuple[np.ndarray, np.ndarray]:
    """Sort every stage's segment table by descending copy length and
    build the per-class offset table the fused kernel consumes.

    ``winmap_segments`` emits power-of-two pieces in run order; the
    kernel, whose DMA extents must be static, would then have to test
    every slot against every length class (O(classes x NSEG) issue work
    per window -- the interpret-mode 10x inversion ``bench_spmm``
    measured).  Grouping slots by class instead lets the kernel run one
    ``fori_loop`` per class with *dynamic bounds* ``[off[c], off[c+1])``
    over exactly that class's slots: total issue work is O(real
    segments), unconditionally.

    Args:
      winsegs: ``[..., NSEG, 3]`` table from :func:`winmap_segments`.
      buf: the window height (``winmap.shape[-1]``) -- fixes the static
        class list ``xct_spmm._dma_classes(buf)`` the offsets index.

    Returns:
      ``(sorted_segs [..., NSEG, 3], offsets [..., NCLS+1])`` int32:
      slots ``[offsets[i], offsets[i+1])`` hold exactly the segments of
      length ``classes_desc[i]`` (classes in descending order);
      ``offsets[-1]`` ends the real segments, pad slots (len 0) follow.
    """
    segs = np.asarray(winsegs)
    lead, nseg = segs.shape[:-2], segs.shape[-2]
    flat = segs.reshape(-1, nseg, 3)
    order = np.argsort(-flat[..., 2], axis=1, kind="stable")
    srt = np.take_along_axis(flat, order[..., None], axis=1)
    classes = _dma_classes(buf)[::-1]
    lens = srt[..., 2]
    off = np.empty((flat.shape[0], len(classes) + 1), np.int32)
    for i, ln in enumerate(classes):
        off[:, i] = (lens > ln).sum(axis=1)
    off[:, -1] = (lens > 0).sum(axis=1)
    return (
        srt.astype(np.int32).reshape(*lead, nseg, 3),
        off.reshape(*lead, len(classes) + 1),
    )


def dma_issue_count(winsegs) -> int:
    """Copies the coalesced kernel issues per window pass: one per
    non-pad segment (pad slots have ``len == 0``)."""
    return int((np.asarray(winsegs)[..., 2] > 0).sum())


def segment_histogram(winsegs) -> dict:
    """``{copy_len: count}`` over the non-pad segments of a table --
    the measured segments-per-stage histogram ``bench_spmm`` reports."""
    lens = np.asarray(winsegs)[..., 2].ravel()
    lens = lens[lens > 0]
    uniq, cnt = np.unique(lens, return_counts=True)
    return {int(u): int(c) for u, c in zip(uniq, cnt)}


def staged_window_bytes(s: int, buf: int, f: int,
                        storage_bytes: int) -> int:
    """Transient device bytes of ONE row-block's gathered windows: the
    ``[S, BUF, F]`` tensor only ``staging="gather"`` allocates."""
    return s * buf * f * storage_bytes


def _gather_blocks_per_call(b, s, buf, f, bytes_per, budget=64 << 20):
    """Row-blocks whose gathered windows fit a ~64 MB transient budget.

    ``bytes_per`` is the storage dtype's itemsize.  The largest divisor
    of ``b`` that fits, as the reference chunks its gather path.
    """
    per_block = staged_window_bytes(s, buf, f, bytes_per)
    want = max(1, budget // max(1, per_block))
    if want >= b:
        return b
    for d in range(min(want, b), 0, -1):
        if b % d == 0:
            return d
    return 1


def check_supported(staging: str, dma: str) -> None:
    """Raise ``ValueError`` for an unknown staging or dma mode."""
    if staging not in STAGINGS:
        raise ValueError(
            f"unknown staging {staging!r}; one of {STAGINGS}"
        )
    if dma not in DMA_MODES:
        raise ValueError(f"unknown dma {dma!r}; one of {DMA_MODES}")


def apply_operator(
    inds,
    vals,
    winmap,
    x_loc,
    *,
    storage_dtype=torch.float16,
    compute_dtype=torch.float32,
    use_ref: bool = False,
    staging: str = "fused",
    dma: str = "coalesced",
    winsegs=None,
    segoff=None,
    smem_budget: int | None = None,
    blocks_per_call: int | None = None,
    scales=None,
):
    """Shard-local fused SpMM: returns the fp32 partial rows [B*R, F].

    Args:
      inds: [B, S, R, K] int16 window-local indices.
      vals: [B, S, R, K] float lengths (cast to ``storage_dtype`` here
        unless already that dtype), or packed int8/fp8 with ``scales``.
      winmap: [B, S, BUF] device-local input column ids.
      x_loc: [C, F] local input slab (any float dtype; cast to
        ``storage_dtype``, computed in ``compute_dtype``).
      use_ref: run the ``ref.spmm_ref`` oracle instead of the kernel.
      staging: "fused" (the kernel stages windows itself) or "gather"
        (windows gathered into device memory first, chunked over
        row-blocks; the reference's A/B baseline).
      dma: "coalesced" (windows staged from run-length segments) or
        "per_row" (one copy per window row).  Fused staging only.
      winsegs, segoff: the class-sorted segment table and its per-class
        offsets (``OperatorShards.winsegs`` / ``.segoff``).  Both are
        built here from ``winmap`` when ``winsegs`` is omitted;
        ``winsegs`` without ``segoff`` runs the unsorted-segment kernel.
      smem_budget: kept for the reference's signature.  It sized the TPU
        kernel's scalar-prefetch chunks; on Hopper every CTA loads its
        own descriptors, so it has no effect.
      blocks_per_call: row-blocks per gather chunk (``staging="gather"``);
        sized from the 64 MB budget when None.
      scales: [B, S] int32 per-block dequantization exponents
        (``core.precision.quantize_block_vals``).  ``vals`` is then
        packed int8/fp8 and passes through untouched: the fused kernels
        dequantize inline, the oracle and the gather path widen to f32
        first.
    """
    check_supported(staging, dma)
    del smem_budget  # no scalar-prefetch memory to budget on Hopper
    quantized = scales is not None
    vals_s = vals if quantized else vals.to(storage_dtype)
    x_s = x_loc.to(storage_dtype).contiguous()
    b, s, r, k = inds.shape
    buf = winmap.shape[-1]
    f = x_loc.shape[-1]

    if quantized and (use_ref or staging != "fused"):
        vals_s = dequantize_block_vals(vals, scales, torch.float32)

    if use_ref:
        return ref.spmm_ref(
            inds, vals_s, winmap, x_s, compute_dtype=compute_dtype
        ).to(torch.float32)

    if staging == "fused":
        if dma == "coalesced" and winsegs is None:
            segs_np, off_np = sort_segments_by_class(
                winmap_segments(winmap.cpu().numpy()), buf
            )
            winsegs = torch.from_numpy(segs_np).to(winmap.device)
            segoff = torch.from_numpy(off_np).to(winmap.device)
        coalesced = dma == "coalesced"
        out = spmm_block_ell(
            inds, vals_s, winmap, x_s, compute_dtype=compute_dtype,
            winsegs=winsegs if coalesced else None,
            segoff=segoff if coalesced else None, scales=scales,
        )
        return out.reshape(b * r, f)

    # --- gather staging: windows in device memory, chunked ------------
    def one_chunk(lo, hi):
        window = x_s[winmap[lo:hi].long()]  # [bpc, S, BUF, F]
        return spmm_block_ell_staged(
            inds[lo:hi], vals_s[lo:hi], window, compute_dtype=compute_dtype
        )

    bpc = blocks_per_call or _gather_blocks_per_call(
        b, s, buf, f, x_s.element_size()
    )
    out = torch.cat([one_chunk(lo, lo + bpc) for lo in range(0, b, bpc)])
    return out.reshape(b * r, f)
