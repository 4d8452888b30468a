"""Fused multi-stage blocked-ELL SpMM: the CUDA kernels and their plain versions.

:func:`spmm_block_ell` and :func:`spmm_block_ell_staged` compute, for
one device's shard,

    out[b, r, :] = sum_s sum_k vals[b, s, r, k] * x[winmap[b, s, inds[b, s, r, k]], :]

as fp32 ``[B, R, F]``, each stage's partial summed in ``compute_dtype``
from zero over ``k`` and then added into the fp32 output (the
reference's ``_fma_block`` contract).

On a CUDA tensor they launch the hand-written kernels in
``csrc/xct_spmm.cu`` (one CTA per row-block; see the note at the top of
that file for what each staging mode replaces and what bounds it).
``spmm_block_ell`` picks the kernel from its arguments, as the
reference's ``one_call`` does: ``winsegs`` + ``segoff`` -> the
class-sorted kernel (row 1), ``winsegs`` alone -> the unsorted-segment
kernel (row 2), neither -> one copy per window row (row 3); ``scales``
selects the quantized form (row 1q) of each.  ``spmm_block_ell_staged``
is the pre-gathered window kernel (row 4).  On a CPU tensor each runs
its plain version.  There is no fallback between the two: a CUDA call
that cannot launch raises.  ``LAUNCHES`` counts the launches of every
kernel by name.

The kernel is compiled with ``nvcc`` into a plain-C shared library under
``build/`` at first use and loaded with ``ctypes``; nothing is compiled
or imported from a toolchain when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from ..core.precision import dequantize_block_vals

__all__ = [
    "spmm_block_ell",
    "spmm_block_ell_plain",
    "spmm_block_ell_staged",
    "spmm_block_ell_staged_plain",
    "build",
    "reset_launches",
    "smem_bytes",
    "SMEM_LIMIT",
    "KERNEL_PAIRS",
    "QUANT_DTYPES",
    "ENTRIES",
    "LAUNCHES",
]

# Shared memory one CTA may use on Hopper (232,448 bytes of the SM's 256 KB).
SMEM_LIMIT = 232_448
_THREADS = 256
_MAX_OUT = 4  # outputs per thread in the kernel: R * F <= 1024

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "xct_spmm.cu"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

_NAMES = {
    torch.float64: "f64",
    torch.float32: "f32",
    torch.float16: "f16",
    torch.bfloat16: "bf16",
    torch.int8: "i8",
    torch.float8_e4m3fn: "e4m3",
}
# (storage, compute) pairs the six float precision policies use
KERNEL_PAIRS = (
    (torch.float64, torch.float64),
    (torch.float32, torch.float32),
    (torch.float16, torch.float16),
    (torch.float16, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32),
)
# packed value types of the quantized kernels (row 1q): f16 windows,
# f32 compute, one int32 exponent per (row-block, stage)
QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)
_QUANT_PAIR = (torch.float16, torch.float32)


def _entries() -> tuple:
    """``(staging, vals, window, compute)`` of every ``extern "C"`` entry
    of ``csrc/xct_spmm.cu``."""
    out = []
    for staging in ("sorted", "unsorted", "per_row"):
        out += [(staging, st, st, ct) for st, ct in KERNEL_PAIRS]
        out += [(staging, q, *_QUANT_PAIR) for q in QUANT_DTYPES]
    out += [("staged", st, st, ct) for st, ct in KERNEL_PAIRS]
    # the quantized tier under staging="gather": vals dequantized to f32
    out.append(("staged", torch.float32, *_QUANT_PAIR))
    return tuple(out)


ENTRIES = _entries()
# launches per kernel; "_q" names the quantized form (row 1q)
LAUNCHES = dict.fromkeys(
    ("sorted", "sorted_q", "unsorted", "unsorted_q", "per_row",
     "per_row_q", "staged"),
    0,
)

_lib = None
_lib_lock = threading.Lock()


def _dma_classes(buf: int) -> tuple:
    """Static power-of-two copy lengths a decomposed segment can have.

    ``ops.winmap_segments`` splits every run into power-of-two pieces,
    so the kernel can issue fixed-size copies (Pallas DMAs need static
    extents) while still moving one *run* in O(log) issues instead of
    O(len) per-row issues.
    """
    classes = []
    ln = 1
    while ln <= max(1, buf):
        classes.append(ln)
        ln *= 2
    return tuple(classes)


def _align16(n: int) -> int:
    return (n + 15) & ~15


def smem_bytes(r: int, k: int, buf: int, f: int, store_bytes: int,
               vals_bytes: int | None = None) -> int:
    """Dynamic shared memory of one CTA: the ``[BUF, F]`` window plus the
    stage's ``R*K`` values and int16 indices, each 16-byte aligned (the
    layout ``smem_layout`` in ``csrc/xct_spmm.cu`` computes).
    ``vals_bytes`` defaults to ``store_bytes``."""
    vb = store_bytes if vals_bytes is None else vals_bytes
    return (
        _align16(buf * f * store_bytes)
        + _align16(r * k * vb)
        + _align16(r * k * 2)
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the CUDA kernel is built "
            "from csrc/xct_spmm.cu on first use and needs the CUDA toolkit"
        )
    return str(cand)


def build() -> tuple[Path, float, str]:
    """Compile ``csrc/xct_spmm.cu`` for ``sm_90a`` unless already built.

    Returns ``(library path, build seconds, compiler output)``; the
    seconds are 0 and the output empty when the library for this exact
    source already exists.  The library name carries a hash of the
    source, so an edited kernel is rebuilt.
    """
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:12]
    out = _BUILD_DIR / f"libxct_spmm_{tag}.so"
    if out.exists():
        return out, 0.0, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", tmp, str(_SOURCE),
    ]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}"
                f"{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, time.perf_counter() - t0, proc.stdout + proc.stderr


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _, _ = build()
            lib = ctypes.CDLL(str(path))
            for entry in ENTRIES:
                fn = getattr(lib, _entry_name(*entry))
                fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
                    ctypes.c_void_p
                ]
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _entry_name(staging, vals, window, compute) -> str:
    return (f"xct_spmm_{staging}_{_NAMES[vals]}_{_NAMES[window]}_"
            f"{_NAMES[compute]}")


def reset_launches() -> None:
    """Set every launch count (per kernel and per wrapper) to 0."""
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    spmm_block_ell.launches = 0
    spmm_block_ell_staged.launches = 0


def _plain_stages(inds, vals, window_of, f, compute_dtype):
    """The float contract over stages; ``window_of(s)`` gives stage
    ``s``'s ``[B, BUF, F]`` window in the storage dtype."""
    b, s, r, k = inds.shape
    fused = compute_dtype == torch.float16
    wide = torch.float32 if fused else compute_dtype
    out = torch.zeros((b, r, f), dtype=torch.float32, device=inds.device)
    for si in range(s):
        window = window_of(si)  # [B, BUF, F] storage dtype
        idx = inds[:, si].long()  # [B, R, K]
        v = vals[:, si].to(compute_dtype).to(wide)  # [B, R, K]
        part = torch.zeros((b, r, f), dtype=compute_dtype, device=out.device)
        for kk in range(k):
            g = torch.take_along_dim(
                window, idx[:, :, kk, None].expand(b, r, f), dim=1
            )
            step = v[:, :, kk, None] * g.to(compute_dtype).to(wide)
            part = (part.to(wide) + step).to(compute_dtype)
        out += part.float()
    return out


def _rows_from_segments(segs, buf: int):
    """``[B, BUF]`` source row of every window row of one stage, as the
    ``[B, NSEG, 3]`` segment table ``{src, dst, len}`` copies them; slots
    with ``len == 0`` copy nothing."""
    b, nseg, _ = segs.shape
    flat = segs.reshape(-1, 3).long()
    lens = flat[:, 2]
    slot = torch.repeat_interleave(
        torch.arange(flat.shape[0], device=segs.device), lens
    )
    first = torch.cumsum(lens, 0) - lens
    off = torch.arange(slot.numel(), device=segs.device) - first[slot]
    rows = torch.zeros((b, buf), dtype=torch.long, device=segs.device)
    rows[slot // nseg, flat[slot, 1] + off] = flat[slot, 0] + off
    return rows


def spmm_block_ell_plain(inds, vals, winmap, x, *,
                         compute_dtype=torch.float32, winsegs=None,
                         scales=None):
    """Plain PyTorch version of the fused kernels, with their contract.

    Per stage ``s`` the window is gathered -- ``x[winmap[:, s]]``, or,
    with ``winsegs``, staged from the segment table as the
    unsorted-segment kernel does -- and the partial is summed in
    ``compute_dtype`` from zero over ``k`` in order, then added into the
    fp32 output.  Rounding of one step ``part + v * x``, as the
    reference computes it on its CPU validation platform: f16 evaluates
    the step in f32 (the product of two f16 values is exact there) and
    rounds once to f16; bf16, f32 and f64 round the product and then the
    sum.  ``scales`` dequantizes packed int8/fp8 ``vals`` to f32 first
    (``2**scales[b, s]`` is exact).  Memory stays at one stage's window.
    """
    if scales is not None:
        vals = dequantize_block_vals(vals, scales, torch.float32)
    if winsegs is None:
        def window_of(si):
            return x[winmap[:, si].long()]
    else:
        buf = winmap.shape[-1]

        def window_of(si):
            return x[_rows_from_segments(winsegs[:, si], buf)]
    return _plain_stages(inds, vals, window_of, x.shape[-1], compute_dtype)


def spmm_block_ell_staged_plain(inds, vals, window, *,
                                compute_dtype=torch.float32):
    """Plain PyTorch version of the pre-gathered window kernel: the same
    contract on ``window [B, S, BUF, F]``."""
    return _plain_stages(inds, vals, lambda si: window[:, si],
                         window.shape[-1], compute_dtype)


def _check(staging, inds, vals, x, compute_dtype, *, tables, scales):
    tensors = {"inds": inds, "vals": vals, "x": x, **tables,
               "scales": scales}
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if inds.dtype != torch.int16:
        raise ValueError(f"inds must be int16, got {inds.dtype}")
    for name, t in (*tables.items(), ("scales", scales)):
        if t is not None and t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    entry = (staging, vals.dtype, x.dtype, compute_dtype)
    if scales is not None and (
        staging == "staged" or vals.dtype not in QUANT_DTYPES
    ):
        raise ValueError(
            f"scales select the quantized kernels: vals must be one of "
            f"{[str(q) for q in QUANT_DTYPES]} under a fused staging, got "
            f"{vals.dtype} ({staging})"
        )
    if scales is None and vals.dtype in QUANT_DTYPES:
        raise ValueError(f"{vals.dtype} vals need their scales")
    if entry not in ENTRIES:
        raise ValueError(
            f"no kernel for vals {vals.dtype} / storage {x.dtype} / compute "
            f"{compute_dtype} ({staging}); entries: "
            f"{[_entry_name(*e) for e in ENTRIES if e[0] == staging]}"
        )
    b, s, r, k = inds.shape
    if vals.shape != inds.shape:
        raise ValueError(f"vals {tuple(vals.shape)} != inds {tuple(inds.shape)}")
    if scales is not None and scales.shape != (b, s):
        raise ValueError(f"scales must be [B, S] = {(b, s)}, got "
                         f"{tuple(scales.shape)}")
    if r * x.shape[-1] > _THREADS * _MAX_OUT:
        raise ValueError(
            f"R*F = {r}*{x.shape[-1]} exceeds the kernel's "
            f"{_THREADS * _MAX_OUT} outputs per row-block; shrink "
            "rows_per_block or fuse"
        )


def _launch(staging, inds, vals, x, compute_dtype, *, buf, table=None,
            segoff=None, scales=None, nseg=0, noff=0):
    """Check, size and launch one kernel entry on the current stream."""
    tables = {"winsegs" if staging in ("sorted", "unsorted") else "winmap":
              table, "segoff": segoff}
    _check(staging, inds, vals, x, compute_dtype, tables=tables,
           scales=scales)
    b, s, r, k = inds.shape
    f = x.shape[-1]
    sb = x.element_size()
    need = smem_bytes(r, k, buf, f, sb, vals.element_size())
    if need > SMEM_LIMIT:
        raise ValueError(
            f"kernel shared memory {need} B exceeds the {SMEM_LIMIT} B a "
            f"CTA may use (R={r}, K={k}, BUF={buf}, F={f}); the window "
            f"BUF*F = {buf}*{f} x {sb} B dominates -- shrink the window "
            "(BUF) or fuse (F)"
        )
    vec = int((f * sb) % 16 == 0 and x.data_ptr() % 16 == 0)
    out = torch.empty((b, r, f), dtype=torch.float32, device=x.device)
    fn = getattr(
        _library(), _entry_name(staging, vals.dtype, x.dtype, compute_dtype)
    )

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            inds.data_ptr(), vals.data_ptr(), x.data_ptr(), ptr(table),
            ptr(segoff), ptr(scales), out.data_ptr(),
            b, s, r, k, buf, f, nseg, noff, vec, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"xct_spmm {staging} kernel launch failed: cudaError {err} "
            f"(B={b}, S={s}, R={r}, K={k}, BUF={buf}, F={f}, "
            f"{vals.dtype}/{x.dtype}/{compute_dtype})"
        )
    LAUNCHES[staging + ("_q" if scales is not None else "")] += 1
    return out


def spmm_block_ell(inds, vals, winmap, x, *, compute_dtype=torch.float32,
                   winsegs=None, segoff=None, scales=None):
    """Fused multi-stage SpMM over one device's blocked-ELL shard.

    Args:
      inds:   [B, S, R, K] int16 window-local indices.
      vals:   [B, S, R, K] storage-dtype lengths, or int8 / fp8-e4m3
              packed values with ``scales``.
      winmap: [B, S, BUF] int32 device-local input column ids (the
              per-row kernel stages with it; the others take BUF from it).
      x:      [C, F] local input slab (storage dtype, contiguous).
      compute_dtype: dtype of the per-stage partial sums.
      winsegs: [B, S, NSEG, 3] int32 run-length segments
              (``ops.winmap_segments``).  With ``segoff`` the table must
              be class-sorted (``ops.sort_segments_by_class``) and the
              class-sorted kernel runs; alone, the unsorted-segment
              kernel runs; without it, the per-row kernel.
      segoff: [B, S, NCLS+1] int32 per-class slot offsets into a
              class-sorted ``winsegs``.
      scales: [B, S] int32 per-block dequantization exponents
              (``core.precision.quantize_block_vals``); ``vals`` is then
              int8 / fp8-e4m3, ``x`` f16 and ``compute_dtype`` f32, and
              the kernel multiplies each value by ``2.0**scales[b, s]``.

    Returns:
      [B, R, F] fp32 partial output band blocks.

    CPU tensors take :func:`spmm_block_ell_plain`.  CUDA tensors launch a
    kernel on the current stream (``spmm_block_ell.launches`` counts
    them, ``LAUNCHES`` by kernel) or raise.
    """
    if x.device.type == "cpu":
        return spmm_block_ell_plain(
            inds, vals, winmap, x, compute_dtype=compute_dtype,
            winsegs=winsegs if segoff is None else None, scales=scales,
        )
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    buf = winmap.shape[-1]
    if winsegs is not None and segoff is not None:
        if segoff.shape[-1] != len(_dma_classes(buf)) + 1:
            raise ValueError(
                f"segoff carries {segoff.shape[-1] - 1} length classes but "
                f"BUF={buf} implies {len(_dma_classes(buf))} "
                "(sort_segments_by_class(winsegs, buf) with the same buf)"
            )
        staging = "sorted"
    else:
        staging = "per_row" if winsegs is None else "unsorted"
    b, s = inds.shape[:2]
    for name, t, lead in (("winsegs", winsegs, 4), ("segoff", segoff, 3),
                          ("winmap", winmap, 3)):
        if t is not None and (t.dim() != lead or t.shape[:2] != (b, s)):
            raise ValueError(
                f"{name} must lead with [B, S] = {(b, s)}, got "
                f"{tuple(t.shape)}"
            )
    if x.dim() != 2:
        raise ValueError(f"x must be [C, F], got {tuple(x.shape)}")
    out = _launch(
        staging, inds, vals, x, compute_dtype, buf=buf,
        table=winmap if staging == "per_row" else winsegs,
        segoff=segoff if staging == "sorted" else None, scales=scales,
        nseg=0 if winsegs is None else winsegs.shape[-2],
        noff=0 if staging != "sorted" else segoff.shape[-1],
    )
    spmm_block_ell.launches += 1
    return out


def spmm_block_ell_staged(inds, vals, window, *,
                          compute_dtype=torch.float32):
    """SpMM on windows pre-gathered in device memory (the reference's
    legacy two-pass path, ``ops.apply_operator(staging="gather")``).

    Args:
      inds:   [B, S, R, K] int16 window-local indices.
      vals:   [B, S, R, K] lengths in the window's dtype, or f32 with an
              f16 window and f32 compute (the quantized tier, dequantized
              before the call).
      window: [B, S, BUF, F] the gathered windows (contiguous).

    Returns [B, R, F] fp32.  CPU tensors take
    :func:`spmm_block_ell_staged_plain`; CUDA tensors launch the kernel
    (``spmm_block_ell_staged.launches``) or raise.
    """
    if window.device.type == "cpu":
        return spmm_block_ell_staged_plain(
            inds, vals, window, compute_dtype=compute_dtype
        )
    if window.device.type != "cuda":
        raise ValueError(f"unsupported device {window.device}")
    if window.dim() != 4 or window.shape[:2] != inds.shape[:2]:
        raise ValueError(
            f"window must be [B, S, BUF, F] with B, S = "
            f"{tuple(inds.shape[:2])}, got {tuple(window.shape)}"
        )
    out = _launch("staged", inds, vals, window, compute_dtype,
                  buf=window.shape[-2])
    spmm_block_ell_staged.launches += 1
    return out


spmm_block_ell.launches = 0
spmm_block_ell_staged.launches = 0
