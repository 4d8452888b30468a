"""Fused multi-stage blocked-ELL SpMM: the CUDA kernel and its plain version.

:func:`spmm_block_ell` computes, for one device's shard,

    out[b, r, :] = sum_s sum_k vals[b, s, r, k] * x[winmap[b, s, inds[b, s, r, k]], :]

as fp32 ``[B, R, F]``, each stage's partial summed in ``compute_dtype``
from zero over ``k`` and then added into the fp32 output (the
reference's ``_fma_block`` contract).

On a CUDA tensor it launches the hand-written kernel in
``csrc/xct_spmm.cu`` (one CTA per row-block, the stage window staged in
shared memory from the class-sorted segment table; see the note at the
top of that file for what it replaces and what bounds it).  On a CPU
tensor it runs :func:`spmm_block_ell_plain`.  There is no fallback
between the two: a CUDA call that cannot launch raises.

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

__all__ = [
    "spmm_block_ell",
    "spmm_block_ell_plain",
    "build",
    "smem_bytes",
    "SMEM_LIMIT",
    "KERNEL_PAIRS",
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


def smem_bytes(r: int, k: int, buf: int, f: int, store_bytes: int) -> int:
    """Dynamic shared memory of one CTA: the ``[BUF, F]`` window plus the
    stage's ``R*K`` values and int16 indices, each 16-byte aligned (the
    layout ``smem_layout`` in ``csrc/xct_spmm.cu`` computes)."""
    return (
        _align16(buf * f * store_bytes)
        + _align16(r * k * store_bytes)
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
            for st, ct in KERNEL_PAIRS:
                fn = getattr(lib, f"xct_spmm_{_NAMES[st]}_{_NAMES[ct]}")
                fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
                    ctypes.c_void_p
                ]
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def spmm_block_ell_plain(inds, vals, winmap, x, *,
                         compute_dtype=torch.float32):
    """Plain PyTorch version of the kernel, with its numeric contract.

    Per stage ``s`` the window ``x[winmap[:, s]]`` is gathered and the
    partial is summed in ``compute_dtype`` from zero over ``k`` in order,
    then added into the fp32 output.  Rounding of one step
    ``part + v * x``, as the reference computes it on its CPU validation
    platform: f16 evaluates the step in f32 (the product of two f16
    values is exact there) and rounds once to f16; bf16, f32 and f64
    round the product and then the sum.  Memory stays at one stage's
    window.
    """
    b, s, r, k = inds.shape
    f = x.shape[-1]
    fused = compute_dtype == torch.float16
    wide = torch.float32 if fused else compute_dtype
    out = torch.zeros((b, r, f), dtype=torch.float32, device=x.device)
    for si in range(s):
        window = x[winmap[:, si].long()]  # [B, BUF, F] storage dtype
        idx = inds[:, si].long()  # [B, R, K]
        v = vals[:, si].to(compute_dtype).to(wide)  # [B, R, K]
        part = torch.zeros((b, r, f), dtype=compute_dtype, device=x.device)
        for kk in range(k):
            g = torch.take_along_dim(
                window, idx[:, :, kk, None].expand(b, r, f), dim=1
            )
            step = v[:, :, kk, None] * g.to(compute_dtype).to(wide)
            part = (part.to(wide) + step).to(compute_dtype)
        out += part.float()
    return out


def _check(inds, vals, x, winsegs, segoff, compute_dtype):
    tensors = {"inds": inds, "vals": vals, "x": x, "winsegs": winsegs,
               "segoff": segoff}
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if inds.dtype != torch.int16:
        raise ValueError(f"inds must be int16, got {inds.dtype}")
    if winsegs.dtype != torch.int32 or segoff.dtype != torch.int32:
        raise ValueError("winsegs and segoff must be int32")
    if vals.dtype != x.dtype:
        raise ValueError(
            f"vals ({vals.dtype}) and x ({x.dtype}) must share the "
            "storage dtype"
        )
    if (x.dtype, compute_dtype) not in KERNEL_PAIRS:
        raise ValueError(
            f"no kernel for storage {x.dtype} / compute {compute_dtype}; "
            f"pairs: {[(str(a), str(c)) for a, c in KERNEL_PAIRS]}"
        )
    b, s, r, k = inds.shape
    if vals.shape != inds.shape:
        raise ValueError(f"vals {tuple(vals.shape)} != inds {tuple(inds.shape)}")
    if x.dim() != 2:
        raise ValueError(f"x must be [C, F], got {tuple(x.shape)}")
    if winsegs.dim() != 4 or winsegs.shape[:2] != (b, s) \
            or winsegs.shape[-1] != 3:
        raise ValueError(f"winsegs must be [B, S, NSEG, 3], got "
                         f"{tuple(winsegs.shape)}")
    if segoff.dim() != 3 or segoff.shape[:2] != (b, s):
        raise ValueError(f"segoff must be [B, S, NCLS+1], got "
                         f"{tuple(segoff.shape)}")
    if r * x.shape[-1] > _THREADS * _MAX_OUT:
        raise ValueError(
            f"R*F = {r}*{x.shape[-1]} exceeds the kernel's "
            f"{_THREADS * _MAX_OUT} outputs per row-block; shrink "
            "rows_per_block or fuse"
        )


def spmm_block_ell(inds, vals, winmap, x, *, compute_dtype=torch.float32,
                   winsegs=None, segoff=None):
    """Fused multi-stage SpMM over one device's blocked-ELL shard.

    Args:
      inds:   [B, S, R, K] int16 window-local indices.
      vals:   [B, S, R, K] storage-dtype lengths.
      winmap: [B, S, BUF] device-local input column ids (the plain
              version gathers with it; the kernel takes BUF from it).
      x:      [C, F] local input slab (storage dtype, contiguous).
      compute_dtype: dtype of the per-stage partial sums.
      winsegs: [B, S, NSEG, 3] int32 class-sorted run-length segments
              (``ops.sort_segments_by_class``); the kernel stages each
              window from it.  Required on CUDA.
      segoff: [B, S, NCLS+1] int32 per-class slot offsets into
              ``winsegs``.  Required on CUDA.

    Returns:
      [B, R, F] fp32 partial output band blocks.

    CPU tensors take :func:`spmm_block_ell_plain`.  CUDA tensors launch
    the kernel on the current stream (``spmm_block_ell.launches`` counts
    the launches) or raise.
    """
    if x.device.type == "cpu":
        return spmm_block_ell_plain(
            inds, vals, winmap, x, compute_dtype=compute_dtype
        )
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if winsegs is None or segoff is None:
        raise ValueError(
            "the CUDA kernel stages windows from the class-sorted segment "
            "table: pass winsegs and segoff (ops.sort_segments_by_class)"
        )
    _check(inds, vals, x, winsegs, segoff, compute_dtype)
    b, s, r, k = inds.shape
    buf = winmap.shape[-1]
    f = x.shape[-1]
    if segoff.shape[-1] != len(_dma_classes(buf)) + 1:
        raise ValueError(
            f"segoff carries {segoff.shape[-1] - 1} length classes but "
            f"BUF={buf} implies {len(_dma_classes(buf))} "
            "(sort_segments_by_class(winsegs, buf) with the same buf)"
        )
    sb = x.element_size()
    need = smem_bytes(r, k, buf, f, sb)
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
        _library(), f"xct_spmm_{_NAMES[x.dtype]}_{_NAMES[compute_dtype]}"
    )
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            inds.data_ptr(), vals.data_ptr(), x.data_ptr(),
            winsegs.data_ptr(), segoff.data_ptr(), out.data_ptr(),
            b, s, r, k, buf, f, winsegs.shape[-2], segoff.shape[-1], vec,
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"xct_spmm kernel launch failed: cudaError {err} "
            f"(B={b}, S={s}, R={r}, K={k}, BUF={buf}, F={f}, "
            f"{x.dtype}/{compute_dtype})"
        )
    spmm_block_ell.launches += 1
    return out


spmm_block_ell.launches = 0
