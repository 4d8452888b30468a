"""Fused multi-stage blocked-ELL SpMM: the CUDA kernels and their plain versions.

:func:`spmm_block_ell` and :func:`spmm_block_ell_staged` compute, for
one device's shard,

    out[b, r, :] = sum_s sum_k vals[b, s, r, k] * x[winmap[b, s, inds[b, s, r, k]], :]

as fp32 ``[B, R, F]``, each stage's partial summed in ``compute_dtype``
from zero over ``k`` and then added into the fp32 output in stage order
(the reference's ``_fma_block`` contract).

On a CUDA tensor they launch the hand-written kernels in
``csrc/xct_spmm.cu`` (see the note at the top of that file for what each
staging mode replaces, what bounds it and what its design does about
it).  ``spmm_block_ell`` picks the kernel from its arguments, as the
reference's ``one_call`` does: ``winsegs`` + ``segoff`` -> the
class-sorted kernel (row 1), ``winsegs`` alone -> the unsorted-segment
kernel (row 2), neither -> one copy per window row (row 3); ``scales``
selects the quantized form (row 1q) of each.  ``spmm_block_ell_staged``
is the pre-gathered window kernel (row 4).  On a CPU tensor each runs
its plain version.  There is no fallback between the two: a CUDA call
that cannot launch raises.  ``LAUNCHES`` counts the launches of every
kernel by name.

Every kernel was redesigned for Hopper (rows 1, 1q and 4 first, then
rows 2 and 3): a thread computes one row of one stage on a 16-byte
vector of ``F`` with its indices and values in registers, a CTA
computes several stages at once from a ring of windows in shared memory
that producer warps fill ahead of the compute, and row 4 splits each
row-block's stages over a thread block cluster.  The producer warps copy
row 1's class-sorted and row 2's run-order segments of 256 bytes or more
by one ``cp.async.bulk`` each and the shorter ones by 16-byte
``cp.async``; row 3's window rows by 16-byte ``cp.async``, a row's
pieces on neighbouring lanes; row 4's window by one bulk copy per stage.
:func:`launch_geometry` chooses the ring depth, the stages computed at
once and the cluster size from what :func:`smem_bytes` says fits in the
CTAs an SM holds; nothing else bounds ``R * F``.  Windows whose rows are
not 16-byte multiples, or an ``x`` that is not 16-byte aligned, take
the staging loops on every thread, element by element.

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
from typing import NamedTuple

import torch

from ..core.precision import dequantize_block_vals

__all__ = [
    "spmm_block_ell",
    "spmm_block_ell_plain",
    "spmm_block_ell_staged",
    "spmm_block_ell_staged_plain",
    "fma_f32",
    "build",
    "reset_launches",
    "smem_bytes",
    "sm_smem_bytes",
    "launch_geometry",
    "Geometry",
    "SMEM_LIMIT",
    "KERNEL_PAIRS",
    "QUANT_DTYPES",
    "ENTRIES",
    "LAUNCHES",
]

# Shared memory one CTA may use on Hopper (232,448 bytes of the SM's 256 KB).
SMEM_LIMIT = 232_448
_SM_SMEM = 233_472  # shared memory of one SM; 1 KB of it reserved per CTA
_THREADS = 256
_MAX_CLUSTER = 8  # CTAs per row-block in row 4 (the portable cluster size)
_MAX_LOOKAHEAD = 3  # rounds of windows in flight ahead of the compute
# CTAs per SM a ring may be sized for: two 256-thread CTAs hide each
# other's first round and last fold, and a third fits where the entry's
# registers allow it (80 or fewer a thread).  launch_geometry takes the
# one whose ring keeps more stages computing on an SM, and the most CTAs
# on a tie (on the n=512 shards at f16: two on proj, three on back).
_CTAS_PER_SM = (2, 3)

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


def smem_bytes(r: int, buf: int, f: int, store_bytes: int, depth: int,
               part_buffers: int, acc: bool = True) -> int:
    """Dynamic shared memory of one CTA (the layout ``smem_layout`` in
    ``csrc/xct_spmm.cu`` computes): ``depth`` ring slots of one
    ``[BUF, F]`` window each (rows padded to 16 bytes), ``part_buffers``
    fp32 ``[R, F]`` stage partials, the fp32 ``[R, F]`` accumulator when
    one CTA owns the row-block (``acc``), and one 8-byte mbarrier per
    slot; each region 16-byte aligned."""
    rf = r * f * 4
    return (
        depth * buf * _align16(f * store_bytes)
        + _align16(part_buffers * rf)
        + (_align16(rf) if acc else 0)
        + depth * 8
    )


class Geometry(NamedTuple):
    """How one launch covers the shard, as the kernel receives it:
    ``depth`` ring slots, ``inflight`` stages computed at once,
    ``cluster`` CTAs per row-block, each taking ``stages_per_cta``
    stages, ``part_buffers`` stage partials in shared memory, ``smem``
    bytes of dynamic shared memory."""

    depth: int
    inflight: int
    cluster: int
    stages_per_cta: int
    part_buffers: int
    smem: int

    @property
    def lookahead(self) -> int:
        """Rounds of windows issued ahead of the round being computed."""
        return self.depth // self.inflight - 1


def launch_geometry(staging: str, s: int, r: int, k: int, buf: int, f: int,
                    store_bytes: int, resident: int | None = None) -> Geometry:
    """Ring depth, stages in flight and cluster size of one launch.

    A thread computes one row of one stage on a 16-byte vector of ``F``,
    so a stage takes ``R * ceil(F * store_bytes / 16)`` threads and the
    256-thread CTA computes up to ``256 // that`` stages at once.  Row 4
    (``staging="staged"``) splits each row-block's ``S`` stages over a
    cluster of up to 8 CTAs of at least that many stages each.  The ring
    then holds ``inflight`` slots per round plus as many rounds ahead
    (at most 3) as fit in the shared memory of 2 or 3 CTAs per SM (of no
    more than the ``resident`` CTAs the kernel's registers let an SM
    hold; else of one CTA): the widest ``inflight`` that still leaves one
    round of lookahead wins, and a window that fits only once runs
    single-buffered (depth 1).  Of the rings for 2 and for 3 CTAs, the
    one whose CTAs an SM holds compute more stages at once is taken, the
    one for more CTAs on a tie.  Raises ``ValueError`` when not even one
    window fits.
    """
    resident = _CTAS_PER_SM[-1] if resident is None else max(1, resident)
    best, score = None, None
    for ctas in sorted({min(c, resident) for c in _CTAS_PER_SM}):
        geo = _sized_for(ctas, staging, s, r, k, buf, f, store_bytes)
        held = min(resident, _SM_SMEM // (geo.smem + 1024))
        if score is None or (held * geo.inflight, held) >= score:
            best, score = geo, (held * geo.inflight, held)
    return best


def sm_smem_bytes(staging: str, s: int, r: int, k: int, buf: int, f: int,
                  store_bytes: int, resident: int | None = None) -> int:
    """Dynamic shared memory one launch takes on an SM: its
    :func:`launch_geometry` ring times the CTAs an SM holds of it (of no
    more than ``resident``, as there).  The port's counterpart of the
    reference's per-core ``vmem_bytes``; needs no card."""
    geo = launch_geometry(staging, s, r, k, buf, f, store_bytes, resident)
    resident = _CTAS_PER_SM[-1] if resident is None else max(1, resident)
    return geo.smem * min(resident, _SM_SMEM // (geo.smem + 1024))


def _sized_for(ctas, staging, s, r, k, buf, f, store_bytes) -> Geometry:
    """The ring of :func:`launch_geometry` for ``ctas`` CTAs per SM."""
    s = max(int(s), 1)
    budget = min(SMEM_LIMIT, _SM_SMEM // ctas - 1024)
    row = _align16(f * store_bytes)
    group = min(r * (row // 16), _THREADS)
    groups = _THREADS // group
    if staging == "staged":
        nloc = max(-(-s // _MAX_CLUSTER), min(groups, s))
        cluster = -(-s // nloc)
    else:
        nloc, cluster = s, 1

    def geometry(p, look):
        parts = nloc if cluster > 1 else 2 * p
        depth = (look + 1) * p
        return Geometry(depth, p, cluster, nloc, parts,
                        smem_bytes(r, buf, f, store_bytes, depth, parts,
                                   acc=cluster == 1))

    for limit in (budget, SMEM_LIMIT):
        for p in range(min(groups, nloc), 0, -1):
            rounds = -(-nloc // p)
            for look in range(min(_MAX_LOOKAHEAD, rounds - 1), -1, -1):
                geo = geometry(p, look)
                if geo.smem <= limit and (look >= 1 or rounds == 1):
                    return geo
    geo = geometry(1, 0)  # single-buffered
    if geo.smem > SMEM_LIMIT:
        raise ValueError(
            f"kernel shared memory {geo.smem} B exceeds the {SMEM_LIMIT} B "
            f"a CTA may use (R={r}, K={k}, BUF={buf}, F={f}); the window "
            f"BUF*F = {buf}*{f} x {store_bytes} B dominates -- shrink the "
            "window (BUF) or fuse (F)"
        )
    return geo


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
                fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [
                    ctypes.c_void_p
                ]
                fn.restype = ctypes.c_int
                occ = getattr(lib, _entry_name(*entry) + "_occupancy")
                occ.argtypes = [ctypes.POINTER(ctypes.c_int)]
                occ.restype = ctypes.c_int
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


def fma_f32(part, prod):
    """``part + prod`` rounded once to f32, as a fused multiply-add rounds
    ``part + v * x``: ``part`` f32, ``prod`` the f64 product of two f32
    values (exact in f64).  Where the f64 sum is inexact it is taken to
    the odd one of the two f64 neighbours of the exact sum (round to
    odd), which makes the second rounding, to f32, the correct one."""
    p = part.to(torch.float64)
    s = p + prod
    bb = s - p
    err = (p - (s - bb)) + (prod - bb)  # exact: s + err == p + prod
    even = (s.view(torch.int64) & 1) == 0
    towards = torch.copysign(torch.full_like(s, float("inf")), err)
    s = torch.where((err != 0) & even, torch.nextafter(s, towards), s)
    return s.to(torch.float32)


# significant bits of each dtype's values
_BITS = {torch.float64: 53, torch.float32: 24, torch.float16: 11,
         torch.bfloat16: 8}


def _rounds_twice(parts, prods) -> bool:
    """Whether rounding any f64 sum ``part + prod`` to f32 differs from
    rounding the exact sum once: only an inexact f64 sum on an f32
    midpoint (low 29 mantissa bits ``1 << 28``) or in f32's subnormal
    range can."""
    p, d = torch.stack(parts), torch.stack(prods)
    s = p + d
    bb = s - p
    inexact = (p - (s - bb)) + (d - bb) != 0
    mid = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    tiny = s.abs() < 2.0 ** -126
    return bool((inexact & (mid | tiny)).any())


def _plain_stages(inds, vals, window_of, f, compute_dtype,
                  vals_bits=None):
    """The float contract over stages; ``window_of(s)`` gives stage
    ``s``'s ``[B, BUF, F]`` window in the storage dtype.  ``vals_bits``:
    the most significant bits a value has (default: its dtype's)."""
    b, s, r, k = inds.shape
    fused = compute_dtype == torch.float16
    out = torch.zeros((b, r, f), dtype=torch.float32, device=inds.device)
    for si in range(s):
        window = window_of(si)  # [B, BUF, F] storage dtype
        # a product of two values of 12 or fewer significant bits each
        # (f16, bf16, dequantized int8 / fp8) is exact in f32, where the
        # f32 sum then rounds once; an f32 operand's product needs f64
        once = compute_dtype == torch.float32 and max(
            vals_bits or _BITS[vals.dtype], _BITS[window.dtype]) > 12
        wide = (torch.float32 if fused else torch.float64 if once
                else compute_dtype)
        idx = inds[:, si].long()  # [B, R, K]
        v = vals[:, si].to(compute_dtype).to(wide)  # [B, R, K]
        part = torch.zeros((b, r, f), dtype=compute_dtype, device=out.device)
        parts, steps = [], []
        for kk in range(k):
            g = torch.take_along_dim(
                window, idx[:, :, kk, None].expand(b, r, f), dim=1
            )
            step = v[:, :, kk, None] * g.to(compute_dtype).to(wide)
            p = part.to(wide)
            if once:
                # the f64 product is exact and its f64 sum with part,
                # rounded to f32, is one fused multiply-add's result
                # unless it rounded twice: then the stage is redone
                parts.append(p)
                steps.append(step)
            part = (p + step).to(compute_dtype)
        if once and _rounds_twice(parts, steps):
            part = torch.zeros_like(part)
            for step in steps:
                part = fma_f32(part, step)
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
    reference computes it on its CPU validation platform: f32 rounds the
    step once, as one fused multiply-add does (XLA contracts the step;
    :func:`fma_f32`); f16 evaluates the step in f32 (the product of two
    f16 values is exact there) and rounds once to f16; bf16 and f64 round
    the product and then the sum.  ``scales`` dequantizes packed int8/fp8
    ``vals`` to f32 first (``2**scales[b, s]`` is exact).  Memory stays at
    one stage's window.
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
    return _plain_stages(inds, vals, window_of, x.shape[-1], compute_dtype,
                         vals_bits=None if scales is None else 8)


def spmm_block_ell_staged_plain(inds, vals, window, *,
                                compute_dtype=torch.float32):
    """Plain PyTorch version of the pre-gathered window kernel: the same
    contract on ``window [B, S, BUF, F]``."""
    return _plain_stages(inds, vals, lambda si: window[:, si],
                         window.shape[-1], compute_dtype)


def _table_name(staging):
    return "winsegs" if staging in ("sorted", "unsorted") else "winmap"


def _check_types(staging, inds, vals, x, compute_dtype, table, segoff,
                 scales):
    if inds.dtype != torch.int16:
        raise ValueError(f"inds must be int16, got {inds.dtype}")
    for name, t in ((_table_name(staging), table), ("segoff", segoff),
                    ("scales", scales)):
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


# The chunked row 4 calls the wrapper hundreds of times per application,
# so what does not change between calls is checked and sized once: the
# dtype signatures _check_types accepted, and the (entry, geometry) of
# each staging, dtypes and shard shape.
_CHECKED: set = set()
_PLANS: dict = {}


def _check(staging, inds, vals, x, compute_dtype, table, segoff, scales):
    dev = x.get_device()
    tensors = (inds, vals, x, table, segoff, scales)
    for i, t in enumerate(tensors):
        if t is not None and (t.get_device() != dev
                              or not t.is_contiguous()):
            name = ("inds", "vals", "x", _table_name(staging), "segoff",
                    "scales")[i]
            if t.get_device() != dev:
                raise ValueError(f"{name} is on {t.device}, x on {x.device}")
            raise ValueError(f"{name} must be contiguous")
    sig = (staging, inds.dtype, vals.dtype, x.dtype, compute_dtype,
           table is None or table.dtype, segoff is None or segoff.dtype,
           scales is None or scales.dtype)
    if sig not in _CHECKED:
        _check_types(staging, inds, vals, x, compute_dtype, table, segoff,
                     scales)
        _CHECKED.add(sig)
    if vals.shape != inds.shape:
        raise ValueError(f"vals {tuple(vals.shape)} != inds {tuple(inds.shape)}")
    if scales is not None and scales.shape != inds.shape[:2]:
        raise ValueError(f"scales must be [B, S] = {tuple(inds.shape[:2])}, "
                         f"got {tuple(scales.shape)}")
    return dev


def _resident(name) -> int:
    """CTAs of entry ``name`` an SM of the current device holds by its
    registers and threads."""
    ctas = ctypes.c_int(0)
    err = getattr(_library(), name + "_occupancy")(ctypes.byref(ctas))
    if err != 0:
        raise RuntimeError(f"{name}_occupancy failed: cudaError {err}")
    return ctas.value


def _plan(staging, vals_dtype, x_dtype, compute_dtype, s, r, k, buf, f, sb):
    key = (staging, vals_dtype, x_dtype, compute_dtype, s, r, k, buf, f)
    hit = _PLANS.get(key)
    if hit is None:
        name = _entry_name(staging, vals_dtype, x_dtype, compute_dtype)
        geo = launch_geometry(staging, s, r, k, buf, f, sb,
                              resident=_resident(name))
        hit = _PLANS[key] = (getattr(_library(), name), geo)
    return hit


def _launch(staging, inds, vals, x, compute_dtype, *, buf, table=None,
            segoff=None, scales=None, nseg=0, noff=0):
    """Check, size and launch one kernel entry on the current stream."""
    dev = _check(staging, inds, vals, x, compute_dtype, table, segoff, scales)
    b, s, r, k = inds.shape
    f = x.shape[-1]
    fn, geo = _plan(staging, vals.dtype, x.dtype, compute_dtype, s, r, k, buf,
                    f, x.element_size())
    out = x.new_empty((b, r, f), dtype=torch.float32)
    args = (
        inds.data_ptr(), vals.data_ptr(), x.data_ptr(),
        None if table is None else table.data_ptr(),
        None if segoff is None else segoff.data_ptr(),
        None if scales is None else scales.data_ptr(), out.data_ptr(),
        b, s, r, k, buf, f, nseg, noff, geo.depth, geo.inflight, geo.cluster,
        torch._C._cuda_getCurrentRawStream(dev),
    )
    if dev == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(
            f"xct_spmm {staging} kernel launch failed: cudaError {err} "
            f"(B={b}, S={s}, R={r}, K={k}, BUF={buf}, F={f}, "
            f"{vals.dtype}/{x.dtype}/{compute_dtype}, {geo})"
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
