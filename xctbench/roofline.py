"""The yardstick of a kernel's share of its roofline.

Bytes come from the problem, never from how the program lays it out:
an SpMM application at ``fuse`` slices reads every nonzero of ``A`` once
(the value at the policy's operator width plus a 2-byte in-block column
index, the paper's packed layout), reads its input vector once and
writes its output vector once at the policy's storage width.  It does
2 flops per nonzero per slice, outside the tensor cores.  The least time
is the larger of the bytes over the card's memory rate and the flops
over its rate.
"""
from __future__ import annotations

__all__ = ["PEAKS", "POLICY_BYTES", "INDEX_BYTES", "spmm_bytes",
           "spmm_min_s"]

# published dense peaks per card (NVIDIA's data sheet, SXM part, 700 W):
# HBM bytes/s and float32 flops/s outside the tensor cores
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_flops_per_s": 67e12},
}

# precision policy -> (operator value bytes, vector storage bytes)
POLICY_BYTES = {
    "double": (8, 8),
    "single": (4, 4),
    "half": (2, 2),
    "mixed": (2, 2),
    "bf16": (2, 2),
    "mixed_bf16": (2, 2),
    "q8": (1, 2),
    "fp8": (1, 2),
}
INDEX_BYTES = 2


def spmm_bytes(nnz: int, n_in: int, n_out: int, fuse: int,
               precision: str) -> int:
    """Least bytes one application moves: ``A``'s nonzeros once, the
    ``[n_in, fuse]`` input read and the ``[n_out, fuse]`` output written
    once."""
    vals, store = POLICY_BYTES[precision]
    return nnz * (vals + INDEX_BYTES) + (n_in + n_out) * fuse * store


def spmm_min_s(nnz: int, n_in: int, n_out: int, fuse: int, precision: str,
               kind: str):
    """``(seconds, "bytes" | "flops")`` of one application on card
    ``kind``; ``None`` for a card the table does not hold."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    t_bytes = spmm_bytes(nnz, n_in, n_out, fuse, precision) / \
        peak["hbm_bytes_per_s"]
    t_flops = 2 * nnz * fuse / peak["f32_flops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "flops")
