"""Iterative solvers for ``argmin_x ||y - Ax||^2`` (paper Sec. II-A).

CGNR (conjugate gradient on the normal equations) with a fixed iteration
count, as in the paper's evaluation (30 CG iterations = 31 projections +
31 backprojections).  The solver sees two linear maps and a dot product;
``core.recon`` closes them over the operators, so the same code runs
dense test closures and the blocked-ELL kernel, on tensors or on the
vectors ``core.recon`` shards by rows over the ranks
(``core.sharded.Sharded``, whose dot products sit on every rank).

Per-slice scalars: slices of the volume are independent least-squares
problems sharing ``A``; alpha/beta are computed per fused slice (shape
``[F]``), which never couples slices.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["cgnr"]


def cgnr(
    apply_a: Callable,
    apply_at: Callable,
    y,
    x0,
    iters: int,
    dot_rows: Callable,
    *,
    compute_dtype=torch.float32,
    storage_dtype=None,
):
    """CGNR with a static iteration count.

    Args:
      apply_a: x -> A x (handles precision internally).
      apply_at: r -> A^T r.
      y: measurement slab(s), last dim = slices.
      x0: initial iterate.
      iters: CG iterations (paper uses 30).
      dot_rows: (u, v) -> per-slice dot product reduced over rows,
        returning shape ``[F]`` (float32 in ``core.recon``).
      compute_dtype: scalar/update arithmetic dtype.
      storage_dtype: dtype the iterate vectors are *kept* in between
        iterations (the paper stores state in half for mixed mode; defaults
        to ``compute_dtype``).

    Returns:
      (x, resnorms) -- resnorms has shape ``[iters, F]`` with the per-slice
      residual norm ``||y - Ax||`` after each iteration.
    """
    storage_dtype = storage_dtype or compute_dtype
    eps = torch.finfo(compute_dtype).tiny

    def st(v):
        return v.to(storage_dtype)

    def co(v):
        return v.to(compute_dtype)

    r = co(y) - co(apply_a(st(x0)))
    s = co(apply_at(st(r)))
    gamma = dot_rows(s, s)
    x, p = st(x0), st(s)
    resnorms = []
    for _ in range(iters):
        q = co(apply_a(st(p)))
        # CG scalars stay f32 (dot_rows reduces wide); cast at the update
        alpha = (gamma / torch.clamp_min(dot_rows(q, q), eps)).to(
            compute_dtype
        )
        x = co(x) + alpha[None, :] * co(p)
        r = r - alpha[None, :] * q
        s = co(apply_at(st(r)))
        gamma_new = dot_rows(s, s)
        beta = (gamma_new / torch.clamp_min(gamma, eps)).to(compute_dtype)
        p = s + beta[None, :] * co(p)
        resnorms.append(torch.sqrt(dot_rows(r, r)))
        x, p, gamma = st(x), st(p), gamma_new
    res = torch.stack(resnorms) if resnorms else gamma[None][:0]
    return x, res
