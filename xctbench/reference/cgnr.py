"""CGNR for ``argmin_x ||y - A x||`` with a fixed iteration count.

The same recurrence the program's solver states (x0 = 0; one projection
and one backprojection before the loop and one of each per iteration;
per-slice scalars, so the columns of ``y`` never couple), in float64
with plain torch sparse products.  ``operator`` puts a SciPy CSR matrix
and its transpose on a device.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

__all__ = ["cgnr", "operator"]


def _csr(indptr, indices, data, shape, device, dtype):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "beta" notice
        return torch.sparse_csr_tensor(
            torch.from_numpy(np.asarray(indptr, np.int32)),
            torch.from_numpy(np.asarray(indices, np.int32)),
            torch.from_numpy(np.asarray(data)).to(dtype),
            size=shape, check_invariants=False,
        ).to(device)


def operator(a, device, dtype=torch.float64, transpose=True):
    """SciPy CSR ``a`` -> ``(A, A^T)`` as torch CSR tensors on ``device``
    (``A^T`` is ``None`` unless ``transpose``)."""
    fwd = _csr(a.indptr, a.indices, a.data, a.shape, device, dtype)
    if not transpose:
        return fwd, None
    t = a.tocsc()  # A in CSC == A^T in CSR
    back = _csr(t.indptr, t.indices, t.data, a.shape[::-1], device, dtype)
    return fwd, back


def cgnr(a, at, y: torch.Tensor, iters: int):
    """``(x [n_vox, F], resnorms [iters, F])``: the iterate and ``||y -
    A x||`` after each iteration, in ``y``'s dtype."""
    tiny = torch.finfo(y.dtype).tiny
    x = torch.zeros((a.shape[1], y.shape[1]), dtype=y.dtype, device=y.device)
    r = y.clone()
    s = at @ r
    p = s
    gamma = (s * s).sum(0)
    res = []
    for _ in range(iters):
        q = a @ p
        alpha = gamma / torch.clamp_min((q * q).sum(0), tiny)
        x = x + alpha * p
        r = r - alpha * q
        s = at @ r
        gamma_new = (s * s).sum(0)
        p = s + gamma_new / torch.clamp_min(gamma, tiny) * p
        gamma = gamma_new
        res.append(torch.sqrt((r * r).sum(0)))
    return x, torch.stack(res)
