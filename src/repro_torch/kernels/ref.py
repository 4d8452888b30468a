"""Plain PyTorch oracles for the XCT blocked-ELL SpMM.

Two oracles:

  * :func:`spmm_ref` -- operates on the exact blocked-ELL shard layout the
    kernel consumes (same staging, same padding).  Used for
    kernel-vs-oracle allclose sweeps.
  * :func:`coo_apply` -- operates on the raw COO triplets of the original
    (un-permuted) system matrix.  Used for end-to-end system checks
    (partitioning + permutation + kernel + reduction == plain SpMM).
"""
from __future__ import annotations

import torch

__all__ = ["spmm_ref", "coo_apply"]


def spmm_ref(inds, vals, winmap, x_loc, *, compute_dtype=torch.float32):
    """Reference fused SpMM over one device's blocked-ELL shard.

    Args:
      inds:   [B, S, R, K] window-local indices (any int dtype).
      vals:   [B, S, R, K] lengths (any float dtype).
      winmap: [B, S, BUF]  device-local input column ids.
      x_loc:  [C, F] local input slab (C = padded local columns, F = fused
              slices, the paper's minibatch/FFACTOR dimension).

    Returns:
      [B * R, F] partial output band in ``compute_dtype``.
    """
    b, s, r, k = inds.shape
    f = x_loc.shape[-1]
    window = x_loc[winmap.long()].to(compute_dtype)  # B,S,BUF,F
    flat = inds.reshape(b, s, r * k).long()
    g = torch.take_along_dim(window, flat[..., None], dim=2)  # B,S,R*K,F
    g = g.reshape(b, s, r, k, f)
    acc = (vals.to(compute_dtype)[..., None] * g).sum(dim=(1, 3))
    return acc.reshape(b * r, f)


def coo_apply(rows, cols, lens, x, n_rows, *, compute_dtype=torch.float32):
    """Plain COO SpMM: ``y[rows] += lens * x[cols]`` broadcast over slices.

    Args:
      rows, cols, lens: COO triplets of the (dense-index) system matrix.
      x: [n_cols, F] input slabs.
      n_rows: output row count.
    """
    contrib = lens.to(compute_dtype)[:, None] * x[cols.long()].to(
        compute_dtype
    )
    y = torch.zeros(
        (n_rows, x.shape[1]), dtype=compute_dtype, device=x.device
    )
    return y.index_add_(0, rows.long(), contrib)
