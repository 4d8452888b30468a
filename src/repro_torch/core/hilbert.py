"""Pseudo-Hilbert ordering for arbitrary W x H tile grids.

The paper (Sec. III-A1) orders tomogram and sinogram tiles with a
*pseudo*-Hilbert curve so that contiguous ranges of the ordering form
spatially-compact subdomains.  We generate the classic Hilbert curve on
the enclosing power-of-two square (vectorized d->(x,y) bit manipulation)
and filter to in-bounds cells -- the standard pseudo-Hilbert construction
for non-square domains.  Filtering can skip cells (the curve is not
strictly step-contiguous at the padded boundary) but preserves the
property the decomposition actually relies on: *locality* -- any
contiguous chunk of the ordering has a compact bounding box
(tests/test_hilbert.py asserts this quantitatively).

The ordering is used at two levels (paper Fig. 4):
  * device level  -- contiguous chunks of the curve = per-device subdomains,
  * kernel level  -- contiguous runs inside a chunk = row-blocks handled by
    one Pallas grid step (the thread-block analogue).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "hilbert_curve_square",
    "gilbert2d",
    "hilbert_order",
    "hilbert_argsort",
    "tile_hilbert_order",
]


def _hilbert_d2xy(order: int, d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized distance -> (x, y) on a 2^order square Hilbert curve."""
    x = np.zeros_like(d)
    y = np.zeros_like(d)
    t = d.copy()
    s = 1
    while s < (1 << order):
        rx = 1 & (t // 2)
        ry = 1 & (t ^ rx)
        # rotate quadrant
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f, y_f = x.copy(), y.copy()
        x = np.where(swap, y_f, x)
        y = np.where(swap, x_f, y)
        x = np.where(flip, s - 1 - x, x)
        y = np.where(flip, s - 1 - y, y)
        x = x + s * rx
        y = y + s * ry
        t //= 4
        s *= 2
    return x, y


def hilbert_curve_square(order: int) -> np.ndarray:
    """Full curve on the 2^order square: [(x, y)] in curve order."""
    n = 1 << order
    d = np.arange(n * n, dtype=np.int64)
    x, y = _hilbert_d2xy(order, d)
    return np.stack([x, y], axis=1)


def gilbert2d(width: int, height: int) -> np.ndarray:
    """Pseudo-Hilbert curve over a W x H rectangle: ``(W*H, 2)`` (x, y).

    Power-of-two Hilbert on the enclosing square, filtered to in-bounds
    cells (name kept for API compatibility with the generalized-curve
    variant it replaces).
    """
    if width <= 0 or height <= 0:
        return np.zeros((0, 2), np.int64)
    side = max(width, height)
    order = max(1, int(np.ceil(np.log2(side)))) if side > 1 else 1
    pts = hilbert_curve_square(order)
    mask = (pts[:, 0] < width) & (pts[:, 1] < height)
    out = pts[mask]
    assert out.shape == (width * height, 2), (out.shape, width, height)
    return out


def hilbert_order(width: int, height: int) -> np.ndarray:
    """``order[k] = flat_index(x_k, y_k)``: curve position -> row-major cell.

    ``flat_index = y * width + x`` (row-major over the W x H grid).
    """
    pts = gilbert2d(width, height)
    return pts[:, 1] * width + pts[:, 0]


def hilbert_argsort(width: int, height: int) -> np.ndarray:
    """``rank[flat_index] = position along the curve`` (inverse of order)."""
    order = hilbert_order(width, height)
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    return rank


def tile_hilbert_order(
    n_rows: int, n_cols: int, tile: int
) -> tuple[np.ndarray, tuple[int, int]]:
    """Hilbert-order the cells of an ``n_rows x n_cols`` grid tile-wise.

    The grid is cut into ``tile x tile`` patches (paper Fig. 4a); patches
    are visited in pseudo-Hilbert order and cells inside a patch are
    visited row-major.  Returns ``(perm, (ty, tx))`` where ``perm`` maps
    curve position -> flat row-major cell index (exactly
    ``n_rows * n_cols`` entries) and ``(ty, tx)`` is the tile-grid shape.
    """
    ty = -(-n_rows // tile)
    tx = -(-n_cols // tile)
    patch_order = gilbert2d(tx, ty)  # (x = col-tile, y = row-tile)
    perm = np.empty(n_rows * n_cols, dtype=np.int64)
    k = 0
    for px, py in patch_order:
        r0, c0 = py * tile, px * tile
        rr = np.arange(r0, min(r0 + tile, n_rows))
        cc = np.arange(c0, min(c0 + tile, n_cols))
        if rr.size == 0 or cc.size == 0:
            continue
        block = (rr[:, None] * n_cols + cc[None, :]).ravel()
        perm[k : k + block.size] = block
        k += block.size
    assert k == n_rows * n_cols
    return perm, (ty, tx)
