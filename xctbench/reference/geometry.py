"""Parallel-beam XCT system matrix by Siddon ray tracing (frozen copy).

Entry (r, v) of ``A`` (rays x voxels) is the exact length of ray ``r``
inside voxel ``v``; every slice of a parallel-beam volume shares it.
This is a frozen copy of the projector the program also implements, kept
here so that the benchmark's operator does not change when the
program's does.  Voxel ``v = iy * n + ix``; ray ``r = k * n_det + c``
for angle ``k`` of ``n_angles`` spread over [0, pi).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

__all__ = ["XCTGeometry", "build_system_matrix"]


@dataclasses.dataclass(frozen=True)
class XCTGeometry:
    """One slice's scan: an ``n x n`` image, ``n_angles`` projections of
    ``n_det`` channels (default ``n``), voxel side ``vox``."""

    n: int
    n_angles: int
    n_det: int | None = None
    vox: float = 1.0

    @property
    def num_det(self) -> int:
        return self.n_det if self.n_det is not None else self.n

    @property
    def n_rays(self) -> int:
        return self.n_angles * self.num_det

    @property
    def n_vox(self) -> int:
        return self.n * self.n


def _siddon_one_angle(geo: XCTGeometry, theta: float) -> tuple[np.ndarray, ...]:
    """All rays of one projection angle.  Returns COO (chan, col, len)."""
    n, vox = geo.n, geo.vox
    c = geo.num_det
    half = n * vox / 2.0
    planes = -half + vox * np.arange(n + 1)  # grid-line coordinates

    ux, uy = np.cos(theta), np.sin(theta)  # propagation direction
    ex, ey = -np.sin(theta), np.cos(theta)  # detector axis
    t = (np.arange(c) - (c - 1) / 2.0) * vox  # channel offsets
    # Ray origin far outside the grid; |u| = 1 so alpha == arc length.
    L = 2.0 * half * 2.0
    p0x = t * ex - L * ux
    p0y = t * ey - L * uy

    eps = 1e-12
    with np.errstate(divide="ignore", invalid="ignore"):
        ax = (planes[None, :] - p0x[:, None]) / ux if abs(ux) > eps else None
        ay = (planes[None, :] - p0y[:, None]) / uy if abs(uy) > eps else None

    # Entry/exit of the bounding box per ray.
    lo = np.full(c, -np.inf)
    hi = np.full(c, np.inf)
    for a in (ax, ay):
        if a is not None:
            lo = np.maximum(lo, np.minimum(a[:, 0], a[:, -1]))
            hi = np.minimum(hi, np.maximum(a[:, 0], a[:, -1]))
    # Rays parallel to an axis must still lie inside that axis' extent.
    if ax is None:
        inside = (p0x >= planes[0]) & (p0x <= planes[-1])
        hi = np.where(inside, hi, lo)
    if ay is None:
        inside = (p0y >= planes[0]) & (p0y <= planes[-1])
        hi = np.where(inside, hi, lo)

    parts = [a for a in (ax, ay) if a is not None]
    alphas = np.concatenate(parts + [lo[:, None], hi[:, None]], axis=1)
    alphas = np.clip(alphas, lo[:, None], hi[:, None])
    alphas.sort(axis=1)

    seg = np.diff(alphas, axis=1)  # intersection lengths
    mid = 0.5 * (alphas[:, 1:] + alphas[:, :-1])
    px = p0x[:, None] + mid * ux
    py = p0y[:, None] + mid * uy
    ix = np.floor((px + half) / vox).astype(np.int64)
    iy = np.floor((py + half) / vox).astype(np.int64)

    valid = (seg > 1e-9 * vox) & (ix >= 0) & (ix < n) & (iy >= 0) & (iy < n)
    chan = np.broadcast_to(np.arange(c)[:, None], seg.shape)[valid]
    col = (iy * n + ix)[valid]
    return chan, col, seg[valid]


def build_system_matrix(geo: XCTGeometry, dtype=np.float32) -> sp.csr_matrix:
    """Exact Siddon system matrix ``A`` of shape (K * n_det, n * n)."""
    rows, cols, vals = [], [], []
    thetas = np.pi * np.arange(geo.n_angles) / geo.n_angles
    for k, theta in enumerate(thetas):
        chan, col, seg = _siddon_one_angle(geo, theta)
        rows.append(chan + k * geo.num_det)
        cols.append(col)
        vals.append(seg)
    coo = sp.coo_matrix(
        (
            np.concatenate(vals).astype(dtype),
            (np.concatenate(rows), np.concatenate(cols)),
        ),
        shape=(geo.n_rays, geo.n_vox),
    )
    csr = coo.tocsr()
    csr.sum_duplicates()
    return csr
