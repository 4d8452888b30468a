"""3D phantom generation + measurement simulation for XCT.

Shepp-Logan-style ellipse phantoms varying smoothly along the slice axis,
plus a measurement simulator (forward projection + optional Poisson-ish
noise) so examples/benchmarks reconstruct from realistic sinograms the
same way the paper reconstructs its four beamline datasets.
"""
from __future__ import annotations

import numpy as np

__all__ = ["phantom_slices", "simulate_measurements"]

# (intensity, x0, y0, a, b, theta) -- loosely Shepp-Logan
_ELLIPSES = [
    (1.0, 0.0, 0.0, 0.69, 0.92, 0.0),
    (-0.8, 0.0, -0.0184, 0.6624, 0.874, 0.0),
    (-0.2, 0.22, 0.0, 0.11, 0.31, -18.0),
    (-0.2, -0.22, 0.0, 0.16, 0.41, 18.0),
    (0.1, 0.0, 0.35, 0.21, 0.25, 0.0),
    (0.1, 0.0, 0.1, 0.046, 0.046, 0.0),
    (0.1, -0.08, -0.605, 0.046, 0.023, 0.0),
    (0.1, 0.06, -0.605, 0.023, 0.046, 0.0),
]


def phantom_slices(
    n: int,
    n_slices: int,
    seed: int = 0,
    *,
    start: int = 0,
    stop: int | None = None,
) -> np.ndarray:
    """Returns [n*n, stop-start] float32; slices morph along the axis.

    ``start``/``stop`` select a slab of the *global* ``n_slices``-slice
    volume: the ellipse drift depends only on ``seed`` and each slice
    only on its global index, so generating a volume slab-by-slab is
    bit-identical to one call over the full range (what the streaming
    fixture writer ``stream.store.simulate_to_store`` relies on).
    """
    stop = n_slices if stop is None else stop
    if not 0 <= start <= stop <= n_slices:
        raise ValueError((start, stop, n_slices))
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    x = (xx - (n - 1) / 2) / (n / 2)
    y = (yy - (n - 1) / 2) / (n / 2)
    out = np.zeros((stop - start, n, n), np.float32)
    drift = rng.normal(0, 0.02, size=(len(_ELLIPSES), 2))
    for s in range(start, stop):
        z = (s + 0.5) / n_slices - 0.5  # [-0.5, 0.5]
        img = np.zeros((n, n), np.float32)
        for i, (a0, x0, y0, ea, eb, th) in enumerate(_ELLIPSES):
            # ellipses shrink away from the equatorial plane (3D-ish)
            shrink = np.sqrt(max(1e-3, 1.0 - (2 * z) ** 2))
            cx = x0 + drift[i, 0] * z * 4
            cy = y0 + drift[i, 1] * z * 4
            c, si = np.cos(np.radians(th)), np.sin(np.radians(th))
            xr = (x - cx) * c + (y - cy) * si
            yr = -(x - cx) * si + (y - cy) * c
            img += a0 * (
                (xr / (ea * shrink)) ** 2 + (yr / (eb * shrink)) ** 2
                <= 1.0
            )
        out[s - start] = np.clip(img, 0, None)
    return out.reshape(stop - start, n * n).T.astype(np.float32).copy()


def simulate_measurements(
    a_csr,
    x: np.ndarray,
    noise: float = 0.0,
    seed: int = 0,
    *,
    chunk: int = 64,
    first_slice: int = 0,
) -> np.ndarray:
    """Sinograms ``y = A x (+ noise)``; x [n_vox, Y] -> y [n_rays, Y].

    The forward projection is chunked over slices (``chunk`` columns per
    ``A @ x`` product) so a large ``Y`` never materializes scipy's
    intermediate on top of the output: peak extra memory is one
    ``[n_rays, chunk]`` block.  The noise stream is *per slice*, seeded
    by ``(seed, global slice index)`` with the noise scale taken per
    slice -- so the result is independent of ``chunk`` and, via
    ``first_slice``, of how the volume is split into slabs
    (slab-by-slab simulation == one-shot simulation, bit for bit).
    """
    n_rays, y_slices = a_csr.shape[0], x.shape[1]
    y = np.empty((n_rays, y_slices), np.float32)
    step = max(1, int(chunk))
    for j0 in range(0, y_slices, step):
        j1 = min(j0 + step, y_slices)
        y[:, j0:j1] = (a_csr @ x[:, j0:j1]).astype(np.float32)
        if noise > 0:
            for j in range(j0, j1):
                rng = np.random.default_rng([seed, first_slice + j])
                scale = np.abs(y[:, j]).max() or 1.0
                y[:, j] += rng.normal(
                    0.0, noise * scale, size=n_rays
                ).astype(np.float32)
    return y
