"""Shepp-Logan-style phantom slices in plain torch (frozen copy).

The ellipse table and the slice-axis morph follow the generator the
program ships, written in torch so that a slab is made on the card from
a ``torch.Generator``: the ellipses drift along the slice axis by an
amount drawn from the generator, and shrink away from the equatorial
plane.  Slice ``s`` of a ``volume_slices``-slice volume depends only on
the drift and on ``s``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["ELLIPSES", "phantom_slices"]

# (intensity, x0, y0, a, b, theta in degrees) -- loosely Shepp-Logan
ELLIPSES = (
    (1.0, 0.0, 0.0, 0.69, 0.92, 0.0),
    (-0.8, 0.0, -0.0184, 0.6624, 0.874, 0.0),
    (-0.2, 0.22, 0.0, 0.11, 0.31, -18.0),
    (-0.2, -0.22, 0.0, 0.16, 0.41, 18.0),
    (0.1, 0.0, 0.35, 0.21, 0.25, 0.0),
    (0.1, 0.0, 0.1, 0.046, 0.046, 0.0),
    (0.1, -0.08, -0.605, 0.046, 0.023, 0.0),
    (0.1, 0.06, -0.605, 0.023, 0.046, 0.0),
)


def phantom_slices(n: int, volume_slices: int, slices: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """Slices ``slices`` (int tensor of global indices) of the volume, as
    ``[n * n, len(slices)]`` float32 on the generator's device; voxel
    ``iy * n + ix``.  Draws the drift (8 x 2 normals) from ``generator``."""
    dev = generator.device
    drift = 0.02 * torch.randn((len(ELLIPSES), 2), generator=generator,
                               device=dev, dtype=torch.float64)
    grid = (torch.arange(n, device=dev, dtype=torch.float64) - (n - 1) / 2) \
        / (n / 2)
    y, x = grid[:, None], grid[None, :]
    z = (slices.to(dev, torch.float64) + 0.5) / volume_slices - 0.5
    shrink = torch.sqrt(torch.clamp(1.0 - (2 * z) ** 2, min=1e-3))
    img = torch.zeros((len(slices), n, n), device=dev, dtype=torch.float32)
    for i, (a0, x0, y0, ea, eb, th) in enumerate(ELLIPSES):
        cx = (x0 + drift[i, 0] * z * 4)[:, None, None]
        cy = (y0 + drift[i, 1] * z * 4)[:, None, None]
        c, s = math.cos(math.radians(th)), math.sin(math.radians(th))
        dx, dy = x[None] - cx, y[None] - cy
        xr, yr = dx * c + dy * s, -dx * s + dy * c
        sh = shrink[:, None, None]
        inside = (xr / (ea * sh)) ** 2 + (yr / (eb * sh)) ** 2 <= 1.0
        img += a0 * inside.to(torch.float32)
    return img.clamp_(min=0).reshape(len(slices), n * n).T.contiguous()
