"""Sinogram slabs from the seed, and the closed loop's order over them.

A mix's parameters (``traffic/<name>.json``):

* ``slab_slices``: slices per ``reconstruct`` call;
* ``pool``: distinct slabs; call ``i`` sends slab ``i % pool``, so every
  seed sends the same sizes in the same order and only the content moves;
* ``noise``: relative Gaussian noise, per slice ``noise * max|y_j|``;
* ``loop`` / ``callers``: ``"closed"`` with one caller (the next call
  is sent when the last returns);
* ``warmup_solves`` / ``trace_solves``: calls before the window, and
  calls profiled after it in a traced run.

Slab ``k`` is the slices centred on ``(k + 1/2) / pool`` of the
configuration's volume depth, so the pool spreads over the volume.  The
phantom and its sinogram are made on ``device``: the ellipses' drift
and the noise come from one ``torch.Generator`` seeded with the seed.
"""
from __future__ import annotations

import numpy as np
import torch

from ..reference.cgnr import operator
from ..reference.phantom import phantom_slices

__all__ = ["slab_starts", "make_pool"]


def slab_starts(volume_slices: int, slab: int, pool: int) -> list:
    """First global slice of each pool slab."""
    return [min(max(0, round((k + 0.5) * volume_slices / pool - slab / 2)),
                volume_slices - slab) for k in range(pool)]


def make_pool(a, config: dict, traffic: dict, seed: int, device) -> list:
    """The pool's sinograms, host float32 ``[n_rays, slab_slices]`` each,
    from the benchmark's matrix ``a`` (SciPy CSR)."""
    if traffic["loop"] != "closed" or traffic["callers"] != 1:
        raise ValueError("the generator drives one caller in a closed loop")
    device = torch.device(device)
    slab, pool = traffic["slab_slices"], traffic["pool"]
    if slab % config["fuse"]:
        raise ValueError(f"slab_slices {slab} is not a multiple of fuse "
                         f"{config['fuse']}")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    idx = torch.tensor([s + j for s in slab_starts(config["slices"], slab,
                                                   pool)
                        for j in range(slab)])
    x = phantom_slices(config["n"], config["slices"], idx, gen)
    fwd, _ = operator(a, device, torch.float64, transpose=False)
    y = fwd @ x.to(torch.float64)
    del fwd, x
    scale = traffic["noise"] * y.abs().amax(dim=0)
    y += torch.randn(y.shape, generator=gen, device=device,
                     dtype=torch.float64) * scale
    host = y.to(torch.float32).cpu().numpy()
    return [np.ascontiguousarray(host[:, k * slab:(k + 1) * slab])
            for k in range(pool)]
