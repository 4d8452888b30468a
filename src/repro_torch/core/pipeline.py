"""Batch processing pipeline: minibatch comm/compute order (Sec. III-E).

One (back)projection over an I/O batch of ``Y`` slices is processed as
``Y / F`` minibatches of ``F`` fused slices; minibatch ``i`` holds slices
``i*F .. i*F + F - 1`` (the reference's ``x_all.reshape(c, n_mini, fuse)``
order).  The paper overlaps the global reduction of minibatch ``i`` with
the local work of minibatch ``i+1`` (Fig. 8).  ``overlap=True`` issues
the work in that order -- kernel ``i``, then the reduction of ``i-1`` --
and ``overlap=False`` serializes the two per minibatch.

Over a mesh the kernel phase yields the ranks' bands (a list, one per
rank) and the reduce phase turns them into the owned output; this module
only orders the two.  Both run on the current stream of each rank's
device, so both orders give the same result; side CUDA streams, which
would let the reduction of ``i-1`` run beside kernel ``i``, are not
ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["pipelined_apply"]


def pipelined_apply(
    kernel_fn: Callable,
    reduce_fn: Callable,
    x_all,
    fuse: int,
    *,
    overlap: bool = True,
):
    """Apply ``reduce_fn(kernel_fn(chunk))`` over slice-minibatches.

    Args:
      kernel_fn: [C, F] slab -> the ranks' [band_rows, F] partials
        (local SpMM on each rank).
      reduce_fn: the ranks' partials -> [rows_out, F] owned output (the
        communication phase).
      x_all: [C, Y] input slab, ``Y = n_mini * fuse``.
      fuse: minibatch size F (the paper's FFACTOR; 16 in their runs).
      overlap: issue kernel ``i`` before the reduction of ``i-1``
        (Fig. 8) or serialize the two phases.

    Returns:
      [rows_out, Y] reduced output for the whole I/O batch.
    """
    y = x_all.shape[1]
    if y % fuse:
        raise ValueError(f"slice count {y} is not a multiple of fuse={fuse}")
    outs = []
    pending = None
    for i in range(y // fuse):
        band = kernel_fn(x_all[:, i * fuse:(i + 1) * fuse].contiguous())
        if not overlap:
            outs.append(reduce_fn(band))
            continue
        if pending is not None:
            outs.append(reduce_fn(pending))
        pending = band
    if pending is not None:
        outs.append(reduce_fn(pending))
    return torch.cat(outs, dim=1)
