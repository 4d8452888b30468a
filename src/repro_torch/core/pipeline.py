"""Batch processing pipeline: minibatch comm/compute order (Sec. III-E).

One (back)projection over an I/O batch of ``Y`` slices is processed as
``Y / F`` minibatches of ``F`` fused slices; minibatch ``i`` holds slices
``i*F .. i*F + F - 1`` (the reference's ``x_all.reshape(c, n_mini, fuse)``
order).  The paper overlaps the global reduction of minibatch ``i`` with
the local work of minibatch ``i+1`` (Fig. 8).  ``overlap=True`` issues
the work in that order -- kernel ``i``, then the reduction of ``i-1`` --
and ``overlap=False`` serializes the two per minibatch.

Over a mesh the kernel phase yields the ranks' bands (a list, one per
rank) and the reduce phase turns them into the owned output.  On CUDA
devices with ``overlap=True`` the reduce phase runs on side streams, one
per distinct device of the ranks (:func:`side_streams`): the reduction of
minibatch ``i-1`` waits for an event recorded after kernel ``i-1`` and
runs beside kernel ``i``, which the caller's stream issues.  The caller's
streams wait for the side streams before the minibatches' outputs are
joined, so whatever reads the result (a span's fence, a copy to the
host) sees every minibatch.  Both orders issue the same operations on
the same data, so they give the same bits.  On the CPU, and with
``overlap=False``, everything is issued on the current stream.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

__all__ = ["pipelined_apply", "side_streams"]


def side_streams(devices) -> dict:
    """``{device: new side stream}`` for ``devices``' distinct cards;
    empty unless every device is a CUDA device.  The side streams have
    the high priority: the block scheduler hands the reduce phase's
    small kernels the SMs that free up before the rest of a running
    SpMM's blocks, so they run beside it instead of after it."""
    devs = list(dict.fromkeys(torch.device(d) for d in devices))
    if not devs or any(d.type != "cuda" for d in devs):
        return {}
    return {d: torch.cuda.Stream(d, priority=-1) for d in devs}


def pipelined_apply(
    kernel_fn: Callable,
    reduce_fn: Callable,
    x_all,
    fuse: int,
    *,
    overlap: bool = True,
    streams=(),
):
    """Apply ``reduce_fn(kernel_fn(chunk))`` over slice-minibatches.

    Args:
      kernel_fn: [C, F] slab -> the ranks' [band_rows, F] partials
        (local SpMM on each rank).
      reduce_fn: the ranks' partials -> [rows_out, F] owned output (the
        communication phase).
      x_all: [C, Y] input slab, ``Y = n_mini * fuse``; or a list of the
        ranks' row chunks of it, each on its rank's device, in which
        case ``kernel_fn`` takes and ``reduce_fn`` returns such lists.
      fuse: minibatch size F (the paper's FFACTOR; 16 in their runs).
      overlap: issue kernel ``i`` before the reduction of ``i-1``
        (Fig. 8) or serialize the two phases.
      streams: with ``overlap``, the side CUDA streams the reduce phase
        runs on, one per distinct device of the ranks (the values of
        :func:`side_streams`).

    Returns:
      [rows_out, Y] reduced output for the whole I/O batch (a list of
      the ranks' row chunks of it for a list ``x_all``).
    """
    many = isinstance(x_all, (list, tuple))
    xs = list(x_all) if many else [x_all]
    y = xs[0].shape[1]
    if y % fuse:
        raise ValueError(f"slice count {y} is not a multiple of fuse={fuse}")
    minis = ([x[:, i * fuse:(i + 1) * fuse].contiguous() for x in xs]
             for i in range(y // fuse))
    if not many:
        minis = (m[0] for m in minis)
    if overlap and streams:
        outs = _overlapped(kernel_fn, reduce_fn, minis, list(streams))
    else:
        outs = _in_order(kernel_fn, reduce_fn, minis, overlap)
    if not many:
        return torch.cat(outs, dim=1)
    return [torch.cat([o[p] for o in outs], dim=1) for p in range(len(xs))]


def _in_order(kernel_fn, reduce_fn, minis, overlap):
    """The minibatches' outputs, every operation on the current stream."""
    outs = []
    pending = None
    for x in minis:
        band = kernel_fn(x)
        if not overlap:
            outs.append(reduce_fn(band))
            continue
        if pending is not None:
            outs.append(reduce_fn(pending))
        pending = band
    if pending is not None:
        outs.append(reduce_fn(pending))
    return outs


def _overlapped(kernel_fn, reduce_fn, minis, streams):
    """The Fig. 8 order with the reduce phase on ``streams``: the
    minibatches' outputs."""
    main = {s.device: torch.cuda.current_stream(s.device) for s in streams}
    side = {s.device: s for s in streams}

    def reduce_on_side(band, done):
        for s in streams:
            s.wait_event(done[s.device])
        for t in band:
            # made on the caller's stream, read on the side stream
            t.record_stream(side[t.device])
        with contextlib.ExitStack() as stack:
            for s in streams:
                stack.enter_context(torch.cuda.stream(s))
            out = reduce_fn(band)
        # made on the side stream, read by the caller's stream's cat
        for t in out if isinstance(out, list) else [out]:
            t.record_stream(main[t.device])
        return out

    outs = []
    pending = None
    for x in minis:
        band = kernel_fn(x)
        done = {d: m.record_event() for d, m in main.items()}
        if pending is not None:
            outs.append(reduce_on_side(*pending))
        pending = (band, done)
    outs.append(reduce_on_side(*pending))
    for s in streams:
        main[s.device].wait_stream(s)
    return outs
