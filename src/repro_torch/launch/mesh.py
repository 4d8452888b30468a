"""Device meshes: named axes over ``torch.device``s, driven by one process.

The reference is single-controller: one process drives every device of a
``jax.make_mesh`` through ``shard_map``.  The port's counterpart is a
:class:`DeviceMesh`, an ndarray of ``torch.device`` with axis names, that
``dist.Topology.from_mesh`` binds; every rank of the partial-data
exchange lives on its mesh device and the collectives of
``dist.collectives`` are tensor operations across the ranks.

Devices may repeat.  A mesh of ``cuda:0`` four times is the one-card
stand-in for four GPUs, as the reference's tests force four host devices
onto one CPU (``--xla_force_host_platform_device_count``); every rank
then runs on the same card and the "wire" is device memory.

Mesh axes (fast -> slow physical links), as in the reference:

  "model" -- the fastest axis (XCT: in-slice data parallelism's first
             reduction level, the paper's "socket")
  "data"  -- the next axis (XCT: "node" level)
  "pod"   -- the outermost axis (XCT: "global")
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..dist.topology import LINK_CLASSES, DeviceMesh

__all__ = ["DeviceMesh", "make_mesh", "mesh_axis_classes"]


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              devices=None) -> DeviceMesh:
    """The counterpart of ``jax.make_mesh``.

    ``devices`` (any iterable of ``torch.device`` or strings, repeats
    allowed) fills the mesh in row-major order; its first
    ``prod(axis_shapes)`` entries are used.  ``None`` takes the first
    CUDA devices, one per position.  A CUDA device without a card, or
    fewer cards than positions, raises: a mesh never moves to the CPU.
    """
    shape = tuple(int(n) for n in axis_shapes)
    size = math.prod(shape)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh takes CUDA devices by default and none is "
                "available; pass devices=['cpu'] * n to run on the CPU"
            )
        found = torch.cuda.device_count()
        if found < size:
            raise RuntimeError(
                f"a mesh of shape {shape} needs {size} CUDA devices and "
                f"{found} {'is' if found == 1 else 'are'} available; pass "
                "devices= to repeat one"
            )
        devices = [torch.device("cuda", i) for i in range(size)]
    devs = [torch.device(d) for d in devices]
    if len(devs) < size:
        raise ValueError(
            f"a mesh of shape {shape} needs {size} devices, got {len(devs)}"
        )
    devs = devs[:size]
    for d in devs:
        if d.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {d}; use cuda or cpu")
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"mesh device {d} asked for and no CUDA device is "
                "available; pass devices=['cpu'] * n to run on the CPU"
            )
    arr = np.empty(size, dtype=object)
    arr[:] = devs
    return DeviceMesh(arr.reshape(shape), axis_names)


def mesh_axis_classes(multi_pod: bool = False) -> dict:
    """Link-speed class per axis of the production mesh, derived from
    the canonical ``dist.topology.LINK_CLASSES`` table."""
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return {a: LINK_CLASSES[a] for a in axes}
