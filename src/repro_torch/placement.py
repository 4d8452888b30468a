"""Placeholder devices, and the kind of each copy between them.

A leaf module (it imports nothing of the package), so that the mesh
(``dist.topology``, ``launch.mesh``), the exchange functions and the
abstract trace (``core.lowering``) can all use it.

:class:`FakeDevice` names a device that need not exist: a mesh of them
(``launch.mesh.make_production_mesh``) is what an abstract
``Reconstructor`` binds at the paper's scale.  :class:`copy_kind` tags
the copies between devices made inside a function or a block with the
exchange that made them; a trace reads the tag with
:func:`current_copy_kind`, and outside a trace the tag costs one
context-variable set and reset.

>>> @copy_kind("all-gather")
... def gather():
...     return current_copy_kind()
>>> gather(), current_copy_kind()
('all-gather', 'other')
>>> with copy_kind("split"):
...     print(current_copy_kind(), gather())
split all-gather
"""
from __future__ import annotations

import contextvars
import functools

import torch

__all__ = ["FakeDevice", "copy_kind", "current_copy_kind", "empty_on",
           "move", "placeholder"]

_KIND = contextvars.ContextVar("repro_torch_copy_kind", default="other")
_TRACES: list = []  # the abstract traces running, innermost last


class FakeDevice(str):
    """A placeholder device ``type:index`` for fake tensors.

    Where torch reads a device it reads ``"meta"``, so a tensor made on
    a placeholder has meta storage; under a ``core.lowering.FakeTrace``
    the tensor reports the placeholder as its ``device`` and
    ``.to(placeholder)`` moves it.  ``type`` and ``index`` are those of
    the device it stands for (``index`` may exceed ``torch.device``'s
    127); two placeholders are equal when both are.
    """

    def __new__(cls, type: str, index: int):
        self = super().__new__(cls, "meta")
        self.type = str(type)
        self.index = int(index)
        return self

    def __reduce__(self):
        return FakeDevice, (self.type, self.index)

    def __repr__(self):
        return f"{self.type}:{self.index}"

    __str__ = __repr__

    def __eq__(self, other):
        return (isinstance(other, FakeDevice)
                and (self.type, self.index) == (other.type, other.index))

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash((FakeDevice, self.type, self.index))


def placeholder(device) -> FakeDevice:
    """The placeholder that stands for ``device``: itself if it is one,
    else ``FakeDevice(type, index)``.  Only CUDA devices: the trace
    follows the card's path, where every kernel is a custom op with a
    fake; the plain versions of the CPU path read values."""
    if isinstance(device, FakeDevice):
        d = device
    else:
        dev = torch.device(device)
        d = FakeDevice(dev.type, dev.index or 0)
    if d.type != "cuda":
        raise ValueError(
            f"an abstract trace places ranks on CUDA devices, got {d}"
        )
    return d


class copy_kind:
    """Copies between devices made inside are of ``kind``
    (``"all-reduce"``, ``"split"``, ...): a context manager, or a
    decorator of a function.  The innermost tag holds."""

    __slots__ = ("kind", "_token")

    def __init__(self, kind: str):
        self.kind = kind

    def __enter__(self):
        self._token = _KIND.set(self.kind)

    def __exit__(self, *exc):
        _KIND.reset(self._token)

    def __call__(self, fn):
        kind = self.kind

        @functools.wraps(fn)
        def tagged(*args, **kwargs):
            token = _KIND.set(kind)
            try:
                return fn(*args, **kwargs)
            finally:
                _KIND.reset(token)

        return tagged


def current_copy_kind() -> str:
    """The innermost :class:`copy_kind` in force (``"other"``: none)."""
    return _KIND.get()


def move(t, device):
    """``t.to(device)``, differentiable.  Under an abstract trace
    (``core.lowering.FakeTrace``) a copy to a placeholder is the trace's
    own: recorded under the :class:`copy_kind` in force, its backward
    moving the gradient back, also where torch's Python-level modes are
    off (a checkpoint's recompute)."""
    if _TRACES and isinstance(device, FakeDevice):
        return _TRACES[-1].move(t, device)
    return t.to(device)


def empty_on(shape, dtype, device):
    """An uninitialized tensor on ``device`` (on a placeholder under an
    abstract trace: a fake of that shape there)."""
    if _TRACES and isinstance(device, FakeDevice):
        return _TRACES[-1].empty(shape, dtype, device)
    return torch.empty(tuple(shape), dtype=dtype, device=device)
