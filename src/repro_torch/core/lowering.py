"""Abstract lowering: the port's own code run on fake tensors, accounted.

The reference proves a configuration at the paper's scale without a
cluster by lowering its ``shard_map`` program on 256 or 512 placeholder
devices and reading XLA's memory analysis and the collectives in the
compiled HLO (``Reconstructor.lower_cg``).  The port has no compiler to
ask, so it runs the program itself, on fake tensors: tensors in meta
storage, which carry a shape and a dtype and no data, so that every
operation computes its output's shape and allocates nothing, and the
hand-written kernels are custom ops whose registered fakes give their
outputs' shapes (``kernels.xct_spmm``).  A :class:`FakeTrace` watches
that run:

* **placement.**  Every rank of a mesh is a ``placement.FakeDevice``, a
  placeholder ``cuda:i``: ``torch.device`` holds an 8-bit index, so it
  cannot name the 300th card of a 512-device mesh, and
  ``FakeTensorMode``'s tensors answer ``.device`` from a property of
  their own that nothing can redirect.  A ``TorchFunctionMode`` answers
  ``tensor.device`` with the tensor's placeholder and carries out
  ``tensor.to(placeholder)`` as a copy between ranks, so the code under
  trace moves data as it does on the cards.
* **memory per device.**  A ``TorchDispatchMode`` adds each op output's
  storage bytes to its device's live count (each storage once, views
  included), takes them off when ``weakref.finalize`` sees the storage
  die, and keeps each device's peak.  An op that makes a real tensor
  (but an empty one) under the trace is an error: nothing is
  allocated.  A tensor's placeholder is its storage's, so a new tensor
  object on the same storage (an ``nn.Parameter`` of it) stays on its
  device.
* **work per device.**  Each op's FLOPs, by the formulas of
  ``torch.utils.flop_counter`` (matrix products, batched ones,
  convolutions and attention kernels: what ``FlopCounterMode``
  counts), and the bytes it reads and writes, unfused (the bytes of its
  tensor inputs and outputs; views and ``empty`` move none), are added
  to the device it runs on.  The backward and a checkpoint's recompute
  are ops like the others.
* **bytes between devices.**  Every copy between two placeholders is
  recorded with its bytes, its link class (the slowest
  ``dist.LINK_CLASSES`` axis on which the two devices' mesh coordinates
  differ) and its kind, the ``placement.copy_kind`` tag of the code
  that moved it: ``reduce-scatter``, ``all-to-all``, ``pmax`` and
  ``psum`` (the CG's scale and dots), ...

:class:`Lowered` is the record a trace leaves: ``memory_analysis()``
with the reference's field names and ``collectives()`` in the shape of
the reference's ``analyze_collectives``.

>>> import torch
>>> from repro_torch.placement import FakeDevice
>>> devs = [FakeDevice("cuda", i) for i in range(2)]
>>> trace = FakeTrace({devs[0]: {"model": 0}, devs[1]: {"model": 1}})
>>> with trace.running():
...     a = torch.empty((256, 4), device=devs[0])
...     b = a[128:].to(devs[1])
...     print(b.device, b.is_meta)
...     del a
cuda:1 True
>>> trace.peak, trace.live
({cuda:0: 4096, cuda:1: 2048}, {cuda:0: 0, cuda:1: 2048})
>>> [(c.src, c.dst, c.nbytes, c.link) for c in trace.copies]
[(cuda:0, cuda:1, 2048, 'ici')]
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..dist.topology import LINK_CLASSES
from ..placement import FakeDevice, current_copy_kind, placeholder

__all__ = [
    "FakeTrace",
    "Copy",
    "Lowered",
    "LoweredCG",
    "MemoryAnalysis",
    "storage_bytes",
]

_DEVICE = torch._C.TensorBase.__dict__["device"]  # the .device property
_TAG = "_xct_placeholder"  # a traced tensor's placeholder, in its __dict__


def storage_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors`` (each once)."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


@dataclasses.dataclass(frozen=True)
class Copy:
    """One copy between two placeholders, as the trace saw it."""

    src: FakeDevice
    dst: FakeDevice
    nbytes: int
    link: str  # "ici" | "dci"
    kind: str  # the port's function that moved it


_NO_BYTES = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
             torch.ops.aten.empty_like}  # allocate; read or write nothing


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _split_device(args, kwargs):
    """``Tensor.to``'s arguments without a placeholder, and the
    placeholder (or ``None``)."""
    dest = kwargs.get("device")
    if isinstance(dest, FakeDevice):
        kwargs = {k: v for k, v in kwargs.items() if k != "device"}
        return args, kwargs, dest
    rest = []
    for a in args:
        if isinstance(a, FakeDevice) and dest is None:
            dest = a
        else:
            rest.append(a)
    return tuple(rest), kwargs, dest


class _Placement(TorchFunctionMode):
    """Placeholders at the Python level: ``.device`` and ``.to``."""

    def __init__(self, trace):
        super().__init__()
        self.trace = trace

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        trace = self.trace
        if getattr(func, "__self__", None) is _DEVICE:
            return trace.device_of(args[0])
        if func is torch.Tensor.to:
            rest, kw, dest = _split_device(args[1:], kwargs)
            src = args[0]
            if dest is None or dest == trace.device_of(src):
                return func(src, *rest, **kw) if rest or kw else src
            with trace.placed(dest):
                moved = func(src, *rest, **kw) if rest or kw else src
                if moved is src:
                    moved = src.clone()
            trace.record_copy(trace.device_of(src), dest, moved)
            return moved
        dest = kwargs.get("device")
        if isinstance(dest, FakeDevice):
            with trace.placed(dest):
                return func(*args, **kwargs)
        return func(*args, **kwargs)


class _Counter(TorchDispatchMode):
    """Storages at the dispatch level: placement tags and live bytes."""

    def __init__(self, trace):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        trace = self.trace
        ins = list(_tensors((args, kwargs)))
        placed = {d for d in map(trace.where, ins) if d is not None}
        if len(placed) > 1:  # as a card would, refuse to mix devices
            raise RuntimeError(f"{func} mixes devices {sorted(placed)}")
        if placed:
            trace.last = next(iter(placed))
        # an op with no placed input follows the last one that had: a
        # checkpoint's recompute runs without the Python-level mode, so
        # its factories (``arange(device=x.device)``) see "meta"
        dev = trace.forced or next(iter(placed), None) or trace.last \
            or trace.default
        outs = [t for t in _tensors(out) if t.is_meta or t.numel()]
        for t in outs:  # an empty real tensor allocates nothing
            if not t.is_meta:
                raise RuntimeError(
                    f"{func} made a tensor on {t.device} under an abstract "
                    "trace: give it a placeholder device"
                )
            if _TAG not in t.__dict__:
                t.__dict__[_TAG] = trace.where(t) or dev
            trace.allocated(t)
        trace.count(func, dev, args, kwargs, out, ins, outs)
        return out


class FakeTrace:
    """Fake tensors on placeholder devices, with their accounting.

    ``coords`` maps each placeholder to its mesh coordinates (``{axis:
    index}``); ``link_classes`` maps an axis to ``"ici"`` / ``"dci"``
    (default ``dist.LINK_CLASSES``).  :meth:`binding` is the context in
    which a program's arguments are made; :meth:`running` the one in
    which it runs, whose counts start afresh with the arguments it is
    given live from the start.  The run also counts each device's FLOPs
    (``flops``) and bytes read and written (``bytes_accessed``).
    """

    def __init__(self, coords: dict, link_classes: dict | None = None):
        self.coords = dict(coords)
        self.flops: dict = {}
        self.bytes_accessed: dict = {}
        self.links = dict(LINK_CLASSES)
        self.links.update(link_classes or {})
        self.default = next(iter(self.coords))
        self.forced = None
        self.last = None
        self.live: dict = {}
        self.peak: dict = {}
        self.copies: list = []
        self._known: set = set()  # ids of storages counted or bound
        self._run = 0  # a storage of an earlier run frees nothing of this
        self._where: dict = {}  # id(storage) -> (weakref, placeholder)

    @classmethod
    def for_mesh(cls, mesh) -> "FakeTrace":
        """A trace over the placeholders of a ``dist.DeviceMesh``'s
        devices (``placement.placeholder``), each at its first position's
        coordinates."""
        coords: dict = {}
        for idx in np.ndindex(mesh.devices.shape):
            coords.setdefault(placeholder(mesh.devices[idx]),
                              dict(zip(mesh.axis_names, map(int, idx))))
        return cls(coords)

    def where(self, t):
        """The placeholder of ``t`` (its storage's), or ``None``."""
        d = t.__dict__.get(_TAG)
        if d is not None or not t.is_meta:
            return d
        st = t.untyped_storage()
        hit = self._where.get(id(st))
        if hit is None or hit[0]() is not st:
            return None
        t.__dict__[_TAG] = hit[1]
        return hit[1]

    def device_of(self, t):
        """``t.device`` under the trace: its placeholder, if it has one."""
        return self.where(t) or _DEVICE.__get__(t)

    def empty(self, shape, dtype, device) -> torch.Tensor:
        """A fake (meta) tensor on placeholder ``device``, under
        :meth:`binding` or :meth:`running`."""
        with self.placed(device):
            return torch.empty(tuple(shape), dtype=dtype, device="meta")

    # ------------------------------------------------------------------ #
    # contexts
    # ------------------------------------------------------------------ #
    @contextlib.contextmanager
    def binding(self):
        """Make fake tensors on placeholders."""
        with _Placement(self), _Counter(self):
            yield self

    @contextlib.contextmanager
    def running(self, bound=(), grad: bool = False):
        """Run under the trace; the storages of ``bound`` (tensors made
        under :meth:`binding`) are live on their devices from the
        start.  Autograd is off unless ``grad``."""
        self._run += 1
        self.live, self.peak, self.copies = {}, {}, []
        self.flops, self.bytes_accessed = {}, {}
        self.last = None
        self._known = set()
        for t in bound:
            st = t.untyped_storage()
            if id(st) not in self._known:
                self._known.add(id(st))
                self._add(self.device_of(t), st.nbytes())
        with _Placement(self), _Counter(self), \
                torch.set_grad_enabled(grad):
            yield self

    @contextlib.contextmanager
    def placed(self, device):
        """Ops issued inside put their outputs on ``device``."""
        prev, self.forced = self.forced, device
        try:
            yield
        finally:
            self.forced = prev

    # ------------------------------------------------------------------ #
    # accounting
    # ------------------------------------------------------------------ #
    def _add(self, dev, n):
        live = self.live.get(dev, 0) + n
        self.live[dev] = live
        if live > self.peak.get(dev, 0):
            self.peak[dev] = live

    def _free(self, run, key, dev, n):
        hit = self._where.get(key)
        if hit is not None and hit[0]() is None:
            del self._where[key]
        if run == self._run:
            self._known.discard(key)
            self.live[dev] = self.live.get(dev, 0) - n

    def allocated(self, t):
        st = t.untyped_storage()
        key = id(st)
        if key in self._known:
            return
        self._known.add(key)
        n = st.nbytes()
        dev = t.__dict__[_TAG]
        self._add(dev, n)
        self._where[key] = (weakref.ref(st), dev)
        weakref.finalize(st, self._free, self._run, key, dev, n)

    def count(self, func, dev, args, kwargs, out, ins, outs):
        """An op's FLOPs and bytes, on ``dev``."""
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        if formula is not None:
            self.flops[dev] = (self.flops.get(dev, 0)
                               + int(formula(*args, **kwargs, out_val=out)))
        if func.is_view or packet in _NO_BYTES:
            return
        n = sum(t.numel() * t.element_size() for t in ins + outs)
        self.bytes_accessed[dev] = self.bytes_accessed.get(dev, 0) + n

    def link(self, src, dst) -> str:
        a, b = self.coords.get(src, {}), self.coords.get(dst, {})
        differ = [ax for ax in set(a) | set(b) if a.get(ax) != b.get(ax)]
        return ("dci" if any(self.links.get(ax) == "dci" for ax in differ)
                else "ici")

    def record_copy(self, src, dst, t):
        self.copies.append(Copy(src, dst, t.numel() * t.element_size(),
                                self.link(src, dst), current_copy_kind()))


# --------------------------------------------------------------------- #
# the record
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class MemoryAnalysis:
    """Bytes of a lowered program, under the reference's field names.

    The scalar fields are the busiest rank's (``rank``: the one whose
    device's peak is largest).  ``argument``: the tensors bound to the
    rank (operator shards, exchange tables); ``input``: the program's
    inputs on its device; ``temp``: what the run added at its device's
    peak (``peak = argument + input + temp`` for a rank alone on its
    device); ``output``: the program's outputs on its device.  Ranks
    that share a device share its ``input``, ``temp``, ``output`` and
    ``peak``.  ``per_rank`` holds the same five as arrays in rank order
    (batch group major), ``rank0`` rank 0's.
    """

    argument_size_in_bytes: int
    temp_size_in_bytes: int
    output_size_in_bytes: int
    input_size_in_bytes: int
    peak_size_in_bytes: int
    rank: int
    per_rank: dict
    rank0: dict


@dataclasses.dataclass
class Lowered:
    """What a trace leaves: its numbers, per rank and per device.

    ``devices`` lists each rank's placeholder, ``argument`` each rank's
    bound bytes; ``bound`` (the distinct bound storages on a device),
    ``input`` / ``output`` / ``peak`` map a placeholder to its bytes;
    ``copies`` are the trace's copies between placeholders; ``notes``
    say what the numbers stand for where the layout is an estimate;
    ``flops`` / ``bytes_accessed`` map a placeholder to its work, where
    the trace counted it.
    """

    devices: list
    argument: list
    bound: dict
    input: dict
    output: dict
    peak: dict
    copies: list
    notes: list = dataclasses.field(default_factory=list)
    flops: dict = dataclasses.field(default_factory=dict)
    bytes_accessed: dict = dataclasses.field(default_factory=dict)

    def memory_analysis(self) -> MemoryAnalysis:
        arg = np.array(self.argument, dtype=np.int64)
        inp = np.array([self.input.get(d, 0) for d in self.devices],
                       dtype=np.int64)
        out = np.array([self.output.get(d, 0) for d in self.devices],
                       dtype=np.int64)
        peak = np.array([self.peak.get(d, 0) for d in self.devices],
                        dtype=np.int64)
        bound = np.array([self.bound.get(d, 0) for d in self.devices],
                         dtype=np.int64)
        temp = peak - bound - inp
        per_rank = {"argument": arg, "input": inp, "temp": temp,
                    "output": out, "peak": peak}
        busiest = int(np.argmax(peak))
        return MemoryAnalysis(
            argument_size_in_bytes=int(arg[busiest]),
            temp_size_in_bytes=int(temp[busiest]),
            output_size_in_bytes=int(out[busiest]),
            input_size_in_bytes=int(inp[busiest]),
            peak_size_in_bytes=int(peak[busiest]),
            rank=busiest,
            per_rank=per_rank,
            rank0={k: int(v[0]) for k, v in per_rank.items()},
        )

    def collectives(self) -> dict:
        """The bytes of every copy between devices, in the shape of the
        reference's ``analyze_collectives``: ``ops`` (copies),
        ``ici_bytes`` / ``dci_bytes`` and ``by_kind`` (``{kind: {count,
        bytes, ici_bytes, dci_bytes}}``), bytes per rank (the trace's
        total over the ranks);
        ``total_bytes``, and the most bytes one rank sent
        (``max_sent``) and rank 0's ``rank0_sent`` / ``rank0_received``
        beside them."""
        n = max(1, len(dict.fromkeys(self.devices)))
        out = {"ops": 0, "ici_bytes": 0.0, "dci_bytes": 0.0, "by_kind": {}}
        sent: dict = {}
        received: dict = {}
        total = 0
        for c in self.copies:
            out["ops"] += 1
            out[f"{c.link}_bytes"] += c.nbytes / n
            k = out["by_kind"].setdefault(c.kind, {
                "count": 0, "bytes": 0.0, "ici_bytes": 0.0, "dci_bytes": 0.0})
            k["count"] += 1
            k["bytes"] += c.nbytes / n
            k[f"{c.link}_bytes"] += c.nbytes / n
            sent[c.src] = sent.get(c.src, 0) + c.nbytes
            received[c.dst] = received.get(c.dst, 0) + c.nbytes
            total += c.nbytes
        dev0 = self.devices[0]
        out["total_bytes"] = total
        out["max_sent"] = max(sent.values(), default=0)
        out["rank0_sent"] = sent.get(dev0, 0)
        out["rank0_received"] = received.get(dev0, 0)
        return out


@dataclasses.dataclass
class LoweredCG(Lowered):
    """What :meth:`Reconstructor.lower_cg` leaves: a :class:`Lowered`
    of ``iters`` CG iterations on ``y_slices`` slices (``devices``: each
    rank's placeholder, batch group major)."""

    y_slices: int = 0
    iters: int = 0
