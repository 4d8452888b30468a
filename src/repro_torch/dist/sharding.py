"""Parameter / batch / cache specs for the LM substrate: the reference's
``dist/sharding.py`` in PyTorch.

One rule, applied uniformly (megatron-style tensor parallelism): every
matrix-like parameter shards its largest eligible dimension over the
``model`` mesh axis; vectors, scalars and indivisible shapes replicate.
The reference's scan-stacked parameter leaves (leading ``n_per`` period
dimension) never shard the stacking dimension.  Batch-like trees shard
their leading (batch) dimension over the data-parallel axes.

A spec is a tuple per leaf, the port's stand-in for ``PartitionSpec``:
``()`` replicates, else one entry per dimension, an axis name, a tuple
of axis names (split over their product, the first major) or ``None``;
``tuple(P(...))`` of the reference's spec is the port's.  The spec trees
mirror the input trees; an ``LMParams`` becomes ``{"embed", "unembed",
"final_norm", "layers": [one dict per layer]}`` (``unembed`` only when
present), every block a dict of its parameters.

The port keeps one module per layer (``models/transformer.py``) where
the reference stacks the layers of its scan into ``[n_per, ...]``
leaves.  ``param_specs`` gives each of those layers the spec the
reference gives its slice: the rule runs on the stacked shape
(``LMParams.stack``) and drops the stacking dimension's entry; the
trailing partial period's layers are unstacked in both.

:func:`shardings` binds a spec tree to a ``DeviceMesh`` as
:class:`Placement` objects; ``Placement.place`` splits a tensor into the
piece each mesh position holds (:class:`Placed`), and ``Placed.full``
(or ``numpy.asarray``) joins them again, bit for bit.

This is the layout the training and serving state lives in:
:func:`place_state` lays parameters and optimizer moments out as
:class:`PlacedTree`s, which the train steps, ``prefill`` and
``decode_step`` take and give back (``models.lm``); a checkpoint holds
``full()`` and is laid out again on restore.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch
from torch import nn

from ..opt.tree import leaves, module_dict, tree_map, unflatten
from .collectives import Pieces

__all__ = ["Placed", "PlacedTree", "Placement", "batch_specs",
           "cache_specs", "group_pieces", "param_specs", "place_state",
           "place_tree", "shardings", "spec_leaves"]


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def _model_spec(shape, model_axis: str, size: int) -> tuple:
    ndim = len(shape)
    if ndim < 2 or size <= 1:
        return ()
    # candidate dims: all but a leading stack dim when ndim >= 3
    # (scan-stacked layers / MoE expert stacks keep dim 0 whole)
    start = 1 if ndim >= 3 else 0
    best, best_size = None, 0
    for i in range(start, ndim):
        if shape[i] % size == 0 and shape[i] >= best_size:
            best, best_size = i, shape[i]  # ties -> later dim wins
    if best is None:
        return ()
    return tuple(model_axis if i == best else None for i in range(ndim))


def _stacked_spec(shape, n_per: int, model_axis: str, size: int) -> tuple:
    """The reference's spec of one layer's slice of an ``[n_per, ...]``
    stacked leaf."""
    spec = _model_spec((n_per,) + tuple(shape), model_axis, size)
    return spec[1:] if spec else ()


def _is_spec(x) -> bool:
    return isinstance(x, tuple)


def _as_tree(tree):
    """A module as its parameters by name (``opt.tree.module_dict``)."""
    return module_dict(tree) if isinstance(tree, nn.Module) else tree


def param_specs(params, mesh, model_axis: str = "model"):
    """Spec tree for a parameter tree (tensor parallelism): an
    ``LMParams`` (each scanned layer its slice's spec), or any tree of
    dicts, lists and tensors (the rule on each leaf's shape)."""
    size = dict(mesh.shape).get(model_axis, 1)

    def rule(x):
        return _model_spec(_shape(x), model_axis, size)

    if not hasattr(params, "stack"):
        return tree_map(rule, _as_tree(params))
    n_per, period = params.stack

    def stacked(x):
        return _stacked_spec(_shape(x), n_per, model_axis, size)

    tree = module_dict(params)
    out = {k: tree_map(rule, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [tree_map(stacked if i < n_per * period else rule, layer)
                     for i, layer in enumerate(tree["layers"])]
    return out


def _dp(mesh, dp_axes) -> tuple:
    dp = tuple(a for a in dp_axes if a in mesh.shape)
    return dp, int(np.prod([mesh.shape[a] for a in dp], dtype=np.int64))


def batch_specs(batch, mesh, dp_axes=("pod", "data")):
    """Shard each leaf's leading dimension over the data-parallel axes
    (when divisible); everything else replicates."""
    dp, ndp = _dp(mesh, dp_axes)

    def spec(leaf):
        shape = _shape(leaf)
        if not dp or not shape or shape[0] % ndp:
            return ()
        return (dp,) + (None,) * (len(shape) - 1)

    return tree_map(spec, _as_tree(batch))


def cache_specs(cache, cfg, mesh, dp_axes=("pod", "data")):
    """Spec tree for a decode cache (``transformer.init_cache``: a list
    of per-layer dicts): :func:`batch_specs`'s rule.  Each leaf is
    batch-major ``[B, ...]`` in the port, as one layer's slice of the
    reference's stacked leaves is; leaves too small to split (and the
    host-int ``pos``) replicate."""
    del cfg  # the reference's signature; the layout is per layer here
    return batch_specs(cache, mesh, dp_axes)


@dataclasses.dataclass(frozen=True)
class Placed:
    """A tensor laid out over a mesh: ``pieces`` is an object ndarray of
    the mesh's shape, each entry the piece that position holds, on its
    device (positions that hold the same piece on the same device share
    one tensor)."""

    spec: tuple
    mesh: object
    pieces: np.ndarray
    shape: tuple
    dtype: torch.dtype

    def full(self) -> torch.Tensor:
        """The whole tensor, on the first position's device."""
        return _join(self)

    @property
    def dims(self) -> tuple:
        """Each dimension's axes (``()``: whole)."""
        spec = tuple(self.spec) + (None,) * (len(self.shape)
                                             - len(self.spec))
        return tuple(_axes(e) for e in spec)

    def model_dim(self, axis: str = "model"):
        """The dimension split over ``axis`` (``None``: none is)."""
        return next((d for d, a in enumerate(self.dims) if axis in a), None)

    def owners(self) -> list:
        """Positions whose pieces hold every element once: coordinate 0
        on each axis that splits no dimension, in row-major order."""
        split = {a for axes in self.dims for a in axes}
        names = self.mesh.axis_names
        return [idx for idx in np.ndindex(self.pieces.shape)
                if all(i == 0 for a, i in zip(names, idx) if a not in split)]

    def map(self, fn, *others) -> "Placed":
        """``fn(piece, *others' pieces)`` at every position, once per
        distinct piece of ``self`` (positions that share a piece share
        the result); ``None`` stays ``None``."""
        out = np.empty(self.pieces.shape, dtype=object)
        done = {}
        for idx in np.ndindex(out.shape):
            p = self.pieces[idx]
            if p is None:
                continue
            if id(p) not in done:
                done[id(p)] = fn(p, *[o.pieces[idx] for o in others])
            out[idx] = done[id(p)]
        some = done[next(iter(done))] if done else None
        dtype = self.dtype if some is None else some.dtype
        return Placed(self.spec, self.mesh, out, self.shape, dtype)

    def __array__(self, dtype=None, copy=None):
        arr = self.full().detach().cpu().numpy()
        return arr if dtype is None else arr.astype(dtype)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A spec bound to a mesh (the reference's ``NamedSharding``)."""

    mesh: object
    spec: tuple

    def place(self, x, positions=None) -> Placed:
        """``x`` (a tensor or array) split by the spec: the position at
        coordinate ``c`` on the axes of a dimension's entry holds chunk
        ``c`` of that dimension (the entry's axes linearized first-major),
        moved to its device; replicated dimensions stay whole.  With
        ``positions`` (a set of mesh indices) only those positions get a
        piece, the others ``None`` (the dry run's phantoms)."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(np.asarray(x)))
        t = t.detach()
        names = self.mesh.axis_names
        spec = tuple(self.spec) + (None,) * (t.dim() - len(self.spec))
        pieces = np.empty(self.mesh.devices.shape, dtype=object)
        cache = {}
        for idx in np.ndindex(pieces.shape):
            if positions is not None and idx not in positions:
                continue
            coords = dict(zip(names, idx))
            sl = []
            for dim, entry in enumerate(spec):
                axes = _axes(entry)
                n = int(np.prod([self.mesh.shape[a] for a in axes],
                                dtype=np.int64))
                c = 0
                for a in axes:
                    c = c * self.mesh.shape[a] + coords[a]
                if t.shape[dim] % n:
                    raise ValueError(
                        f"dimension {dim} of {tuple(t.shape)} does not "
                        f"split over {axes} ({n})")
                w = t.shape[dim] // n
                sl.append((c * w, (c + 1) * w))
            dev = self.mesh.devices[idx]
            key = (tuple(sl), str(dev))
            if key not in cache:
                piece = t[tuple(slice(a, b) for a, b in sl)]
                moved = piece.to(dev)
                if moved is piece and piece.numel() != t.numel():
                    moved = piece.clone()  # a piece of its own, not a view
                cache[key] = moved
            pieces[idx] = cache[key]
        return Placed(tuple(self.spec), self.mesh, pieces,
                      tuple(t.shape), t.dtype)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _join(placed: Placed) -> torch.Tensor:
    """Reassemble a :class:`Placed` from its pieces along its split
    dimensions (the first position along every other axis)."""
    mesh = placed.mesh
    names = mesh.axis_names
    spec = tuple(placed.spec) + (None,) * (len(placed.shape)
                                           - len(placed.spec))
    split = [(d, _axes(e)) for d, e in enumerate(spec) if _axes(e)]
    home = mesh.devices.flat[0]
    if not split:
        return placed.pieces.flat[0].to(home)
    counts = [int(np.prod([mesh.shape[a] for a in axes], dtype=np.int64))
              for _, axes in split]
    out = torch.empty(placed.shape, dtype=placed.dtype, device=home)
    for chunk in itertools.product(*[range(n) for n in counts]):
        coords = {a: 0 for a in names}
        sl = [slice(None)] * len(placed.shape)
        for (dim, axes), c in zip(split, chunk):
            sizes = [mesh.shape[a] for a in axes]
            for a, v in zip(axes, np.unravel_index(c, sizes)):
                coords[a] = int(v)
            w = placed.shape[dim] // int(np.prod(sizes, dtype=np.int64))
            sl[dim] = slice(c * w, (c + 1) * w)
        piece = placed.pieces[tuple(coords[a] for a in names)]
        out[tuple(sl)] = piece.to(home)
    return out


def shardings(specs, mesh):
    """Bind a spec tree to a mesh: a tree of :class:`Placement`."""
    return tree_map(lambda s: Placement(mesh, s), specs, is_leaf=_is_spec)


def spec_leaves(specs) -> list:
    """The specs of a spec tree, in ``opt.tree.leaves`` order."""
    return leaves(specs, is_leaf=_is_spec)


# --------------------------------------------------------------------- #
# the state's layout
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class PlacedTree:
    """A tree laid out over a mesh, the layout the training and serving
    state lives in: ``leaves`` are :class:`Placed`, in ``opt.tree.leaves``
    order of ``template``, whose structure they fill (an ``LMParams`` or
    a dict; its own leaves are empty tensors and hold nothing)."""

    template: object
    leaves: tuple

    @property
    def mesh(self):
        return self.leaves[0].mesh

    def full(self):
        """The whole tensors, in the template's structure, on the first
        position's device (a checkpoint saves this)."""
        return unflatten(self.template, [pl.full() for pl in self.leaves])

    def map(self, fn, *others) -> "PlacedTree":
        """:meth:`Placed.map` leaf by leaf, with the leaves of ``others``
        (trees of the same layout)."""
        return PlacedTree(self.template, tuple(
            pl.map(fn, *[o.leaves[j] for o in others])
            for j, pl in enumerate(self.leaves)))

    def bytes_at(self, idx) -> int:
        """Bytes of position ``idx``'s pieces."""
        return sum(pl.pieces[idx].numel() * pl.pieces[idx].element_size()
                   for pl in self.leaves if pl.pieces[idx] is not None)


def _path_spec(specs, name: str):
    node = specs
    for part in name.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


def _skeleton(tree):
    """``tree``'s structure with empty leaves."""
    return tree_map(lambda t: torch.empty(0), tree)


def place_tree(tree, specs, mesh, positions=None) -> PlacedTree:
    """``tree`` (an ``nn.Module`` or a tree of dicts and lists) laid out
    by ``specs`` (its :func:`param_specs`, or any spec tree of the same
    shape): each leaf :meth:`Placement.place`-d on ``mesh``."""
    if isinstance(tree, nn.Module):
        sl = [_path_spec(specs, n) for n, _ in tree.named_parameters()]
    else:
        sl = spec_leaves(specs)
    xs = leaves(tree)
    if len(sl) != len(xs):
        raise ValueError(f"{len(sl)} specs for {len(xs)} leaves")
    return PlacedTree(_skeleton(tree), tuple(
        Placement(mesh, s).place(x, positions) for x, s in zip(xs, sl)))


def place_state(params, opt_state, mesh, *, model_axis: str = "model",
                positions=None):
    """Lay the training state out on ``mesh`` as the reference's
    ``shardings(param_specs)`` does: every parameter by
    :func:`param_specs`, the optimizer's moments (``m`` and ``v`` of
    ``AdamW``, ``mom`` of ``sgd_momentum``) on the same specs, and
    ``count`` replicated.  Returns ``(params, opt_state)``: a
    :class:`PlacedTree` and a dict of them (``count`` a :class:`Placed`),
    each position holding the piece ``NamedSharding(mesh, spec)`` gives
    a reference device.  ``opt_state`` may be ``None``."""
    specs = param_specs(params, mesh, model_axis)
    placed = place_tree(params, specs, mesh, positions)
    if opt_state is None:
        return placed, None
    out = {}
    for k, v in opt_state.items():
        if isinstance(v, torch.Tensor):
            out[k] = Placement(mesh, ()).place(v, positions)
        else:
            out[k] = place_tree(v, specs, mesh, positions)
    return placed, out


def group_pieces(placed: PlacedTree, idx, axis: str = "model") -> list:
    """The model group through position ``idx`` (its other
    coordinates): one ``collectives.Pieces`` per leaf, the pieces in
    model rank order."""
    mesh = placed.mesh
    names = mesh.axis_names
    k = names.index(axis)
    n = mesh.shape[axis]
    out = []
    for pl in placed.leaves:
        parts = []
        for r in range(n):
            at = list(idx)
            at[k] = r
            parts.append(pl.pieces[tuple(at)])
        out.append(Pieces(parts, tuple(pl.shape), pl.model_dim(axis)))
    return out
