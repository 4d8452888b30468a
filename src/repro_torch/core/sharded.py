"""Vectors sharded by rows over the ranks, as the reference lays them out.

The reference shards ``y``, ``x0`` and every CG vector as ``P(data_axes,
batch_axes)``: rank ``p`` of batch group ``g`` holds row chunk ``p`` of
group ``g``'s columns (slices).  :class:`Sharded` is that layout in one
process.  Its blocks are group major; a block holds the row chunks of a
run of consecutive ranks on one device (``ranks[i]`` of them, in rank
order), so ranks that share a card share one buffer and its arithmetic
runs once, while ranks on cards of their own have a block each.
Arithmetic, indexing, ``.to`` and torch functions apply block by block
(a plain tensor or number operand goes to every block), so
``core.solver.cgnr`` runs on it as written.  A per-slice scalar, such as
a CG dot product, is a :class:`Sharded` with one ``[F]`` per block, the
same on every block of a group, as the reference's ``psum`` leaves it.

>>> import torch
>>> v = Sharded([torch.ones(2, 1), 2 * torch.ones(3, 1)])
>>> w = (v * 3 - 1).to(torch.float64)
>>> [tuple(b.shape) for b in w.parts], w.cpu()[:, 0].tolist()
([(2, 1), (3, 1)], [2.0, 2.0, 5.0, 5.0, 5.0])
>>> torch.sqrt(v * v).cpu()[:, 0].tolist()
[1.0, 1.0, 2.0, 2.0, 2.0]
>>> u = Sharded([torch.arange(4.0)[:, None]], ranks=[2])
>>> [t[:, 0].tolist() for t in u.rank_views()]
[[0.0, 1.0], [2.0, 3.0]]
"""
from __future__ import annotations

import operator

import torch

__all__ = ["Sharded"]


def _pick(a, i: int):
    """Block ``i`` of ``a``, inside lists and tuples too; anything else
    as it is."""
    if isinstance(a, Sharded):
        return a.parts[i]
    if isinstance(a, (list, tuple)):
        return type(a)(_pick(x, i) for x in a)
    return a


def _first(args):
    for a in args:
        if isinstance(a, Sharded):
            return a
        if isinstance(a, (list, tuple)):
            found = _first(a)
            if found is not None:
                return found
    return None


class Sharded:
    """Row blocks of a vector, group major.

    ``parts``: the blocks, each on its ranks' device; ``ranks``: how many
    consecutive ranks' row chunks each block holds (default one each);
    ``n_groups``: the batch groups (a group's blocks are consecutive and
    share its columns; every group has the same number of ranks).
    """

    __slots__ = ("parts", "ranks", "n_groups")

    def __init__(self, parts, ranks=None, n_groups: int = 1):
        self.parts = tuple(parts)
        self.ranks = (1,) * len(self.parts) if ranks is None else tuple(ranks)
        self.n_groups = n_groups
        if (not self.parts or len(self.ranks) != len(self.parts)
                or sum(self.ranks) % n_groups):
            raise ValueError(f"{len(self.parts)} blocks of {self.ranks} "
                             f"ranks do not split into {n_groups} group(s)")

    @classmethod
    def map(cls, fn, *args, **kwargs):
        """``fn`` on each block of the :class:`Sharded` arguments, with
        every other argument passed to each call as it is."""
        like = _first((*args, *kwargs.values()))
        return cls([fn(*_pick(args, i), **_pick(kwargs, i))
                    for i in range(len(like.parts))], like.ranks,
                   like.n_groups)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return cls.map(func, *args, **(kwargs or {}))

    @classmethod
    def join(cls, groups) -> "Sharded":
        """One vector from the vectors of consecutive batch groups."""
        return cls([b for g in groups for b in g.parts],
                   [r for g in groups for r in g.ranks],
                   sum(g.n_groups for g in groups))

    def group(self, g: int) -> "Sharded":
        """Batch group ``g``'s blocks."""
        per = sum(self.ranks) // self.n_groups
        start, picked = 0, []
        for i, r in enumerate(self.ranks):
            if g * per <= start < (g + 1) * per:
                picked.append(i)
            start += r
        return Sharded([self.parts[i] for i in picked],
                       [self.ranks[i] for i in picked])

    def first_ranks(self) -> "Sharded":
        """Each group's first block: of a vector whose blocks are the same
        on every block of a group (CG scalars), one copy per group."""
        firsts = [self.group(g).parts[0] for g in range(self.n_groups)]
        return Sharded(firsts, n_groups=self.n_groups)

    def rank_views(self) -> list:
        """Every rank's row chunk, in rank order (group major): views of
        the blocks."""
        return [t for b, r in zip(self.parts, self.ranks)
                for t in b.tensor_split(r)]

    @classmethod
    def pack(cls, chunks, ranks) -> "Sharded":
        """Per-rank row chunks, rank order, into blocks of ``ranks``
        consecutive chunks each (one ``torch.cat`` per block of several)."""
        parts, i = [], 0
        for r in ranks:
            parts.append(chunks[i] if r == 1 else torch.cat(chunks[i:i + r]))
            i += r
        return cls(parts, ranks)

    def to(self, *args, **kwargs) -> "Sharded":
        return Sharded.map(lambda t: t.to(*args, **kwargs), self)

    def __getitem__(self, index) -> "Sharded":
        return Sharded.map(operator.getitem, self, index)

    @property
    def device(self):
        """Rank 0's device of batch group 0."""
        return self.parts[0].device

    def cpu(self) -> torch.Tensor:
        """The whole vector on the host: each group's blocks joined along
        the rows, the groups along the columns (dimension 1)."""
        groups = [torch.cat([t.to("cpu") for t in self.group(g).parts])
                  for g in range(self.n_groups)]
        return groups[0] if self.n_groups == 1 else torch.cat(groups, 1)


def _binary(op):
    def forward(a, b):
        return Sharded.map(op, a, b)

    def reverse(a, b):
        return Sharded.map(op, b, a)

    return forward, reverse


for _name in ("add", "sub", "mul", "truediv"):
    _fwd, _rev = _binary(getattr(operator, _name))
    setattr(Sharded, f"__{_name}__", _fwd)
    setattr(Sharded, f"__r{_name}__", _rev)
del _name, _fwd, _rev
