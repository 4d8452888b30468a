"""Fault tolerance & elasticity: stragglers, rebalancing, remeshing.

At the paper's scale (thousands of GPUs, day-long campaigns) the failure
model stops being "a node might die" and becomes "some node is always
slow".  This module provides the host-side substrate:

  * :class:`StragglerMonitor` -- robust (median/MAD) detection of workers
    whose recent step times fall out of the population;
  * :func:`rebalance` -- shrink a straggler's contiguous slice range and
    redistribute, conserving total work;
  * :func:`suggest_checkpoint_period` -- Young/Daly optimal checkpoint
    interval as the system MTBF shrinks with node count;
  * :func:`remesh` -- re-place a restored checkpoint onto another mesh.
"""
from __future__ import annotations

import collections
import math

__all__ = [
    "StragglerMonitor",
    "rebalance",
    "remesh",
    "suggest_checkpoint_period",
]


class StragglerMonitor:
    """Flag workers whose recent step times are population outliers.

    Each worker's statistic is the mean of its last ``window`` recorded
    times (a mean, not a median, so a single large stall registers
    immediately).  A worker is a straggler when its statistic exceeds
    ``median + k_mad * 1.4826 * MAD`` of all workers' statistics -- the
    usual robust z-score with the MAD scaled to sigma.
    """

    def __init__(self, k_mad: float = 3.0, window: int = 4):
        self.k_mad = float(k_mad)
        self.window = int(window)
        self._times: dict = collections.defaultdict(
            lambda: collections.deque(maxlen=self.window)
        )

    def record(self, worker, seconds: float) -> None:
        self._times[worker].append(float(seconds))

    def stats(self) -> dict:
        return {
            w: sum(ts) / len(ts) for w, ts in self._times.items() if ts
        }

    def stragglers(self) -> list:
        stats = self.stats()
        if len(stats) < 3:  # no meaningful population
            return []
        vals = sorted(stats.values())
        med = _median(vals)
        mad = _median(sorted(abs(v - med) for v in vals))
        # Floor: don't hair-trigger on a near-constant population.
        thresh = med + self.k_mad * 1.4826 * max(mad, 0.01 * med, 1e-12)
        return sorted(w for w, v in stats.items() if v > thresh)


def _median(sorted_vals):
    n = len(sorted_vals)
    mid = n // 2
    if n % 2:
        return sorted_vals[mid]
    return 0.5 * (sorted_vals[mid - 1] + sorted_vals[mid])


def rebalance(ranges: dict, stragglers, shed: float = 0.5) -> dict:
    """Shrink stragglers' slice ranges, redistribute to healthy workers.

    Args:
      ranges: worker -> (start, end) contiguous half-open slice ranges.
      stragglers: workers to shed load from (e.g.
        ``StragglerMonitor.stragglers()``).
      shed: fraction of a straggler's slices to move away.

    Returns:
      New worker -> (start, end) map over the same total span, re-laid-out
      contiguously in worker key order.  Total slice count is conserved,
      and a straggler that had work keeps at least one slice -- even at
      ``shed=1.0`` it sheds load, never its membership (zeroing it out
      would drop it from the mesh, which is a remesh's job, not a
      rebalance).  Empty input maps and empty per-worker ranges are
      both fine (an empty range stays empty, contiguity holds).
    """
    if not ranges:
        return {}
    keys = sorted(ranges)
    sizes = {k: ranges[k][1] - ranges[k][0] for k in keys}
    bad = [k for k in keys if k in set(stragglers)]
    good = [k for k in keys if k not in set(stragglers)]
    if not bad or not good:
        return dict(ranges)
    moved = 0
    for k in bad:
        give = min(int(sizes[k] * shed), max(sizes[k] - 1, 0))
        sizes[k] -= give
        moved += give
    for i in range(moved):  # round-robin keeps healthy loads even
        sizes[good[i % len(good)]] += 1
    start = min(s for s, _ in ranges.values())
    out = {}
    for k in keys:
        out[k] = (start, start + sizes[k])
        start += sizes[k]
    return out


def remesh(tree, specs, mesh):
    """Re-place a (restored) tree onto ``mesh`` per ``specs``
    (``dist.sharding.param_specs`` and friends).

    Values are preserved exactly; only placement changes.  This is the
    elastic-restart path: save on mesh A, lose nodes, restore host-side
    (``ckpt.checkpoint.restore``), ``remesh`` onto mesh B.  ``tree`` is a
    tree of dicts and lists (or an ``nn.Module``, as its parameters by
    name) whose leaves are arrays, tensors or ``sharding.Placed``;
    returns the same tree of ``sharding.Placed``.

    A laid-out state (``sharding.PlacedTree``, what the train steps take
    and give back) moves whole: its pieces are joined and laid out on
    ``mesh`` by ``specs`` (``None``: ``param_specs`` of its tree on
    ``mesh``), whatever the two meshes' ``model`` sizes; a dict of them
    (an optimizer state) moves leaf by leaf, a ``count`` replicated.
    """
    from ..opt.tree import tree_map
    from .sharding import (
        Placed, Placement, PlacedTree, _as_tree, param_specs, place_tree,
        shardings,
    )

    if isinstance(tree, PlacedTree):
        whole = tree.full()
        specs = param_specs(whole, mesh) if specs is None else specs
        return place_tree(whole, specs, mesh)
    if isinstance(tree, dict) and any(isinstance(v, PlacedTree)
                                      for v in tree.values()):
        return {k: remesh(v, specs, mesh) if isinstance(v, PlacedTree)
                else Placement(mesh, ()).place(
                    v.full() if isinstance(v, Placed) else v)
                for k, v in tree.items()}

    def place(x, pl):
        return pl.place(x.full() if isinstance(x, Placed) else x)

    return tree_map(place, _as_tree(tree), shardings(specs, mesh))


def suggest_checkpoint_period(
    write_cost_s: float, n_nodes: int, node_mtbf_s: float = 5.0e6
) -> float:
    """Young/Daly first-order optimum: ``sqrt(2 * delta * MTBF_system)``.

    ``MTBF_system = node_mtbf_s / n_nodes`` -- more nodes, more frequent
    failures, shorter optimal period.
    """
    mtbf_sys = node_mtbf_s / max(int(n_nodes), 1)
    return math.sqrt(2.0 * float(write_cost_s) * mtbf_sys)
