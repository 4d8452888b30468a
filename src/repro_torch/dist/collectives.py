"""Runtime collectives: thin views over the :class:`CommPlan` ladder.

Every entry point takes **a list of per-rank tensors in rank order** (see
:mod:`repro_torch.dist.topology`) and returns one, each result on its
input's device, plus a :class:`Topology` naming the ladder (a mesh-bound
one or :meth:`Topology.from_sizes`).  The gathers and scatter-adds are
plain torch, as the reference leaves them to XLA.

  reduce_partials    dense partials [rows_pad, F] -> owned chunks
                     (direct | rs | hier)
  sparse_exchange    footprint-compressed banded exchange
                     (sparse | hier-sparse)
  hierarchical_psum  all-reduce semantics for gradient sync
                     (direct | rs | hier)
  ordered_index_add  the scatter-add of a static table, in XLA's order
                     (``ScatterPasses``)

Half-precision wire formats are the caller's choice: cast with
``core.precision.qcast`` (adaptive normalization, one factor for the
group) before the exchange and multiply the inverse scale back after --
see ``core/recon.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.precision import _log2_ratio, _pow2
from .topology import Topology, all_to_all, reduce_scatter

__all__ = [
    "reduce_partials",
    "sparse_exchange",
    "hierarchical_psum",
    "ScatterPasses",
    "ordered_index_add",
]


def _as_topology(topo) -> Topology:
    if isinstance(topo, Topology):
        return topo
    raise TypeError(
        f"expected a Topology, got {type(topo).__name__}: the ranks' "
        "tensors carry no axis sizes (use Topology.from_sizes)"
    )


def reduce_partials(xs, topo, *, mode: str = "hier"):
    """Reduce per-rank dense partials to each rank's owned chunk.

    Args:
      xs: per-rank ``[rows_pad, F]`` dense partials in rank order
        (rows_pad divisible by the group size; the scatter-add in
        ``core/recon.py`` produces exactly this).
      topo: Topology.
      mode: direct | rs | hier.

    Returns:
      per-rank ``[rows_pad / n_data, F]`` owned chunks, rank order.
    """
    return _as_topology(topo).plan(mode).reduce_partials(xs)


def hierarchical_psum(xs, topo, *, mode: str = "hier"):
    """All-reduce with the plan's schedule (gradient sync).

    ``hier`` realizes the paper's ladder -- reduce-scatter the fast
    levels, all-reduce the slowest at reduced volume, all-gather back.
    """
    return _as_topology(topo).plan(mode).psum(xs)


@dataclasses.dataclass(frozen=True)
class ScatterPasses:
    """A static scatter-add table split into occurrence passes.

    XLA's ``.at[idx].add`` applies the updates in flattened index order
    and rounds to the operand's dtype after each one.  Pass ``k`` holds
    the ``k``-th occurrence of every destination row that has one, in
    that order, with its source slot, so no pass repeats a destination:
    one ``index_add_`` per pass then adds two values of the band's dtype
    and rounds once, which is the correctly rounded add of the reference,
    and on the card no two of a pass's atomics meet a row, so the result
    does not depend on the order in which they land.  Destinations at or
    above ``rows`` (the padding's trash rows) are dropped.

    Pass 0 takes every source slot, so it needs no gather: ``first``
    sends each slot of pass 0 to its row and every other slot (padding,
    or a later occurrence) to a trash row of its own past ``rows``,
    ``trash`` of them.  The later passes gather their slots: pass ``k``
    is ``dst[bounds[k-1]:bounds[k]]`` fed from ``src`` at the same range.
    """

    first: torch.Tensor  # int64 [slots]: pass 0's row, or a trash row
    dst: torch.Tensor  # int64 rows of passes 1, 2, ...
    src: torch.Tensor  # int64 source slots of passes 1, 2, ...
    bounds: tuple  # pass k >= 1 is [bounds[k-1], bounds[k])
    rows: int
    trash: int

    @classmethod
    def build(cls, index, rows: int) -> "ScatterPasses":
        """Host tables from ``index`` (any shape, flattened; entry ``i``
        is the destination of source slot ``i``) and ``rows``, the
        number of real destination rows."""
        idx = np.asarray(index).reshape(-1).astype(np.int64)
        slots = np.flatnonzero((idx >= 0) & (idx < rows))
        order = np.argsort(idx[slots], kind="stable")
        dst, src = idx[slots][order], slots[order]
        starts = np.r_[0, np.flatnonzero(dst[1:] != dst[:-1]) + 1]
        runs = np.diff(np.r_[starts, dst.size])
        # occurrence number of each slot among its destination's slots
        occ = np.arange(dst.size) - np.repeat(starts, runs)
        first = np.empty(idx.size, np.int64)
        rest = np.ones(idx.size, bool)
        rest[src[occ == 0]] = False
        first[src[occ == 0]] = dst[occ == 0]
        first[rest] = rows + np.arange(int(rest.sum()))
        later = np.flatnonzero(occ > 0)
        later = later[np.argsort(occ[later], kind="stable")]
        counts = np.bincount(occ[later])[1:] if later.size else []
        return cls(
            first=torch.from_numpy(first),
            dst=torch.from_numpy(dst[later]),
            src=torch.from_numpy(src[later]),
            bounds=tuple(int(b) for b in np.r_[0, np.cumsum(counts)]),
            rows=int(rows),
            trash=int(rest.sum()),
        )

    @property
    def device(self) -> torch.device:
        return self.first.device

    @property
    def depth(self) -> int:
        """Passes: the largest number of slots on one destination row."""
        return len(self.bounds) if self.trash < self.first.numel() else 0


def ordered_index_add(passes: ScatterPasses, src):
    """``out[dst] += src[slot]`` over a zero ``out`` of ``passes.rows``
    rows, pass after pass: the reference's scatter-add, rounded to
    ``src``'s dtype after every update in index order, deterministic on
    the card.  Returns ``out`` (a view of the rows before the trash)."""
    out = src.new_zeros((passes.rows + passes.trash, src.shape[1]))
    out.index_add_(0, passes.first, src)
    out = out[:passes.rows]
    b = passes.bounds
    for lo, hi in zip(b[:-1], b[1:]):
        out.index_add_(0, passes.dst[lo:hi],
                       src.index_select(0, passes.src[lo:hi]))
    return out


def _wire_q8_pack(msgs):
    """Per-(peer, slice) int8 compression for the slow-axis hop.

    ``msgs`` is [n_slow, V2, F]; each (slow peer, fused slice) band gets
    one power-of-two scale steering its max |value| onto the int8 grid
    (floor rounding, so nothing clips -- same construction as
    ``core.precision.quantize_block_vals``).  Returns ``(q, inv)``:
    int8 payload plus the f32 inverse scales [n_slow, 1, F] that ride
    the same all-to-all (4 bytes per (peer, slice) vs 2 per value --
    the ~2x wire saving ``partition.hier_sparse_wire_bytes`` prices).
    """
    wide = msgs.to(torch.float32)
    m = torch.amax(torch.abs(wide), dim=1, keepdim=True)
    exp = torch.clamp(torch.floor(_log2_ratio(127.0, m)), -100.0, 100.0)
    scale = _pow2(exp)
    q = torch.round(wide * scale).to(torch.int8)
    return q, 1.0 / scale


def sparse_exchange(bands, send_idx, recv_passes, topo, rows_out: int,
                    *, socket_passes=None, socket_rows: int | None = None,
                    wire: str = "native"):
    """Footprint-compressed banded exchange (plan modes "sparse" and
    "hier-sparse"), executed as a view over the resolved ``CommPlan``.

    Each rank's SpMM emits partials only for the virtual-row band its
    shard touches (an O(1/sqrt(P)) subset of global rows -- paper Fig.
    6-7).  Instead of densifying and reducing, ship exactly those entries
    to their owners:

      sparse        one flat all-to-all over the joint group, tables from
                    ``core.partition.build_sparse_exchange``;
      hier-sparse   two stages over the ladder, tables from
                    ``core.partition.build_hier_sparse_exchange``:
                    socket-level gather/dedup (scatter-add into the
                    socket's merged band, reduce-scatter over the fast
                    axis -- overlapping footprints are summed over the
                    fast link instead of crossing the slow link once per
                    member), then a sparse all-to-all across the slow
                    (node/global) axes, then the local scatter-add.

    Every per-rank argument is a list in rank order, each entry on its
    rank's device; index tables are int64, and the scatter tables are
    :class:`ScatterPasses` built at bind time, so every scatter-add rounds
    as the reference's does and gives the same bits on every run.

    Args:
      bands: per rank ``[flat_rows, F]`` virtual-row partials.
      send_idx: flat: per rank ``[P, V]`` band slots destined for each
        peer (padding points at ``flat_rows``); hier: ``[n_slow, V2]``
        slots of the rank's merged-band group per slow peer (padding
        points at ``socket_rows``).
      recv_passes: the receive table (flat: ``[P, V]``; hier: ``[n_slow,
        V2]``, the owned-chunk row of each incoming slot, padding at
        ``rows_out``) as ``ScatterPasses.build(recv, rows_out)``.
      topo: Topology spanning the P = n_data exchange group.
      rows_out: rows of the owned output chunk.
      socket_passes: per rank, the ``[flat_rows]`` merged-band slot of
        each band slot as ``ScatterPasses.build(smap, fast_size *
        socket_rows)`` (selects the hier-sparse path; the trash slot
        ``fast_size * socket_rows`` is dropped, as the reference's
        ``mode="drop"``).
      socket_rows: W, rows per merged-band group (required with
        ``socket_passes``).
      wire: "native" ships the slow-axis hop in the bands' dtype; "q8"
        (hier-sparse only) quantizes each (slow peer, fused slice) band
        to int8 + one f32 inverse scale before the slow all-to-all and
        widens after.  The fast-axis reduce-scatter stays native: the
        merged-band sums accumulate unquantized.

    Returns:
      per rank ``[rows_out, F]`` owned chunks with all incoming partials
      scatter-added, rank order.
    """
    topo = _as_topology(topo)
    mode = "sparse" if socket_passes is None else "hier-sparse"
    if wire not in ("native", "q8"):
        raise ValueError(f"unknown wire {wire!r}; one of ('native', 'q8')")
    if wire == "q8" and mode != "hier-sparse":
        raise ValueError(
            "wire='q8' compresses the hier-sparse slow-axis hop; the flat "
            "sparse mode has no per-band structure to scale (use "
            "socket_passes/socket_rows, or wire='native')"
        )
    plan = topo.plan(mode)
    bands = list(bands)
    if len(bands) != topo.n_data:
        raise ValueError(
            f"{len(bands)} per-rank bands for {topo.n_data} ranks"
        )
    f = bands[0].shape[1]
    dtype = bands[0].dtype

    def scatter_out(got, recv):
        # scatter-add into the owned chunk (padding slots go to trash)
        return ordered_index_add(recv, got.reshape(-1, f))

    def pad_row(x):
        # one zero row so padding send slots contribute nothing
        return torch.cat([x, x.new_zeros((1, f))], dim=0)

    def take(x, idx):
        return pad_row(x).index_select(0, idx.reshape(-1)).reshape(
            *idx.shape, f
        )

    if mode == "sparse":
        (step,) = plan.steps
        msgs = [take(b, s) for b, s in zip(bands, send_idx)]  # [P, V, F]
        # row q of rank p's msgs goes to rank q; rank q receives [P, V, F]
        # whose row p came from rank p
        got = all_to_all(msgs, topo.groups(step.axes))
        return [scatter_out(g, r) for g, r in zip(got, recv_passes)]

    if socket_rows is None:
        raise ValueError("hier-sparse exchange needs socket_rows (W)")
    rs_step, a2a_step = plan.steps
    g = topo.levels[0].size
    # stage 1: merge the socket's partials into its deduplicated band
    # (grouped by owner fast index) and leave each member its group,
    # summed over the fast link.
    merged = [ordered_index_add(smap, b)
              for b, smap in zip(bands, socket_passes)]
    mine = reduce_scatter(merged, topo.groups(rs_step.axes))  # [W, F]
    # stage 2: sparse all-to-all across the slow axes; every row of a
    # rank's group is owned by a rank with its fast index, so it lands
    # on its owner directly.
    msgs = [take(m, s) for m, s in zip(mine, send_idx)]  # [n_slow, V2, F]
    groups = topo.groups(a2a_step.axes) if a2a_step.axes else None
    if wire == "q8":
        packed = [_wire_q8_pack(m) for m in msgs]
        q = [p[0] for p in packed]
        inv = [p[1] for p in packed]
        if groups is not None:
            q = all_to_all(q, groups)
            inv = all_to_all(inv, groups)
        msgs = [(qq.to(torch.float32) * ii).to(dtype)
                for qq, ii in zip(q, inv)]
    elif groups is not None:
        msgs = all_to_all(msgs, groups)
    return [scatter_out(m, r) for m, r in zip(msgs, recv_passes)]
