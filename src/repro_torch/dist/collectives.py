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

Half-precision wire formats are the caller's choice: cast with
``core.precision.qcast`` (adaptive normalization, one factor for the
group) before the exchange and multiply the inverse scale back after --
see ``core/recon.py``.
"""
from __future__ import annotations

import torch

from ..core.precision import _log2_ratio, _pow2
from .topology import Topology, all_to_all, reduce_scatter

__all__ = ["reduce_partials", "sparse_exchange", "hierarchical_psum"]


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


def sparse_exchange(bands, send_idx, recv_idx, topo, rows_out: int,
                    *, socket_map=None, socket_rows: int | None = None,
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
    rank's device; index tables are int64.

    Args:
      bands: per rank ``[flat_rows, F]`` virtual-row partials.
      send_idx: flat: per rank ``[P, V]`` band slots destined for each
        peer (padding points at ``flat_rows``); hier: ``[n_slow, V2]``
        slots of the rank's merged-band group per slow peer (padding
        points at ``socket_rows``).
      recv_idx: flat: ``[P, V]``; hier: ``[n_slow, V2]``.  Owned-chunk row
        for each incoming slot; padding points at ``rows_out`` (trash
        row).
      topo: Topology spanning the P = n_data exchange group.
      rows_out: rows of the owned output chunk.
      socket_map: per rank ``[flat_rows]`` merged-band slot per band slot
        (selects the hier-sparse path; trash = fast_size * socket_rows).
      socket_rows: W, rows per merged-band group (required with
        ``socket_map``).
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
    mode = "sparse" if socket_map is None else "hier-sparse"
    if wire not in ("native", "q8"):
        raise ValueError(f"unknown wire {wire!r}; one of ('native', 'q8')")
    if wire == "q8" and mode != "hier-sparse":
        raise ValueError(
            "wire='q8' compresses the hier-sparse slow-axis hop; the flat "
            "sparse mode has no per-band structure to scale (use "
            "socket_map/socket_rows, or wire='native')"
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
        # Scatter-add into the owned chunk (+ trash row for padding slots).
        out = torch.zeros((rows_out + 1, f), dtype=dtype, device=got.device)
        out.index_add_(0, recv.reshape(-1), got.reshape(-1, f))
        return out[:rows_out]

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
        return [scatter_out(g, r) for g, r in zip(got, recv_idx)]

    if socket_rows is None:
        raise ValueError("hier-sparse exchange needs socket_rows (W)")
    rs_step, a2a_step = plan.steps
    g = topo.levels[0].size
    # stage 1: merge the socket's partials into its deduplicated band
    # (grouped by owner fast index) and leave each member its group,
    # summed over the fast link.
    merged = []
    for b, smap in zip(bands, socket_map):
        m = torch.zeros((g * socket_rows + 1, f), dtype=dtype,
                        device=b.device)
        merged.append(m.index_add_(0, smap, b)[:-1])
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
    return [scatter_out(m, r) for m, r in zip(msgs, recv_idx)]
