"""Declarative communication topology: ``Topology`` and ``CommPlan``.

The paper's hierarchical communication (Sec. III-B) exploits the fact that
a fat node's links form a ladder of speeds: GPUs on one socket talk over
NVLink, sockets within a node over the host bus, and nodes over the
interconnect.  A :class:`Topology` names that ladder once -- an ordered
(fast -> slow) list of :class:`Level`, each a mesh axis with a link class
-- and a :class:`CommPlan` resolves a requested reduction *mode* against
it into a schedule of per-level collectives plus a per-level wire-volume
model.  Link classes keep the reference's names: "ici" for the links
inside a node (NVLink, the host bus), "dci" for the links between nodes.

Everything downstream is a view over the plan: the runtime collectives
(:mod:`repro_torch.dist.collectives`) and the volume accounting.

Modes
-----
  direct   one all-reduce over the joint device group; every level's link
           carries the full dense partial.
  rs       one reduce-scatter over the joint group (flat; all links carry
           the full volume, but each device ends with only its chunk).
  hier     the paper's ladder: reduce-scatter level by level, fast ->
           slow; level ``i`` carries ``1 / prod(size of faster levels)``
           of the dense partial -- the local-reduction trick that shrinks
           slow-link traffic by 58-64% in the paper's runs.
  sparse   footprint-compressed all-to-all (beyond-paper): only rows that
           carry partial sums travel, using the static tables from
           ``core.partition.build_sparse_exchange``.
  hier-sparse
           the two paper tricks composed: partials are first merged
           *within the socket level* (union of the members' footprints,
           one deduplicated band per socket, reduce-scattered over the
           fast link), and only the merged band crosses the slower links
           in a sparse all-to-all.  Static tables come from
           ``core.partition.build_hier_sparse_exchange``.

Volume model: for a dense per-device partial of ``M`` bytes over ``R``
padded rows, ladder sizes ``g_0`` (the socket) ... ``g_{L-1}``,
flat-sparse pair capacity ``V``, merged socket band ``G*W`` rows and
cross-socket capacity ``V2``:

  direct / rs   level i carries M          (data reduced at every rung)
  hier          level i carries M / prod_{j<i} g_j
  sparse        level i carries M * P*V / R
  hier-sparse   socket level carries M * G*W / R; every slower level
                carries M * n_slow*V2 / R   (n_slow = P / G)

Ranks
-----
One process drives every rank (the reference is single-controller too:
one ``shard_map`` over the mesh).  The ladder engine takes **a list of
per-rank tensors in rank order** and returns one; each result lives on
its input's device.  Rank ``p`` is the row-major linearization of its
coordinates over ``data_axes`` (first axis major), as
``jax.lax.axis_index(data_axes)`` is in the reference: with
``data_axes=("model", "data")`` and a fast level of size ``G``, rank
``p = f * n_slow + t``.  A collective over axes ``A`` acts on the groups
of ranks that share their coordinates on every other data axis; a
member's index within its group linearizes its coordinates on ``A``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from ..placement import FakeDevice, copy_kind

__all__ = [
    "DeviceMesh",
    "Level",
    "Topology",
    "CommStep",
    "CommPlan",
    "MODES",
    "LINK_CLASSES",
]

MODES = ("direct", "rs", "hier", "sparse", "hier-sparse")

# Canonical link class per production mesh axis: the minor ICI axis is
# the paper's "socket", the major ICI axis its "node", DCI its "global"
# level.  ``launch.mesh.mesh_axis_classes`` derives from this table.
LINK_CLASSES = {"model": "ici", "data": "ici", "pod": "dci"}


@dataclasses.dataclass(frozen=True)
class Level:
    """One rung of the communication ladder (fast -> slow order)."""

    axis: str  # mesh axis name
    size: int  # devices along this axis
    link: str  # "ici" | "dci"
    paper_level: str  # "socket" | "node" | "global"


class DeviceMesh:
    """An ndarray of ``torch.device`` with named axes, the mesh a
    :class:`Topology` binds (built by ``launch.mesh.make_mesh``, the
    counterpart of ``jax.make_mesh``).  Its devices may instead be
    ``placement.FakeDevice`` placeholders
    (``launch.mesh.make_production_mesh``), which only an abstract
    ``Reconstructor`` binds.

    ``shape`` maps axis name -> size in axis order, as
    ``jax.sharding.Mesh.shape`` does; ``devices`` is the ndarray itself.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            d = src[idx]
            if not isinstance(d, FakeDevice):  # placeholders stay as given
                d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                # the card a bare "cuda" means, so that a rank's device
                # compares equal to its tensors'
                d = torch.device("cuda", torch.cuda.current_device())
            arr[idx] = d
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(
                f"{arr.ndim}-d devices for {len(names)} axis names {names}"
            )
        if len(set(names)) != len(names):
            raise ValueError(f"repeated axis name in {names}")
        self.devices = arr
        self.axis_names = names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        shape = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return (f"DeviceMesh({shape}; "
                f"{sorted({str(d) for d in self.devices.flat})})")


@dataclasses.dataclass(frozen=True)
class Topology:
    """A mesh's communicating axes, ordered fast -> slow, plus the axes
    that carry communication-free (batch) parallelism.

    Build with :meth:`from_mesh` (binds a ``DeviceMesh``,
    required by ``core.recon.Reconstructor``) or :meth:`from_sizes` (pure
    accounting, e.g. volume tables for a machine that is not attached;
    the collectives run on it too, each rank on its input's device).
    """

    levels: tuple  # tuple[Level, ...], fast -> slow
    batch_axes: tuple = ()
    mesh: object = None  # DeviceMesh | None

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @classmethod
    def from_mesh(
        cls,
        mesh,
        data_axes: Sequence[str] = ("model",),
        batch_axes: Sequence[str] = ("data",),
        link_classes: dict | None = None,
    ) -> "Topology":
        """Build from a ``DeviceMesh``.

        ``data_axes`` (fast -> slow) carry the in-slice partial-data
        reduction; ``batch_axes`` carry slice/batch parallelism and never
        communicate.  ``link_classes`` maps axis -> "ici" | "dci";
        defaults come from the canonical :data:`LINK_CLASSES` table.
        """
        links = dict(LINK_CLASSES)
        links.update(link_classes or {})
        data_axes = tuple(data_axes)
        for a in data_axes + tuple(batch_axes):
            if a not in mesh.shape:
                raise ValueError(
                    f"axis {a!r} not in mesh axes {tuple(mesh.shape)}"
                )
        levels = _make_levels(
            [(a, mesh.shape[a], links.get(a, "ici")) for a in data_axes]
        )
        return cls(
            levels=levels, batch_axes=tuple(batch_axes), mesh=mesh
        )

    @classmethod
    def from_sizes(cls, sizes: Sequence) -> "Topology":
        """Meshless topology from ``[(axis, size, link), ...]`` fast ->
        slow (link defaults to "ici" for 2-tuples)."""
        norm = [
            (s[0], int(s[1]), s[2] if len(s) > 2 else "ici")
            for s in sizes
        ]
        return cls(levels=_make_levels(norm))

    # ------------------------------------------------------------------ #
    # interrogation
    # ------------------------------------------------------------------ #
    @property
    def data_axes(self) -> tuple:
        """Communicating mesh axes, fast -> slow."""
        return tuple(lv.axis for lv in self.levels)

    @property
    def n_data(self) -> int:
        """Total devices in the reduction group."""
        return math.prod(lv.size for lv in self.levels)

    @property
    def n_batch(self) -> int:
        if self.mesh is None:
            return 1
        return math.prod(self.mesh.shape[a] for a in self.batch_axes)

    def plan(self, mode: str, *, pair_slots: int | None = None,
             dense_rows: int | None = None,
             merged_rows: int | None = None,
             cross_rows: int | None = None,
             wire: str = "native",
             comm_bytes: int = 2) -> "CommPlan":
        """Resolve ``mode`` into a :class:`CommPlan`.

        The sparse modes additionally need static table capacities to
        model wire volume (runtime execution works without them):
        ``sparse`` takes ``pair_slots`` (V of ``build_sparse_exchange``)
        and ``dense_rows`` (padded global rows); ``hier-sparse`` takes
        ``merged_rows`` (G*W, the padded per-socket merged band of
        ``build_hier_sparse_exchange``) and ``cross_rows`` (n_slow*V2,
        per-device rows crossing the slow links) plus ``dense_rows``.
        ``core.partition.exchange_volume_params`` computes all four from
        an operator shard (exact tables when built, estimates for
        abstract plans).

        ``wire="q8"`` (hier-sparse only) prices the compressed slow-axis
        hop of ``collectives.sparse_exchange(wire="q8")``: int8 payload
        plus one f32 scale per (slow peer, slice), relative to a native
        wire of ``comm_bytes``-wide values (the policy's ``comm_bytes``).
        """
        return CommPlan.resolve(
            self, mode, pair_slots=pair_slots, dense_rows=dense_rows,
            merged_rows=merged_rows, cross_rows=cross_rows,
            wire=wire, comm_bytes=comm_bytes,
        )

    def groups(self, axes: Sequence[str]) -> list:
        """Ranks grouped for a collective over ``axes``: ranks that share
        their coordinates on every other data axis, each group listed in
        member order (the coordinates on ``axes``, linearized in the
        order given)."""
        names = self.data_axes
        for a in axes:
            if a not in names:
                raise ValueError(f"axis {a!r} not in data axes {names}")
        sizes = [lv.size for lv in self.levels]
        on = [names.index(a) for a in axes]
        off = [i for i in range(len(names)) if i not in on]
        # ranks laid out over the data axes (first major), the other axes
        # first: each row is then one group in member order
        ranks = np.arange(self.n_data).reshape(sizes).transpose(off + on)
        return ranks.reshape(-1, math.prod(sizes[i] for i in on)).tolist()

    def rank_devices(self, batch: int = 0) -> list:
        """``torch.device`` of each data rank of batch group ``batch``, in
        rank order: the mesh device at the rank's data coordinates and the
        group's batch coordinates (``batch`` linearizes them over
        ``batch_axes``, first axis major, as ``axis_index`` does), index
        0 on every other axis."""
        if self.mesh is None:
            raise ValueError(
                "rank devices need a mesh-bound topology "
                "(Topology.from_mesh)"
            )
        if not 0 <= batch < self.n_batch:
            raise ValueError(
                f"batch group {batch} of {self.n_batch} "
                f"(batch axes {self.batch_axes})"
            )
        names = self.mesh.axis_names
        sizes = [lv.size for lv in self.levels]
        bsizes = [self.mesh.shape[a] for a in self.batch_axes]
        group = dict(zip(self.batch_axes, np.unravel_index(batch, bsizes)))
        out = []
        for p in range(self.n_data):
            coords = dict(group)
            coords.update(zip(self.data_axes, np.unravel_index(p, sizes)))
            idx = tuple(int(coords.get(a, 0)) for a in names)
            out.append(self.mesh.devices[idx])
        return out

    def describe(self) -> str:
        """Human-readable ladder summary (one line per level)."""
        rows = [
            f"  {lv.paper_level:>6s}: axis {lv.axis!r} x{lv.size} "
            f"({lv.link})"
            for lv in self.levels
        ]
        head = (
            f"Topology over {self.n_data} devices"
            + (f", batch axes {self.batch_axes}" if self.batch_axes
               else "")
        )
        return "\n".join([head] + rows)


def _make_levels(sizes) -> tuple:
    """Assign paper levels: fastest ICI axis = socket, later ICI = node,
    DCI = global."""
    levels = []
    for i, (axis, size, link) in enumerate(sizes):
        if link == "dci":
            paper = "global"
        elif i == 0:
            paper = "socket"
        else:
            paper = "node"
        levels.append(
            Level(axis=axis, size=int(size), link=link, paper_level=paper)
        )
    return tuple(levels)


# --------------------------------------------------------------------- #
# plans
# --------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class CommStep:
    """One collective of a resolved schedule.

    ``wire_frac`` is the fraction of the dense per-device partial that
    crosses this step's (slowest) link, per device -- reduce-semantics
    accounting as in the paper's Table IV, not ring-hop counting.
    """

    op: str  # all_reduce | reduce_scatter | all_gather | all_to_all
    axes: tuple  # mesh axes the collective spans
    link: str  # slowest link class crossed
    wire_frac: float


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """A reduction mode resolved against a topology.

    ``steps`` is the execution schedule (consumed by
    ``dist.collectives``); ``level_fracs`` is the per-level wire-volume
    model (consumed by benchmarks and the roofline sweeps): entry ``i`` is
    the fraction of the dense partial that crosses level ``i``'s link.
    """

    topology: Topology
    mode: str
    steps: tuple  # tuple[CommStep, ...]
    level_fracs: tuple  # tuple[float, ...], aligned with topology.levels

    # ------------------------------------------------------------------ #
    # resolution
    # ------------------------------------------------------------------ #
    @classmethod
    def resolve(cls, topo: Topology, mode: str, *,
                pair_slots: int | None = None,
                dense_rows: int | None = None,
                merged_rows: int | None = None,
                cross_rows: int | None = None,
                wire: str = "native",
                comm_bytes: int = 2) -> "CommPlan":
        if mode not in MODES:
            raise ValueError(f"unknown comm mode {mode!r}; one of {MODES}")
        if wire not in ("native", "q8"):
            raise ValueError(
                f"unknown wire {wire!r}; one of ('native', 'q8')"
            )
        if wire == "q8" and mode != "hier-sparse":
            raise ValueError(
                "wire='q8' compresses the hier-sparse slow-axis hop only "
                "(other modes ship dense partials; quantize via the "
                "precision policy's comm dtype instead)"
            )
        levels = topo.levels
        axes = topo.data_axes
        slowest = levels[-1].link if levels else "ici"
        if mode == "direct":
            steps = (CommStep("all_reduce", axes, slowest, 1.0),)
            fracs = tuple(1.0 for _ in levels)
        elif mode == "rs":
            steps = (CommStep("reduce_scatter", axes, slowest, 1.0),)
            fracs = tuple(1.0 for _ in levels)
        elif mode == "hier":
            steps, fracs = [], []
            frac = 1.0
            for lv in levels:
                steps.append(
                    CommStep("reduce_scatter", (lv.axis,), lv.link, frac)
                )
                fracs.append(frac)
                frac /= lv.size
            steps, fracs = tuple(steps), tuple(fracs)
        elif mode == "sparse":
            if pair_slots is not None and dense_rows:
                frac = topo.n_data * pair_slots / float(dense_rows)
            else:
                frac = float("nan")  # volume model needs the tables
            steps = (CommStep("all_to_all", axes, slowest, frac),)
            fracs = tuple(frac for _ in levels)
        else:  # hier-sparse: socket-level dedup, then cross-socket a2a
            if not levels:
                raise ValueError("hier-sparse needs at least one level")
            sock = levels[0]
            if merged_rows is not None and dense_rows:
                sock_frac = merged_rows / float(dense_rows)
            else:
                sock_frac = float("nan")
            if cross_rows is not None and dense_rows:
                if wire == "q8":
                    # int8 values + one f32 inverse scale per slow peer
                    # (per slice), as a fraction of the *native* dense
                    # frame (dense_rows at comm_bytes wide) so level
                    # fractions stay comparable across wire formats
                    # (core.partition.hier_sparse_wire_bytes).
                    n_slow = max(
                        1, math.prod(lv.size for lv in levels[1:])
                    )
                    cross_frac = (cross_rows * 1 + n_slow * 4) / (
                        float(dense_rows) * comm_bytes
                    )
                else:
                    cross_frac = cross_rows / float(dense_rows)
            else:
                cross_frac = float("nan")
            steps = (
                CommStep(
                    "reduce_scatter", (sock.axis,), sock.link, sock_frac
                ),
                CommStep("all_to_all", axes[1:], slowest, cross_frac),
            )
            fracs = (sock_frac,) + tuple(cross_frac for _ in levels[1:])
        return cls(
            topology=topo, mode=mode, steps=steps, level_fracs=fracs
        )

    # ------------------------------------------------------------------ #
    # volume model (paper Table IV)
    # ------------------------------------------------------------------ #
    def level_bytes(self, dense_bytes: float) -> tuple:
        """Per-level wire bytes for one reduction of a ``dense_bytes``
        partial, aligned with ``topology.levels``."""
        return tuple(f * dense_bytes for f in self.level_fracs)

    def wire_bytes_by_link(self, dense_bytes: float) -> dict:
        """Aggregate wire bytes per link class ("ici" / "dci")."""
        out: dict = {}
        for lv, b in zip(self.topology.levels,
                         self.level_bytes(dense_bytes)):
            out[lv.link] = out.get(lv.link, 0.0) + b
        return out

    def slow_link_bytes(self, dense_bytes: float) -> float:
        """Bytes crossing the slowest (last) level's link -- the quantity
        the paper's hierarchical scheme minimizes."""
        return self.level_bytes(dense_bytes)[-1]

    def describe(self) -> str:
        lines = [f"CommPlan(mode={self.mode!r})"]
        for s in self.steps:
            lines.append(
                f"  {s.op:>14s} over {s.axes} [{s.link}] "
                f"wire x{s.wire_frac:.4g}"
            )
        return "\n".join(lines)

    # ------------------------------------------------------------------ #
    # ladder engine (lists of per-rank tensors, rank order)
    # ------------------------------------------------------------------ #
    def reduce_partials(self, xs):
        """Per-rank dense partials ``[rows_pad, F]`` -> each rank's owned
        chunk ``[rows_pad / n_data, F]``, on its input's device.

        Chunk ownership follows the rank order (first data axis major),
        matching the partition plan's device order.
        """
        if self.mode in ("sparse", "hier-sparse"):
            raise ValueError(
                f"{self.mode} mode reduces via "
                "dist.collectives.sparse_exchange (needs the static "
                "footprint tables)"
            )
        topo = self.topology
        p = topo.n_data
        xs = _ranks(xs, p)
        rows = xs[0].shape[0]
        if rows % p:
            raise ValueError(
                f"rows {rows} not divisible by group size {p}"
            )
        for step in self.steps:
            groups = topo.groups(step.axes)
            if step.op == "all_reduce":
                xs = all_reduce(xs, groups)
                c = rows // p
                xs = [x[i * c:(i + 1) * c] for i, x in enumerate(xs)]
            elif step.op == "reduce_scatter":
                xs = reduce_scatter(xs, groups)
            else:  # pragma: no cover - resolve() emits only the above
                raise AssertionError(step.op)
        return xs

    def psum(self, xs):
        """All-reduce semantics (every rank gets the full sum, same
        shape), scheduled per the plan.

        ``rs`` and ``hier`` realize the ladder as the reference's TPU
        branch does: reduce-scatter the fast levels (``rs``: the joint
        group), all-reduce the slowest at the reduced volume, all-gather
        back.  (The reference's CPU branch only changes this schedule to
        one all-reduce per level; the values are the same.)
        """
        topo = self.topology
        xs = _ranks(xs, topo.n_data)
        axes = topo.data_axes
        if not axes:
            return xs
        if self.mode == "direct" or len(axes) == 1:
            return all_reduce(xs, topo.groups(axes))
        if self.mode in ("sparse", "hier-sparse"):
            raise ValueError(f"{self.mode} mode has no psum form")
        if self.mode == "rs":
            return _rs_ag_psum(xs, topo, [axes], topo.n_data)
        # hier: scatter down the fast levels, all-reduce the slowest
        fast_levels = topo.levels[:-1]
        return _rs_ag_psum(
            xs,
            topo,
            [(lv.axis,) for lv in fast_levels],
            math.prod(lv.size for lv in fast_levels),
            last=topo.levels[-1].axis,
        )


def _ranks(xs, p: int) -> list:
    xs = list(xs)
    if len(xs) != p:
        raise ValueError(f"{len(xs)} per-rank tensors for {p} ranks")
    return xs


def _sum(parts, device):
    """Sum in member order on ``device`` (one part: that tensor)."""
    acc = parts[0].to(device)
    for t in parts[1:]:
        acc = acc + t.to(device)
    return acc


def _cat(parts, device):
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([t.to(device) for t in parts], dim=0)


@copy_kind("all-reduce")
def all_reduce(xs, groups) -> list:
    """Every member of a group gets the group's sum (``psum``)."""
    out = list(xs)
    for g in groups:
        s = _sum([xs[r] for r in g], xs[g[0]].device)
        for r in g:
            out[r] = s.to(xs[r].device)
    return out


@copy_kind("reduce-scatter")
def reduce_scatter(xs, groups) -> list:
    """Member ``j`` of a group gets chunk ``j`` of the group's sum along
    dim 0 (``psum_scatter(..., tiled=True)``)."""
    out = list(xs)
    for g in groups:
        c = xs[g[0]].shape[0] // len(g)
        for j, r in enumerate(g):
            out[r] = _sum([xs[k][j * c:(j + 1) * c] for k in g],
                          xs[r].device)
    return out


@copy_kind("all-gather")
def all_gather(xs, groups) -> list:
    """Every member gets the members' tensors concatenated along dim 0
    in member order (``all_gather(..., tiled=True)``)."""
    out = list(xs)
    for g in groups:
        for r in g:
            out[r] = _cat([xs[k] for k in g], xs[r].device)
    return out


@copy_kind("all-to-all")
def all_to_all(xs, groups) -> list:
    """Member ``j`` gets chunk ``j`` of every member's tensor, stacked
    along dim 0 in member order (``all_to_all(split_axis=0,
    concat_axis=0, tiled=True)``): with ``msgs[k]`` of shape ``[n, V,
    F]`` over an ``n``-member group, member ``j`` receives
    ``msgs[k][j]`` from each member ``k`` as its row ``k``."""
    out = list(xs)
    for g in groups:
        c = xs[g[0]].shape[0] // len(g)
        for j, r in enumerate(g):
            out[r] = _cat([xs[k][j * c:(j + 1) * c] for k in g],
                          xs[r].device)
    return out


def _rs_ag_psum(xs, topo, scatter_groups, group: int,
                last: str | None = None):
    """Flatten-pad ladder: reduce-scatter each group of axes (fast ->
    slow), optionally all-reduce ``last``, then all-gather back in
    reverse.  ``group`` is the product of all scattered axis sizes."""
    shape = xs[0].shape
    flat = [x.reshape(-1) for x in xs]
    pad = (-flat[0].shape[0]) % group
    if pad:
        flat = [torch.cat([f, f.new_zeros(pad)]) for f in flat]
    for axes in scatter_groups:
        flat = reduce_scatter(flat, topo.groups(axes))
    if last is not None:
        flat = all_reduce(flat, topo.groups((last,)))
    for axes in reversed(scatter_groups):
        flat = all_gather(flat, topo.groups(axes))
    if pad:
        flat = [f[:-pad] for f in flat]
    return [f.reshape(shape) for f in flat]
