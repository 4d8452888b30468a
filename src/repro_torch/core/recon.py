"""End-to-end XCT reconstruction (the paper's system, in PyTorch).

``Reconstructor`` binds a partition plan to the ranks of a device mesh
and exposes ``project`` / ``backproject`` / ``reconstruct``.  Every
operator application runs per slice-minibatch: each rank's blocked-ELL
SpMM on its shard (the CUDA kernel, or its plain version on the CPU) ->
cast to the wire dtype with adaptive normalization, one factor for all
ranks -> partial-data reduction (direct / reduce-scatter / hierarchical
as a scatter-add plus the ``CommPlan`` ladder, or the sparse / hierarchical
sparse footprint exchange) -> the owned chunks concatenated in rank order
-> CGNR update.

One process drives every rank, as the reference's ``shard_map`` does
(``dist.DeviceMesh``).  The vectors are sharded as the reference's
``P(data_axes, batch_axes)`` (``core.sharded.Sharded``): their columns
(slices) contiguously over the batch groups, each group a full set of
data ranks that runs its own CG solve on its columns; within a group
rank ``p`` holds shard ``p`` of every operator array and row chunk ``p``
of every vector on its mesh device.  The CG dots sum each rank's rows
and then the ranks' sums (the reference's ``psum``); the adaptive scale
takes the group's maximum (its ``pmax``).  Only the host joins the
chunks, once, when a result is downloaded.  Without a topology the
reconstructor has one rank on ``device``.

The solve is timed by the ``recon/stage`` and ``recon/solve`` spans of
``obs.trace``; with tracing on, a ``recon/exchange`` instant and the
``comm_bytes_total`` / ``dma_issues_total`` counters carry its modeled
traffic.  ``resil.inject``'s ``recon/solve`` site sees the solution
before the non-finite check.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..dist import DeviceMesh, Topology
from ..dist.collectives import (
    ScatterPasses,
    ordered_index_add,
    sparse_exchange,
)
from ..kernels.ops import (
    apply_operator,
    check_supported,
    sort_segments_by_class,
    winmap_segments,
)
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..obs.trace import span as obs_span
from ..resil import inject
from ..resil.errors import NonFiniteSolveError
from ..placement import FakeDevice, copy_kind, placeholder
from .lowering import FakeTrace, LoweredCG, storage_bytes
from .partition import (
    Plan,
    build_hier_sparse_exchange,
    build_sparse_exchange,
    estimate_hier_sparse,
)
from .pipeline import pipelined_apply, side_streams
from .precision import (
    adaptive_scale_cols,
    get_policy,
    qcast,
    quantize_block_vals,
)
from .sharded import Sharded
from .solver import cgnr

__all__ = ["ReconConfig", "Reconstructor", "StagedSlab", "resolve_device"]

_SPARSE_MODES = ("sparse", "hier-sparse")


def _check_devices(mesh) -> None:
    """A mesh a Reconstructor binds real tensors on: no placeholders, and
    a card for every CUDA device (never a silent move to the CPU)."""
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for d in dict.fromkeys(mesh.devices.flat):
        if isinstance(d, FakeDevice):
            raise ValueError(
                f"mesh device {d} is a placeholder "
                "(launch.mesh.make_production_mesh / make_fake_mesh): only "
                "Reconstructor(..., abstract=True) binds one"
            )
        if d.type == "cuda" and d.index >= found:
            raise RuntimeError(
                f"mesh device {d} asked for and {found} CUDA device(s) "
                "available"
            )


def _bound_tensors(arrs: dict):
    """The tensors of one rank's bound arrays (a scatter table's passes
    are three)."""
    for t in arrs.values():
        if isinstance(t, ScatterPasses):
            yield from (t.first, t.dst, t.src)
        else:
            yield t


def resolve_device(device) -> torch.device:
    """``None`` -> ``cuda``; a missing card is an error, never a silent
    move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class StagedSlab:
    """A sinogram slab already packed, normalized and on the device.

    Produced by :meth:`Reconstructor.stage_sino`; pass it to
    :meth:`Reconstructor.reconstruct` in place of the natural-order
    numpy slab to skip the host->device staging inside the solve.
    """

    y: Sharded  # [sino_pad, Y] f32, pre-scaled, each rank's rows on its
    #   device (``.cpu()`` joins them on the host)
    scale: np.ndarray  # [Y] power-of-two per-slice normalization
    n_slices: int


@dataclasses.dataclass(frozen=True)
class ReconConfig:
    precision: str = "mixed"  # paper ladder: double|single|half|mixed
    #   (+bf16 variants, +q8/fp8 quantized-operator tiers)
    comm_mode: str = "hier"  # direct | rs | hier | sparse | hier-sparse
    wire: str = "native"  # hier-sparse slow-axis wire: native | q8
    fuse: int = 16  # paper's minibatch size (FFACTOR)
    overlap: bool = True  # Fig. 8 pipelining (side CUDA streams)
    use_ref: bool = False  # oracle instead of the kernel
    staging: str = "fused"  # in-kernel window staging | gather (A/B)
    dma: str = "coalesced"  # run-length segment window staging | per_row
    # kept for the reference's field set; no effect on Hopper (see
    # kernels.ops.apply_operator)
    smem_budget: int | None = None

    @classmethod
    def tuned(cls, passport=None, *, tune_dir=None, **overrides):
        """Build a config from a tuning passport (``repro_torch.tune``).

        Resolution: an explicit ``passport`` wins; else the passport
        for THIS machine's hardware fingerprint is looked up under
        ``tune_dir`` (missing or unusable -> stock defaults, never an
        error); ``overrides`` beat passport knobs either way.  Only the
        knobs this dataclass owns are consumed (``precision``,
        ``comm_mode``, ``wire``, ``fuse``, ``dma``) -- partition-level
        knobs live in the passport for ``build_plan`` callers to apply.
        """
        if passport is None and tune_dir is not None:
            from ..tune.passport import resolve_passport

            passport = resolve_passport(tune_dir)
        kw = {}
        if passport is not None:
            for field in ("precision", "comm_mode", "wire", "fuse", "dma"):
                if field in passport.knobs:
                    kw[field] = passport.knobs[field]
        kw.update(overrides)
        return cls(**kw)


class Reconstructor:
    """Iterative reconstruction over the ranks of a device mesh.

    Args:
      plan: partition plan (``core.partition.build_plan``).
      cfg: runtime configuration.
      device: ``"cuda"`` (default) or ``"cpu"`` for the one-rank default
        topology; raises when CUDA is asked for and absent.
      topology: ``dist.Topology.from_mesh(mesh, data_axes=...,
        batch_axes=...)`` over a ``dist.DeviceMesh``; the data
        levels' size product must equal ``plan.cfg.n_data``, and the
        batch axes' size product ``n_batch`` splits the slices.  Default:
        one rank on ``device`` (a 1x1 ``("data", "model")`` mesh with
        data axis ``"model"``, as the reference's default).
      abstract: bind every operator array and exchange table as a fake
        tensor (``core.lowering``) on a placeholder (``placement``) of its rank's CUDA
        device -- the mesh's own placeholders
        (``launch.mesh.make_production_mesh``) or one per real device --
        and allocate nothing; such a reconstructor only
        :meth:`lower_cg`.  An ``estimate_plan`` plan binds so, and a real
        plan too.  A mesh of placeholders binds only so.
    """

    def __init__(self, plan: Plan, cfg: ReconConfig = ReconConfig(),
                 device=None, *, topology: Topology | None = None,
                 abstract: bool = False):
        if topology is None:
            dev = (placeholder("cuda" if device is None else device)
                   if abstract else resolve_device(device))
            mesh = DeviceMesh([[dev]], ("data", "model"))
            topology = Topology.from_mesh(
                mesh, data_axes=("model",), batch_axes=("data",)
            )
        elif device is not None:
            raise ValueError(
                "pass either device= (one rank) or topology=, not both"
            )
        if not isinstance(topology.mesh, DeviceMesh):
            raise ValueError(
                "Reconstructor needs a mesh-bound topology "
                "(Topology.from_mesh over a DeviceMesh)"
            )
        if cfg.wire not in ("native", "q8"):
            raise ValueError(
                f"unknown wire {cfg.wire!r}; one of ('native', 'q8')"
            )
        if cfg.wire == "q8" and cfg.comm_mode != "hier-sparse":
            raise ValueError(
                "wire='q8' compresses the hier-sparse slow-axis hop; "
                f"comm_mode={cfg.comm_mode!r} has no such hop (use "
                "comm_mode='hier-sparse' or wire='native')"
            )
        self.comm_plan = topology.plan(cfg.comm_mode)
        if topology.n_data != plan.cfg.n_data:
            raise ValueError(
                f"plan has P_d={plan.cfg.n_data} but data axes "
                f"{topology.data_axes} have size {topology.n_data}"
            )
        fast = topology.levels[0].size if topology.levels else 1
        if plan.cfg.socket not in (1, fast):
            warnings.warn(
                f"plan was laid out for socket={plan.cfg.socket} but the "
                f"topology's fast level is {fast}-wide; the hier-sparse "
                "dedup will not see consecutive chunks per socket",
                stacklevel=2,
            )
        check_supported(cfg.staging, cfg.dma)
        self.plan = plan
        self.cfg = cfg
        self.topology = topology
        self.mesh = topology.mesh
        self.n_batch = topology.n_batch
        self.abstract = abstract
        if abstract:
            self._trace = FakeTrace.for_mesh(self.mesh)
            place, bind = placeholder, self._fake_arrays
        else:
            _check_devices(self.mesh)
            place, bind = (lambda d: d), self._device_arrays
        # the data ranks' devices of each batch group
        self.groups = [[place(d) for d in topology.rank_devices(b)]
                       for b in range(self.n_batch)]
        self.devices = self.groups[0]
        self.device = self.devices[0]
        self.policy = get_policy(cfg.precision)
        self._rank_rows = None  # lazy inverse row permutation
        self._rank_cols = None
        self._arrays = bind(self.devices)
        # another group's rank on a device of its own binds its own copy
        self._other = {
            (p, d): bind([d], [p])[0]
            for group in self.groups[1:]
            for p, d in enumerate(group) if d != self.devices[p]
        }
        # the reduce phase's side CUDA streams, one per distinct device,
        # shared by the ranks and batch groups on it; an abstract trace
        # issues everything in order on no stream
        self._side = (side_streams(d for g in self.groups for d in g)
                      if cfg.overlap and not abstract else {})
        # stage_sino's uploads: a stream of their own, so that an upload
        # from another thread does not queue behind the solve's kernels
        self._stage_stream = (
            torch.cuda.Stream(self.device)
            if not abstract and self.device.type == "cuda" else None)

    # ------------------------------------------------------------------ #
    # data movement helpers (host side)
    # ------------------------------------------------------------------ #
    @property
    def tomo_pad(self) -> int:
        return self.plan.proj.n_cols_pad

    @property
    def sino_pad(self) -> int:
        return self.plan.proj.n_rows_pad

    def pack_tomo(self, x_nat):
        """[n_vox, Y] natural order -> [tomo_pad, Y] stored (Hilbert)
        order, as numpy float32."""
        n = self.plan.geo.n_vox
        out = np.zeros((self.tomo_pad, x_nat.shape[1]), np.float32)
        pos = self.plan.col_pos
        dst = slice(None, n) if pos is None else pos[:n]
        out[dst] = np.asarray(x_nat)[self.plan.col_perm]
        return out

    def unpack_tomo(self, x_curve):
        g = self.plan.geo
        if self._rank_cols is None:
            pos = self.plan.col_pos
            stored = (
                np.arange(g.n_vox) if pos is None else pos[: g.n_vox]
            )
            rank = np.empty(g.n_vox, np.int64)
            rank[self.plan.col_perm] = stored
            self._rank_cols = rank
        return np.asarray(x_curve)[self._rank_cols]

    def pack_sino(self, y_nat):
        n = self.plan.geo.n_rays
        out = np.zeros((self.sino_pad, y_nat.shape[1]), np.float32)
        pos = self.plan.row_pos
        dst = slice(None, n) if pos is None else pos[:n]
        out[dst] = np.asarray(y_nat)[self.plan.row_perm]
        return out

    def unpack_sino(self, y_curve):
        g = self.plan.geo
        if self._rank_rows is None:
            pos = self.plan.row_pos
            stored = (
                np.arange(g.n_rays) if pos is None else pos[: g.n_rays]
            )
            rank = np.empty(g.n_rays, np.int64)
            rank[self.plan.row_perm] = stored
            self._rank_rows = rank
        return np.asarray(y_curve)[self._rank_rows]

    def _upload(self, a, device=None) -> torch.Tensor:
        """Host numpy or tensor -> tensor on ``device`` (default rank 0's)
        through pinned memory, without blocking the host (the copy is
        ordered on the current stream)."""
        device = self.device if device is None else device
        t = (a.contiguous() if isinstance(a, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(a)))
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    def _runs(self, g: int) -> list:
        """``[(device, ranks)]``: batch group ``g``'s runs of consecutive
        ranks on one device, in rank order (each a block of a
        :class:`Sharded` vector)."""
        runs = []
        for d in self.groups[g]:
            if runs and runs[-1][0] == d:
                runs[-1][1] += 1
            else:
                runs.append([d, 1])
        return [tuple(r) for r in runs]

    def _blocks(self, shape):
        """``(device, ranks, rows, cols)`` of each block of a ``[pad, Y]``
        vector, group major: a run of ranks ``p .. p + ranks - 1`` of
        group ``g`` holds their row chunks of group ``g``'s columns on
        their device."""
        n, y = shape
        per_rank = n // len(self.devices)
        per_group = y // self.n_batch
        for g in range(self.n_batch):
            p = 0
            for d, r in self._runs(g):
                yield (d, r, slice(p * per_rank, (p + r) * per_rank),
                       slice(g * per_group, (g + 1) * per_group))
                p += r

    def _sharded(self, shape, make) -> Sharded:
        """A ``[pad, Y]`` :class:`Sharded` whose blocks are
        ``make(device, rows, cols)``."""
        blocks = list(self._blocks(shape))
        return Sharded([make(d, rows, cols) for d, _, rows, cols in blocks],
                       [r for _, r, _, _ in blocks], self.n_batch)

    def _shard(self, a) -> Sharded:
        """Host ``[pad, Y]`` -> :class:`Sharded`: each block uploaded
        straight to its ranks' device."""
        a = np.asarray(a)
        return self._sharded(a.shape, lambda d, rows, cols: self._upload(
            a[rows, cols], d))

    def _download(self, v: Sharded) -> np.ndarray:
        """A sharded vector joined on the host, once."""
        return v.cpu().numpy()

    # ------------------------------------------------------------------ #
    # device arrays
    # ------------------------------------------------------------------ #
    def _device_arrays(self, devices, ranks_of=None) -> list:
        """One dict per rank: shard ``p`` of every operator array (and of
        the exchange's tables) on ``devices[i]``, for ``p = ranks_of[i]``
        (default: rank ``i``).  The scatter tables are bound as
        :class:`~repro_torch.dist.collectives.ScatterPasses`."""
        pol = self.policy
        mode = self.cfg.comm_mode
        topo = self.topology
        fast = topo.levels[0].size if topo.levels else 1
        ranks_of = list(range(len(devices))) if ranks_of is None else ranks_of
        self._socket_rows: dict = {}  # static W per operator (hier-sparse)
        ranks = [{} for _ in devices]
        for name, op in (("proj", self.plan.proj), ("back", self.plan.back)):
            if op.winsegs is not None and op.segoff is not None:
                segs, off = op.winsegs, op.segoff
            else:  # plans carried without tables: build both now
                segs, off = sort_segments_by_class(
                    winmap_segments(op.winmap), op.winmap.shape[-1]
                )
            # scatter tables: (table, limit) -- slots at or past the limit
            # are padding (the reference's trash row or mode="drop")
            tables, scatters = {}, {
                "row_map": (op.row_map, op.n_rows_pad)
            }
            if mode == "sparse":
                tables["send"], recv, _ = build_sparse_exchange(op)
                scatters["recv"] = (recv, op.rows_per_dev)
            elif mode == "hier-sparse":
                smap, send, recv, w, _ = build_hier_sparse_exchange(op, fast)
                self._socket_rows[name] = w
                tables["send"] = send
                scatters.update(smap=(smap, fast * w),
                                recv=(recv, op.rows_per_dev))
            for arrs, dev, p in zip(ranks, devices, ranks_of):
                def up(a, dev=dev):
                    return self._upload(a, dev)

                arrs[f"{name}_inds"] = up(op.inds[p])
                if pol.quantized:
                    # pack once at bind time, on the host: int8/fp8 values
                    # and per-(block, stage) power-of-two dequant exponents
                    # the kernel applies inline
                    q, exp = quantize_block_vals(
                        torch.from_numpy(op.vals[p]), pol.vals_dtype
                    )
                    arrs[f"{name}_vals"] = up(q)
                    arrs[f"{name}_vscale"] = up(exp)
                else:
                    arrs[f"{name}_vals"] = up(op.vals[p]).to(pol.storage)
                arrs[f"{name}_winmap"] = up(op.winmap[p])
                arrs[f"{name}_winsegs"] = up(segs[p].astype(np.int32))
                arrs[f"{name}_segoff"] = up(off[p].astype(np.int32))
                for key, table in tables.items():
                    arrs[f"{name}_{key}"] = up(table[p].astype(np.int64))
                for key, (table, limit) in scatters.items():
                    sp = ScatterPasses.build(table[p], limit)
                    arrs[f"{name}_{key}"] = dataclasses.replace(
                        sp, first=up(sp.first), dst=up(sp.dst),
                        src=up(sp.src))
        return ranks

    def _fake_arrays(self, devices, ranks_of=None) -> list:
        """:meth:`_device_arrays` in fake tensors: the same keys, shapes
        and dtypes on each rank's placeholder, nothing allocated.  On a
        real plan the exchange tables and the scatter passes are built on
        the host as the real bind builds them, and bound as fakes of their
        shapes.  On an ``estimate_plan`` plan the tables take their
        estimated shapes and each scatter table is one pass over its
        slots, as the reference's one scatter op: the real pass count
        depends on the tables' values."""
        pol = self.policy
        mode = self.cfg.comm_mode
        topo = self.topology
        fast = topo.levels[0].size if topo.levels else 1
        n_slow = max(1, topo.n_data // fast)
        ranks_of = list(range(len(devices))) if ranks_of is None else ranks_of
        real = isinstance(self.plan.proj.row_map, np.ndarray)
        self._socket_rows: dict = {}
        # per operator: {key: (dtype, shape)} of the plain tensors, and
        # {key: per-rank host ScatterPasses or (slots, rows)}
        plain, passes = {}, {}
        for name, op in (("proj", self.plan.proj), ("back", self.plan.back)):
            _, b, s, r, k = op.inds.shape
            buf = op.winmap.shape[-1]
            if op.winsegs is not None and op.segoff is not None:
                segs, off = op.winsegs.shape[1:], op.segoff.shape[1:]
            else:  # plans carried without tables: build both now
                segs, off = (t.shape[1:] for t in sort_segments_by_class(
                    winmap_segments(op.winmap), buf))
            vals = pol.vals_dtype if pol.quantized else pol.storage
            plain[name] = {"inds": (torch.int16, (b, s, r, k)),
                           "vals": (vals, (b, s, r, k)),
                           "winmap": (torch.int32, (b, s, buf)),
                           "winsegs": (torch.int32, segs),
                           "segoff": (torch.int32, off)}
            if pol.quantized:
                plain[name]["vscale"] = (torch.int32, (b, s))
            tables = {"row_map": (op.row_map, op.n_rows_pad)}
            if mode == "sparse":
                if real:
                    send, recv, _ = build_sparse_exchange(op)
                    send = send.shape[1:]
                else:
                    send = recv = (op.inds.shape[0],
                                   int(getattr(op, "est_v", 8)))
                plain[name]["send"] = (torch.int64, send)
                tables["recv"] = (recv, op.rows_per_dev)
            elif mode == "hier-sparse":
                if real:
                    smap, send, recv, w, _ = build_hier_sparse_exchange(
                        op, fast)
                    send = send.shape[1:]
                else:
                    w, v2 = estimate_hier_sparse(op, fast, n_slow)
                    smap, send = (op.flat_rows,), (n_slow, v2)
                    recv = send
                self._socket_rows[name] = w
                plain[name]["send"] = (torch.int64, send)
                tables.update(smap=(smap, fast * w),
                              recv=(recv, op.rows_per_dev))
            passes[name] = {}
            for key, (table, rows) in tables.items():
                if real:
                    passes[name][key] = [ScatterPasses.build(table[p], rows)
                                         for p in ranks_of]
                else:
                    shape = table.shape[1:] if key == "row_map" else table
                    passes[name][key] = (int(np.prod(shape)), rows)
        trace = self._trace
        ranks = [{} for _ in devices]
        with trace.binding():
            for i, (arrs, dev) in enumerate(zip(ranks, devices)):
                def fake(shape, dtype, dev=dev):
                    return trace.empty(shape, dtype, dev)

                for name in ("proj", "back"):
                    for key, (dtype, shape) in plain[name].items():
                        arrs[f"{name}_{key}"] = fake(shape, dtype)
                    for key, host in passes[name].items():
                        if real:
                            sp = host[i]
                            shapes = (sp.first.shape, sp.dst.shape,
                                      sp.src.shape)
                            meta = dict(bounds=sp.bounds, rows=sp.rows,
                                        trash=sp.trash)
                        else:
                            slots, rows = host
                            shapes = ((slots,), (0,), (0,))
                            meta = dict(bounds=(0,), rows=rows, trash=0)
                        first, dst, src = (fake(sh, torch.int64)
                                           for sh in shapes)
                        arrs[f"{name}_{key}"] = ScatterPasses(
                            first=first, dst=dst, src=src, **meta)
        return ranks

    def argument_bytes(self) -> list:
        """Bytes of the tensors bound to each rank (each storage once),
        in rank order, batch group major: the abstract argument bytes of
        :meth:`lower_cg`, and on a real reconstructor what the ranks hold
        on their devices."""
        return [storage_bytes(_bound_tensors(a))
                for g in range(self.n_batch) for a in self._group_arrays(g)]

    def _group_arrays(self, g: int) -> list:
        """Batch group ``g``'s per-rank arrays: group 0's wherever its rank
        shares group 0's device."""
        return [
            self._arrays[p] if d == self.devices[p] else self._other[p, d]
            for p, d in enumerate(self.groups[g])
        ]

    def scatter_depths(self) -> dict:
        """``{"<op>_<table>": (largest multiplicity over the ranks, passes
        summed over the ranks)}`` of the bound scatter tables: the
        multiplicity is a pass count, each pass one gather and one
        ``index_add_`` per minibatch and application."""
        out = {}
        for key, t in self._arrays[0].items():
            if isinstance(t, ScatterPasses):
                depths = [a[key].depth for a in self._arrays]
                out[key] = (max(depths), sum(depths))
        return out

    # ------------------------------------------------------------------ #
    # per-rank compute
    # ------------------------------------------------------------------ #
    def _make_ops(self, g: int = 0):
        """Closures (project, backproject, dot_rows) over batch group
        ``g``'s ranks, on its :class:`Sharded` vectors (each rank's row
        chunk on the rank's device)."""
        cfg, pol, ranks = self.cfg, self.policy, self._group_arrays(g)
        devices = self.groups[g]
        blocks = [r for _, r in self._runs(g)]
        firsts = np.cumsum([0] + blocks[:-1])  # each block's first rank
        sparse = cfg.comm_mode in _SPARSE_MODES
        hier = cfg.comm_mode == "hier-sparse"
        streams = [self._side[d] for d in dict.fromkeys(devices)
                   if d in self._side]

        def one_operator(prefix, op):
            rows_out = op.rows_per_dev

            def kernel(x_f):
                """The kernel phase: each rank's SpMM on its row chunk of
                the minibatch's blocks, yielding the ranks' bands."""
                x_f = Sharded(x_f, blocks).rank_views()
                return [
                    apply_operator(
                        a[f"{prefix}_inds"],
                        a[f"{prefix}_vals"],
                        a[f"{prefix}_winmap"],
                        x_p,
                        storage_dtype=pol.storage,
                        compute_dtype=pol.compute,
                        use_ref=cfg.use_ref,
                        staging=cfg.staging,
                        dma=cfg.dma,
                        winsegs=a[f"{prefix}_winsegs"],
                        segoff=a[f"{prefix}_segoff"],
                        smem_budget=cfg.smem_budget,
                        scales=a.get(f"{prefix}_vscale"),
                    )
                    for a, x_p in zip(ranks, x_f)
                ]

            def reduce(bands):
                """The reduce phase: the ranks' bands -> the owned chunks
                [rows_per_dev, F] of the ranks of each block, on its
                device."""
                bandc, inv = qcast(bands, pol.comm, adaptive=pol.adaptive)
                if sparse:
                    chunks = sparse_exchange(
                        bandc,
                        [a[f"{prefix}_send"] for a in ranks],
                        [a[f"{prefix}_recv"] for a in ranks],
                        self.topology,
                        rows_out,
                        socket_passes=(
                            [a[f"{prefix}_smap"] for a in ranks]
                            if hier else None
                        ),
                        socket_rows=(
                            self._socket_rows[prefix] if hier else None
                        ),
                        wire=cfg.wire,
                    )
                else:
                    # scatter-ADD: split rows (virtual-row packing) may
                    # map several band slots onto one row, added in the
                    # reference's order; padding slots are not in the
                    # passes
                    fulls = [ordered_index_add(a[f"{prefix}_row_map"], b)
                             for a, b in zip(ranks, bandc)]
                    chunks = self.comm_plan.reduce_partials(fulls)
                # the ranks share the group's factor: one per block
                return [b.to(torch.float32) * inv[i] for b, i in zip(
                    Sharded.pack(chunks, blocks).parts, firsts)]

            narrow = pol.storage_bytes < 4 or pol.compute.itemsize < 4

            def apply(x_all: Sharded) -> Sharded:
                xs, inv = list(x_all.parts), None
                if narrow:
                    # Paper III-C1: renormalize the evolving iterate per
                    # slice before every (back)projection so the fp16
                    # accumulation never under/overflows; one factor per
                    # slice for all ranks (the group's max over its
                    # blocks, as the reference's pmax over its ranks).
                    s = adaptive_scale_cols(xs, 1.0)
                    xs = [(x.to(torch.float32) * f).to(pol.storage)
                          for x, f in zip(xs, s)]
                    inv = [1.0 / f for f in s]
                out = pipelined_apply(
                    kernel, reduce, xs, cfg.fuse, overlap=cfg.overlap,
                    streams=streams,
                )
                if inv is not None:
                    out = [o * i for o, i in zip(out, inv)]
                return Sharded(out, blocks)

            return apply

        project = one_operator("proj", self.plan.proj)
        backproject = one_operator("back", self.plan.back)

        @copy_kind("psum")
        def dot_rows(u: Sharded, v: Sharded) -> Sharded:
            # Scalar reductions always in f32: a half-mode dot over 1e6+
            # entries overflows f16's 65504 range.  Each rank sums its
            # rows, then the ranks' sums add in rank order (the
            # reference's local sum + psum over the data axes).  The f32
            # products are summed in f64 and the sum rounded once, on
            # rank 0, and placed on every block: PyTorch's row sums
            # reduce in an order that depends on the column count, and
            # an f32 sum would carry that order into the CG's last bits,
            # which 8 iterations amplify to 1e-2 (a streamed slab against
            # the full volume)
            partials = []
            for a, b, r in zip(u.parts, v.parts, u.ranks):
                prod = a.to(torch.float32) * b.to(torch.float32)
                if r == 1:
                    partials.append(torch.sum(prod, dim=0,
                                              dtype=torch.float64))
                else:  # one row sum per rank of the block
                    partials += prod.reshape(r, -1, prod.shape[-1]).sum(
                        dim=1, dtype=torch.float64).unbind(0)
            total = partials[0]
            for t in partials[1:]:
                total = total + t.to(total.device)
            total = total.to(torch.float32)
            return Sharded([total.to(b.device) for b in u.parts], u.ranks)

        return project, backproject, dot_rows

    # ------------------------------------------------------------------ #
    # public API (natural-order numpy in/out)
    # ------------------------------------------------------------------ #
    def _check_slices(self, y: int):
        per = self.n_batch * self.cfg.fuse
        if y % per:
            raise ValueError(
                f"slice count {y} must be a multiple of batch x fuse = {per}"
            )

    def _by_group(self, fn, *vectors):
        """Run ``fn(g, *blocks)`` for every batch group on its blocks of
        the :class:`Sharded` ``vectors`` (already on the group's
        devices); the groups' results join into one :class:`Sharded`
        each.  ``fn`` returns one :class:`Sharded` or a tuple of them."""
        outs = [fn(g, *(v.group(g) for v in vectors))
                for g in range(self.n_batch)]
        if isinstance(outs[0], tuple):
            return tuple(Sharded.join(o) for o in zip(*outs))
        return Sharded.join(outs)

    def _concrete(self):
        if self.abstract:
            raise ValueError(
                "an abstract Reconstructor holds fake tensors: it only "
                "lowers (lower_cg)"
            )

    def _apply(self, which: str, packed: np.ndarray) -> np.ndarray:
        self._concrete()

        def one(g, x):
            proj, back, _ = self._make_ops(g)
            op = proj if which == "project" else back
            return op(x).to(torch.float32)

        x = self._shard(packed).to(self.policy.storage)
        with torch.no_grad():
            out = self._by_group(one, x)
        return self._download(out)

    def project(self, x_nat):
        """[n_vox, Y] -> [n_rays, Y] forward projection."""
        self._check_slices(x_nat.shape[1])
        return self.unpack_sino(self._apply("project", self.pack_tomo(x_nat)))

    def backproject(self, y_nat):
        """[n_rays, Y] -> [n_vox, Y] back projection (A^T)."""
        self._check_slices(y_nat.shape[1])
        return self.unpack_tomo(
            self._apply("backproject", self.pack_sino(y_nat))
        )

    def stage_sino(self, sino_nat) -> StagedSlab:
        """Pack + normalize + upload one sinogram slab (host -> device).

        Each rank's rows of its group's columns go straight to its
        device.  The copies go through pinned host memory on a CUDA
        stream of the reconstructor's own (so a prefetch thread's upload
        runs beside the solve on the device's default stream); this
        method then waits for that stream alone, so the caller's timing
        is honest and the slab is on the device when it returns.
        """
        self._concrete()
        self._check_slices(sino_nat.shape[1])
        with obs_span("recon/stage", slices=int(sino_nat.shape[1])):
            y = self.pack_sino(sino_nat)
            m = np.abs(y).max(axis=0)
            # target 1.0: keeps every CG vector (and the fp16 CG scalars)
            # O(n * K) at most, inside half range for any practical
            # geometry
            scale = np.exp2(
                np.round(np.log2(1.0 / np.maximum(m, 1e-30)))
            ).astype(np.float32)
            if self._stage_stream is None:
                y_dev = self._shard(y * scale)
            else:
                with torch.cuda.stream(self._stage_stream):
                    y_dev = self._shard(y * scale)
                self._stage_stream.synchronize()
        return StagedSlab(
            y=y_dev, scale=scale, n_slices=int(sino_nat.shape[1])
        )

    def reconstruct(self, sino_nat, iters: int = 30, x0_nat=None):
        """CGNR solve; returns ``(x [n_vox, Y], resnorms [iters, Y])``.

        Inputs are normalized per slice by a power-of-two factor so
        narrow-precision iterates stay in range; the solution scales back
        exactly.  ``sino_nat`` may be a pre-staged :class:`StagedSlab`.

        Raises :class:`~repro_torch.resil.errors.NonFiniteSolveError` when
        the solution contains NaN/Inf (a blown-up narrow-precision solve,
        or a ``nonfinite`` fault injected at ``recon/solve``).
        """
        staged = (
            sino_nat
            if isinstance(sino_nat, StagedSlab)
            else self.stage_sino(sino_nat)
        )
        for t in staged.y.parts:
            if t.device.type == "cuda":
                # staged on the staging stream, read on this one: the
                # caching allocator must not hand its memory out again
                # before this stream is done with it
                t.record_stream(torch.cuda.current_stream(t.device))
        scale = staged.scale
        x0 = (
            self.pack_tomo(x0_nat) * scale
            if x0_nat is not None
            else np.zeros((self.tomo_pad, staged.n_slices), np.float32)
        )
        with obs_span(
            "recon/solve", iters=iters, slices=staged.n_slices
        ) as sp:
            with torch.no_grad():
                x, res = self._solve(staged.y, self._shard(x0), iters)
            # the span ends when the devices are done
            sp.fence((x.parts, res.parts))
        self._emit_exchange(iters, staged.n_slices)
        x_nat = self.unpack_tomo(self._download(x)) / scale
        # the resilience guard: a blown-up solve (or an injected
        # nonfinite fault) surfaces as a typed error the caller can
        # retry or escalate, never as NaNs in the volume
        x_nat = inject.mutate(
            "recon/solve", x_nat, ctx={"precision": self.cfg.precision}
        )
        if not np.isfinite(x_nat).all():
            n_bad = int(x_nat.size - np.isfinite(x_nat).sum())
            raise NonFiniteSolveError(
                f"solve produced {n_bad} non-finite value(s) over "
                f"{staged.n_slices} slices "
                f"(precision={self.cfg.precision})"
            )
        return x_nat, self._download(res.first_ranks()) / scale

    def _solve(self, y: Sharded, x0: Sharded, iters: int):
        """The CG solve of every batch group on ``y`` and ``x0`` ([pad,
        Y], sharded): ``(x, resnorms)`` in f32, ``resnorms`` the same
        ``[iters, Y]`` on every block of a group."""
        pol = self.policy

        def solve(g, y, x0):
            proj, back, dot = self._make_ops(g)
            x, res = cgnr(
                proj, back, y, x0, iters, dot,
                compute_dtype=pol.compute, storage_dtype=pol.storage,
            )
            return x.to(torch.float32), res.to(torch.float32)

        return self._by_group(solve, y, x0)

    def lower_cg(self, y_slices: int, iters: int) -> LoweredCG:
        """Dry-run the CG solve on fake tensors (``abstract=True``).

        Runs :meth:`reconstruct`'s solve -- the same ``cgnr`` through
        ``_make_ops``, rank loop, exchange and kernels' fakes -- on a fake
        ``y [sino_pad, Y]`` and ``x0 [tomo_pad, Y]`` sharded as the real
        solve's (each rank's block on its placeholder), and returns the
        trace's :class:`LoweredCG`: the bound bytes of every rank, the
        inputs, outputs and peak of every device, and every copy between
        devices.  Nothing is allocated and no kernel is launched.
        """
        if not self.abstract:
            raise ValueError("lower_cg traces a Reconstructor(..., "
                             "abstract=True)")
        self._check_slices(y_slices)
        trace = self._trace
        ranks = [(d, a) for g in range(self.n_batch)
                 for d, a in zip(self.groups[g], self._group_arrays(g))]
        bound: dict = {}
        for d, a in ranks:
            bound.setdefault(d, {}).update(
                {id(t.untyped_storage()): t for t in _bound_tensors(a)})

        def fake(rows):
            return self._sharded((rows, y_slices), lambda d, r, c: trace.empty(
                (r.stop - r.start, c.stop - c.start), torch.float32, d))

        def per_device(*vectors):
            on: dict = {}
            for v in vectors:
                for d, t in zip(devs, v.parts):
                    on.setdefault(d, []).append(t)
            return {d: storage_bytes(ts) for d, ts in on.items()}

        devs = [d for g in range(self.n_batch) for d, _ in self._runs(g)]
        with trace.running([t for ts in bound.values()
                            for t in ts.values()]):
            y, x0 = fake(self.sino_pad), fake(self.tomo_pad)
            inputs = per_device(y, x0)
            x, res = self._solve(y, x0, iters)
            outputs = per_device(x, res)
            peak = dict(trace.peak)
        notes = []
        if not isinstance(self.plan.proj.row_map, np.ndarray):
            notes.append("estimate_plan: every scatter table is one pass "
                         "over its slots; the real pass count depends on "
                         "the tables' values")
        return LoweredCG(
            y_slices=y_slices, iters=iters,
            devices=[d for d, _ in ranks],
            argument=self.argument_bytes(),
            bound={d: storage_bytes(ts.values()) for d, ts in bound.items()},
            input=inputs, output=outputs, peak=peak,
            copies=list(trace.copies), notes=notes,
        )

    def _emit_exchange(self, iters: int, n_slices: int):
        """Annotate a finished solve with its modeled wire traffic.

        Host spans do not time the exchanges inside the solve, so when
        tracing is on a ``recon/exchange`` instant carries the *modeled*
        per-link bytes of the whole solve (``launch.xct_perf.comm_volume``
        per fused minibatch, x ``iters + 1`` operator applications, the
        same pricing the autotuner and ``obs.drift`` use) and bumps the
        ``comm_bytes_total{link=}`` / ``dma_issues_total`` counters.
        """
        tracer = obs_trace.get_tracer()
        if not tracer.enabled:
            return
        per_mini = getattr(self, "_obs_traffic", None)
        if per_mini is None:
            from ..kernels.traffic import (
                op_segments_per_stage,
                spmm_traffic,
            )
            from ..launch.xct_perf import comm_volume

            wire = comm_volume(
                self.plan, self.cfg.comm_mode, self.cfg.fuse,
                self.policy.comm_bytes, self.topology,
                wire=self.cfg.wire,
            )
            issues = 0.0
            for op in (self.plan.proj, self.plan.back):
                _, b, s, r, k = op.inds.shape
                issues += spmm_traffic(
                    b, s, r, k, op.winmap.shape[-1], self.cfg.fuse,
                    storage_bytes=self.policy.storage_bytes,
                    vals_bytes=self.policy.vals_bytes,
                    staging=self.cfg.staging,
                    dma=self.cfg.dma,
                    segments_per_stage=op_segments_per_stage(op),
                )["dma_issues"]
            per_mini = self._obs_traffic = {
                "ici": wire["ici"], "dci": wire["dci"],
                "dma_issues": issues,
            }
        minis = n_slices // (self.n_batch * self.cfg.fuse)
        apps = iters + 1  # CGNR: initial A/A^T pair + one per iteration
        scale = minis * apps
        tracer.instant(
            "recon/exchange",
            ici_bytes=per_mini["ici"] * scale,
            dci_bytes=per_mini["dci"] * scale,
            iters=iters,
            slices=n_slices,
        )
        obs_metrics.inc(
            "comm_bytes_total", per_mini["ici"] * scale, link="ici"
        )
        obs_metrics.inc(
            "comm_bytes_total", per_mini["dci"] * scale, link="dci"
        )
        obs_metrics.inc(
            "dma_issues_total", per_mini["dma_issues"] * scale, op="spmm"
        )
