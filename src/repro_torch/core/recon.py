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
(``dist.DeviceMesh``).  The vectors are split as the reference's
``P(data_axes, batch_axes)``: their columns (slices) contiguously over
the batch groups, each group a full set of data ranks that runs its own
CG solve on its columns; within a group rank ``p`` holds shard ``p`` of
every operator array on its mesh device, and the group's CG vectors stay
on its rank 0's device, split by rank into row chunks for the kernels.
Without a topology the reconstructor has one rank on ``device``.

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
from .partition import Plan, build_hier_sparse_exchange, build_sparse_exchange
from .pipeline import pipelined_apply, side_streams
from .precision import (
    adaptive_scale_cols,
    get_policy,
    qcast,
    quantize_block_vals,
)
from .solver import cgnr

__all__ = ["ReconConfig", "Reconstructor", "StagedSlab", "resolve_device"]

_SPARSE_MODES = ("sparse", "hier-sparse")


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

    y: torch.Tensor  # [sino_pad, Y] f32 on rank 0's device, pre-scaled
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
    """

    def __init__(self, plan: Plan, cfg: ReconConfig = ReconConfig(),
                 device=None, *, topology: Topology | None = None):
        if topology is None:
            mesh = DeviceMesh([[resolve_device(device)]], ("data", "model"))
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
        # the data ranks' devices of each batch group; group 0's rank 0
        # holds the global vectors
        self.groups = [topology.rank_devices(b) for b in range(self.n_batch)]
        self.devices = self.groups[0]
        self.device = self.devices[0]
        self.policy = get_policy(cfg.precision)
        self._rank_rows = None  # lazy inverse row permutation
        self._rank_cols = None
        self._arrays = self._device_arrays(self.devices)
        # the reduce phase's side CUDA streams, one per distinct device,
        # shared by the ranks and batch groups on it
        self._side = (side_streams(d for g in self.groups for d in g)
                      if cfg.overlap else {})
        # stage_sino's uploads: a stream of their own, so that an upload
        # from another thread does not queue behind the solve's kernels
        self._stage_stream = (torch.cuda.Stream(self.device)
                              if self.device.type == "cuda" else None)
        # another group's rank on a device of its own binds its own copy
        self._other = {
            (p, d): self._device_arrays([d], [p])[0]
            for group in self.groups[1:]
            for p, d in enumerate(group) if d != self.devices[p]
        }

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

    def _download(self, t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu").numpy()

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
        ``g``'s ranks; its vectors are global on its rank 0's device."""
        cfg, pol, ranks = self.cfg, self.policy, self._group_arrays(g)
        devices = self.groups[g]
        dev0 = devices[0]
        n_ranks = len(ranks)
        sparse = cfg.comm_mode in _SPARSE_MODES
        hier = cfg.comm_mode == "hier-sparse"
        streams = [self._side[d] for d in dict.fromkeys(devices)
                   if d in self._side]

        def split(x, rows):
            """Global [n * rows, F] -> per-rank row chunks on their
            devices (views when a rank shares rank 0's device)."""
            return [x[p * rows:(p + 1) * rows].to(d)
                    for p, d in enumerate(devices)]

        def gather(chunks):
            """Owned chunks, rank order -> one tensor on rank 0's device."""
            if n_ranks == 1:
                return chunks[0].to(dev0)
            return torch.cat([c.to(dev0) for c in chunks], dim=0)

        def one_operator(prefix, op):
            rows_out, cols = op.rows_per_dev, op.cols_per_dev

            def kernel(x_f):
                """The kernel phase: each rank's SpMM on its column
                chunk, yielding the ranks' bands."""
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
                    for a, x_p in zip(ranks, split(x_f, cols))
                ]

            def reduce(bands):
                """The reduce phase: the ranks' bands -> the global owned
                output [n_rows_pad, F] on rank 0's device."""
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
                return gather(chunks).to(torch.float32) * inv[0]

            narrow = pol.storage_bytes < 4 or pol.compute.itemsize < 4

            def apply(x_all):
                inv = None
                if narrow:
                    # Paper III-C1: renormalize the evolving iterate per
                    # slice before every (back)projection so the fp16
                    # accumulation never under/overflows; one factor per
                    # slice for all ranks.
                    s = adaptive_scale_cols(x_all, 1.0)
                    x_all = (x_all.to(torch.float32) * s).to(pol.storage)
                    inv = 1.0 / s
                out = pipelined_apply(
                    kernel, reduce, x_all, cfg.fuse, overlap=cfg.overlap,
                    streams=streams,
                )
                return out if inv is None else out * inv

            return apply

        project = one_operator("proj", self.plan.proj)
        backproject = one_operator("back", self.plan.back)

        def dot_rows(u, v):
            # Scalar reductions always in f32: a half-mode dot over 1e6+
            # entries overflows f16's 65504 range.  The group's vectors
            # are global, so this sums the rows of its data ranks only
            # (the reference's local sum + psum over the data axes, in
            # another order).  The f32 products are summed in f64 and the
            # sum rounded once: PyTorch's row sums reduce in an order that
            # depends on the column count, and an f32 sum would carry
            # that order into the CG's last bits, which 8 iterations
            # amplify to 1e-2 (a streamed slab against the full volume)
            return torch.sum(u.to(torch.float32) * v.to(torch.float32), dim=0,
                             dtype=torch.float64).to(torch.float32)

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
        """Run ``fn(g, *columns)`` for every batch group on its columns of
        ``vectors`` (global on rank 0's device), moved to the group's
        device; the groups' results join along the columns on rank 0's
        device.  ``fn`` returns one tensor or a tuple of them."""
        outs = []
        for g, group in enumerate(self.groups):
            cols = [v.tensor_split(self.n_batch, dim=1)[g].to(group[0])
                    for v in vectors]
            outs.append(fn(g, *cols))
        if self.n_batch == 1:
            return outs[0]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat([o[i].to(self.device) for o in outs], 1)
                         for i in range(len(outs[0])))
        return torch.cat([o.to(self.device) for o in outs], dim=1)

    def _apply(self, which: str, packed: np.ndarray) -> np.ndarray:
        def one(g, x):
            proj, back, _ = self._make_ops(g)
            op = proj if which == "project" else back
            return op(x).to(torch.float32)

        x = self._upload(packed).to(self.policy.storage)
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

        The copy goes through pinned host memory on a CUDA stream of the
        reconstructor's own (so a prefetch thread's upload runs beside
        the solve on the device's default stream); this method then
        waits for that stream alone, so the caller's timing is honest and
        the slab is on the device when it returns.
        """
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
                y_dev = self._upload(y * scale)
            else:
                with torch.cuda.stream(self._stage_stream):
                    y_dev = self._upload(y * scale)
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
        if staged.y.device.type == "cuda":
            # staged on the staging stream, read on this one: the caching
            # allocator must not hand its memory out again before this
            # stream is done with it
            staged.y.record_stream(torch.cuda.current_stream(staged.y.device))
        scale = staged.scale
        x0 = (
            self.pack_tomo(x0_nat) * scale
            if x0_nat is not None
            else np.zeros((self.tomo_pad, staged.n_slices), np.float32)
        )
        pol = self.policy

        def solve(g, y, x0):
            proj, back, dot = self._make_ops(g)
            x, res = cgnr(
                proj, back, y, x0, iters, dot,
                compute_dtype=pol.compute, storage_dtype=pol.storage,
            )
            return x.to(torch.float32), res.to(torch.float32)

        with obs_span(
            "recon/solve", iters=iters, slices=staged.n_slices
        ) as sp:
            with torch.no_grad():
                x, res = self._by_group(solve, staged.y, self._upload(x0))
            sp.fence((x, res))  # the span ends when the device is done
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
        return x_nat, self._download(res) / scale

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
