"""End-to-end XCT reconstruction on one GPU (the paper's system, in PyTorch).

``Reconstructor`` binds a partition plan to one device and exposes
``project`` / ``backproject`` / ``reconstruct``.  Every operator
application runs per slice-minibatch: blocked-ELL SpMM (the CUDA kernel,
or its plain version on the CPU) -> cast to the wire dtype with adaptive
normalization -> scatter-add of the band into the owned rows -> CGNR
update.  With one device the partial-data reduction of the ``direct``,
``rs`` and ``hier`` modes is that local scatter-add; the sparse exchanges
and ``n_data > 1`` come with the multi-GPU exchange (ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.ops import (
    apply_operator,
    check_supported,
    sort_segments_by_class,
    winmap_segments,
)
from ..resil.errors import NonFiniteSolveError
from .partition import Plan
from .pipeline import pipelined_apply
from .precision import (
    adaptive_scale_cols,
    get_policy,
    qcast,
    quantize_block_vals,
)
from .solver import cgnr

__all__ = ["ReconConfig", "Reconstructor", "StagedSlab", "resolve_device"]

# partial-data reductions that are a local scatter-add on one device
_LOCAL_MODES = ("direct", "rs", "hier")
_MULTI_GPU = "ROADMAP.md queue 1, the multi-GPU exchange"


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

    y: torch.Tensor  # [sino_pad, Y] f32 on the device, pre-scaled
    scale: np.ndarray  # [Y] power-of-two per-slice normalization
    n_slices: int


@dataclasses.dataclass(frozen=True)
class ReconConfig:
    precision: str = "mixed"  # paper ladder: double|single|half|mixed
    #   (+bf16 variants, +q8/fp8 quantized-operator tiers)
    comm_mode: str = "hier"  # direct | rs | hier (sparse modes: multi-GPU)
    wire: str = "native"  # hier-sparse slow-axis wire: native | q8
    fuse: int = 16  # paper's minibatch size (FFACTOR)
    overlap: bool = True  # Fig. 8 pipelining order
    use_ref: bool = False  # oracle instead of the kernel
    staging: str = "fused"  # in-kernel window staging | gather (A/B)
    dma: str = "coalesced"  # run-length segment window staging | per_row
    # kept for the reference's field set; no effect on Hopper (see
    # kernels.ops.apply_operator)
    smem_budget: int | None = None


class Reconstructor:
    """Iterative reconstruction on one device.

    Args:
      plan: partition plan (``core.partition.build_plan``) with
        ``n_data == 1``.
      cfg: runtime configuration.
      device: ``"cuda"`` (default) or ``"cpu"``; raises when CUDA is asked
        for and absent.
      mesh: the reference's device mesh; more than one device is not
        ported yet, so anything but ``None`` raises.
    """

    def __init__(self, plan: Plan, cfg: ReconConfig = ReconConfig(),
                 device=None, *, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                f"a device mesh is not ported yet: {_MULTI_GPU}"
            )
        if plan.cfg.n_data != 1:
            raise NotImplementedError(
                f"plan has n_data={plan.cfg.n_data}; more than one device "
                f"is not ported yet: {_MULTI_GPU}"
            )
        if cfg.comm_mode not in _LOCAL_MODES:
            raise NotImplementedError(
                f"comm_mode={cfg.comm_mode!r} is not ported yet "
                f"({_MULTI_GPU}); one device runs {_LOCAL_MODES}"
            )
        if cfg.wire != "native":
            raise NotImplementedError(
                f"wire={cfg.wire!r} compresses the hier-sparse hop, not "
                f"ported yet: {_MULTI_GPU}"
            )
        check_supported(cfg.staging, cfg.dma)
        self.plan = plan
        self.cfg = cfg
        self.device = resolve_device(device)
        self.policy = get_policy(cfg.precision)
        self._rank_rows = None  # lazy inverse row permutation
        self._rank_cols = None
        self._arrays = self._device_arrays()

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

    def _upload(self, a) -> torch.Tensor:
        """Host numpy or tensor -> device tensor through pinned memory,
        without blocking the host (the copy is ordered on the current
        stream)."""
        t = (a.contiguous() if isinstance(a, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(a)))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _download(self, t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu").numpy()

    # ------------------------------------------------------------------ #
    # device arrays
    # ------------------------------------------------------------------ #
    def _device_arrays(self):
        pol = self.policy
        arrs = {}
        for name, op in (("proj", self.plan.proj), ("back", self.plan.back)):
            if op.winsegs is not None and op.segoff is not None:
                segs, off = op.winsegs, op.segoff
            else:  # plans carried without tables: build both now
                segs, off = sort_segments_by_class(
                    winmap_segments(op.winmap), op.winmap.shape[-1]
                )
            arrs[f"{name}_inds"] = self._upload(op.inds[0])
            if pol.quantized:
                # pack once at bind time, on the host: int8/fp8 values and
                # per-(block, stage) power-of-two dequant exponents the
                # kernel applies inline
                q, exp = quantize_block_vals(
                    torch.from_numpy(op.vals[0]), pol.vals_dtype
                )
                arrs[f"{name}_vals"] = self._upload(q)
                arrs[f"{name}_vscale"] = self._upload(exp)
            else:
                arrs[f"{name}_vals"] = self._upload(op.vals[0]).to(
                    pol.storage
                )
            arrs[f"{name}_winmap"] = self._upload(op.winmap[0])
            arrs[f"{name}_winsegs"] = self._upload(segs[0].astype(np.int32))
            arrs[f"{name}_segoff"] = self._upload(off[0].astype(np.int32))
            arrs[f"{name}_row_map"] = self._upload(
                op.row_map[0].reshape(-1).astype(np.int64)
            )
        return arrs

    # ------------------------------------------------------------------ #
    # per-device compute
    # ------------------------------------------------------------------ #
    def _make_ops(self):
        """Closures (project, backproject, dot_rows) on the device arrays."""
        cfg, pol, a = self.cfg, self.policy, self._arrays

        def one_operator(prefix, n_rows_pad):
            def kernel(x_f):
                return apply_operator(
                    a[f"{prefix}_inds"],
                    a[f"{prefix}_vals"],
                    a[f"{prefix}_winmap"],
                    x_f,
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

            idx = a[f"{prefix}_row_map"]

            def reduce(band):
                bandc, inv = qcast(band, pol.comm, adaptive=pol.adaptive)
                # scatter-ADD: split rows (virtual-row packing) may map
                # several band slots onto one row; padding slots land in
                # the trash row n_rows_pad, cut off below
                full = torch.zeros(
                    (n_rows_pad + 1, band.shape[-1]), dtype=bandc.dtype,
                    device=band.device,
                ).index_add_(0, idx, bandc)
                return full[:n_rows_pad].to(torch.float32) * inv

            narrow = pol.storage_bytes < 4 or pol.compute.itemsize < 4

            def apply(x_all):
                inv = None
                if narrow:
                    # Paper III-C1: renormalize the evolving iterate per
                    # slice before every (back)projection so the fp16
                    # accumulation never under/overflows.
                    s = adaptive_scale_cols(x_all, 1.0)
                    x_all = (x_all.to(torch.float32) * s).to(pol.storage)
                    inv = 1.0 / s
                out = pipelined_apply(
                    kernel, reduce, x_all, cfg.fuse, overlap=cfg.overlap
                )
                return out if inv is None else out * inv

            return apply

        project = one_operator("proj", self.plan.proj.n_rows_pad)
        backproject = one_operator("back", self.plan.back.n_rows_pad)

        def dot_rows(u, v):
            # Scalar reductions always in f32: a half-mode dot over 1e6+
            # entries overflows f16's 65504 range.
            return torch.sum(u.to(torch.float32) * v.to(torch.float32), dim=0)

        return project, backproject, dot_rows

    # ------------------------------------------------------------------ #
    # public API (natural-order numpy in/out)
    # ------------------------------------------------------------------ #
    def _check_slices(self, y: int):
        if y % self.cfg.fuse:
            raise ValueError(
                f"slice count {y} must be a multiple of fuse = "
                f"{self.cfg.fuse}"
            )

    def _apply(self, which: str, packed: np.ndarray) -> np.ndarray:
        proj, back, _ = self._make_ops()
        op = proj if which == "project" else back
        x = self._upload(packed).to(self.policy.storage)
        with torch.no_grad():
            out = op(x).to(torch.float32)
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

        The copy goes through pinned host memory without blocking the
        host; this method then waits for it, so the caller's timing is
        honest.
        """
        self._check_slices(sino_nat.shape[1])
        y = self.pack_sino(sino_nat)
        m = np.abs(y).max(axis=0)
        # target 1.0: keeps every CG vector (and the fp16 CG scalars)
        # O(n * K) at most, inside half range for any practical geometry
        scale = np.exp2(
            np.round(np.log2(1.0 / np.maximum(m, 1e-30)))
        ).astype(np.float32)
        y_dev = self._upload(y * scale)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return StagedSlab(
            y=y_dev, scale=scale, n_slices=int(sino_nat.shape[1])
        )

    def reconstruct(self, sino_nat, iters: int = 30, x0_nat=None):
        """CGNR solve; returns ``(x [n_vox, Y], resnorms [iters, Y])``.

        Inputs are normalized per slice by a power-of-two factor so
        narrow-precision iterates stay in range; the solution scales back
        exactly.  ``sino_nat`` may be a pre-staged :class:`StagedSlab`.

        Raises :class:`~repro_torch.resil.errors.NonFiniteSolveError` when
        the solution contains NaN/Inf.
        """
        staged = (
            sino_nat
            if isinstance(sino_nat, StagedSlab)
            else self.stage_sino(sino_nat)
        )
        scale = staged.scale
        x0 = (
            self.pack_tomo(x0_nat) * scale
            if x0_nat is not None
            else np.zeros((self.tomo_pad, staged.n_slices), np.float32)
        )
        pol = self.policy
        proj, back, dot = self._make_ops()
        with torch.no_grad():
            x, res = cgnr(
                proj, back, staged.y, self._upload(x0), iters, dot,
                compute_dtype=pol.compute, storage_dtype=pol.storage,
            )
            x = x.to(torch.float32)
            res = res.to(torch.float32)
        x_nat = self.unpack_tomo(self._download(x)) / scale
        if not np.isfinite(x_nat).all():
            n_bad = int(x_nat.size - np.isfinite(x_nat).sum())
            raise NonFiniteSolveError(
                f"solve produced {n_bad} non-finite value(s) over "
                f"{staged.n_slices} slices "
                f"(precision={self.cfg.precision})"
            )
        return x_nat, self._download(res) / scale
