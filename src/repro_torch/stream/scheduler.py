"""Slab scheduling: size I/O batches from a memory budget, prefetch ahead
(the port's copy of the reference's ``stream/scheduler.py``).

The paper's Sec. III-E structures one reconstruction as ``Y`` slices
drained in I/O batches, each solved as ``Y_slab / F`` fused minibatches.
This module picks ``Y_slab`` from a *byte budget* instead of assuming the
whole volume fits:

  budget >= fixed + Y_slab * per_slice

``fixed`` is the resident operator footprint (both blocked-ELL shards,
``OperatorShards.hbm_bytes`` at the precision policy's storage width --
parallel-beam geometry shares one ``A`` across every slab, so streaming
re-pays this never).  The byte model is the reference's, term for
term, plus the device terms of the port's own layout that it does not
count (:func:`port_extras`, a stated divergence measured on the card).
``per_slice`` is the per-slice working set:

  * CGNR state on device, summed over the data-parallel shards: three
    tomogram-space vectors (``x``, ``p``, ``s``) and three sinogram-space
    vectors (``y``, ``r``, ``q``) per slice, kept f32 (4 B) -- see
    ``core.solver.cgnr``;
  * host staging of the sinogram slab in and the volume slab out
    (``4 * (rows_pad + cols_pad)``), doubled when the prefetcher
    double-buffers (slab ``i+1`` loads while slab ``i`` solves), plus
    the next slab's device-staged sinogram (``4 * rows_pad``) under the
    driver's default device-upload overlap.

``Y_slab`` is rounded down to the solve granule ``n_batch * fuse``
(``Reconstructor`` requires it) and capped at ``Y``.  The plan also
carries the modeled device-memory traffic of one slab solve
(``kernels.traffic.spmm_traffic``) and, where the reference carries the
kernel's per-core VMEM footprint, the dynamic shared memory an SM gives
the row 1 launch of each operator (``kernels.xct_spmm.sm_smem_bytes``:
the ring ``launch_geometry`` sizes, times the CTAs an SM holds), so
callers can report modeled arithmetic intensity per slab without
re-deriving byte counts.

:class:`Prefetcher` is the host half of the Fig. 8 overlap, one level up
the hierarchy: a single background thread fetches slab ``i+1`` from the
store while the solver owns slab ``i`` -- same pipeline shape as the
in-solve minibatch overlap (``core.pipeline``), applied to disk -> host
instead of compute -> wire.  With a ``stage=`` callable it also covers
the *next* rung: the thread runs host -> device staging (e.g.
``Reconstructor.stage_sino``, which copies on a CUDA stream of its
own) right after the disk read, so slab
``i+1``'s upload hides under slab ``i``'s solve too.  Fetch/stage wall
times are recorded per item (``Prefetcher.times``) and thread failures
surface at the consuming ``next()`` as :class:`PrefetchError` naming
the failing item -- a dead prefetch thread can no longer hang the
drain loop silently.
"""
from __future__ import annotations

import dataclasses
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Sequence

from ..obs.trace import span
from ..resil import inject
from ..resil.retry import RetryPolicy, call_with_retry

__all__ = ["SlabPlan", "suggest_slab", "port_extras", "Prefetcher",
           "PrefetchError"]


class PrefetchError(RuntimeError):
    """A background fetch/stage failed.

    Raised by :class:`Prefetcher` at the consuming ``next()`` -- never
    swallowed in the worker thread -- with the failing item and its
    position attached so a driver can checkpoint/skip deterministically.
    """

    def __init__(self, item, index: int, cause: BaseException):
        self.item = item
        self.index = index
        self.cause = cause
        super().__init__(
            f"prefetch of item {item!r} (index {index}) failed: "
            f"{type(cause).__name__}: {cause}"
        )


@dataclasses.dataclass(frozen=True)
class SlabPlan:
    """A sized streaming schedule (see :func:`suggest_slab`)."""

    y_slab: int  # slices per I/O batch (multiple of granule)
    granule: int  # n_batch * fuse, the solve quantum
    fixed_bytes: int  # resident operator footprint
    per_slice_bytes: int  # working set per slice (device + host staging)
    slab_hbm_bytes: float  # modeled kernel device-memory traffic per slab
    slab_flops: float  # modeled kernel FLOPs per slab per iter
    smem_bytes: int  # row 1's dynamic shared memory per SM (larger op)
    # the port's terms beyond the reference's model, already in
    # fixed_bytes / per_slice_bytes (see port_extras)
    extra_fixed_bytes: int = 0
    extra_per_slice_bytes: int = 0

    @property
    def slab_bytes(self) -> int:
        """Peak bytes while one slab is in flight."""
        return self.fixed_bytes + self.y_slab * self.per_slice_bytes

    def n_slabs(self, n_slices: int) -> int:
        return int(math.ceil(n_slices / self.y_slab))


def _op_traffic(op, fuse: int, storage_bytes: int,
                vals_bytes: int | None = None) -> tuple[float, float]:
    from ..kernels.traffic import op_segments_per_stage, spmm_traffic

    _, b, s, r, k = op.inds.shape
    t = spmm_traffic(
        b, s, r, k, op.winmap.shape[-1], fuse,
        storage_bytes=storage_bytes, vals_bytes=vals_bytes,
        staging="fused",
        # measured winsegs tables for real plans, est capacity for
        # abstract ones
        segments_per_stage=op_segments_per_stage(op),
    )
    return t["hbm_bytes"], t["flops"]


def port_extras(plan, policy) -> tuple[int, int]:
    """``(fixed, per_slice)`` bytes the port's ``Reconstructor`` holds on
    the device beyond the reference's model -- a stated divergence,
    measured on the card (``chip_smoke.py`` phase 7: at n=512 the peak
    over a drain exceeded the reference's ``slab_bytes``).  Upper bounds
    from the port's own layout, per operator and summed over the ranks:

    * fixed: the scatter passes (``dist.collectives.ScatterPasses``) that
      take the place of the int32 ``row_map``: an int64 row for every
      slot, and int64 destination and source slots of the later passes,
      at most one of each per slot -- 20 B per slot where ``hbm_bytes``
      counts 4;
    * per slice: the solve's f32 initial iterate (4 B per column), and
      the larger operator application's transients -- the scaled f32
      input and its storage cast, the kernel's f32 band and its wire
      cast, the pass-0 output on the wire, the gathered f32 output and
      its rescaled copy.
    """
    sb, cb = policy.storage_bytes, policy.comm_bytes
    fixed = sum(16 * op.row_map.size for op in (plan.proj, plan.back))
    apply = max(
        (4 + sb) * op.n_cols_pad
        + (4 + 2 * cb) * op.inds.shape[0] * op.flat_rows
        + 8 * op.n_rows_pad
        for op in (plan.proj, plan.back)
    )
    return int(fixed), int(4 * plan.proj.n_cols_pad + apply)


def suggest_slab(
    plan,
    cfg,
    topology,
    mem_budget: int,
    *,
    n_slices: int | None = None,
    overlap: bool = True,
    passport=None,
) -> SlabPlan:
    """Pick the largest budget-fitting ``Y_slab`` for a partition plan.

    Args:
      plan: ``core.partition.Plan`` (real or ``estimate_plan`` abstract --
        only static shapes are consulted, so budget planning at xct-brain
        scale allocates nothing).
      cfg: ``core.recon.ReconConfig`` (fuse + precision drive the model).
      topology: ``dist.Topology``; its batch size sets the solve granule.
      mem_budget: total bytes available for operator + in-flight slabs.
      n_slices: optional total Y; caps the slab at the whole volume.
      overlap: double-buffered host staging (2x the slab staging bytes).
      passport: optional ``repro_torch.tune.TuningPassport``; its tuned
        ``y_slab`` knob *caps* the granted slab (never raises it past
        what the budget allows -- the budget stays the authority,
        the passport only stops over-allocation the tuner found
        unprofitable).

    Raises ``ValueError`` when even one granule of slices overflows the
    budget (the operator alone may already be too large).
    """
    from ..core.precision import get_policy
    from ..kernels.xct_spmm import sm_smem_bytes

    pol = get_policy(cfg.precision)
    sb = pol.storage_bytes
    vb = pol.vals_bytes  # operator value width (1 for q8/fp8 tiers)
    proj, back = plan.proj, plan.back
    fixed = proj.hbm_bytes(value_bytes=vb) + back.hbm_bytes(value_bytes=vb)
    rows_pad, cols_pad = proj.n_rows_pad, proj.n_cols_pad
    # 3 tomo-space + 3 sino-space f32 CG vectors, + (1 or 2 with the
    # prefetch double buffer) host staging copies of slab-in + slab-out,
    # + with overlap the next slab's device-staged sinogram
    # (StagedSlab.y: reconstruct_streaming's default
    # device_upload="overlap" keeps slab i+1 resident on device while
    # slab i solves)
    staging_copies = 2 if overlap else 1
    per_slice = 4 * (3 + staging_copies) * (rows_pad + cols_pad)
    if overlap:
        per_slice += 4 * rows_pad
    # the port's device terms the reference's model does not count
    extra_fixed, extra_slice = port_extras(plan, pol)
    fixed += extra_fixed
    per_slice += extra_slice
    granule = max(1, topology.n_batch) * cfg.fuse
    avail = mem_budget - fixed
    y_slab = (avail // per_slice // granule) * granule
    if y_slab < granule:
        need = fixed + granule * per_slice
        raise ValueError(
            f"mem_budget={mem_budget} cannot hold one solve granule of "
            f"{granule} slices (needs >= {need} bytes: {fixed} operator "
            f"+ {granule}x{per_slice} working set)"
        )
    if n_slices is not None:
        y_slab = min(y_slab, (n_slices // granule) * granule or granule)
    if passport is not None:
        cap = passport.knobs.get("y_slab")
        if cap:
            y_slab = min(y_slab, max(granule, cap // granule * granule))
    hbm = flops = 0.0
    smem = 0
    minis = y_slab // granule  # fused minibatches per batch member
    for op in (proj, back):
        h, f = _op_traffic(op, cfg.fuse, sb, vb)
        hbm += h * minis
        flops += f * minis
        _, _, s, r, k = op.inds.shape
        # the window ring holds storage-dtype rows (f16 under q8/fp8)
        smem = max(smem, sm_smem_bytes("sorted", s, r, k,
                                       op.winmap.shape[-1], cfg.fuse, sb))
    return SlabPlan(
        y_slab=int(y_slab),
        granule=int(granule),
        fixed_bytes=int(fixed),
        per_slice_bytes=int(per_slice),
        slab_hbm_bytes=hbm,
        slab_flops=flops,
        smem_bytes=int(smem),
        extra_fixed_bytes=extra_fixed,
        extra_per_slice_bytes=extra_slice,
    )


class Prefetcher:
    """Iterate ``(item, stage(fetch(item)))`` with background lookahead.

    One worker thread keeps ``depth`` fetches in flight ahead of the
    consumer: while the solver owns slab ``i``, slab ``i+1`` streams
    disk -> host (``fetch``) and, when ``stage=`` is given, host ->
    device (e.g. ``Reconstructor.stage_sino``) -- the whole staging
    ladder off the critical path.  ``depth=0`` (or ``enabled=False``)
    degrades to a plain synchronous loop -- the A/B baseline; ``stage``
    still applies (inline) so results never depend on the schedule.

    Per-item wall times land in ``self.times[position] = {"load": s,
    "stage": s}`` (keyed by the item's position in ``items`` -- items
    themselves may be unhashable or duplicated) as each item is
    produced.  A failure in the worker thread re-raises at the
    consuming ``next()`` as :class:`PrefetchError` carrying the failing
    item and position.

    With ``retry=RetryPolicy(...)`` transient fetch/stage failures
    (``resil.RETRYABLE_IO``: disk errors, corrupt shards, timeouts)
    retry *in the worker* with deterministic backoff before anything
    surfaces -- a recovered hiccup costs one backoff, not a drain-loop
    round trip.  ``self.retries`` counts them; only exhausted (or
    non-retryable, e.g. a dying worker thread) failures become
    :class:`PrefetchError`.
    """

    def __init__(
        self,
        fetch: Callable,
        items: Sequence | Iterable,
        *,
        depth: int = 1,
        enabled: bool = True,
        stage: Callable | None = None,
        retry: RetryPolicy | None = None,
    ):
        self._fetch = fetch
        self._stage = stage
        self._items = list(items)
        self._depth = depth if enabled else 0
        self._retry = retry
        self.times: dict = {}
        self.retries = 0

    def __len__(self) -> int:
        return len(self._items)

    def _note_retry(self):
        self.retries += 1

    def _produce(self, pos, item):
        # spans always measure (their durations feed self.times and,
        # through reconstruct_streaming, StreamResult); with tracing on
        # they land on the worker thread's own Perfetto lane.  Retried attempts
        # carry retry=<n>; the last (successful) attempt's time is what
        # lands in self.times.
        key = item if isinstance(item, int) else pos

        def load(attempt):
            with span("stream/load", pos=pos, retry=attempt) as sp:
                inject.fire("stream/load", key=key)
                out = self._fetch(item)
            self.times[pos] = {"load": sp.duration_s, "stage": 0.0}
            return out

        if self._retry is None:
            out = load(0)
        else:
            out = call_with_retry(
                load, policy=self._retry, site="stream/load", key=key,
                on_retry=self._note_retry,
            )
        if self._stage is not None:
            def stage_one(attempt):
                with span("stream/stage", pos=pos, retry=attempt) as sp:
                    inject.fire("stream/stage", key=key)
                    staged = self._stage(out)
                self.times[pos]["stage"] = sp.duration_s
                return staged

            if self._retry is None:
                out = stage_one(0)
            else:
                out = call_with_retry(
                    stage_one, policy=self._retry, site="stream/stage",
                    key=key, on_retry=self._note_retry,
                )
        return out

    def __iter__(self):
        if self._depth <= 0:
            for i, it in enumerate(self._items):
                try:
                    out = self._produce(i, it)
                except Exception as e:  # noqa: BLE001
                    raise PrefetchError(it, i, e) from e
                yield it, out
            return
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = []
            idx = 0
            # lookahead is exactly `depth`: pending futures + the one
            # yielded slab bound resident slabs at depth+1, matching the
            # staging copies suggest_slab budgets for
            while idx < len(self._items) and len(pending) < self._depth:
                pending.append(
                    (idx, self._items[idx],
                     pool.submit(self._produce, idx, self._items[idx]))
                )
                idx += 1
            while pending:
                i, item, fut = pending.pop(0)
                try:
                    out = fut.result()
                except Exception as e:  # noqa: BLE001
                    # surface the *failing slab* at the consumer instead
                    # of leaving the drain loop to starve on a dead
                    # worker.  Pool teardown waits for the already-
                    # submitted lookahead fetch to finish (running
                    # futures cannot be cancelled), so the error lands
                    # after at most one extra slab's worth of I/O.
                    raise PrefetchError(item, i, e) from e
                if idx < len(self._items):
                    pending.append(
                        (idx, self._items[idx],
                         pool.submit(self._produce, idx,
                                     self._items[idx]))
                    )
                    idx += 1
                yield item, out
