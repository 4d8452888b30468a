"""Out-of-core streaming reconstruction: drain slabs through the solver
(the port's copy of the reference's ``stream/driver.py``, onto the
port's ``Reconstructor``).

``reconstruct_streaming`` turns a :class:`~repro_torch.stream.store.SlabStore`
sinogram into a volume store without ever holding more than one slab (two
with prefetch) in host memory:

  1. size the slab from the byte budget (``scheduler.suggest_slab``) or
     take an explicit ``y_slab``;
  2. restore the resume manifest (``ckpt.checkpoint``) and skip slabs
     already recorded done -- slices are independent least-squares
     problems sharing ``A`` (parallel-beam, paper Sec. II-B), so a
     restart that re-solves only the remaining slabs converges to the
     identical volume;
  3. for each pending slab: prefetch slab ``i+1`` from disk -- and, by
     default, stage it host -> device (``Reconstructor.stage_sino``) --
     while slab ``i`` solves (``scheduler.Prefetcher``, the Fig. 8
     overlap lifted up the memory hierarchy; the upload runs on a CUDA
     stream of its own), run the in-memory
     ``Reconstructor.reconstruct`` on the staged slab, write the
     reconstructed slab to the volume store (atomic shard publish);
     per-slab wall time is split into load / upload / solve so a run
     shows what each rung of the pipeline actually hides;
  4. checkpoint the manifest every ``k`` slabs, ``k`` from the measured
     slab/write times via the Young/Daly optimum
     (``dist.fault.suggest_checkpoint_period``) unless pinned by
     ``checkpoint_every``.

The drain **self-heals**:

* transient load/stage failures retry inside the prefetch worker under
  ``retry=`` (:class:`~repro_torch.resil.RetryPolicy`, deterministic
  backoff); a worker that dies anyway gets one synchronous re-try in
  ``reconstruct_streaming`` before the slab is *quarantined* --
  recorded in the resume manifest's ``failed`` array and ``StreamResult.failed_slabs``, the
  drain continues with the rest, and a later resume re-attempts it;
* a :class:`~repro_torch.resil.NonFiniteSolveError` retries at the
  native precision (a transient blow-up heals bit-exactly), then
  re-solves **one precision rung up** (q8/fp8/half -> f32) before
  quarantining; the rung-up ``Reconstructor`` binds a second operator
  (at f32 on the card) that ``suggest_slab``'s ``fixed_bytes`` does not
  count, so on the card the peak device memory after binding it lands in
  the ``stream_escalation_peak_bytes`` gauge and the
  ``stream/escalate`` trace instant;
* per-slab load times feed a
  :class:`~repro_torch.dist.fault.StragglerMonitor`;
  a flagged straggler shrinks the prefetch lookahead to zero (stop
  racing a struggling disk), emits a ``stream_prefetch_lookahead``
  gauge + ``stream/straggler`` trace instant, and the drain carries on
  synchronously.

Because the per-slice math in ``Reconstructor.reconstruct`` never couples
slices (CG scalars, normalization, and the solve itself are all
column-wise), the streamed volume equals the one-shot in-memory volume
slice for slice, for *any* slab size -- pinned by
``tests/test_torch_stream.py``, with the chaos scenarios above.  A slab
is held to the in-memory solve of the same slab shape: PyTorch's row
sums in the CG dots reduce in an order that depends on the column
count, so the assembled volume and a full-Y solve agree only to the
last bits.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..ckpt import checkpoint as ckpt
from ..core.recon import Reconstructor, StagedSlab
from ..dist.fault import StragglerMonitor, suggest_checkpoint_period
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..obs.trace import span
from ..resil import inject
from ..resil.errors import NonFiniteSolveError
from ..resil.retry import RetryPolicy
from .scheduler import Prefetcher, PrefetchError, suggest_slab
from .store import SlabStore

UPLOAD_MODES = ("overlap", "sync")

# graceful degradation: precision rung to re-solve at after a
# non-finite result exhausts same-rung retries (f32/f64 have nowhere
# safer to go -> straight to quarantine)
ESCALATION = {
    "q8": "single",
    "fp8": "single",
    "int8": "single",
    "half": "single",
    "f16": "single",
    "bf16": "single",
    "mixed": "single",
    "mixed_bf16": "single",
}

__all__ = ["StreamResult", "reconstruct_streaming", "ESCALATION"]


@dataclasses.dataclass
class StreamResult:
    """What one (possibly resumed, possibly interrupted) drain did.

    Timing fields use the repo-wide ``*_s`` convention (seconds,
    float).  Every value is a span duration from
    :mod:`repro_torch.obs.trace` -- with tracing enabled the exported
    ``stream/*`` spans and these fields are the same numbers.
    """

    volume: SlabStore  # the output store (complete iff slabs all done)
    resnorms: np.ndarray  # [iters, Y] per-slice residuals (0 = unsolved)
    y_slab: int
    solved: list  # slab starts solved by THIS call
    skipped: list  # slab starts skipped via the resume manifest
    slab_s: list  # critical-path wall seconds per solved slab
    # the per-slab pipeline split (parallel lists to ``solved``):
    load_s: list = dataclasses.field(default_factory=list)
    upload_s: list = dataclasses.field(default_factory=list)
    solve_s: list = dataclasses.field(default_factory=list)
    upload_overlapped: bool = False  # uploads ran off the critical path
    # resilience outcome of this call:
    failed_slabs: list = dataclasses.field(default_factory=list)
    retries: int = 0  # load/stage/solve retries this call
    escalated: list = dataclasses.field(default_factory=list)
    stragglers: list = dataclasses.field(default_factory=list)

    @property
    def complete(self) -> bool:
        return self.volume.complete()


def _manifest_like(n_slabs: int, iters: int, n_slices: int) -> dict:
    return {
        "done": np.zeros(n_slabs, np.uint8),
        "failed": np.zeros(n_slabs, np.uint8),
        "res": np.zeros((iters, n_slices), np.float32),
        "y_slab": np.zeros((), np.int64),
    }


def reconstruct_streaming(
    rec,
    sino_store: SlabStore,
    out_dir: str,
    *,
    iters: int = 30,
    mem_budget: int | None = None,
    y_slab: int | None = None,
    ckpt_dir: str | None = None,
    overlap: bool = True,
    device_upload: str = "overlap",
    checkpoint_every: int | None = None,
    max_slabs: int | None = None,
    retry: RetryPolicy | None = None,
    fail_fast: bool = False,
    straggler_k_mad: float = 4.0,
) -> StreamResult:
    """Reconstruct a stored sinogram slab-by-slab into a volume store.

    Args:
      rec: a ``core.recon.Reconstructor`` (its plan's geometry must match
        the store's row count).
      sino_store: measurements, ``[n_rays, Y]`` in natural order.
      out_dir: directory for the output volume store (``[n_vox, Y]``).
      iters: CG iterations per slab (the paper's 30).
      mem_budget: total bytes for operator + in-flight slabs; sizes the
        slab via ``scheduler.suggest_slab``.  Exactly one of
        ``mem_budget`` / ``y_slab`` must be given.
      y_slab: explicit slab size (multiple of ``n_batch * fuse``).
      ckpt_dir: resume-manifest directory; restart skips slabs recorded
        done there (quarantined slabs stay pending, so a resume
        re-attempts them).  ``None`` disables checkpointing.
      overlap: prefetch the next slab while the current one solves.
      device_upload: "overlap" (default) runs the host->device staging
        (``rec.stage_sino``) in the prefetch thread too; "sync" keeps
        the upload on the critical path (A/B baseline).  Results are
        bit-identical.
      checkpoint_every: manifest cadence in slabs; ``None`` derives it
        from measured slab/write costs (Young/Daly).
      max_slabs: stop after solving this many slabs (simulated
        preemption for tests/examples); the manifest is saved first.
      retry: :class:`~repro_torch.resil.RetryPolicy` for transient
        load/stage/solve failures (``None`` -> the default policy:
        3 attempts, 50 ms base backoff).
      fail_fast: disable retry/quarantine -- the first failure
        propagates (debugging; the CLI's ``--fail-fast``).
      straggler_k_mad: robust z-score threshold for the per-slab load
        straggler monitor.

    A drain with quarantined slabs returns normally: the poison slabs
    are listed in ``StreamResult.failed_slabs`` (and counted by the
    ``slabs_quarantined_total`` metric), the rest of the volume is on
    disk, and ``result.complete`` is ``False`` -- the exit-code
    contract (``launch.recon`` exits 3 on a partial drain) lives at the
    CLI.
    """
    if (mem_budget is None) == (y_slab is None):
        raise ValueError("pass exactly one of mem_budget= / y_slab=")
    if device_upload not in UPLOAD_MODES:
        raise ValueError(
            f"unknown device_upload {device_upload!r}; "
            f"one of {UPLOAD_MODES}"
        )
    geo = rec.plan.geo
    if sino_store.rows != geo.n_rays:
        raise ValueError(
            f"store has {sino_store.rows} rows, plan expects "
            f"{geo.n_rays} rays"
        )
    n_slices = sino_store.n_slices
    granule = rec.n_batch * rec.cfg.fuse
    if n_slices % granule:
        raise ValueError(
            f"slice count {n_slices} must be a multiple of "
            f"batch x fuse = {granule}"
        )
    if y_slab is None:
        y_slab = suggest_slab(
            rec.plan, rec.cfg, rec.topology, mem_budget,
            n_slices=n_slices, overlap=overlap,
        ).y_slab
    if y_slab % granule:
        raise ValueError(f"y_slab {y_slab} not a multiple of {granule}")
    policy = retry if retry is not None else RetryPolicy()
    volume = SlabStore.create(
        out_dir, geo.n_vox, n_slices, y_slab, np.float32
    )
    slabs = volume.slabs()

    # ---- resume manifest -------------------------------------------- #
    done = np.zeros(len(slabs), np.uint8)
    failed = np.zeros(len(slabs), np.uint8)
    res = np.zeros((iters, n_slices), np.float32)
    if ckpt_dir is not None:
        step = ckpt.latest_step(ckpt_dir)
        if step is not None:
            try:
                state = ckpt.restore(
                    ckpt_dir, step,
                    _manifest_like(len(slabs), iters, n_slices),
                )
            except (ValueError, AssertionError) as e:
                # shape drift inside restore means the run parameters
                # changed; surface the actual knobs, not leaf shapes
                raise ValueError(
                    f"resume manifest in {ckpt_dir} does not match this "
                    f"run (y_slab={y_slab}, iters={iters}, "
                    f"Y={n_slices}); restart with the original settings "
                    f"or clear the manifest [{e}]"
                ) from e
            if int(state["y_slab"]) != y_slab:
                raise ValueError(
                    f"resume manifest was written with y_slab="
                    f"{int(state['y_slab'])}, this run uses {y_slab}"
                )
            done, failed, res = (
                state["done"], state["failed"], state["res"]
            )

    def save_manifest():
        if ckpt_dir is None:
            return 0.0
        with span("stream/ckpt", step=int(done.sum())) as sp:
            ckpt.save(
                ckpt_dir, int(done.sum()),
                {"done": done, "failed": failed, "res": res,
                 "y_slab": np.asarray(y_slab, np.int64)},
            )
        return sp.duration_s

    pending = [i for i in range(len(slabs)) if not done[i]]
    if max_slabs is not None:
        pending = pending[:max_slabs]
    skipped = [slabs[i][0] for i in range(len(slabs)) if done[i]]
    solved: list = []
    slab_s: list = []
    load_s: list = []
    upload_s: list = []
    solve_s: list = []
    failed_slabs: list = []
    escalated: list = []
    stragglers: list = []
    n_retries = 0
    n_nodes = max(1, rec.mesh.size)
    every = checkpoint_every
    since_save = 0
    monitor = StragglerMonitor(k_mad=straggler_k_mad, window=1)

    up_overlap = device_upload == "overlap"
    lookahead = 1 if overlap else 0
    fetch = lambda i: sino_store.read(*slabs[i])  # noqa: E731
    # host->device staging in the worker thread: slab i+1's upload runs
    # while slab i solves
    stage_fn = rec.stage_sino if up_overlap else None

    esc_cache: dict = {}

    def escalated_rec():
        """Lazily build the one-rung-up solver (shares the plan and the
        topology -- hence the devices; only the precision policy -- and
        hence the operator packing -- differs)."""
        if "rec" not in esc_cache:
            target = ESCALATION.get(rec.cfg.precision)
            esc_cache["rec"] = None if target is None else Reconstructor(
                rec.plan,
                cfg=dataclasses.replace(rec.cfg, precision=target),
                topology=rec.topology,
            )
            if esc_cache["rec"] is not None and rec.device.type == "cuda":
                peak = torch.cuda.max_memory_allocated(rec.device)
                obs_metrics.set_gauge("stream_escalation_peak_bytes",
                                      float(peak))
                obs_trace.instant("stream/escalate", precision=target,
                                  peak_bytes=int(peak))
        return esc_cache["rec"]

    def solve_slab(i, staged):
        """Solve with heal: same-rung retries, then one rung up.

        Raises ``NonFiniteSolveError`` when every rung blew up -- the
        caller quarantines.
        """
        nonlocal n_retries
        attempt = 0
        solver = rec
        while True:
            try:
                with span(
                    "stream/solve", slab=i, iters=iters, retry=attempt,
                    precision=solver.cfg.precision,
                ) as sp:
                    with inject.scope(i):
                        x, r = solver.reconstruct(staged, iters=iters)
                if solver is not rec:
                    escalated.append(slabs[i][0])
                    obs_metrics.inc("stream_escalations_total")
                return x, r, sp.duration_s
            except NonFiniteSolveError:
                if fail_fast:
                    raise
                attempt += 1
                if attempt < policy.max_attempts:
                    n_retries += 1
                    obs_metrics.inc("retries_total", site="stream/solve")
                    obs_trace.instant(
                        "resil/retry", site="stream/solve", key=str(i),
                        attempt=attempt, error="NonFiniteSolveError",
                    )
                    d = policy.delay_s("stream/solve", i, attempt)
                    if d > 0.0:
                        time.sleep(d)
                    continue
                nxt = escalated_rec() if solver is rec else None
                if nxt is None:
                    raise  # both rungs poisoned -> quarantine
                solver = nxt  # one try at the escalated rung

    def quarantine(i, exc):
        j0 = slabs[i][0]
        failed[i] = 1
        failed_slabs.append(j0)
        obs_metrics.inc("slabs_quarantined_total")
        obs_trace.instant(
            "stream/quarantine", slab=i, j0=j0,
            error=type(exc).__name__,
        )
        save_manifest()  # record the quarantine durably, off-cadence

    def process(i, slab_in, t_load, t_stage):
        """Upload + solve + write + bookkeeping for one fetched slab."""
        nonlocal every, since_save
        j0, j1 = slabs[i]
        with span("stream/slab", slab=i, j0=j0) as sp_slab:
            if isinstance(slab_in, StagedSlab):
                staged, t_up = slab_in, t_stage
            else:
                with span("stream/upload", slab=i) as sp_up:
                    staged = rec.stage_sino(slab_in)
                t_up = sp_up.duration_s
            assert isinstance(staged, StagedSlab)
            try:
                x, r, t_solve = solve_slab(i, staged)
            except NonFiniteSolveError as e:
                if fail_fast:
                    raise
                quarantine(i, e)
                return
            with span("stream/write", slab=i):
                volume.write(j0, x)
        dt = sp_slab.duration_s
        res[:, j0:j1] = r
        done[i] = 1
        failed[i] = 0  # a resumed quarantined slab that now solved
        solved.append(j0)
        slab_s.append(dt)
        load_s.append(t_load)
        upload_s.append(t_up)
        solve_s.append(t_solve)
        obs_metrics.inc("stream_slabs_total")
        since_save += 1
        if every is None and ckpt_dir is not None:
            # first slab: measure one save, then derive the Young/Daly
            # cadence from the measured write cost and slab time
            write_cost = save_manifest()
            since_save = 0
            period = suggest_checkpoint_period(
                max(write_cost, 1e-6), n_nodes
            )
            every = max(1, int(period / max(dt, 1e-9)))
        elif every is not None and since_save >= every:
            save_manifest()
            since_save = 0
        # the crash-resume property test's preemption point: fires
        # AFTER this slab's work (and its cadenced manifest save)
        inject.fire("stream/after_slab", key=i)

    # ---- drain ------------------------------------------------------ #
    # Outer loop restarts the prefetch pipeline after any structural
    # event (quarantine, worker death, straggler-driven lookahead
    # shrink); each segment drains `remaining` until one occurs.
    remaining = list(pending)
    while remaining:
        pre = Prefetcher(
            fetch, remaining, depth=lookahead, enabled=lookahead > 0,
            stage=stage_fn, retry=None if fail_fast else policy,
        )
        gen = iter(pre)
        pos = -1
        try:
            while True:
                pos += 1
                try:
                    i, slab_in = next(gen)
                except StopIteration:
                    remaining = []
                    break
                except PrefetchError as e:
                    if fail_fast:
                        raise
                    # worker-level retries are already exhausted (or the
                    # failure was non-retryable, e.g. the worker thread
                    # died): one synchronous driver-level re-try, then
                    # quarantine
                    i = e.item
                    n_retries += 1
                    obs_metrics.inc("retries_total", site="stream/slab")
                    try:
                        raw = fetch(i)
                        slab_in = stage_fn(raw) if stage_fn else raw
                    except Exception as e2:  # noqa: BLE001
                        quarantine(i, e2)
                    else:
                        process(i, slab_in, 0.0, 0.0)
                    remaining = remaining[e.index + 1:]
                    break
                tm = pre.times.get(pos, {})
                process(
                    i, slab_in, tm.get("load", 0.0), tm.get("stage", 0.0)
                )
                monitor.record(i, tm.get("load", 0.0))
                if lookahead > 0:
                    bad = monitor.stragglers()
                    if bad:
                        # a struggling disk: stop racing ahead of it
                        stragglers.extend(
                            b for b in bad if b not in stragglers
                        )
                        lookahead = 0
                        obs_metrics.set_gauge(
                            "stream_prefetch_lookahead", 0.0
                        )
                        obs_metrics.inc("stream_stragglers_total")
                        obs_trace.instant(
                            "stream/straggler", slabs=str(bad)
                        )
                        remaining = remaining[pos + 1:]
                        break
        finally:
            gen.close()  # drop the lookahead worker before rebuilding
        n_retries += pre.retries
    if since_save and ckpt_dir is not None:
        save_manifest()
    return StreamResult(
        volume=volume,
        resnorms=res,
        y_slab=int(y_slab),
        solved=solved,
        skipped=skipped,
        slab_s=slab_s,
        load_s=load_s,
        upload_s=upload_s,
        solve_s=solve_s,
        # with disk prefetch on, loads of slab i+1 hide under slab i's
        # solve; with device_upload="overlap" the upload does too
        upload_overlapped=bool(overlap and up_overlap),
        failed_slabs=failed_slabs,
        retries=n_retries,
        escalated=escalated,
        stragglers=stragglers,
    )
