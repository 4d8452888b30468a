"""The in-process reconstruction service: submit jobs, drain batches
(the port's copy of the reference's ``serve/server.py``).

``ReconServer`` ties the serve subsystem together around the machinery
the rest of the repo already trusts:

* **submit** fingerprints the job (``core.partition.plan_key``), prices
  it against the memory budget (``serve.admission``, allocation-free via
  ``estimate_plan``) and either queues it or rejects it with the reason.
* **step** forms one batch (``serve.batching``: priority + per-tenant
  fairness, then same-key coalescing under the budget), resolves the
  plan through the byte-bounded LRU ``serve.plan_cache`` -- the cold
  path (``build_plan`` + binding the ``Reconstructor`` to the card) runs
  at most once per resident key -- and drains the batch's slabs round-robin through one
  ``stream.scheduler.Prefetcher`` so every co-scheduled job streams
  progressive previews from its first slab on.
* Results land in per-job ``stream.SlabStore`` volumes (atomic shard
  publishes -- a preview path is always a complete, memmap-able slab),
  with per-request queue/load/upload/solve telemetry.
* The path **self-heals** (``repro_torch.resil``): transient slab-load
  failures retry under the job's (or server's) ``RetryPolicy``, jobs
  carry optional wall-clock deadlines, and repeated plan-build failures
  trip a per-``plan_key`` circuit breaker that turns the key's jobs
  away (terminal ``rejected_circuit``) for a cooldown instead of
  re-paying the broken build.

Per-slab solves go through the same ``Reconstructor.reconstruct`` the
streaming driver uses, on independent slices, so a job's volume is
bit-exact vs running it alone through ``stream.reconstruct_streaming``
regardless of what it was batched or interleaved with (pinned by
``tests/test_torch_serve.py``): a slab's solve equals the in-memory solve
of its slices bit for bit, whatever the slab's width (the CG dots sum in
f64, ``core.recon``).

The server solves on one device, ``device`` (default ``cuda``; without a
card it raises, as ``Reconstructor`` does, unless ``device="cpu"``).
Every solve runs with that device current, whatever thread runs the
batch; the prefetch thread stages the next slab on the reconstructor's
own staging stream (``Reconstructor.stage_sino`` waits for its copy
before it hands the slab over, and ``reconstruct`` records the slab on
the solve's stream), so an upload is ordered before the solve that
reads it.

Synchronous use::

    srv = ReconServer(mem_budget=2 * 2**30, workdir=tmp)
    job = srv.submit(JobSpec(geo=geo, sino=sino))
    srv.drain()                      # run queued batches to completion
    vol = job.volume.to_array()      # [n_vox, Y]

Background use: ``start()`` spins a scheduler thread; ``submit`` wakes
it; ``job.wait()`` joins on completion; ``stop()`` shuts it down.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import threading
import time

import numpy as np
import torch

from ..core.partition import PartitionConfig, build_plan, plan_key
from ..core.recon import ReconConfig, Reconstructor, resolve_device
from ..dist import Topology
from ..obs import metrics as obs_metrics
from ..obs.trace import span as obs_span
from ..resil import inject
from ..resil.circuit import CircuitBreaker
from ..resil.errors import DeadlineExceeded
from ..resil.retry import RetryPolicy, call_with_retry
from ..stream.scheduler import Prefetcher, PrefetchError
from ..stream.store import SlabStore
from .admission import AdmissionController
from .batching import fair_order, form_batch, interleave_slabs
from .jobs import Job, JobSpec
from .plan_cache import PlanCache

__all__ = ["ReconServer"]


class ReconServer:
    """Multi-tenant reconstruction-as-a-service (in-process).

    Args:
      mem_budget: bytes the running batch may occupy (resident operator
        + all co-scheduled slab working sets -- the admission formula).
      workdir: directory for per-job volume stores (``job_<id>/``);
        defaults to a fresh temp dir (kept on ``stop`` -- results live
        there).
      cache_bytes: plan-cache LRU bound (None = unbounded).
      max_batch: most jobs coalesced into one batch.
      fair_share: same-key jobs the fair-share slab sizing leaves room
        for (``admission.AdmissionController``).
      max_queue: backlog bound; submits past it are rejected.
      overlap: prefetch depth-1 staging overlap while draining slabs
        (the streaming driver's default; ``False`` degrades to a
        synchronous loop for debugging).
      on_preview: ``callable(job, SlabPreview)`` fired per published
        slab, while the job is still running.
      retry: default ``resil.RetryPolicy`` for transient slab-load
        failures (a ``JobSpec.retry`` overrides it per job; ``None``
        disables server-side load retries).
      breaker: per-``plan_key`` ``resil.CircuitBreaker`` guarding the
        plan build: after its ``threshold`` consecutive build failures
        the key's jobs come back terminal ``rejected_circuit`` until
        the cooldown lapses (default: 3 failures, 30 s cooldown).
      device: where every job solves: ``"cuda"`` (default) or ``"cpu"``;
        raises when CUDA is asked for and absent, never moving to the
        CPU on its own.
    """

    def __init__(
        self,
        mem_budget: int,
        *,
        workdir: str | None = None,
        cache_bytes: int | None = None,
        max_batch: int = 4,
        fair_share: int = 2,
        max_queue: int | None = None,
        overlap: bool = True,
        on_preview=None,
        retry: RetryPolicy | None = RetryPolicy(),
        breaker: CircuitBreaker | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.workdir = workdir or tempfile.mkdtemp(prefix="repro_serve_")
        os.makedirs(self.workdir, exist_ok=True)
        self.admission = AdmissionController(
            mem_budget,
            # in-process serving solves on the default one-rank mesh:
            # meshless accounting topology => granule = fuse
            Topology.from_sizes([("model", 1, "ici")]),
            fair_share=fair_share,
            max_queue=max_queue,
        )
        self.cache = PlanCache(capacity_bytes=cache_bytes)
        self.max_batch = int(max_batch)
        self.overlap = bool(overlap)
        self.retry = retry
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            threshold=3, cooldown_s=30.0
        )
        self._on_preview = on_preview
        self._lock = threading.Lock()
        self._queue: list[Job] = []
        self._jobs: dict[int, Job] = {}
        self._costs: dict[int, object] = {}  # job id -> JobCost
        self.served: dict[str, float] = {}  # tenant -> slices solved
        self.batches: list[dict] = []  # {"key", "jobs", "cold"}
        self._next_id = 0
        self._rejected = 0
        self._rejected_circuit = 0
        self._completed = 0
        self._failed = 0
        self._thread: threading.Thread | None = None
        self._stop_evt = threading.Event()
        self._wake = threading.Event()

    # ------------------------------------------------------------------ #
    # intake
    # ------------------------------------------------------------------ #
    def submit(self, spec: JobSpec) -> Job:
        """Price + enqueue one job; returns it (possibly ``rejected``).

        Rejection is an admission decision, not an exception: the job
        comes back terminal with ``status == "rejected"`` and the
        pricing error in ``job.error``, so a tenant script can react
        without try/except around every submit.
        """
        pcfg = spec.pcfg if spec.pcfg is not None else PartitionConfig()
        rcfg = spec.rcfg if spec.rcfg is not None else ReconConfig()
        spec = dataclasses.replace(spec, pcfg=pcfg, rcfg=rcfg)
        key = plan_key(spec.geo, pcfg, recon=rcfg)
        with self._lock:
            job = Job(self._next_id, spec, key,
                      on_preview=self._on_preview)
            self._next_id += 1
            self._jobs[job.id] = job

        rows = (
            spec.sino.rows if hasattr(spec.sino, "rows")
            else np.asarray(spec.sino).shape[0]
        )
        if rows != spec.geo.n_rays:
            job._transition(
                "rejected",
                error=f"sinogram has {rows} rays, geometry wants "
                      f"{spec.geo.n_rays}",
            )
            self._rejected += 1
            obs_metrics.inc("serve_jobs_total", status="rejected")
            return job
        try:
            # price against the real plan when one is already cached
            # (peek: pricing must not count as a serving hit)
            if spec.n_slices % rcfg.fuse:
                raise ValueError(
                    f"n_slices={spec.n_slices} not a multiple of the "
                    f"solve granule fuse={rcfg.fuse}"
                )
            entry = self.cache.peek(key)
            cost = self.admission.price(
                spec.geo, pcfg, rcfg, spec.n_slices,
                y_slab=spec.y_slab,
                plan=entry.plan if entry is not None else None,
            )
        except ValueError as e:
            job._transition("rejected", error=str(e))
            self._rejected += 1
            obs_metrics.inc("serve_jobs_total", status="rejected")
            return job
        with self._lock:
            if self.admission.queue_full(len(self._queue)):
                job._transition(
                    "rejected",
                    error=f"queue full ({len(self._queue)} >= "
                          f"{self.admission.max_queue})",
                )
                self._rejected += 1
                obs_metrics.inc("serve_jobs_total", status="rejected")
                return job
            self._costs[job.id] = cost
            self._queue.append(job)
            obs_metrics.set_gauge("serve_queue_depth", len(self._queue))
        self._wake.set()
        return job

    def job(self, job_id: int) -> Job:
        return self._jobs[job_id]

    # ------------------------------------------------------------------ #
    # scheduling
    # ------------------------------------------------------------------ #
    def step(self) -> int:
        """Form and run one batch; returns how many jobs it drained."""
        with self._lock:
            if not self._queue:
                return 0
            ordered = fair_order(self._queue, self.served)
            batch = form_batch(
                ordered, self._costs, self.admission, self.max_batch
            )
            for job in batch:
                self._queue.remove(job)
            obs_metrics.set_gauge("serve_queue_depth", len(self._queue))
        if not batch:
            return 0
        self._run_batch(batch)
        return len(batch)

    def drain(self) -> int:
        """Run batches until the queue is empty; returns jobs drained."""
        n = 0
        while True:
            k = self.step()
            if not k:
                return n
            n += k

    def _run_batch(self, batch: list[Job]):
        key = batch[0].plan_key
        if not self.breaker.allow(key):
            # the key's build path is poisoned and cooling down: turn
            # the batch away instantly instead of re-paying the failure
            for job in batch:
                self._reject_circuit(job, key)
            return
        for job in batch:  # queue wait ends when the batch is picked
            job._transition("running")
            job.telemetry.queue_s = time.perf_counter() - job.submit_t
        try:
            entry, hit = self.cache.get_or_build(
                key, lambda: self._build(batch[0])
            )
        except Exception as e:  # noqa: BLE001 - build failure
            self.breaker.record_failure(key)
            for job in batch:
                self._fail(
                    job, f"plan build failed: {type(e).__name__}: {e}",
                    exc=e,
                )
            return
        self.breaker.record_success(key)
        self.batches.append(
            {"key": key, "jobs": [j.id for j in batch], "cold": not hit}
        )
        for job in batch:
            job.telemetry.plan_cold = not hit
        self.cache.pin(key)
        try:
            self._execute(entry, batch)
        finally:
            self.cache.unpin(key)

    def _reject_circuit(self, job: Job, key: str):
        job.telemetry.total_s = time.perf_counter() - job.submit_t
        job._transition(
            "rejected_circuit",
            error=f"plan {key[:16]} build circuit open "
                  f"(cooling down after repeated build failures)",
        )
        self._rejected_circuit += 1
        obs_metrics.inc("serve_jobs_total", status="rejected_circuit")

    def _build(self, job: Job):
        """The cold path: system matrix + partition + winseg tables, and
        the solver bound to the server's device (the operator uploaded
        and, under q8/fp8, packed)."""
        spec = job.spec
        inject.fire("serve/build")  # chaos hook: plan-build failure
        plan = build_plan(spec.geo, spec.pcfg)
        rec = Reconstructor(plan, cfg=spec.rcfg, device=self.device)
        vb = rec.policy.vals_bytes  # packed value width (1 on q8/fp8)
        nbytes = (
            plan.proj.hbm_bytes(value_bytes=vb)
            + plan.back.hbm_bytes(value_bytes=vb)
        )
        return plan, rec, nbytes

    # ------------------------------------------------------------------ #
    # execution
    # ------------------------------------------------------------------ #
    def _execute(self, entry, batch: list[Job]):
        # the batch may run on the scheduler thread: make the solve's
        # device current there, not whatever that thread last had
        rec = entry.rec
        on_card = (torch.cuda.device(rec.device)
                   if rec.device.type == "cuda" else contextlib.nullcontext())
        with on_card:
            self._drain_batch(rec, batch)

    def _drain_batch(self, rec, batch: list[Job]):
        per_job_slabs = []
        pending: dict[int, int] = {}
        for job in batch:
            cost = self._costs[job.id]
            job.y_slab = cost.y_slab
            job.volume = SlabStore.create(
                os.path.join(self.workdir, f"job_{job.id:05d}"),
                rows=job.spec.geo.n_vox,
                n_slices=job.spec.n_slices,
                slab=cost.y_slab,
                dtype=np.float32,
            )
            job.resnorms = np.zeros(
                (job.spec.iters, job.spec.n_slices), np.float32
            )
            slabs = job.volume.slabs()
            pending[job.id] = len(slabs)
            per_job_slabs.append(slabs)

        # round-robin across jobs: every co-scheduled job sees its
        # first preview after ~one slab time
        tasks = [
            (batch[ji], rng)
            for ji, rng in interleave_slabs(per_job_slabs)
        ]

        def fetch(task):
            job, (j0, j1) = task
            policy = job.spec.retry if job.spec.retry is not None \
                else self.retry
            if policy is None:
                return job.spec.read_slab(j0, j1)

            def load(attempt):
                with obs_span(
                    "serve/load", job=job.id, j0=j0, retry=attempt
                ):
                    return job.spec.read_slab(j0, j1)

            def note():
                job.telemetry.retries += 1

            # per-job policy: a flaky tenant store retries with its own
            # backoff before the failure can surface as a PrefetchError
            return call_with_retry(
                load, policy=policy, site="serve/load", key=j0,
                on_retry=note,
            )

        while tasks:
            pre = Prefetcher(
                fetch, tasks, depth=1, enabled=self.overlap,
                stage=rec.stage_sino,
            )
            consumed = 0
            try:
                for pos, (task, staged) in enumerate(pre):
                    job, (j0, j1) = task
                    if job.status != "running":
                        # failed earlier in this drain (deadline / bad
                        # load); its later slabs are already in flight
                        consumed = pos + 1
                        continue
                    dl = job.spec.deadline_s
                    if dl is not None and (
                        time.perf_counter() - job.submit_t > dl
                    ):
                        self._fail(
                            job,
                            f"deadline {dl:g}s exceeded",
                            exc=DeadlineExceeded(f"{dl:g}s"),
                        )
                        consumed = pos + 1
                        continue
                    lane = f"tenant:{job.spec.tenant}"
                    # a solve/write failure propagates through these
                    # spans, so the failing slab's span records the
                    # exception type before _fail() sees it
                    with obs_span(
                        "serve/slab", lane=lane, job=job.id, j0=j0
                    ):
                        with obs_span(
                            "serve/solve", lane=lane, job=job.id
                        ) as sp_solve:
                            x, r = rec.reconstruct(
                                staged, iters=job.spec.iters
                            )
                        path = job.volume.write(j0, np.asarray(x))
                    job.resnorms[:, j0:j1] = r
                    tm = pre.times.get(pos, {})
                    job.telemetry.load_s += tm.get("load", 0.0)
                    job.telemetry.upload_s += tm.get("stage", 0.0)
                    job.telemetry.solve_s += sp_solve.duration_s
                    job.publish_preview(j0, j1, path)
                    with self._lock:
                        self.served[job.spec.tenant] = (
                            self.served.get(job.spec.tenant, 0.0)
                            + (j1 - j0)
                        )
                    pending[job.id] -= 1
                    if pending[job.id] == 0:
                        job.telemetry.total_s = (
                            time.perf_counter() - job.submit_t
                        )
                        job._transition("done")
                        self._completed += 1
                        obs_metrics.inc(
                            "serve_jobs_total", status="done"
                        )
                    consumed = pos + 1
            except PrefetchError as e:
                # the failing fetch/stage names its job; everything
                # already yielded for other jobs is safely on disk
                bad, _ = e.item
                self._fail(bad, f"slab load failed: {e}", exc=e.cause)
                tasks = [
                    t for t in tasks[e.index + 1:]
                    if t[0].status == "running"
                ]
                continue
            except Exception as e:  # noqa: BLE001 - solve/write failure
                bad = tasks[consumed][0]
                self._fail(bad, f"{type(e).__name__}: {e}", exc=e)
                tasks = [
                    t for t in tasks[consumed + 1:]
                    if t[0].status == "running"
                ]
                continue
            break

    def _fail(self, job: Job, msg: str, exc: BaseException | None = None):
        # a failed job still reports terminal-phase timing: total_s
        # covers submit -> failure, and the slab split it accumulated
        # before dying stays (the telemetry gap the obs PR closed)
        job.telemetry.total_s = time.perf_counter() - job.submit_t
        if exc is not None:
            job.telemetry.error_type = type(exc).__name__
        job._transition("failed", error=msg)
        self._failed += 1
        obs_metrics.inc("serve_jobs_total", status="failed")

    # ------------------------------------------------------------------ #
    # background mode
    # ------------------------------------------------------------------ #
    def start(self):
        """Run the scheduler on a daemon thread; ``submit`` wakes it."""
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._loop, name="repro-serve", daemon=True
        )
        self._thread.start()

    def _loop(self):
        while not self._stop_evt.is_set():
            if not self.step():
                self._wake.wait(0.05)
                self._wake.clear()

    def stop(self, drain: bool = True):
        """Stop the scheduler thread (after ``drain``-ing by default).

        Job volumes stay on disk under ``workdir`` -- results outlive
        the server.
        """
        if self._thread is None:
            return
        if drain:
            while True:
                with self._lock:
                    empty = not self._queue
                if empty:
                    break
                time.sleep(0.01)
        self._stop_evt.set()
        self._wake.set()
        self._thread.join()
        self._thread = None

    # ------------------------------------------------------------------ #
    # observability
    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        s = self.cache.stats()
        s.update(
            submitted=self._next_id,
            rejected=self._rejected,
            rejected_circuit=self._rejected_circuit,
            completed=self._completed,
            failed=self._failed,
            queued=len(self._queue),
            batches=len(self.batches),
            hit_rate=self.cache.hit_rate,
        )
        return s

    def metrics_text(self) -> str:
        """Prometheus text snapshot of the process metrics registry.

        Refreshes the point-in-time gauges first so a scrape is
        self-consistent; counters (``serve_jobs_total{status=}``,
        ``plan_cache_*_total``, ``comm_bytes_total{link=}``, ...)
        accumulate as the wired paths bump them.  The exposition is
        byte-deterministic for a given registry state (sorted series;
        see ``repro_torch.obs.metrics``).
        """
        with self._lock:
            obs_metrics.set_gauge("serve_queue_depth", len(self._queue))
        return obs_metrics.render_prometheus()
