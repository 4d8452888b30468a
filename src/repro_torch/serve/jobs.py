"""Job model of the reconstruction service: specs, lifecycle, telemetry
(the port's copy of the reference's ``serve/jobs.py``).

A *job* is one reconstruction request: a sinogram (numpy array or an
on-disk :class:`~repro_torch.stream.store.SlabStore`), the scan geometry and
solver configuration that shape its compiled plan, and multi-tenant
metadata (tenant, priority).  The server prices it at submit
(``serve.admission``), queues it, batches it with same-``plan_key``
neighbors (``serve.batching``) and drains it slab by slab -- publishing
a :class:`SlabPreview` per completed slab *while the job is still
running* (iFDK's "instant reconstruction": the beamline user watches
slabs land instead of waiting for the volume).

Lifecycle (monotone; terminal states starred)::

    QUEUED -> RUNNING -> DONE*
       \\-> REJECTED*         (admission: impossible budget / full queue)
        \\-> REJECTED_CIRCUIT* (plan build circuit open, see resil)
         \\-> FAILED*          (runtime error; other jobs keep draining)

Jobs carry their own resilience knobs: ``JobSpec.retry`` (a
``resil.RetryPolicy`` for transient slab-load failures; ``None`` uses
the server default) and ``JobSpec.deadline_s`` (wall-clock budget from
submit -- a job past it fails with ``error_type="DeadlineExceeded"``
instead of starving its batch mates).

Telemetry per job aggregates the same load/upload/solve split the
streaming driver records per slab (``stream.StreamResult``), plus the
service-level numbers the benchmarks gate: queue wait and
queue-to-first-slab (``bench_serve``'s p50/p95 metric).
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

__all__ = ["JobSpec", "Job", "JobTelemetry", "SlabPreview", "STATUSES"]

STATUSES = (
    "queued", "running", "done", "rejected", "rejected_circuit", "failed",
)
_TERMINAL = ("done", "rejected", "rejected_circuit", "failed")


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """What a tenant submits.

    ``sino`` is either a ``[n_rays, Y]`` numpy array or a
    ``stream.SlabStore`` holding one; ``y_slab=None`` lets admission
    size the slab from the server's memory budget (fair-share, see
    ``serve.admission.AdmissionController.price``).
    """

    geo: object  # core.geometry.XCTGeometry
    sino: object  # np.ndarray | stream.SlabStore
    pcfg: object = None  # core.partition.PartitionConfig (None = default)
    rcfg: object = None  # core.recon.ReconConfig (None = default)
    iters: int = 30
    tenant: str = "default"
    priority: int = 0  # higher runs earlier
    y_slab: int | None = None  # None -> sized by admission
    retry: object = None  # resil.RetryPolicy | None (server default)
    deadline_s: float | None = None  # wall budget from submit

    @property
    def n_slices(self) -> int:
        return int(
            self.sino.n_slices
            if hasattr(self.sino, "n_slices")
            else np.asarray(self.sino).shape[1]
        )

    def read_slab(self, j0: int, j1: int):
        """One sinogram slab, whatever the backing storage."""
        if hasattr(self.sino, "read"):
            return self.sino.read(j0, j1)
        return np.asarray(self.sino)[:, j0:j1]


@dataclasses.dataclass
class JobTelemetry:
    """Per-request split, aggregated over the job's slabs.

    ``queue_s`` is submit -> first slab *starts*; ``first_slab_s`` is
    submit -> first slab *published* (the queue-to-first-slab the
    warm-path acceptance compares: a cache hit skips the plan build, so
    a warm job's number is strictly below the cold job's).  The
    load/upload/solve sums mirror the ``stream.StreamResult`` per-slab
    fields.  Timing fields follow the repo-wide ``*_s`` convention
    (seconds, float).

    A FAILED job still carries telemetry up to the failure point:
    whatever slabs completed keep their split, ``total_s`` covers
    submit -> failure, and ``error_type`` names the exception class
    (the failing ``serve/slab`` span records the same under its
    ``exception`` attr).
    """

    queue_s: float = 0.0
    first_slab_s: float = 0.0
    total_s: float = 0.0
    load_s: float = 0.0
    upload_s: float = 0.0
    solve_s: float = 0.0
    n_slabs: int = 0
    plan_cold: bool = False  # this job paid the plan build
    error_type: str | None = None  # exception class name (failed jobs)
    retries: int = 0  # transient slab-load retries this job absorbed


@dataclasses.dataclass(frozen=True)
class SlabPreview:
    """One progressively published slab (the store shard IS the data).

    ``path`` points at the atomically published ``SlabStore`` shard, so
    a client can memmap the preview without copying; ``seconds`` is wall
    time since submit (monotone within a job -- previews stream in
    order while the job is still running).
    """

    job_id: int
    j0: int
    j1: int
    path: str
    seconds: float  # since submit


class Job:
    """A submitted job: spec + mutable status/results/telemetry.

    Thread-safe where it matters for a service: status transitions and
    preview appends happen under a lock, and ``wait()`` blocks on an
    event set at any terminal state (the background-server mode's join
    point).  Previews are also delivered to the spec-independent
    ``on_preview`` callback *before* the job completes -- pinned by the
    serve-smoke CI job.
    """

    def __init__(self, job_id: int, spec: JobSpec, key: str,
                 on_preview=None):
        self.id = job_id
        self.spec = spec
        self.plan_key = key
        self.status = "queued"
        self.error: str | None = None
        self.y_slab: int | None = spec.y_slab
        self.volume = None  # stream.SlabStore once running
        self.resnorms: np.ndarray | None = None
        self.previews: list[SlabPreview] = []
        self.telemetry = JobTelemetry()
        self.submit_t = time.perf_counter()
        self._on_preview = on_preview
        self._lock = threading.Lock()
        self._done = threading.Event()

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    @property
    def terminal(self) -> bool:
        return self.status in _TERMINAL

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the job reaches a terminal state."""
        return self._done.wait(timeout)

    def _transition(self, status: str, error: str | None = None):
        assert status in STATUSES, status
        with self._lock:
            if self.terminal:  # terminal states are sticky
                return
            self.status = status
            if error is not None:
                self.error = error
        if status in _TERMINAL:
            self._done.set()

    def publish_preview(self, j0: int, j1: int, path: str):
        """Record (and stream out) one completed slab."""
        now = time.perf_counter() - self.submit_t
        pv = SlabPreview(self.id, j0, j1, path, now)
        with self._lock:
            self.previews.append(pv)
            if self.telemetry.n_slabs == 0:
                self.telemetry.first_slab_s = now
            self.telemetry.n_slabs += 1
        if self._on_preview is not None:
            self._on_preview(self, pv)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Job(id={self.id}, tenant={self.spec.tenant!r}, "
            f"key={self.plan_key}, status={self.status})"
        )
