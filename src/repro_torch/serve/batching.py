"""Batch formation: fairness-ordered coalescing of same-plan jobs (the
port's copy of the reference's ``serve/batching.py``).

Pure functions over the server's queue (no I/O, no torch) so the
scheduling policy is unit-testable in isolation:

``fair_order``
    Priority first, then *least-served tenant* first (work-proportional
    fairness: ``served`` carries slices already solved per tenant, so a
    tenant that just drained a big volume yields to the others), FIFO
    within ties.  A single greedy tenant flooding the queue cannot
    starve anyone at equal priority.

``form_batch``
    Take the head of the fair order, then coalesce every queued job
    sharing its ``plan_key`` -- in fair order, regardless of tenant:
    coalescing is free capacity, the fairness cost was already paid by
    head selection -- while the admission budget holds
    (``AdmissionController.fits``: one shared operator + the sum of
    slab working sets) and the batch stays under ``max_batch``.

``interleave_slabs``
    Round-robin the batch's slabs across jobs, so every co-scheduled
    job streams its first preview after ~one slab time instead of
    waiting its turn behind a whole earlier volume -- the progressive-
    results half of the iFDK "instant reconstruction" framing.

>>> order = interleave_slabs([[(0, 4), (4, 8)], [(0, 2)]])
>>> [(j, s) for j, s in order]
[(0, (0, 4)), (1, (0, 2)), (0, (4, 8))]
"""
from __future__ import annotations

__all__ = ["fair_order", "form_batch", "interleave_slabs"]


def fair_order(jobs, served: dict) -> list:
    """Queued jobs in scheduling order (see module docstring).

    ``served`` maps tenant -> slices already solved; missing tenants
    count as 0 (a brand-new tenant is maximally under-served).
    """
    return sorted(
        jobs,
        key=lambda j: (
            -j.spec.priority,
            float(served.get(j.spec.tenant, 0.0)),
            j.id,
        ),
    )


def form_batch(ordered, costs: dict, admission, max_batch: int) -> list:
    """The next batch: head + same-key followers that fit the budget.

    Args:
      ordered: queued jobs, already through :func:`fair_order`.
      costs: job id -> ``admission.JobCost`` (priced at submit).
      admission: ``AdmissionController`` (the ``fits`` oracle).
      max_batch: hard cap on co-scheduled jobs.
    """
    if not ordered:
        return []
    head = ordered[0]
    batch = [head]
    batch_costs = [costs[head.id]]
    for job in ordered[1:]:
        if len(batch) >= max_batch:
            break
        if job.plan_key != head.plan_key:
            continue
        trial = batch_costs + [costs[job.id]]
        if not admission.fits(trial):
            continue  # stays queued; re-tried next batch
        batch.append(job)
        batch_costs = trial
    return batch


def interleave_slabs(per_job_slabs) -> list:
    """Round-robin ``[(job_index, (j0, j1)), ...]`` across jobs."""
    out = []
    depth = max((len(s) for s in per_job_slabs), default=0)
    for d in range(depth):
        for ji, slabs in enumerate(per_job_slabs):
            if d < len(slabs):
                out.append((ji, slabs[d]))
    return out
