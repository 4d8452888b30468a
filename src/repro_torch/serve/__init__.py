"""repro_torch.serve -- multi-tenant reconstruction-as-a-service (the
port's copy of the reference's ``repro.serve``, solving on the card).

Serving many reconstruction requests on one machine is dominated by the
cold path: partitioning the Siddon operator into blocked-ELL shards +
winseg copy tables and binding the operator to the card.  Parallel-beam
slices share one system matrix, so every job with the same
geometry/config fingerprint (``core.partition.plan_key``) can reuse all
of it.  This package builds the service around that observation:

``jobs``        -- :class:`JobSpec` / :class:`Job` lifecycle, per-slab
                   :class:`SlabPreview` streaming, per-request telemetry
``plan_cache``  -- byte-bounded LRU over built plans + solvers
``admission``   -- price-before-admit against the memory budget
                   (``suggest_slab`` on allocation-free estimates)
``batching``    -- fairness ordering, same-key coalescing, slab
                   round-robin interleave
``server``      -- :class:`ReconServer`: submit / step / drain, optional
                   background scheduler thread

``admission``'s docstring has the admission-control formula.
"""
from .admission import AdmissionController, JobCost
from .batching import fair_order, form_batch, interleave_slabs
from .jobs import STATUSES, Job, JobSpec, JobTelemetry, SlabPreview
from .plan_cache import PlanCache, PlanEntry
from .server import ReconServer

__all__ = [
    "AdmissionController",
    "JobCost",
    "fair_order",
    "form_batch",
    "interleave_slabs",
    "STATUSES",
    "Job",
    "JobSpec",
    "JobTelemetry",
    "SlabPreview",
    "PlanCache",
    "PlanEntry",
    "ReconServer",
]
