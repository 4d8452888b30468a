"""Admission control: price every job before it touches the machine
(the port's copy of the reference's ``serve/admission.py``).

The service's memory budget ``M`` has to cover, at any instant, the
resident operator of the running batch plus every co-scheduled job's
in-flight slab working set.  Both terms come from the same accounting
the rest of the stack already trusts -- ``stream.scheduler.suggest_slab``
(which itself prices the operator with ``OperatorShards.hbm_bytes`` and
the slab traffic with ``kernels.traffic.spmm_traffic``) -- evaluated on
an **allocation-free** ``estimate_plan`` abstraction, so pricing a job
never pays the cold path it is deciding about:

    admit(batch) <=> fixed + sum_j y_slab_j * per_slice  <=  M

``fixed`` is shared across a batch (same ``plan_key`` => same resident
operator -- that is what batching is for); each job contributes only
its slab term.  The port's ``suggest_slab`` adds to both terms the
device bytes of its own layout that the reference's model does not
count (``stream.scheduler.port_extras``), so a :class:`JobCost` is the
reference's plus those terms and ``fits`` bounds what the card holds.
A job whose single solve granule cannot fit alongside
the operator is *rejected* outright (``suggest_slab`` raises); a job
that fits alone but not alongside the running work is *queued* -- the
batching scheduler re-tries it when slots free up.

Fair-share sizing: with ``fair_share = s``, an unsized job
(``y_slab=None``) gets ``(M - fixed) / s`` of the working budget, so
``s`` same-key jobs can always be co-scheduled.  Meshless doctest (the
same estimate/Topology machinery the slab-size formula's doctest uses,
so this works at full dataset scale):

>>> from repro_torch.core.geometry import XCTGeometry
>>> from repro_torch.core.partition import PartitionConfig
>>> from repro_torch.core.recon import ReconConfig
>>> from repro_torch.dist import Topology
>>> adm = AdmissionController(
...     mem_budget=4 * 2**30,
...     topology=Topology.from_sizes([("model", 16, "ici")]),
...     fair_share=2)
>>> geo = XCTGeometry(n=512, n_angles=256)
>>> pcfg = PartitionConfig(n_data=16, tile=32, rows_per_block=64,
...                        nnz_per_stage=64)
>>> cost = adm.price(geo, pcfg, ReconConfig(precision="mixed", fuse=16),
...                  n_slices=4096)
>>> cost.slab_bytes <= 4 * 2**30          # one job fits its share
True
>>> adm.fits([cost, cost])                # two fair shares co-schedule
True
>>> adm.fits([cost] * 3)                  # a third would blow M
False
>>> try:                                  # explicit oversize: rejected
...     adm.price(geo, pcfg, ReconConfig(precision="mixed", fuse=16),
...               n_slices=4096, y_slab=4096)
... except ValueError as e:
...     print(str(e).split(":")[0])
y_slab=4096 overflows the budget
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["JobCost", "AdmissionController"]


@dataclasses.dataclass(frozen=True)
class JobCost:
    """The priced footprint of one job (see module docstring)."""

    fixed_bytes: int  # resident operator, shared per plan_key
    per_slice_bytes: int  # slab working set per slice
    y_slab: int  # slices per in-flight slab
    n_slices: int  # job volume

    @property
    def working_bytes(self) -> int:
        """The job's own in-flight term."""
        return self.y_slab * self.per_slice_bytes

    @property
    def slab_bytes(self) -> int:
        """Peak bytes if this job ran alone."""
        return self.fixed_bytes + self.working_bytes

    @property
    def n_slabs(self) -> int:
        return int(math.ceil(self.n_slices / self.y_slab))


class AdmissionController:
    """Price jobs against a byte budget; decide admit/queue/reject.

    ``fair_share`` is how many same-key jobs the sizing leaves room
    for; ``max_queue`` bounds the backlog (a submit past it is rejected
    -- backpressure, not unbounded latency).  A tuning passport
    (``repro_torch.tune``; pass one explicitly or a ``tune_dir`` to resolve
    this machine's by hardware fingerprint) flows into every
    ``suggest_slab`` pricing call, so admission and the streaming
    scheduler size slabs from the SAME tuned cap.
    """

    def __init__(
        self,
        mem_budget: int,
        topology,
        *,
        fair_share: int = 2,
        max_queue: int | None = None,
        passport=None,
        tune_dir: str | None = None,
    ):
        if fair_share < 1:
            raise ValueError(f"fair_share must be >= 1: {fair_share}")
        self.mem_budget = int(mem_budget)
        self.topology = topology
        self.fair_share = int(fair_share)
        self.max_queue = max_queue
        if passport is None and tune_dir is not None:
            from ..tune.passport import resolve_passport

            passport = resolve_passport(tune_dir)
        self.passport = passport

    # ------------------------------------------------------------------ #
    # pricing
    # ------------------------------------------------------------------ #
    def price(
        self,
        geo,
        pcfg,
        rcfg,
        n_slices: int,
        *,
        y_slab: int | None = None,
        plan=None,
    ) -> JobCost:
        """Price one job; raises ``ValueError`` when it can never fit.

        ``plan`` may pass a real (cached) partition plan to price exact
        shard shapes; the default prices an ``estimate_plan``
        abstraction -- allocation-free, so admission never builds what
        it might reject.
        """
        from ..core.partition import estimate_plan
        from ..stream.scheduler import suggest_slab

        if plan is None:
            plan = estimate_plan(geo, pcfg)
        # suggest_slab raises ValueError when operator + one granule
        # overflow the budget: that is the reject signal
        sp = suggest_slab(
            plan, rcfg, self.topology, self.mem_budget,
            n_slices=n_slices, passport=self.passport,
        )
        if y_slab is None:
            # fair share: leave room for fair_share - 1 peers
            share = (self.mem_budget - sp.fixed_bytes) // self.fair_share
            y_fair = (
                share // sp.per_slice_bytes // sp.granule * sp.granule
            )
            y_slab = max(sp.granule, min(sp.y_slab, y_fair))
            y_slab = min(
                y_slab, max(sp.granule, n_slices // sp.granule
                            * sp.granule),
            )
        else:
            y_slab = int(y_slab)
            if y_slab % sp.granule:
                raise ValueError(
                    f"y_slab {y_slab} not a multiple of the solve "
                    f"granule {sp.granule}"
                )
            if sp.fixed_bytes + y_slab * sp.per_slice_bytes \
                    > self.mem_budget:
                raise ValueError(
                    f"y_slab={y_slab} overflows the budget: "
                    f"{sp.fixed_bytes} operator + {y_slab} x "
                    f"{sp.per_slice_bytes} working > {self.mem_budget}"
                )
        return JobCost(
            fixed_bytes=sp.fixed_bytes,
            per_slice_bytes=sp.per_slice_bytes,
            y_slab=int(y_slab),
            n_slices=int(n_slices),
        )

    # ------------------------------------------------------------------ #
    # decisions
    # ------------------------------------------------------------------ #
    def fits(self, costs) -> bool:
        """Can these same-key jobs run concurrently under the budget?

        The operator term is shared (max, not sum -- one plan resident);
        each job adds only its slab working set.
        """
        costs = list(costs)
        if not costs:
            return True
        fixed = max(c.fixed_bytes for c in costs)
        working = sum(c.working_bytes for c in costs)
        return fixed + working <= self.mem_budget

    def queue_full(self, backlog: int) -> bool:
        return self.max_queue is not None and backlog >= self.max_queue
