"""Modeled-tier config autotuner: sweep knobs, pick argmin, mint passport
(the port's copy of the reference's ``tune/autotune.py``, priced with the
H100's rates, ``launch.hardware.HW``).

The sweep axes are exactly the knobs the rest of the stack already
exposes -- kernel block shape ``(R, K)``, slab budget fraction, comm
mode, window-DMA mode, and window-slot order -- and every candidate is
priced by the SAME shared models the roofline sweeps and CI gates pin:

  * ``core.partition.estimate_plan``  -- allocation-free shard shapes;
  * ``kernels.traffic.spmm_traffic`` + ``dma_issue_seconds``  -- device
    memory bytes and copy-issue seconds of the fused SpMM (slot-order
    aware);
  * ``launch.xct_perf.comm_volume``  -- per-link-class wire bytes under
    the production topology ladder;
  * ``stream.scheduler.suggest_slab``  -- slab feasibility under the
    byte budget (an infeasible candidate is skipped, not crashed on).

Because the models are closed-form, the *modeled tier needs no
accelerator*: tuning for a 512-GPU machine runs on a laptop.  An
optional measured tier (``measure=`` callable) re-ranks the top modeled
candidates by wall clock on real hardware -- but never silently: the
traffic module warns when timings taken off the card are used to rank
dma modes (see ``spmm_traffic(interpret_timed=True)``).

The argmin is deterministic: the space is enumerated in a fixed nested
order and ties keep the first winner, so two runs of the same sweep
mint byte-identical passports (pinned by ``tests/test_torch_tune.py``).
"""
from __future__ import annotations

import math

from ..core.partition import (
    SLOT_ORDERS,
    PartitionConfig,
    default_socket,
    estimate_plan,
)
from ..core.precision import get_policy
from ..kernels.traffic import (
    DMA_MODES,
    PER_COPY_OVERHEAD_S,
    dma_issue_seconds,
    spmm_traffic,
)
from ..launch.hardware import HW
from .passport import (
    TuningPassport,
    describe_hardware,
    hardware_fingerprint,
)

__all__ = ["DEFAULT_SPACE", "modeled_objective", "autotune"]

# Non-overlapped cost of one slab boundary (prefetch warmup + solver
# re-entry): a model constant that makes the slab-size axis meaningful
# -- bigger slabs amortize more boundaries -- without pretending to
# know a filesystem.  Candidates differing only in slab_frac tie on
# kernel/comm seconds and split on this term.
SLAB_BOUNDARY_S = 1e-3

DEFAULT_SPACE = {
    "block": [(32, 32), (64, 64)],  # (rows_per_block, nnz_per_stage)
    "tile": [8],  # Hilbert patch side; widen at production scale
    "slab_frac": [1.0, 0.5, 0.25],  # fraction of mem_budget per slab
    "comm_mode": ["direct", "rs", "hier", "sparse", "hier-sparse"],
    "dma": list(DMA_MODES),
    "slot_order": list(SLOT_ORDERS),
    # precision ladder rungs worth sweeping: the paper's mixed default
    # vs the quantized operator tier (int8 vals + per-block scales)
    "precision": ["mixed", "q8"],
    # hier-sparse slow-axis wire: native comm dtype vs int8+scale
    # compression (only paired with comm_mode="hier-sparse")
    "wire": ["native", "q8"],
}


def modeled_objective(
    geo,
    knobs: dict,
    *,
    p_data: int,
    topology,
    mem_budget: int,
    fuse: int = 16,
    precision: str = "mixed",
    n_slices: int | None = None,
    per_copy_overhead_s: float = PER_COPY_OVERHEAD_S,
    _plan_cache: dict | None = None,
) -> dict:
    """Price one knob setting; raises ``ValueError`` when infeasible.

    Returns the per-iteration modeled seconds of one full volume pass
    (``total_seconds``) plus its auditable terms: ``dma_issue_seconds``
    (the issue-overhead term run-length coalescing and slot reordering
    attack), ``hbm_seconds`` (device-memory bytes over ``HW.hbm_bw``), ``ici_seconds``/``dci_seconds`` (from the
    per-link wire bytes, also returned), the granted ``y_slab`` and
    slab count.  All terms per device.
    """
    from ..core.recon import ReconConfig
    from ..launch.xct_perf import comm_volume
    from ..stream.scheduler import suggest_slab

    r, k = knobs["block"]
    key = (r, k, knobs["tile"], knobs["slot_order"])
    cache = _plan_cache if _plan_cache is not None else {}
    if key not in cache:
        cache[key] = estimate_plan(
            geo,
            PartitionConfig(
                n_data=p_data, tile=knobs["tile"], rows_per_block=r,
                nnz_per_stage=k, socket=default_socket(p_data, p_data),
                slot_order=knobs["slot_order"],
            ),
        )
    plan = cache[key]
    prec = knobs.get("precision", precision)
    wire_fmt = knobs.get("wire", "native")
    pol = get_policy(prec)
    rcfg = ReconConfig(
        precision=prec, comm_mode=knobs["comm_mode"], fuse=fuse,
        dma=knobs["dma"], wire=wire_fmt,
    )
    budget = int(mem_budget * knobs["slab_frac"])
    sp = suggest_slab(
        plan, rcfg, topology, budget, n_slices=n_slices,
    )  # ValueError here = candidate infeasible under its slab budget

    issue_s = hbm_s = 0.0
    for op in (plan.proj, plan.back):
        _, b, s, rr, kk = op.inds.shape
        t = spmm_traffic(
            b, s, rr, kk, op.winmap.shape[-1], fuse,
            storage_bytes=pol.storage_bytes,
            vals_bytes=pol.vals_bytes, staging="fused",
            dma=knobs["dma"], slot_order=knobs["slot_order"],
        )
        issue_s += t["dma_issues"] * per_copy_overhead_s
        hbm_s += t["hbm_bytes"] / HW.hbm_bw
    wire = comm_volume(
        plan, knobs["comm_mode"], fuse, pol.comm_bytes, topology,
        wire=wire_fmt,
    )
    ici_s = wire["ici"] / HW.ici_bw
    dci_s = wire["dci"] / HW.dci_bw

    minis = sp.y_slab // sp.granule
    n_slabs = (
        int(math.ceil(n_slices / sp.y_slab)) if n_slices else 1
    )
    # minibatches for the WHOLE volume count granules of n_slices: the
    # last slab is partial, so slabs x full-slab minis would overbill
    # exactly the candidates whose smaller operator grew y_slab
    total_minis = (
        int(math.ceil(n_slices / sp.granule)) if n_slices else minis
    )
    per_mini = issue_s + hbm_s + ici_s + dci_s
    total = per_mini * total_minis + n_slabs * SLAB_BOUNDARY_S
    return {
        "total_seconds": total,
        "dma_issue_seconds": issue_s,
        "hbm_seconds": hbm_s,
        "ici_seconds": ici_s,
        "dci_seconds": dci_s,
        "ici_bytes": wire["ici"],
        "dci_bytes": wire["dci"],
        "y_slab": int(sp.y_slab),
        "n_slabs": n_slabs,
    }


def _baseline_knobs(space: dict) -> dict:
    """The untuned reference: stock runtime defaults on the legacy
    first-seen layout (what every job ran before the tuner existed)."""
    return {
        "block": (32, 32),
        "tile": space["tile"][0],
        "slab_frac": 1.0,
        "comm_mode": "hier",
        "dma": "coalesced",
        "slot_order": "first_seen",
        "precision": "mixed",
        "wire": "native",
    }


def autotune(
    geo,
    *,
    p_data: int = 1,
    topology=None,
    mem_budget: int,
    n_slices: int | None = None,
    fuse: int = 16,
    precision: str = "mixed",
    space: dict | None = None,
    per_copy_overhead_s: float | None = None,
    overhead_source: str | None = None,
    measure=None,
    hardware: dict | None = None,
) -> tuple[TuningPassport, list[dict]]:
    """Sweep the knob space, mint the argmin passport.

    Args:
      geo: ``core.geometry.XCTGeometry`` of the target workload.
      p_data: in-slice data-parallel devices to plan for.
      topology: ``dist.Topology``; default is the meshless production
        ladder ``launch.xct_perf.sweep_topology(p_data)``.
      mem_budget: bytes available per device for operator + slabs.
      n_slices: volume depth (enables the slab-amortization term).
      space: sweep axes, same keys as :data:`DEFAULT_SPACE` (missing
        keys take the defaults).
      per_copy_overhead_s / overhead_source: calibrated copy issue
        overhead (see ``tune.calibrate.calibrate_per_copy_overhead``);
        defaults to the traffic-model constant, recorded as
        ``overhead_source="default"``.
      measure: optional ``measure(knobs) -> seconds`` callable; when
        given, the top 3 modeled candidates are re-ranked by it
        (measured tier).
      hardware: override :func:`passport.describe_hardware` (tests).

    Returns ``(passport, trials)``: the minted (NOT yet saved) passport
    and the full trial log, one dict per candidate, infeasible ones
    included with ``feasible=False``.
    """
    if topology is None:
        from ..launch.xct_perf import sweep_topology

        topology = sweep_topology(p_data)
    sp = dict(DEFAULT_SPACE)
    sp.update(space or {})
    if "precision" not in (space or {}) and precision != "mixed":
        # an explicit precision= restricts the axis (legacy callers
        # tuned FOR a policy; a space override still wins)
        sp["precision"] = [precision]
    overhead = (
        PER_COPY_OVERHEAD_S
        if per_copy_overhead_s is None
        else float(per_copy_overhead_s)
    )
    source = overhead_source or (
        "default" if per_copy_overhead_s is None else "measured"
    )

    plan_cache: dict = {}
    common = dict(
        p_data=p_data, topology=topology, mem_budget=mem_budget,
        fuse=fuse, precision=precision, n_slices=n_slices,
        per_copy_overhead_s=overhead, _plan_cache=plan_cache,
    )
    trials: list[dict] = []
    best = None  # (total, trial) -- strict < keeps the first winner
    for block in sp["block"]:
        for tile in sp["tile"]:
            for slot_order in sp["slot_order"]:
                for dma in sp["dma"]:
                    for comm_mode in sp["comm_mode"]:
                        for prec in sp["precision"]:
                            for wire in sp["wire"]:
                                # q8 wire compresses the hier-sparse
                                # slow hop; other modes have none, so
                                # the combo duplicates wire="native"
                                if (wire != "native"
                                        and comm_mode != "hier-sparse"):
                                    continue
                                for slab_frac in sp["slab_frac"]:
                                    knobs = {
                                        "block": tuple(block),
                                        "tile": tile,
                                        "slot_order": slot_order,
                                        "dma": dma,
                                        "comm_mode": comm_mode,
                                        "precision": prec,
                                        "wire": wire,
                                        "slab_frac": slab_frac,
                                    }
                                    try:
                                        obj = modeled_objective(
                                            geo, knobs, **common
                                        )
                                    except ValueError:
                                        trials.append(
                                            {**knobs, "feasible": False}
                                        )
                                        continue
                                    trial = {
                                        **knobs, **obj, "feasible": True
                                    }
                                    trials.append(trial)
                                    if best is None or (
                                        obj["total_seconds"] < best[0]
                                    ):
                                        best = (
                                            obj["total_seconds"], trial
                                        )
    if best is None:
        raise ValueError(
            f"no feasible candidate under mem_budget={mem_budget}; "
            "the operator alone may overflow every slab fraction"
        )
    if measure is not None:
        top = sorted(
            (t for t in trials if t["feasible"]),
            key=lambda t: t["total_seconds"],
        )[:3]
        timed = [(measure({k: t[k] for k in (
            "block", "tile", "slot_order", "dma", "comm_mode",
            "precision", "wire", "slab_frac")}), t) for t in top]
        best = (best[0], min(timed, key=lambda x: x[0])[1])

    win = best[1]
    try:
        base = modeled_objective(geo, _baseline_knobs(sp), **common)
    except ValueError:
        base = None
    hw = hardware if hardware is not None else describe_hardware()
    passport = TuningPassport(
        fingerprint=hardware_fingerprint(hw),
        hardware=hw,
        knobs={
            "rows_per_block": win["block"][0],
            "nnz_per_stage": win["block"][1],
            "tile": win["tile"],
            "slot_order": win["slot_order"],
            "dma": win["dma"],
            "comm_mode": win["comm_mode"],
            "fuse": fuse,
            "precision": win["precision"],
            "wire": win["wire"],
            "y_slab": win["y_slab"],
        },
        workload={
            "n": geo.n, "n_angles": geo.n_angles, "p_data": p_data,
            "n_slices": n_slices, "mem_budget": int(mem_budget),
        },
        objective={
            k: win[k]
            for k in (
                "total_seconds", "dma_issue_seconds", "hbm_seconds",
                "ici_seconds", "dci_seconds", "ici_bytes", "dci_bytes",
                "n_slabs",
            )
        } | ({"baseline": base} if base is not None else {}),
        per_copy_overhead_s=overhead,
        overhead_source=source,
    )
    return passport, trials
