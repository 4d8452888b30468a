"""Wire volumes of the partial-data exchange, per link class.

The port's copy of ``sweep_topology`` and ``comm_volume`` from the
reference's ``launch/xct_perf.py`` (the autotuner, the drift report and
``Reconstructor._emit_exchange`` price the exchange with them); its
``sweep`` / ``main`` over the paper's datasets are not ported yet.

Wire volumes are not computed here: every byte count flows from
``dist.CommPlan``'s per-link-class volume model, with the sparse-mode
table capacities supplied by ``core.partition.exchange_volume_params``.
``sweep_topology`` builds the meshless production ladder (a 16-wide fast
"socket" level, a fast level filling the pod, a slow level across pods
of 256).

>>> from repro_torch.core.geometry import XCTGeometry
>>> from repro_torch.core.partition import PartitionConfig, estimate_plan
>>> plan = estimate_plan(XCTGeometry(n=64, n_angles=48),
...                      PartitionConfig(n_data=512))
>>> topo = sweep_topology(512)
>>> print(topo.describe())
Topology over 512 devices
  socket: axis 'model' x16 (ici)
    node: axis 'data' x16 (ici)
  global: axis 'pod' x2 (dci)
>>> direct = comm_volume(plan, "direct", fuse=16, comm_bytes=2, topo=topo)
>>> hier = comm_volume(plan, "hier", fuse=16, comm_bytes=2, topo=topo)
>>> direct["dci"], hier["dci"]  # the ladder: 1/(socket*node) crosses
(1048576.0, 4096.0)
"""
from __future__ import annotations

from ..core.partition import exchange_volume_params
from ..dist import Topology

__all__ = ["comm_volume", "sweep_topology"]


def sweep_topology(p_data: int, fast: int = 16, pod: int = 256) -> Topology:
    """Meshless production ladder for ``p_data`` in-slice devices.

    A ``fast``-wide minor fast-link socket, a major fast-link node level
    filling the pod, and a slow level across pods when ``p_data`` spills
    past one pod.
    """
    f = min(fast, p_data)
    mid = max(1, min(p_data // f, pod // f))
    rest = p_data // (f * mid)
    if f * mid * rest != p_data:
        raise ValueError(
            f"p_data={p_data} does not factor into the production "
            f"ladder (fast={fast}, pod={pod}); got {f}x{mid}x{rest}"
        )
    sizes = [("model", f, "ici")]
    if mid > 1:
        sizes.append(("data", mid, "ici"))
    if rest > 1:
        sizes.append(("pod", rest, "dci"))
    return Topology.from_sizes(sizes)


def comm_volume(plan, mode: str, fuse: int, comm_bytes: int,
                topo: Topology, wire: str = "native") -> dict:
    """Per-device wire bytes per reduction, by link class, from CommPlan.

    Sums the proj and back operators' per-link volumes under ``topo``'s
    ladder; the table capacities for the sparse modes come from
    ``core.partition.exchange_volume_params`` (exact when the plan holds
    real shards, analytic for ``estimate_plan`` abstractions).
    ``wire="q8"`` (hier-sparse only) prices the int8-compressed slow-axis
    hop of ``dist.collectives.sparse_exchange``.
    """
    out = {"ici": 0.0, "dci": 0.0}
    for op in (plan.proj, plan.back):
        dense = float(op.n_rows_pad) * fuse * comm_bytes
        # the dense modes ignore the table capacities -- skip building
        # the (possibly exact, O(P^2 V)) exchange tables for them
        params = (
            exchange_volume_params(op, topo)
            if mode in ("sparse", "hier-sparse") else {}
        )
        cp = topo.plan(mode, wire=wire, comm_bytes=comm_bytes, **params)
        for link, b in cp.wire_bytes_by_link(dense).items():
            out[link] = out.get(link, 0.0) + b
    return out
