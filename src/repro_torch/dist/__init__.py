"""Topology-aware hierarchical communication (paper Sec. III-B).

The paper reduces partial sinograms/tomograms with a *hierarchy* of
communicators matched to the machine's links: first among GPUs that share
a socket, then across sockets within a node, then across nodes -- each
rung a faster, smaller reduction whose output is all the slower rung must
carry.  The rungs map onto mesh axes:

  paper level   mesh axis   link class   role
  -----------   ---------   ----------   -------------------------------
  socket        "model"     fast ("ici") in-slice data parallelism
  node          "data"      "ici"        data parallelism
  global        "pod"       slow ("dci") outermost

(see ``launch.mesh.mesh_axis_classes``).  :class:`Topology` declares that
ladder once; :class:`CommPlan` resolves a reduction mode
(``direct | rs | hier | sparse | hier-sparse``) against it into a
schedule of per-level collectives plus a per-level wire-volume model.
The runtime entry points (:func:`reduce_partials`,
:func:`sparse_exchange`, :func:`hierarchical_psum`) act on lists of
per-rank tensors, one process driving every rank of a
``DeviceMesh``.

Submodules:
  topology     Topology / CommPlan / Level (the ladder engine)
  collectives  the reductions and the sparse exchange over rank lists
  fault        stragglers, rebalancing, checkpoint cadence, remesh
  sharding     the LM's parameter / batch / cache specs on a mesh
"""
from .collectives import (  # noqa: F401
    hierarchical_psum,
    reduce_partials,
    sparse_exchange,
)
from .topology import (  # noqa: F401
    CommPlan,
    CommStep,
    DeviceMesh,
    Level,
    LINK_CLASSES,
    MODES,
    Topology,
)

__all__ = [
    "Topology",
    "CommPlan",
    "CommStep",
    "DeviceMesh",
    "Level",
    "LINK_CLASSES",
    "MODES",
    "reduce_partials",
    "sparse_exchange",
    "hierarchical_psum",
]
