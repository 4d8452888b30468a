"""Petascale XCT reconstruction on NVIDIA Hopper GPUs, in PyTorch.

The PyTorch/CUDA port of :mod:`repro`, module for module:

  core     -- geometry, Hilbert ordering, partitioning, precision,
              pipeline, CGNR solver, ``Reconstructor``
  kernels  -- the hand-written blocked-ELL SpMM kernel (``csrc/``), its
              plain PyTorch version and the dispatching ``apply_operator``
  dist     -- the communication ladder (``Topology``, ``CommPlan``) and
              the partial-data exchange over the ranks of a mesh
  data     -- phantoms and measurement simulation
  launch   -- the reconstruction CLI and device meshes

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
