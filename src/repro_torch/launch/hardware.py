"""The card's rates that the cost models divide by.

The port's counterpart of the reference's ``Hardware`` / ``HW`` in
``launch/hlo_analysis.py``, whose other contents analyse an XLA lowering
and have no counterpart here.  One record, for the card the port runs
on: the NVIDIA H100 SXM5 80GB.  Every rate is a published peak from
NVIDIA's H100 Tensor Core GPU datasheet (SXM form factor, dense rates
without sparsity), which assume the card's full power limit of 700 W; a
card set below it runs slower under load, so a measurement beside these
numbers names the card's power limit (``nvidia-smi
--query-gpu=name,power.limit``).

The link classes keep the reference's names (``dist.LINK_CLASSES``):
``ici`` is the fast in-node link (NVLink 4 through the NVSwitch), ``dci``
the slow link between nodes (one InfiniBand NDR port per GPU, as a
DGX H100 wires them).  Both are per direction.

>>> HW.hbm_bw
3350000000000.0
>>> 18 * HW.ici_bw   # all eighteen NVLink links, one direction
450000000000.0
"""
from __future__ import annotations

import dataclasses

__all__ = ["Hardware", "HW"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    # dense bf16 / fp16 tensor-core peak (H100 SXM datasheet: 989 TFLOP/s)
    peak_flops: float = 989e12
    # float32 outside the tensor cores (H100 SXM datasheet: 67 TFLOP/s)
    f32_flops: float = 67e12
    # HBM3 device memory, 80 GB (H100 SXM datasheet: 3.35 TB/s)
    hbm_bw: float = 3.35e12
    # its size (H100 SXM datasheet: 80 GB); the dry run holds a rank's
    # peak against it
    hbm_bytes: float = 80e9
    # one NVLink 4 link, one direction (H100 SXM datasheet: 900 GB/s
    # both directions over 18 links, 25 GB/s each way a link)
    ici_bw: float = 25e9
    # the inter-node link per GPU, one direction: one ConnectX-7
    # InfiniBand NDR port, 400 Gb/s (DGX H100 datasheet: eight ports for
    # eight GPUs)
    dci_bw: float = 50e9


HW = Hardware()
