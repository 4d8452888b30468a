"""The paper's four experimental datasets (Table II) as configs.

Dimensions are K (projections) x M (vertical detector rows == slices) x
N (horizontal channels).  The full shapes drive the dry run
(``launch.dryrun``) and the §Perf sweep (``launch.xct_perf``) through
analytic shard-shape estimation (``core.partition.estimate_plan``);
nothing of a dataset is downloaded or allocated.
"""
from __future__ import annotations

import dataclasses

__all__ = ["XCTDataset", "DATASETS"]


@dataclasses.dataclass(frozen=True)
class XCTDataset:
    name: str
    k: int  # projection angles
    m: int  # slices (detector rows)
    n: int  # detector channels == image side
    # suggested production partitioning (paper Sec. IV-B/E)
    p_data: int = 256
    open_data: bool = True


DATASETS = {
    "xct-shale": XCTDataset("xct-shale", 1501, 1792, 2048, p_data=64),
    "xct-chip": XCTDataset(
        "xct-chip", 1210, 1024, 2448, p_data=64, open_data=False
    ),
    "xct-charcoal": XCTDataset(
        "xct-charcoal", 4500, 4198, 6613, p_data=256
    ),
    "xct-brain": XCTDataset(
        "xct-brain", 4501, 9209, 11283, p_data=512, open_data=False
    ),
}
