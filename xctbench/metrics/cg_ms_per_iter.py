"""Device milliseconds of the operations launched inside the program's
``solve/dot``, ``solve/update`` and ``solve/scale`` ranges (the CG dots,
casts and vector updates, and the adaptive renormalization around each
operator application) per CG iteration per minibatch of ``fuse`` slices,
over the profiled calls, normalized as ``glue_ms_per_iter`` is
(``ranges.phase_ms_per_iter``)."""
from xctbench.ranges import phase_ms_per_iter

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "solver"
MOVES = "slices_per_s"


def read(run):
    return phase_ms_per_iter(run, ("solve/dot", "solve/update",
                                   "solve/scale"))
