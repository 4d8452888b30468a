"""The 95th percentile (nearest rank) of every call's wall time in the
window, host sinogram in to host volume out (host clock)."""
import math

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = None  # end to end
MOVES = None


def read(run):
    walls = sorted(c.t1 - c.t0 for c in run.calls)
    if not walls:
        return None
    return walls[math.ceil(0.95 * len(walls)) - 1]
