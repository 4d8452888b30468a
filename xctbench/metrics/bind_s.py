"""Seconds of ``Reconstructor.__init__`` (the operator's upload, the
scatter passes), ending in a device synchronize (host clock)."""
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "bind"
MOVES = "setup_s"


def read(run):
    return run.bind_s
