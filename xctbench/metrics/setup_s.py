"""Seconds from the process's start to the window's: imports, the plan
and the benchmark's matrix (built on a checkout's first run, loaded
after), the inputs, the bind and the warm-up (host clock)."""
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = None  # end to end
MOVES = None


def read(run):
    return run.setup_s
