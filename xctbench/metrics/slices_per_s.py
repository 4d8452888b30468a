"""Slices reconstructed per second: the slices of every call answered in
the window over the time from the first call's start to the last
answer's end (host clock), so all the work over all the time."""
UNIT = "slices/s"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = None  # end to end
MOVES = None


def read(run):
    done = [c for c in run.calls if c.error is None]
    if not done:
        return None
    return sum(c.slices for c in done) / (done[-1].t1 - run.calls[0].t0)
