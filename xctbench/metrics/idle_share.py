"""Percent of the profiled stretch (a few calls after the window) in
which no kernel, copy or fill ran on the device: one minus the union of
the device's intervals over the stretch, from the profiler's trace."""
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "slices_per_s"


def read(run):
    prof = run.profile
    if prof is None:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
