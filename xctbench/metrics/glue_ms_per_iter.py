"""Milliseconds of device work that is neither an SpMM kernel nor a copy
between host and device (so: the CG updates and dots, the scatter
passes, casts, copies on the device) per CG iteration per minibatch of
``fuse`` slices, summed over the profiled calls' device operations."""
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "solver"
MOVES = "slices_per_s"


def read(run):
    prof = run.profile
    if prof is None:
        return None
    cfg = run.cell.config
    minibatches = run.cell.traffic["slab_slices"] // cfg["fuse"]
    return 1e3 * prof["other_s"] / (prof["solves"] * minibatches
                                    * cfg["iters"])
