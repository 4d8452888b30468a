"""The SpMM kernels' share of their roofline, in percent: the least time
one application could take on this card (``roofline.spmm_min_s``, from
the nonzeros of the benchmark's own matrix and the policy's widths)
over the measured time per application (device time of the kernels
named ``xct_spmm*`` in the profiled calls, over the launches the
program counted there, one per operator, minibatch and application)."""
from xctbench.roofline import spmm_min_s

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "slices_per_s"


def read(run):
    prof = run.profile
    if prof is None or not prof["launches"] or not prof["spmm_s"]:
        return None
    least = spmm_min_s(run.nnz, run.n_vox, run.n_rays,
                       run.cell.config["fuse"], run.precision, run.kind)
    if least is None:
        return None
    return 100.0 * least[0] / (prof["spmm_s"] / prof["launches"])
