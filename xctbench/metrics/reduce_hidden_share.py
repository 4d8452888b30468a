"""Percent of the reduce phase's device time during which an SpMM
kernel also ran: the union of the operations launched inside the
program's ``solve/reduce`` ranges, against the union of the
``xct_spmm*`` kernels, over the profiled calls (``ranges.hidden_share``;
the paper's overlap of minibatch i-1's reduction with minibatch i's
kernel, Fig. 8)."""
from xctbench.ranges import hidden_share, run_ops

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "solver"
MOVES = "slices_per_s"


def read(run):
    ops = run_ops(run)
    return None if ops is None else hidden_share(ops)
