"""Milliseconds a call spends outside its fenced ``recon/solve`` span
(packing, normalizing and uploading the sinogram, downloading and
unpacking the volume), averaged over the window's calls: each call's
host-clock wall less its span (``Run.outside_solve_ms``)."""
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "staging"
MOVES = "slices_per_s"


def read(run):
    return run.outside_solve_ms()
