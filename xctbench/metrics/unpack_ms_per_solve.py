"""Milliseconds of a call's ``recon/unpack`` span (the volume back to
natural order and scale, the finiteness check), averaged over the
window's calls (``ranges.span_ms``: the program's tracer, which the
harness enables before the warm-up, resets after it and only disables
after the window; ``None`` unless every call of the window has the
span)."""
from xctbench.ranges import span_ms

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "staging"
MOVES = "slices_per_s"


def read(run):
    return span_ms(run, "recon/unpack")
