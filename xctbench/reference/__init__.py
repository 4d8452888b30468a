"""The plain reference the benchmark judges the program against.

Plain NumPy, SciPy and PyTorch only: nothing here imports the measured
program or the JAX package.  ``geometry`` is a frozen copy of the
parallel-beam Siddon projector, ``phantom`` a frozen copy of the phantom
generator written in plain torch (so the inputs are made on the card),
and ``cgnr`` the solver, in float64.
"""
