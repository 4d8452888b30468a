"""Typed failures of the solve.

* :class:`NonFiniteSolveError` -- the CG solve returned NaN/Inf (a
  narrow-precision solve that blew up).  Callers that retry or escalate
  dispatch on this type.
"""
from __future__ import annotations

__all__ = ["NonFiniteSolveError"]


class NonFiniteSolveError(FloatingPointError):
    """A solve produced NaN/Inf values."""
