"""Faults planted in the program's timed path, which ``correct`` has to
catch: the tests run each through a whole run, and ``calibrate.py``
reads the check's numbers under them on the card.

``planted(name)`` swaps the program's solver (``core.recon.cgnr``) or
``Reconstructor.reconstruct`` for a broken one while it is open:

* ``state_unchanged``: every CG step returns its state unchanged (``x0``,
  and the residual of ``x0`` after every step);
* ``stopped_after_<k>``: the solve runs ``k`` iterations and pads the
  residuals it owes with its last one (an early exit);
* ``steepest_descent``: each iteration restarts from the residual, so
  the direction drops CG's conjugate term;
* ``half_batch``: half of the slab's slices solved, the rest left zero;
* ``answer_altered``: one slice of every volume scaled by 1.1 where it
  is made.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["SOLVER_FAULTS", "FAULTS", "planted"]

SOLVER_FAULTS = ("state_unchanged", "stopped_after_1", "stopped_after_10",
                 "stopped_after_20", "steepest_descent")
FAULTS = SOLVER_FAULTS + ("half_batch", "answer_altered")


def _unchanged(cgnr):
    def broken(apply_a, apply_at, y, x0, iters, dot_rows, **kwargs):
        from repro_torch.core.sharded import Sharded

        norm = torch.sqrt(dot_rows(y, y).parts[0])
        return x0, Sharded([norm.expand(iters, -1).clone() for _ in y.parts],
                           y.ranks)
    return broken


def _stopped_after(k: int):
    def wrap(cgnr):
        def broken(apply_a, apply_at, y, x0, iters, dot_rows, **kwargs):
            done = min(k, iters)
            x, res = cgnr(apply_a, apply_at, y, x0, done, dot_rows, **kwargs)
            return x, torch.cat([res] + [res[-1:]] * (iters - done))
        return broken
    return wrap


def _steepest(cgnr):
    def broken(apply_a, apply_at, y, x0, iters, dot_rows, **kwargs):
        x, res = x0, []
        for _ in range(iters):
            x, r = cgnr(apply_a, apply_at, y, x, 1, dot_rows, **kwargs)
            res.append(r)
        return x, torch.cat(res)
    return broken


def _half_batch(reconstruct):
    def broken(self, sino, iters=30, x0_nat=None):
        half = sino.shape[1] // 2
        x, res = reconstruct(self, np.ascontiguousarray(sino[:, :half]),
                             iters, x0_nat)
        return (np.concatenate([x, np.zeros_like(x)], axis=1),
                np.concatenate([res, np.zeros_like(res)], axis=1))
    return broken


def _altered(reconstruct):
    def broken(self, sino, iters=30, x0_nat=None):
        x, res = reconstruct(self, sino, iters, x0_nat)
        x[:, 1] *= 1.1
        return x, res
    return broken


@contextlib.contextmanager
def planted(name: str | None):
    """The fault ``name`` planted while the block runs (``None``: none)."""
    if name is None:
        yield
        return
    from repro_torch.core import recon

    if name in ("half_batch", "answer_altered"):
        owner, attr = recon.Reconstructor, "reconstruct"
        wrap = _half_batch if name == "half_batch" else _altered
    elif name in SOLVER_FAULTS:
        owner, attr = recon, "cgnr"
        wrap = (_unchanged if name == "state_unchanged" else _steepest
                if name == "steepest_descent"
                else _stopped_after(int(name.rsplit("_", 1)[1])))
    else:
        raise ValueError(f"no fault {name!r}; there are {FAULTS}")
    saved = getattr(owner, attr)
    setattr(owner, attr, wrap(saved))
    try:
        yield
    finally:
        setattr(owner, attr, saved)
