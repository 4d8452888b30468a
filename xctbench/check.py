"""How ``correct`` is decided: every answer of the run against the plain
reference.

An answer is what one ``reconstruct`` call returned: the volume ``x``
and the residual norm ``res[i]`` after every CG iteration ``i``, per
slice.  The reference (``reference/``: the benchmark's own matrix, in
float64) runs its own 30-iteration CGNR on the same host sinograms ``y``
the program was sent, giving ``ref[i]``, and reads the answers:

* ``res_head_gap``, the start: the widest ``|res[i] - ref[i]| / ref[i]``
  over the first ``HEAD`` iterations and the answers' slices.  Over these
  iterations the program follows the reference closely; a wrong scalar,
  update or direction (a CG that stops, restarts, or drops a term) parts
  from it at once;
* ``fit_gap``, the volume: the widest ``| ||y - A x|| - res[-1] | /
  res[-1]``: the volume returned has to leave the residual the program
  reports for it;
* ``res_end_excess``, the end: the largest ``(res[-1] - ref[-1]) /
  ref[-1]``, one-sided: a solve that stopped early or converges slower
  than CGNR leaves a larger residual than the reference's 30 iterations;
* ``res_end_bias``: the mean of that same ratio over the slices, signed:
  the steadier reading of the same thing.

Past the head the iterations are not followed one by one: two CGNR
solves whose arithmetic differs by a float32 rounding part by percents
within 30 iterations on these operators (their smallest singular values
amplify it), so the end is held one-sided, by how far the program's
residual lies above the reference's.  ``vol_gap`` (widest ``||x -
x_ref|| / ||x_ref||``) and ``res_gap_by_iter`` (the widest gap after each
iteration) are given for the record.

Answers for one slab that are equal bit for bit are judged once.  An
answer that raised, or came with the wrong shape or a non-finite value,
is failed.  The limits are the configuration's (``limits``), each set
between what sound runs of the program read and what its control, the
next precision down, or a planted fault reads; a number without a limit
is not compared.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .reference.cgnr import cgnr

__all__ = ["HEAD", "NUMBERS", "judge", "verdict"]

HEAD = 4  # iterations followed one by one
# the numbers a configuration's ``limits`` may name
NUMBERS = ("res_head_gap", "fit_gap", "res_end_excess", "res_end_bias",
           "vol_gap")
_COLUMNS = 256  # answers' slices per product with A


def _distinct(whole: list) -> list:
    """``whole`` less the answers equal bit for bit to an earlier answer
    for the same slab."""
    seen: dict = {}
    out = []
    for k, x, res in whole:
        firsts = seen.setdefault(k, [])
        if not any(np.array_equal(res, r) and np.array_equal(x, v)
                   for v, r in firsts):
            firsts.append((x, res))
            out.append((k, x, res))
    return out


def judge(answers: list, pool: list, ops, iters: int) -> dict:
    """The readings over ``answers``, each ``(slab, x, res, error)``, by
    the reference's ``ops`` (``reference.cgnr.operator`` of the
    benchmark's matrix, float64): ``attempted``, ``failed``,
    ``distinct`` (the answers judged) and the numbers of the module's
    docstring; a number is ``nan`` when no answer came whole."""
    fwd, back = ops
    device = fwd.device
    y = torch.from_numpy(np.concatenate(pool, axis=1)).to(device,
                                                           torch.float64)
    x_ref, res_ref = cgnr(fwd, back, y, iters)
    slab = pool[0].shape[1]
    whole = [(k, x, res) for k, x, res, error in answers
             if error is None and x is not None and res is not None
             and x.shape == (fwd.shape[1], slab) and res.shape == (iters, slab)
             and np.isfinite(x).all() and np.isfinite(res).all()]
    distinct = _distinct(whole)
    gaps: dict = {name: [] for name in NUMBERS if name != "res_end_bias"}
    by_iter = torch.zeros(iters, dtype=torch.float64)
    end_sum, end_count = 0.0, 0
    per = max(1, _COLUMNS // slab)
    for i in range(0, len(distinct), per):
        chunk = distinct[i:i + per]
        cols = [torch.arange(k * slab, (k + 1) * slab) for k, _, _ in chunk]
        cols = torch.cat(cols).to(device)
        x = torch.from_numpy(np.concatenate([c[1] for c in chunk], axis=1)
                             ).to(device, torch.float64)
        res = torch.from_numpy(np.concatenate([c[2] for c in chunk], axis=1)
                               ).to(device, torch.float64)
        ref = res_ref[:, cols]
        rel = (res - ref) / ref
        gaps["res_head_gap"].append(float(rel[:HEAD].abs().max()))
        fit = torch.linalg.vector_norm(y[:, cols] - fwd @ x, dim=0)
        gaps["fit_gap"].append(float(((fit - res[-1]).abs() / res[-1]).max()))
        gaps["res_end_excess"].append(float(rel[-1].max()))
        end_sum += float(rel[-1].sum())
        end_count += rel.shape[1]
        xr = x_ref[:, cols]
        gaps["vol_gap"].append(float(
            (torch.linalg.vector_norm(x - xr, dim=0)
             / torch.linalg.vector_norm(xr, dim=0)).max()))
        by_iter = torch.maximum(by_iter, rel.abs().amax(dim=1).cpu())
    out = {name: (float("nan") if not v or any(math.isnan(g) for g in v)
                  else max(v)) for name, v in gaps.items()}
    out["res_end_bias"] = (end_sum / end_count if end_count
                           else float("nan"))
    return dict(attempted=len(answers), failed=len(answers) - len(whole),
                distinct=len(distinct), **out,
                res_gap_by_iter=by_iter.tolist() if distinct else [])


def verdict(judged: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {value, limit}})`` over the numbers that have a
    limit (a value is ``None`` where no answer came whole, or where it is
    not finite, as a division by a residual of 0 gives): correct when
    every answer came whole and each number is within its limit."""
    numbers = {name: {"value": judged[name] if math.isfinite(judged[name])
                      else None, "limit": limit}
               for name, limit in limits.items() if limit is not None}
    ok = (judged["attempted"] > 0 and judged["failed"] == 0 and numbers
          and all(n["value"] is not None and n["value"] <= n["limit"]
                  for n in numbers.values()))
    return bool(ok), numbers
