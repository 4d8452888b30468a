"""AdamW with f32 state, and SGD with momentum: the reference's
``opt/adam.py`` in PyTorch.

Functional, as the reference's: ``init(params)`` gives the state and
``update(grads, state, params)`` returns ``(new_params, new_state)``
without touching its arguments.  ``params`` and ``grads`` are trees of
``opt.tree`` (a dict, or the model's ``LMParams``); the state mirrors
``params`` in f32, and ``count`` is an int32 tensor.  The formula is the
reference's, not ``torch.optim.AdamW``'s, which differs in three
places: the global-norm clip (``min(1, clip / (|g| + 1e-9))``), bias
corrections applied inside the step (``(m / b1c) / (sqrt(v / b2c) +
eps)``), and weight decay added to the step before the step is scaled
by ``lr``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..placement import copy_kind, empty_on
from .tree import leaves, tree_map

__all__ = ["AdamW", "sgd_momentum"]


def _f32(x):
    return x.to(torch.float32)


def _piece(pl, idx):
    """``pl``'s piece at ``idx``, or a fake of a piece's shape on that
    position's device where the position is a phantom (the dry run)."""
    g = pl.pieces[idx]
    if g is not None:
        return g
    like = next(p for p in pl.pieces.flat if p is not None)
    return empty_on(like.shape, like.dtype, pl.mesh.devices[idx])


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0

    def init(self, params) -> dict:
        ps = leaves(params)
        dev = ps[0].device if ps else None
        with torch.no_grad():
            zeros = tree_map(
                lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                      device=x.device), params)
            return {"m": zeros,
                    "v": tree_map(torch.zeros_like, zeros),
                    "count": torch.zeros((), dtype=torch.int32,
                                         device=dev)}

    @torch.no_grad()
    def update(self, grads, state, params) -> tuple[Any, dict]:
        if hasattr(params, "leaves") and hasattr(params, "template"):
            return self._update_placed(grads, state, params)
        count = state["count"] + 1
        gs = leaves(grads)
        if self.grad_clip > 0:
            gsq = None
            for g in gs:  # jax.tree.reduce: ((l0 + l1) + l2) + ...
                s = torch.sum(_f32(g) ** 2)
                gsq = s if gsq is None else gsq + s.to(gsq.device)
            gnorm = torch.sqrt(gsq)
            scale = torch.clamp_max(self.grad_clip / (gnorm + 1e-9), 1.0)
        else:
            scale = torch.ones((), dtype=torch.float32, device=count.device)

        cf = count.to(torch.float32)
        b1c = 1.0 - torch.pow(torch.full_like(cf, self.b1), cf)
        b2c = 1.0 - torch.pow(torch.full_like(cf, self.b2), cf)

        def at(t, x):  # a scalar tensor on x's device
            return t.to(x.device)

        new_m = tree_map(
            lambda g, m: self.b1 * m
            + (1 - self.b1) * _f32(g) * at(scale, g),
            grads, state["m"],
        )
        new_v = tree_map(
            lambda g, v: self.b2 * v
            + (1 - self.b2) * (_f32(g) * at(scale, g)) ** 2,
            grads, state["v"],
        )

        def upd(p, m, v):
            step = (m / at(b1c, m)) / (torch.sqrt(v / at(b2c, v))
                                       + self.eps)
            if self.weight_decay:
                step = step + self.weight_decay * _f32(p)
            return (_f32(p) - self.lr * step).to(p.dtype)

        new_params = tree_map(upd, params, new_m, new_v)
        return new_params, {"m": new_m, "v": new_v, "count": count}

    def _update_placed(self, grads, state, params):
        """:meth:`update` on a laid-out state (``dist.sharding
        .PlacedTree``s and a ``Placed`` count, ``grads`` laid out as
        ``params``): the same formula piece by piece, each position
        updating its own pieces.  The clip's global norm counts each
        element once, from the pieces that tile each leaf
        (``Placed.owners``: a piece held whole by several positions
        counts once), summed leaf by leaf on the first position's device
        and sent to every other (``"psum"``)."""
        count = state["count"].map(lambda c: c + 1)
        scale = {}
        if self.grad_clip > 0:
            first = params.leaves[0]
            devs = {str(p.device): p.device for p in first.pieces.flat
                    if p is not None}
            home = next(iter(devs.values()))
            with copy_kind("psum"):
                gsq = None
                for pl in grads.leaves:
                    s = None
                    for idx in pl.owners():
                        t = torch.sum(_f32(_piece(pl, idx)) ** 2).to(home)
                        s = t if s is None else s + t
                    gsq = s if gsq is None else gsq + s
                sc = torch.clamp_max(
                    self.grad_clip / (torch.sqrt(gsq) + 1e-9), 1.0)
                scale = {k: sc.to(d) for k, d in devs.items()}

        def at(g):
            if not scale:
                return torch.ones((), dtype=torch.float32, device=g.device)
            return scale[str(g.device)]

        corrs = {}

        def corr(c, b):  # the bias correction, once per count piece
            key = (id(c), b)
            if key not in corrs:
                cf = c.to(torch.float32)
                corrs[key] = 1.0 - torch.pow(torch.full_like(cf, b), cf)
            return corrs[key]

        new_m = state["m"].map(
            lambda m, g: self.b1 * m + (1 - self.b1) * _f32(g) * at(g),
            grads)
        new_v = state["v"].map(
            lambda v, g: self.b2 * v + (1 - self.b2) * (_f32(g) * at(g)) ** 2,
            grads)

        def upd(p, m, v, c):
            step = (m / corr(c, self.b1)) / (torch.sqrt(v / corr(c, self.b2))
                                             + self.eps)
            if self.weight_decay:
                step = step + self.weight_decay * _f32(p)
            return (_f32(p) - self.lr * step).to(p.dtype)

        new_params = type(params)(params.template, tuple(
            pl.map(upd, new_m.leaves[j], new_v.leaves[j], count)
            for j, pl in enumerate(params.leaves)))
        return new_params, {"m": new_m, "v": new_v, "count": count}


def sgd_momentum(lr: float = 0.1, mu: float = 0.9):
    """Minimal SGD+momentum (used by tests as a second optimizer)."""

    class _SGD:
        def init(self, params):
            with torch.no_grad():
                return {"mom": tree_map(
                    lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params)}

        @torch.no_grad()
        def update(self, grads, state, params):
            def m(b, g):
                return mu * b + _f32(g)

            def p(x, b):
                return (_f32(x) - lr * b).to(x.dtype)

            if hasattr(params, "template"):  # laid out: piece by piece
                mom = state["mom"].map(m, grads)
                return params.map(p, mom), {"mom": mom}
            mom = tree_map(m, state["mom"], grads)
            return tree_map(p, params, mom), {"mom": mom}

    return _SGD()
