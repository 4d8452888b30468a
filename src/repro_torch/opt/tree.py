"""Parameter trees for the functional optimizers: the port's stand-in for
``jax.tree``.

A tree is a dict (its keys in sorted order, as ``jax.tree_util`` walks
them), a list or tuple (in order), ``None`` (no leaves), a
``torch.nn.Module`` (its parameters in ``Module.parameters()`` order:
its own, then its children's, recursively), or a leaf (a tensor, or
anything else).  ``tree_map`` over a module builds a new module of the
same classes whose parameters are the results, so an optimizer's
``update`` returns the model's own type (``models.transformer.LMParams``)
and its state mirrors it.  ``is_leaf`` stops the walk at the nodes it
accepts, as ``jax.tree``'s does (``dist.sharding`` takes its tuple specs
as leaves so).
"""
from __future__ import annotations

import copy

import torch
from torch import nn

__all__ = ["leaves", "module_dict", "tree_map", "unflatten"]


def leaves(tree, is_leaf=None) -> list:
    """The leaves of ``tree`` in order."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in leaves(item, is_leaf)]
    return [tree]


def module_dict(mod: nn.Module) -> dict:
    """``mod`` as a tree of dicts by name: its parameters, and each child
    as its own dict (an ``nn.ModuleList`` as a list of them)."""
    out = {k: p for k, p in mod._parameters.items() if p is not None}
    for k, m in mod._modules.items():
        if isinstance(m, nn.ModuleList):
            out[k] = [module_dict(x) for x in m]
        elif m is not None:
            out[k] = module_dict(m)
    return out


def unflatten(template, values, is_leaf=None):
    """``template``'s structure with its leaves replaced, in order, by
    ``values`` (a module's parameters become ``nn.Parameter`` of the
    values, frozen)."""
    it = iter(values)
    out = _rebuild(template, it, is_leaf)
    rest = sum(1 for _ in it)
    if rest:
        raise ValueError(f"{rest} values left over for the template")
    return out


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn(leaf, *leaves_of_rest)`` for every leaf of ``tree``, in the
    structure of ``tree`` (the other trees only need the same leaves in
    the same order; ``is_leaf`` applies to every tree)."""
    others = [iter(leaves(r, is_leaf)) for r in rest]
    vals = [fn(x, *[next(o) for o in others])
            for x in leaves(tree, is_leaf)]
    return unflatten(tree, vals, is_leaf)


def _rebuild(tree, it, is_leaf=None):
    if is_leaf is not None and is_leaf(tree):
        return next(it)
    if tree is None:
        return None
    if isinstance(tree, nn.Module):
        return _rebuild_module(tree, it)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it, is_leaf) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(item, it, is_leaf) for item in tree)
    return next(it)


def _rebuild_module(mod, it):
    """A shallow copy of ``mod`` holding new parameters (the next values
    of ``it``, in ``parameters()`` order) and rebuilt children."""
    new = copy.copy(mod)
    params = {}
    for name, p in mod._parameters.items():
        if p is None:
            params[name] = None
            continue
        v = next(it)
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"parameter {name!r}: a tensor, not {type(v)}")
        params[name] = nn.Parameter(v, requires_grad=False)
    new._parameters = params
    new._buffers = dict(mod._buffers)
    new._modules = {name: None if m is None else _rebuild_module(m, it)
                    for name, m in mod._modules.items()}
    return new
