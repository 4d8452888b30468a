"""Optimizers for the LM training slice: functional AdamW and SGD with
momentum over parameter trees (``opt.tree``)."""
from .adam import AdamW, sgd_momentum  # noqa: F401
from .tree import leaves, tree_map, unflatten  # noqa: F401

__all__ = ["AdamW", "sgd_momentum", "leaves", "tree_map", "unflatten"]
