"""Sharded, atomic, mesh-agnostic checkpointing (the port's copy of the
reference's ``ckpt/checkpoint.py``, on disk in the same layout).

Layout per step:

  <dir>/step_<n>.tmp/            (written first)
      manifest.json              tree structure, global shapes, dtypes
      shard_<i>.npz              flat-leaf arrays (numpy)
  <dir>/step_<n>/                (atomic rename on completion)

Properties required at scale:

  * atomic: a crash mid-write never corrupts the latest checkpoint
    (tmp + rename; readers only ever see complete directories);
  * mesh-agnostic: leaves are stored as *global* numpy arrays plus the
    manifest, so restore can place them on any device;
  * resumable solvers: nested dicts, lists and tuples of arrays (CG
    state, resume manifests, step counters) round-trip.

A tree is flattened as the reference's ``jax.tree_util`` flattens it:
dicts by sorted key, lists and tuples in order, ``None`` an empty
subtree, anything else a leaf.  The leaf order is therefore the
reference's, and a checkpoint written by either package restores in the
other.  Leaves may be numpy arrays, scalars or torch tensors; restore
returns numpy arrays, or tensors on ``device=`` when one is given.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]


def _flatten(tree) -> tuple[list, object]:
    """``(leaves, treedef)``; the treedef rebuilds the tree from leaves."""
    if tree is None:
        return [], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, defs = [], []
        for k in keys:
            sub, d = _flatten(tree[k])
            leaves += sub
            defs.append((d, len(sub)))
        return leaves, ("dict", keys, defs)
    if isinstance(tree, (list, tuple)):
        leaves, defs = [], []
        for item in tree:
            sub, d = _flatten(item)
            leaves += sub
            defs.append((d, len(sub)))
        return leaves, (type(tree).__name__, None, defs)
    return [tree], "leaf"


def _unflatten(treedef, leaves: list):
    if treedef is None:
        return None
    if treedef == "leaf":
        (leaf,) = leaves
        return leaf
    kind, keys, defs = treedef
    parts, i = [], 0
    for d, n in defs:
        parts.append(_unflatten(d, leaves[i:i + n]))
        i += n
    if kind == "dict":
        return dict(zip(keys, parts))
    return tuple(parts) if kind == "tuple" else parts


def _to_numpy(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):  # a torch tensor, on any device
        return leaf.detach().to("cpu").numpy()
    return np.asarray(leaf)


def save(directory: str, step: int, tree, *, keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves, treedef = _flatten(tree)
    arrays = {}
    manifest = {"treedef": repr(treedef), "n_leaves": len(leaves),
                "step": step, "leaves": []}
    for i, leaf in enumerate(leaves):
        arr = _to_numpy(leaf)
        manifest["leaves"].append(
            {"shape": list(arr.shape), "dtype": str(arr.dtype)}
        )
        arrays[f"leaf_{i}"] = arr
    np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int):
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def restore(directory: str, step: int, like, *, device=None):
    """Restore into the structure of ``like`` (a tree of arrays, tensors
    or anything with a ``.shape``).

    ``device``: a torch device to place every leaf on (as a tensor);
    ``None`` returns numpy arrays.
    """
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "shard_0.npz"))
    leaves_like, treedef = _flatten(like)
    assert manifest["n_leaves"] == len(leaves_like), (
        manifest["n_leaves"], len(leaves_like),
    )
    out = []
    for i, ref in enumerate(leaves_like):
        arr = data[f"leaf_{i}"]
        want = tuple(ref.shape) if hasattr(ref, "shape") else np.shape(ref)
        if tuple(arr.shape) != want:
            raise ValueError(
                f"leaf {i}: checkpoint {arr.shape} vs expected {want}"
            )
        if device is not None:
            import torch

            # asarray keeps a 0-d leaf 0-d (ascontiguousarray makes it 1-d)
            arr = torch.from_numpy(np.asarray(arr, order="C")).to(device)
        out.append(arr)
    return _unflatten(treedef, out)


class CheckpointManager:
    """Every-K-steps + on-demand checkpointing with restore-or-init."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep

    def maybe_save(self, step: int, tree) -> bool:
        if self.every and step % self.every == 0:
            save(self.directory, step, tree, keep=self.keep)
            return True
        return False

    def restore_or_init(self, init_fn, *, device=None):
        """``(tree, step)``: the latest checkpoint restored into the
        structure ``init_fn()`` returns, or ``(init_fn(), 0)`` when there
        is none.  (The reference takes the structure from
        ``jax.eval_shape(init_fn)``; here ``init_fn`` runs.)"""
        step = latest_step(self.directory)
        if step is None:
            return init_fn(), 0
        return restore(self.directory, step, init_fn(), device=device), step
