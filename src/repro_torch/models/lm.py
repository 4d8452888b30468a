"""LM task heads: the loss, the train steps, ``prefill`` and
``decode_step``: the reference's ``models/lm.py`` in PyTorch.

Two gradient-sync modes (the paper's Sec. III-C + III-D applied to data
parallelism):

  * ``spmd`` (:func:`make_train_step`) -- the global batch's loss and
    gradients on one device.
  * ``hier`` (:func:`make_hier_train_step`) -- one process driving the
    data-parallel ranks of a ``DeviceMesh`` (``"data"`` the fast level,
    ``"pod"`` the slow one), each rank the loss and backward of its
    shard of the batch.  The ranks' gradients are cast to the comm dtype
    (bf16) with *adaptive normalization* (one power-of-two factor for the
    group, ``core.precision.qcast``) and reduced, widened to f32, with
    the hierarchical ladder (``dist.collectives.hierarchical_psum``):
    reduce-scatter over ``"data"``, all-reduce over ``"pod"`` at
    ``1/|data|`` volume, all-gather back -- only locally-reduced data
    crosses the slow links.

Serving (``prefill``, ``decode_step``) runs under ``torch.no_grad``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.precision import qcast
from ..dist.collectives import hierarchical_psum
from ..dist.topology import Topology
from ..opt.tree import leaves, tree_map, unflatten
from ..placement import copy_kind
from .transformer import forward, init_cache  # noqa: F401

__all__ = ["decode_step", "loss_fn", "make_hier_train_step",
           "make_train_step", "prefill"]


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _device(params) -> torch.device:
    return leaves(params)[0].device


def loss_fn(params, cfg, batch):
    """Next-token cross entropy (+ MoE aux).  ``batch``: ``inputs``
    (tokens [B, T], or embeddings [B, T, D]) and ``labels`` ([B, T]
    integers), tensors or numpy arrays, moved to the parameters' device.

    ``logsumexp - target logit`` in f32, as the reference; the target
    logit is gathered, which gives the value of the reference's one-hot
    contraction (that adds only exact zeros besides it).  Returns
    ``(loss, {"nll", "aux"})``."""
    dev = _device(params)
    inputs = _as_tensor(batch["inputs"], dev)
    labels = _as_tensor(batch["labels"], dev).long()
    b, t = labels.shape
    positions = torch.arange(t, dtype=torch.int32, device=dev).expand(b, t)
    logits, _, aux = forward(params, cfg, inputs, positions=positions,
                             mode="train")
    lg = logits[:, :-1].to(torch.float32)
    tgt = labels[:, 1:]
    lse = torch.logsumexp(lg, dim=-1)  # [B, T-1]
    tgt_logit = torch.gather(lg, -1, tgt[..., None])[..., 0]
    loss = (lse - tgt_logit).mean()
    return loss + cfg.moe_aux_weight * aux, {"nll": loss, "aux": aux}


def _live(params):
    """A copy of the tree whose leaves share the parameters' storage and
    ask for gradients (the caller's parameters stay frozen)."""
    out = tree_map(lambda p: p.detach(), params)
    for p in leaves(out):
        p.requires_grad_(True)
    return out


def _value_and_grad(params, cfg, batch):
    """``(loss, metrics, grads)``: the loss and its gradient, a list in
    ``opt.tree.leaves`` order (zeros for a leaf the loss does not
    reach)."""
    live = _live(params)
    ps = leaves(live)
    loss, metrics = loss_fn(live, cfg, batch)
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(ps, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def make_train_step(cfg, optimizer):
    """Global-batch (spmd) train step: ``train_step(params, opt_state,
    batch) -> (params, opt_state, {"loss", "nll", "aux"})``, the
    gradients from ``torch.autograd``."""

    def train_step(params, opt_state, batch):
        loss, metrics, grads = _value_and_grad(params, cfg, batch)
        new_params, new_opt = optimizer.update(
            unflatten(params, grads), opt_state, params)
        return new_params, new_opt, {"loss": loss, **metrics}

    return train_step


def make_hier_train_step(
    cfg,
    optimizer,
    mesh,
    dp_axes=("data", "pod"),
    comm_dtype=torch.bfloat16,
    adaptive: bool = True,
    rank_step=None,
):
    """Paper-style hierarchical mixed-precision gradient sync over the
    data-parallel ranks of ``mesh`` (a ``dist.DeviceMesh``).

    Returns a step with :func:`make_train_step`'s signature.  Rank ``p``
    (the ``dp_axes`` linearized first-major, ``Topology.rank_devices``)
    takes row chunk ``p`` of the batch and runs the loss and backward on
    its device (a rank on another device than the parameters works on a
    copy of them).  Then, leaf by leaf, ``qcast`` casts the ranks'
    gradients to ``comm_dtype`` with the group's one power-of-two factor
    (the reference's ``pmax`` over the data axes); the cast leaves of a
    rank go out as one f32 buffer, ``hierarchical_psum`` reduces the
    buffers over the ladder, and each rank takes ``summed * (inv /
    n_dp)``.  The loss is the ranks' mean (``pmean``); ``nll`` and
    ``aux`` are rank 0's.  The optimizer updates the parameters once with
    rank 0's synced gradients, which every rank holds bit for bit.

    The wire carries f32 (``step.wire_dtype``): the ``comm_dtype``
    values widened, so the ladder's sums round in f32 and the cast is
    the one quantization to ``comm_dtype``.  This is the reference's rule off
    TPU (``lm.py:111-119``).  Its TPU branch, and the paper, carry
    ``comm_dtype`` through the ladder, where each level's sum rounds to
    it again; with four ranks at smollm-135m's full width that takes
    some leaves past the 2**-7-of-max|g| bound the step is held to
    against the spmd step (ROADMAP.md, queue 3), so the port does not.

    Stated divergences from the reference:

      * a ``"model"`` axis larger than 1 holds replicas, as the
        reference's off-TPU branch does (fully manual, replicated
        compute): the port has no tensor parallelism, and computes each
        data rank once, at model index 0.  ``models.layers``' sharding
        hints (the reference's ``maybe_constrain``) are XLA's and have no
        counterpart here.

    The copies between devices carry ``placement.copy_kind`` tags: the
    batch rows rank 0 sends to a rank (``"scatter"``), the parameters it
    sends to a rank on another device at every step (``"replicate"``),
    the ranks' losses (``"pmean"``), beside ``qcast``'s ``"pmax"`` and
    the ladder's own.

    ``rank_step(params, cfg, shard) -> (loss, metrics, grads)`` is what
    each rank runs on its replica and its rows (default: the loss and
    its backward); the dry run gives one that replays a rank's work
    (``launch.dryrun``).

    The step carries ``topology`` (the ladder), ``plan`` (its ``hier``
    ``CommPlan``), ``wire_dtype`` and ``sync(params, batch) -> (loss,
    metrics, grads)``, the synced gradients as a list in
    ``opt.tree.leaves`` order.
    """
    dp_axes = tuple(a for a in dp_axes if a in mesh.shape)
    topo = Topology.from_mesh(mesh, data_axes=dp_axes, batch_axes=())
    ndp = topo.n_data
    wire_dtype = torch.float32
    devices = topo.rank_devices()
    rank_step = _value_and_grad if rank_step is None else rank_step

    def sync(params, batch):
        home = _device(params)
        n_rows = int(np.shape(batch["labels"])[0])
        if n_rows % ndp:
            raise ValueError(f"batch of {n_rows} rows for {ndp} data ranks")
        rows = n_rows // ndp
        losses, metrics, grads = [], None, []
        for p, dev in enumerate(devices):
            with copy_kind("scatter"):
                shard = {k: _as_tensor(v[p * rows:(p + 1) * rows], dev)
                         for k, v in batch.items()}
            with copy_kind("replicate"):
                replica = (params if dev == home
                           else tree_map(lambda t, d=dev: t.to(d), params))
            loss, m, g = rank_step(replica, cfg, shard)
            losses.append(loss)
            metrics = m if metrics is None else metrics
            grads.append(g)
        n_leaves = len(grads[0])
        casts = [[] for _ in devices]
        invs = []
        for j in range(n_leaves):
            gc, inv = qcast([g[j] for g in grads], comm_dtype,
                            adaptive=adaptive)
            for p in range(ndp):
                casts[p].append(gc[p])
            invs.append(inv)
        bufs = [torch.cat([c.reshape(-1).to(wire_dtype) for c in cs])
                for cs in casts]
        summed = hierarchical_psum(bufs, topo, mode="hier")[0]
        synced, start = [], 0
        for j, g in enumerate(grads[0]):
            n = g.numel()
            part = summed[start:start + n].reshape(g.shape)
            synced.append(part.to(home) * (invs[j][0].to(home) / ndp))
            start += n
        loss = losses[0]
        with copy_kind("pmean"):
            for x in losses[1:]:
                loss = loss + x.to(loss.device)
            return (loss / ndp).to(home), metrics, synced

    def step(params, opt_state, batch):
        loss, metrics, grads = sync(params, batch)
        new_params, new_opt = optimizer.update(
            unflatten(params, grads), opt_state, params)
        return new_params, new_opt, {"loss": loss, **metrics}

    step.sync = sync
    step.topology = topo
    step.plan = topo.plan("hier")
    step.wire_dtype = wire_dtype
    return step


@torch.no_grad()
def prefill(params, cfg, inputs):
    """Full-sequence prefill: returns (last-token logits [B, V], cache).

    Only the last position is unembedded (``last_token_only``): logits
    for all T positions would cost ``T x`` the unembed matmul in serving.
    """
    b, t = inputs.shape[:2]
    positions = torch.arange(t, dtype=torch.int32,
                             device=inputs.device).expand(b, t)
    logits, cache, _ = forward(
        params, cfg, inputs, positions=positions, mode="prefill",
        last_token_only=True,
    )
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(params, cfg, cache, token, pos: int):
    """One decode step.

    Args:
      token: [B, 1] integer tokens (or [B, 1, D] embeds for stub
        frontends).
      pos: the position of this token.

    Returns (next_token int32 [B, 1], new_cache, logits [B, V]); the
    cache's tensors are written in place.
    """
    b = token.shape[0]
    positions = torch.full((b, 1), int(pos), dtype=torch.int32,
                           device=token.device)
    logits, new_cache, _ = forward(
        params, cfg, token, positions=positions, cache=cache, mode="decode"
    )
    nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    return nxt[:, None], new_cache, logits[:, -1]
