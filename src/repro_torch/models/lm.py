"""LM task heads: the loss, the train steps, ``prefill`` and
``decode_step``: the reference's ``models/lm.py`` in PyTorch.

Two gradient-sync modes (the paper's Sec. III-C + III-D applied to data
parallelism):

  * ``spmd`` (:func:`make_train_step`) -- the global batch's loss and
    gradients on one device, or on a ``DeviceMesh``, the gradients
    averaged over its data ranks in f32.
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

On a mesh both steps split each data rank's work over its ``"model"``
axis (tensor parallelism, what GSPMD makes of the reference's step):
the state is laid out as ``dist.sharding.param_specs`` says
(``place_state``), each data rank's model group runs
:func:`group_value_and_grad` over its pieces
(``transformer.forward_group``, :func:`loss_group`), and every position
updates its own pieces.

Serving (``prefill``, ``decode_step``) runs under ``torch.no_grad``, on
one device or from a laid-out state.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.precision import qcast
from ..dist.collectives import ModelGroup, Pieces, hierarchical_psum
from ..dist.sharding import Placed, PlacedTree, group_pieces, place_state
from ..dist.topology import Topology, all_reduce
from ..opt.tree import leaves, module_dict, tree_map, unflatten
from ..placement import copy_kind
from .transformer import forward, forward_group, init_cache  # noqa: F401

__all__ = ["decode_step", "group_value_and_grad", "loss_fn", "loss_group",
           "make_hier_train_step", "make_train_step", "prefill"]


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


def _group_tree(template, values):
    """``template``'s parameters (an ``nn.Module``) replaced by
    ``values`` in ``parameters()`` order, as an ``opt.tree.module_dict``
    tree (what :func:`transformer.forward_group` reads by name)."""
    tree = module_dict(template)
    for (name, _), v in zip(template.named_parameters(), values):
        *path, last = name.split(".")
        node = tree
        for part in path:
            node = node[int(part)] if isinstance(node, list) else node[part]
        node[last] = v
    return tree


def loss_group(gp, cfg, inputs, labels, group):
    """:func:`loss_fn` over a model group: ``gp`` the group's parameters
    (:func:`transformer.forward_group`), ``inputs`` / ``labels`` per-rank
    lists of the same rows.  The logits stay split on the vocabulary:
    a vocab-parallel logsumexp (each rank's row maximum and sum of
    exponentials, reduced over the group: ``"all-reduce"``) and the
    target logit from the rank that holds it (the others add zero).
    Every rank computes the same loss.  Returns ``(losses, {"nll",
    "aux"})``: each rank's loss (a backward runs from each, as each
    device of a GSPMD step differentiates its own), and the first live
    rank's terms."""
    lv = labels[group.live[0]]
    b, t = lv.shape
    positions = group.each(lambda y: torch.arange(
        t, dtype=torch.int32, device=y.device).expand(b, t), labels)
    logits, bounds, _, aux = forward_group(gp, cfg, inputs, group=group,
                                           positions=positions, mode="train")
    lg = group.each(lambda x: x[:, :-1].to(torch.float32), logits)
    tgt = group.each(lambda y: y[:, 1:].long(), labels)
    if bounds is None:  # every rank holds every logit
        nll = group.each(lambda x, y: torch.logsumexp(x, dim=-1)
                         - torch.gather(x, -1, y[..., None])[..., 0], lg, tgt)
    else:
        m = group.all_max(group.each(
            lambda x: x.detach().amax(dim=-1), lg))
        se = group.all_reduce(group.each(
            lambda x, mx: torch.exp(x - mx[..., None]).sum(-1), lg, m))

        def target(x, y, bd):
            lo, hi = bd
            inside = (y >= lo) & (y < hi)
            v = torch.gather(x, -1, torch.clamp(y - lo, 0, hi - lo - 1)
                             [..., None])[..., 0]
            return torch.where(inside, v, torch.zeros_like(v))

        tl = group.all_reduce(group.each(target, lg, tgt, bounds))
        nll = group.each(lambda mx, e, t_: mx + torch.log(e) - t_, m, se, tl)
    r0 = group.live[0]
    loss = nll[r0].mean()
    losses = group.each(lambda x, a: x.mean() + cfg.moe_aux_weight * a,
                        nll, aux)
    return losses, {"nll": loss, "aux": aux[r0]}


def group_value_and_grad(pieces, template, cfg, shards, group):
    """``(loss, metrics, grads)`` of one model group: ``pieces`` one
    ``collectives.Pieces`` per parameter (``parameters()`` order of
    ``template``), ``shards`` per rank the batch rows (a dict of
    ``inputs`` / ``labels``).  ``grads[j][r]`` is rank ``r``'s gradient
    of its piece of parameter ``j``: complete for a split piece (its
    uses on other ranks reach it through the relayout's copies); for a
    parameter every rank holds whole, the ranks' partial gradients
    summed over the group (``"all-reduce"``).  A group of one rank runs
    the one-device :func:`_value_and_grad`."""
    if group.n == 1:
        loss, metrics, grads = _value_and_grad(
            unflatten(template, [pc.parts[0] for pc in pieces]), cfg,
            shards[0])
        return loss, metrics, [[g] for g in grads]
    live = [Pieces([None if p is None else p.detach().requires_grad_(True)
                    for p in pc.parts], pc.shape, pc.dim) for pc in pieces]
    loss, metrics = loss_group(
        _group_tree(template, live), cfg,
        group.each(lambda sh: sh["inputs"], shards),
        group.each(lambda sh: sh["labels"], shards), group)
    flat = [p for pc in live for p in pc.parts if p is not None]
    outs = [loss[r] for r in group.live]
    seeds = [torch.full_like(x, 1.0 / len(outs)) for x in outs]
    got = iter(torch.autograd.grad(outs, flat, seeds, allow_unused=True))
    loss = metrics["nll"] + cfg.moe_aux_weight * metrics["aux"]
    grads = []
    for pc in live:
        g = [None if p is None else next(got) for p in pc.parts]
        g = [None if p is None else (torch.zeros_like(p) if gi is None
                                     else gi) for p, gi in zip(pc.parts, g)]
        if pc.dim is None:
            g = group.all_reduce(g)
        grads.append(g)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def _groups(mesh, dp_axes, live=None):
    """The data ranks of ``mesh`` (``dp_axes`` linearized first-major, as
    ``Topology.rank_devices``), each ``(idx, group)``: the mesh index of
    its model rank 0 and its :class:`ModelGroup` over ``"model"``."""
    names = mesh.axis_names
    rest = [a for a in names if a not in dp_axes and a != "model"]
    if any(mesh.shape[a] > 1 for a in rest):
        raise ValueError(f"mesh axes {rest} are neither data-parallel "
                         f"({dp_axes}) nor 'model'")
    sizes = [mesh.shape[a] for a in dp_axes]
    n_model = mesh.shape.get("model", 1)
    out = []
    for p in range(int(np.prod(sizes, dtype=np.int64))):
        coords = dict(zip(dp_axes, np.unravel_index(p, sizes)))
        idx = [int(coords.get(a, 0)) for a in names]
        devs = []
        for r in range(n_model):
            if "model" in names:
                idx[names.index("model")] = r
            devs.append(mesh.devices[tuple(idx)])
        if "model" in names:
            idx[names.index("model")] = 0
        out.append((tuple(idx), ModelGroup(devs, live)))
    return out


def _position(idx, names, r):
    """Mesh index ``idx`` at model rank ``r``."""
    if "model" not in names:
        return idx
    at = list(idx)
    at[names.index("model")] = r
    return tuple(at)


def _placed(params, opt_state, mesh):
    """``(params, opt_state, join)``: the state laid out on ``mesh``
    (:func:`dist.sharding.place_state`) unless it already is, and
    whether to join the results back into whole tensors."""
    if isinstance(params, PlacedTree):
        return params, opt_state, False
    p, o = place_state(params, opt_state, mesh)
    return p, o, True


def _data_parallel(cfg, mesh, dp_axes, rank_step, live, sync_grads):
    """The shared body of the mesh train steps: each data rank's model
    group runs ``rank_step`` on its rows; ``sync_grads(grads, groups)``
    reduces ``grads[p][j][r]`` over the data ranks (each data rank
    keeping its own result on its devices).  Returns ``sync(params,
    batch) -> (loss, metrics, grads)``, the grads a
    :class:`PlacedTree` on the parameters' layout."""
    groups = _groups(mesh, dp_axes, live)
    ndp = len(groups)
    names = mesh.axis_names

    def sync(params, batch):
        n_rows = int(np.shape(batch["labels"])[0])
        if n_rows % ndp:
            raise ValueError(f"batch of {n_rows} rows for {ndp} data ranks")
        rows = n_rows // ndp
        home = params.leaves[0].pieces[groups[0][0]].device
        losses, metrics, grads = [], None, []
        for p, (idx, group) in enumerate(groups):
            with copy_kind("scatter"):
                shards = group.each(
                    lambda dev, p=p: {k: _as_tensor(
                        v[p * rows:(p + 1) * rows], dev)
                        for k, v in batch.items()}, group.devices)
            loss, m, g = rank_step(group_pieces(params, idx),
                                   params.template, cfg, shards, group)
            losses.append(loss)
            metrics = m if metrics is None else metrics
            grads.append(g)
        synced = sync_grads(grads, groups)
        out = []
        for j, pl in enumerate(params.leaves):
            pieces = np.empty(pl.pieces.shape, dtype=object)
            for p, (idx, group) in enumerate(groups):
                for r in group.live:
                    pieces[_position(idx, names, r)] = synced[p][j][r]
            out.append(Placed(pl.spec, pl.mesh, pieces, pl.shape,
                              torch.float32))
        loss = losses[0]
        with copy_kind("pmean"):
            for x in losses[1:]:
                loss = loss + x.to(loss.device)
            loss = (loss / ndp).to(home)
        return loss, metrics, PlacedTree(params.template, tuple(out))

    return sync


def _step(optimizer, mesh, sync):
    """A train step over ``sync``, on a laid-out state or a whole one
    (laid out first, joined after)."""
    def step(params, opt_state, batch):
        params, opt_state, join = _placed(params, opt_state, mesh)
        loss, metrics, grads = sync(params, batch)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        if join:
            new_params = new_params.full()
            new_opt = {k: v.full() for k, v in new_opt.items()}
        return new_params, new_opt, {"loss": loss, **metrics}

    def whole_sync(params, batch):
        params, _, join = _placed(params, None, mesh)
        loss, metrics, grads = sync(params, batch)
        if join:
            grads = [pl.full() for pl in grads.leaves]
        return loss, metrics, grads

    step.sync = whole_sync
    return step


def make_train_step(cfg, optimizer, mesh=None, dp_axes=("data", "pod")):
    """Global-batch (spmd) train step: ``train_step(params, opt_state,
    batch) -> (params, opt_state, {"loss", "nll", "aux"})``, the
    gradients from ``torch.autograd``.

    Without ``mesh``, on one device.  Given a ``mesh`` (a
    ``dist.DeviceMesh``), what GSPMD makes of the reference's jitted
    step with its state placed by ``param_specs``: the state is laid out
    on the mesh (:func:`dist.sharding.place_state`; a whole state is laid
    out first and the results joined), each data rank (``dp_axes``,
    first-major) takes its rows of the batch, its model group splits the
    work over ``"model"`` (:func:`group_value_and_grad`), the gradients
    are averaged over the data ranks in f32 (``"all-reduce"``, each data
    rank keeping its own sum), and the optimizer updates every
    position's pieces."""
    if mesh is None:
        def train_step(params, opt_state, batch):
            loss, metrics, grads = _value_and_grad(params, cfg, batch)
            new_params, new_opt = optimizer.update(
                unflatten(params, grads), opt_state, params)
            return new_params, new_opt, {"loss": loss, **metrics}

        return train_step
    dp_axes = tuple(a for a in dp_axes if a in mesh.shape)

    def mean(grads, groups):
        ndp, n = len(groups), groups[0][1].n
        out = [[[None] * n for _ in grads[0]] for _ in range(ndp)]
        for j in range(len(grads[0])):
            for r in groups[0][1].live:
                parts = [grads[p][j][r] for p in range(ndp)]
                if ndp > 1:
                    parts = [x / ndp for x in
                             all_reduce(parts, [list(range(ndp))])]
                for p in range(ndp):
                    out[p][j][r] = parts[p]
        return out

    return _step(optimizer, mesh, _data_parallel(
        cfg, mesh, dp_axes, group_value_and_grad, None, mean))


def make_hier_train_step(
    cfg,
    optimizer,
    mesh,
    dp_axes=("data", "pod"),
    comm_dtype=torch.bfloat16,
    adaptive: bool = True,
    rank_step=None,
    live=None,
):
    """Paper-style hierarchical mixed-precision gradient sync over the
    data-parallel ranks of ``mesh`` (a ``dist.DeviceMesh``), with tensor
    parallelism over its ``"model"`` axis, as the reference's TPU branch
    leaves ``model`` to XLA (``lm.py:132-133``).

    Returns a step with :func:`make_train_step`'s signature.  The state
    lives laid out on the mesh (:func:`dist.sharding.place_state`: each
    position the pieces ``param_specs`` gives it; a whole state is laid
    out first and the results joined).  Data rank ``p`` (the ``dp_axes``
    linearized first-major, ``Topology.rank_devices``) takes row chunk
    ``p`` of the batch (``"scatter"``), and its model group runs the loss
    and backward on its pieces (:func:`group_value_and_grad`).  Then,
    leaf by leaf, ``qcast`` casts the gradients to ``comm_dtype`` with
    one power-of-two factor for the leaf: the maximum over all its
    model pieces and all data ranks (the reference's ``pmax`` over the
    data axes of a leaf whose ``model`` sharding XLA manages); each model
    rank's cast pieces go out as one f32 buffer per data rank,
    ``hierarchical_psum`` reduces the buffers over the ladder, and each
    data rank takes ``summed * (inv / n_dp)`` on its own devices and
    updates its own pieces with them: no parameter crosses between
    data ranks.  The loss is the ranks' mean (``"pmean"``); ``nll`` and
    ``aux`` are rank 0's.

    The wire carries f32 (``step.wire_dtype``): the ``comm_dtype``
    values widened, so the ladder's sums round in f32 and the cast is
    the one quantization to ``comm_dtype``.  This is the reference's rule off
    TPU (``lm.py:111-119``).  Its TPU branch, and the paper, carry
    ``comm_dtype`` through the ladder, where each level's sum rounds to
    it again; with four ranks at smollm-135m's full width that takes
    some leaves past the 2**-7-of-max|g| bound the step is held to
    against the spmd step (ROADMAP.md, queue 3), so the port does not.

    ``rank_step(pieces, template, cfg, shards, group) -> (loss, metrics,
    grads)`` is what each data rank's model group runs (default
    :func:`group_value_and_grad`); the dry run gives one that replays a
    rank's work (``launch.dryrun``).  ``live`` lists the model ranks that
    compute (default all; the dry run's phantoms,
    ``collectives.ModelGroup``): the others get no gradients and no
    update.

    The step carries ``topology`` (the ladder), ``plan`` (its ``hier``
    ``CommPlan``), ``wire_dtype`` and ``sync(params, batch) -> (loss,
    metrics, grads)``, the synced gradients: a list of whole tensors in
    ``opt.tree.leaves`` order for a whole state, rank 0's.
    """
    dp_axes = tuple(a for a in dp_axes if a in mesh.shape)
    topo = Topology.from_mesh(mesh, data_axes=dp_axes, batch_axes=())
    ndp = topo.n_data
    wire_dtype = torch.float32

    def ladder(grads, groups):
        live_r = groups[0][1].live
        n_leaves = len(grads[0])
        casts = {r: [[] for _ in range(ndp)] for r in live_r}
        invs = []
        for j in range(n_leaves):
            parts = [grads[p][j][r] for p in range(ndp) for r in live_r]
            gc, inv = qcast(parts, comm_dtype, adaptive=adaptive)
            for p in range(ndp):
                for k, r in enumerate(live_r):
                    casts[r][p].append(gc[p * len(live_r) + k])
            invs.append({(p, r): inv[p * len(live_r) + k]
                         for p in range(ndp)
                         for k, r in enumerate(live_r)})
        out = [[[None] * groups[0][1].n for _ in range(n_leaves)]
               for _ in range(ndp)]
        for r in live_r:
            bufs = [torch.cat([c.reshape(-1).to(wire_dtype) for c in cs])
                    for cs in casts[r]]
            summed = hierarchical_psum(bufs, topo, mode="hier")
            for p in range(ndp):
                start = 0
                for j in range(n_leaves):
                    g = grads[p][j][r]
                    part = summed[p][start:start + g.numel()].reshape(
                        g.shape)
                    out[p][j][r] = part * (invs[j][p, r] / ndp)
                    start += g.numel()
        return out

    step = _step(optimizer, mesh, _data_parallel(
        cfg, mesh, dp_axes, rank_step or group_value_and_grad, live, ladder))
    step.topology = topo
    step.plan = topo.plan("hier")
    step.wire_dtype = wire_dtype
    return step


def _serving(params, group):
    """``(pieces, group)`` of the model group that serves a laid-out
    state: its first data rank's (or ``group``, the dry run's, with its
    phantoms)."""
    mesh = params.mesh
    dp = tuple(a for a in mesh.axis_names if a != "model")
    idx, first = _groups(mesh, dp)[0]
    return group_pieces(params, idx), group or first


@copy_kind("scatter")
def _to_ranks(x, group):
    """``x`` on every live rank's device (the request's rows)."""
    return group.each(lambda dev: _as_tensor(x, dev), group.devices)


def _gathered_logits(logits, bounds, group):
    """The first live rank's whole [B, T, V] logits from the split."""
    if bounds is not None:
        logits = group.all_gather(logits, dim=-1)
    return logits[group.live[0]]


def _prefill_group(params, cfg, inputs, group=None):
    pieces, group = _serving(params, group)
    b, t = inputs.shape[:2]
    xs = _to_ranks(inputs, group)
    positions = group.each(lambda x: torch.arange(
        t, dtype=torch.int32, device=x.device).expand(b, t), xs)
    logits, bounds, cache, _ = forward_group(
        _group_tree(params.template, pieces), cfg, xs, group=group,
        positions=positions, mode="prefill", last_token_only=True)
    return _gathered_logits(logits, bounds, group)[:, -1], cache


def _decode_group(params, cfg, cache, token, pos, group=None):
    pieces, group = _serving(params, group)
    b = token.shape[0]
    xs = _to_ranks(token, group)
    positions = group.each(lambda x: torch.full(
        (b, 1), int(pos), dtype=torch.int32, device=x.device), xs)
    logits, bounds, new_cache, _ = forward_group(
        _group_tree(params.template, pieces), cfg, xs, group=group,
        positions=positions, caches=cache, mode="decode")
    last = _gathered_logits(logits, bounds, group)[:, -1]
    nxt = torch.argmax(last, dim=-1).to(torch.int32)
    return nxt[:, None], new_cache, last


@torch.no_grad()
def prefill(params, cfg, inputs, *, group=None):
    """Full-sequence prefill: returns (last-token logits [B, V], cache).

    Only the last position is unembedded (``last_token_only``): logits
    for all T positions would cost ``T x`` the unembed matmul in serving.

    On a laid-out state (a ``dist.sharding.PlacedTree``) the first data
    rank's model group serves (:func:`transformer.forward_group`): the
    logits are gathered from the vocabulary split onto its first rank,
    and the cache is a list per rank, each rank's piece (its kv heads
    where attention splits by heads).  ``group`` stands in for that
    group (the dry run's, with phantom ranks).
    """
    if isinstance(params, PlacedTree):
        return _prefill_group(params, cfg, inputs, group)
    b, t = inputs.shape[:2]
    positions = torch.arange(t, dtype=torch.int32,
                             device=inputs.device).expand(b, t)
    logits, cache, _ = forward(
        params, cfg, inputs, positions=positions, mode="prefill",
        last_token_only=True,
    )
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(params, cfg, cache, token, pos: int, *, group=None):
    """One decode step (on a laid-out state, ``cache`` is a list per
    rank, as :func:`prefill` leaves it; ``group`` as there).

    Args:
      token: [B, 1] integer tokens (or [B, 1, D] embeds for stub
        frontends).
      pos: the position of this token.

    Returns (next_token int32 [B, 1], new_cache, logits [B, V]); the
    cache's tensors are written in place.
    """
    if isinstance(params, PlacedTree):
        return _decode_group(params, cfg, cache, token, pos, group)
    b = token.shape[0]
    positions = torch.full((b, 1), int(pos), dtype=torch.int32,
                           device=token.device)
    logits, new_cache, _ = forward(
        params, cfg, token, positions=positions, cache=cache, mode="decode"
    )
    nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    return nxt[:, None], new_cache, logits[:, -1]
