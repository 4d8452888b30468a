"""Mixture-of-Experts layer: top-k routing with capacity-bucketed dispatch.

The reference's ``models/moe.py`` in PyTorch.  GShard-style *grouped*
dispatch: each sequence (batch row) is a dispatch group with its own
per-expert capacity buckets; tokens overflowing an expert's capacity go
to a trash slot at ``cap`` and are dropped (combine weight zero).  The
tokens routed to one expert are *fused* into one matmul, so the expert
weights are read once per bucket.

Arithmetic as the reference's: the router in f32, the top-k in
``jax.lax.top_k``'s order (descending, the lower expert first among
equal probabilities), the expert matmuls in the activation dtype, and
the combine adding each token's k weighted expert outputs one after
another in the activation dtype, rounding after each, as XLA's
scatter-add does in index order.
"""
from __future__ import annotations

import torch

from .layers import act_fn, dense_init, dot, params

__all__ = ["moe_apply", "moe_apply_group", "moe_init"]


def moe_init(gen, cfg):
    d, e, f = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    return params(
        router=dense_init(gen, (d, e)),
        wi=dense_init(gen, (e, d, f), in_axis=1),
        wg=dense_init(gen, (e, d, f), in_axis=1),
        wo=dense_init(gen, (e, f, d), in_axis=1),
    )


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest, descending, ties to the lower
    index (a stable sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router, x, cfg):
    """The routing of ``x`` [B, T, D]: the router in f32, the top-k,
    each (token, choice)'s slot in its expert's bucket."""
    b, t, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    cap = max(1, int(cfg.moe_capacity_factor * k * t / e))
    logits = x.to(torch.float32) @ router
    probs = torch.softmax(logits, dim=-1)  # [B, T, E]
    top_p, top_e = _top_k(probs, k)  # [B, T, k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # dispatch, every group (batch row) at once: the slot of each
    # (token, choice) in its expert's bucket, token-major
    flat_e = top_e.reshape(b, t * k)
    onehot = torch.nn.functional.one_hot(flat_e, e)  # [B, T*k, E]
    pos_in_e = (torch.cumsum(onehot, dim=1) - 1).gather(
        2, flat_e[..., None])[..., 0]
    keep = pos_in_e < cap
    slot = torch.where(keep, pos_in_e, torch.full_like(pos_in_e, cap))
    return dict(probs=probs, top_p=top_p, top_e=top_e, flat_e=flat_e,
                keep=keep, slot=slot, cap=cap)


def _experts(p, x, r, cfg):
    """Each expert's gated MLP on its bucket: [B, E, cap, D] (partial
    sums where ``p`` holds a slice of the experts' hidden width)."""
    b, t, d = x.shape
    e, k, cap = cfg.moe_experts, cfg.moe_top_k, r["cap"]
    tok_idx = torch.arange(t, device=x.device).repeat_interleave(k)
    rows = torch.arange(b, device=x.device)[:, None]
    buckets = x.new_zeros((b, e, cap + 1, d))
    buckets[rows, r["flat_e"], r["slot"]] = x[:, tok_idx]
    buckets = buckets[:, :, :cap]

    act = act_fn(cfg.act)
    h = dot(buckets, p["wi"])
    g = dot(buckets, p["wg"])
    return dot(act(g) * h, p["wo"])


def _combine(out, x, r, cfg):
    """Each token's k expert outputs, weighted, added in order."""
    b, t, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    adt = x.dtype
    rows = torch.arange(b, device=x.device)[:, None]
    # the trash slot reads zeros; each token's k terms added in order,
    # each sum rounded to the activation dtype
    out_ext = torch.cat([out, out.new_zeros((b, e, 1, d))], dim=2)
    gathered = out_ext[rows, r["flat_e"], r["slot"]]  # [B, T*k, D]
    w = (r["top_p"].reshape(b, t * k) * r["keep"]).to(adt)
    terms = (gathered * w[..., None]).reshape(b, t, k, d)
    y = torch.zeros((b, t, d), dtype=adt, device=x.device)
    for j in range(k):
        y = y + terms[:, :, j]
    return y


def _aux(r, cfg):
    """Load-balance aux loss (Switch-style): E * sum_e f_e * P_e."""
    e = cfg.moe_experts
    frac = torch.nn.functional.one_hot(r["top_e"][..., 0], e).to(
        torch.float32).mean(dim=(0, 1))
    return e * torch.sum(frac * r["probs"].mean(dim=(0, 1)))


def moe_apply(p, x, *, cfg):
    """x: [B, T, D] -> ([B, T, D], aux_loss scalar)."""
    r = _route(p["router"], x, cfg)
    y = _combine(_experts(p, x, r, cfg), x, r, cfg)
    return y, _aux(r, cfg)


def moe_apply_group(ps, xs, *, cfg, group):
    """:func:`moe_apply` over a model group.  The routing is computed on
    every rank with the whole router; the experts split their hidden
    width ``moe_d_ff``: rank ``r`` takes columns ``r`` of every expert's
    ``wi`` / ``wg`` and the same rows of ``wo``, combines its partial
    outputs, and one all-reduce sums the ranks'.  A width the ranks do
    not divide is computed whole on every rank, with the whole
    weights.  Returns ``(ys, auxs)``, per rank."""
    names = sorted(k for k in ps if k != "router")
    router = group.whole(ps["router"])
    f = cfg.moe_d_ff
    if f % group.n:
        w = [group.whole(ps[k]) for k in names]
        outs = group.each(
            lambda x, rt, *ws: moe_apply(
                {"router": rt, **dict(zip(names, ws))}, x, cfg=cfg),
            xs, router, *w)
        return [o and o[0] for o in outs], [o and o[1] for o in outs]
    cb = group.bounds(f)
    w = [group.take(ps[k], 1 if k == "wo" else 2, cb) for k in names]

    def one(x, rt, *ws):
        r = _route(rt, x, cfg)
        return _combine(_experts(dict(zip(names, ws)), x, r, cfg), x, r,
                        cfg), _aux(r, cfg)

    outs = group.each(one, xs, router, *w)
    ys = group.all_reduce([o and o[0] for o in outs])
    return ys, [o and o[1] for o in outs]
