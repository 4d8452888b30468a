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

__all__ = ["moe_apply", "moe_init"]


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


def moe_apply(p, x, *, cfg):
    """x: [B, T, D] -> ([B, T, D], aux_loss scalar)."""
    b, t, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    cap = max(1, int(cfg.moe_capacity_factor * k * t / e))
    adt = x.dtype

    logits = x.to(torch.float32) @ p["router"]
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
    tok_idx = torch.arange(t, device=x.device).repeat_interleave(k)
    rows = torch.arange(b, device=x.device)[:, None]
    buckets = x.new_zeros((b, e, cap + 1, d))
    buckets[rows, flat_e, slot] = x[:, tok_idx]
    buckets = buckets[:, :, :cap]

    act = act_fn(cfg.act)
    h = dot(buckets, p["wi"])
    g = dot(buckets, p["wg"])
    out = dot(act(g) * h, p["wo"])

    # combine: the trash slot reads zeros; each token's k terms added in
    # order, each sum rounded to the activation dtype
    out_ext = torch.cat([out, out.new_zeros((b, e, 1, d))], dim=2)
    gathered = out_ext[rows, flat_e, slot]  # [B, T*k, D]
    w = (top_p.reshape(b, t * k) * keep).to(adt)
    terms = (gathered * w[..., None]).reshape(b, t, k, d)
    y = torch.zeros((b, t, d), dtype=adt, device=x.device)
    for j in range(k):
        y = y + terms[:, :, j]

    # load-balance aux loss (Switch-style): E * sum_e f_e * P_e
    frac = torch.nn.functional.one_hot(top_e[..., 0], e).to(
        torch.float32).mean(dim=(0, 1))
    aux = e * torch.sum(frac * probs.mean(dim=(0, 1)))
    return y, aux
