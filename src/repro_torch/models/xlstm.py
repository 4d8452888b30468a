"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

The reference's ``models/xlstm.py`` in PyTorch (arXiv:2405.04517).  Both
use exponential gating with the log-domain stabilizer state m_t so
gates never overflow (``log sigmoid`` written as ``-softplus(-x)``):

  mLSTM (per head, head dim = hd):
    C_t = f_t C_{t-1} + i_t v_t k_t^T     (matrix memory [hd, hd])
    n_t = f_t n_{t-1} + i_t k_t
    h_t = C_t q_t / max(|n_t . q_t|, 1)

  sLSTM (per channel, heads give block-diagonal recurrence):
    c_t = f_t c_{t-1} + i_t z_t ;  n_t = f_t n_{t-1} + i_t
    h_t = o_t * c_t / n_t

Sequences run as a loop over time in f32 (the reference's ``lax.scan``);
decode is one step.  mLSTM block = up-proj x2 (gate/value), causal conv
on the value path, q/k/v from it, cell, gated down-proj; sLSTM block =
cell + gated FFN.
"""
from __future__ import annotations

import math

import torch

from .layers import dense_init, dot, gelu, params, sigmoid, silu, softplus
from .rglru import _conv1d

__all__ = ["mlstm_apply", "mlstm_init", "slstm_apply", "slstm_apply_group",
           "mlstm_apply_group", "slstm_init"]


# --------------------------------------------------------------------- #
# mLSTM
# --------------------------------------------------------------------- #


def mlstm_init(gen, cfg):
    d = cfg.d_model
    h = cfg.n_heads
    dn = cfg.mlstm_expansion * d  # inner width
    dev = gen.device
    return params(
        w_up=dense_init(gen, (d, dn)),
        w_gate=dense_init(gen, (d, dn)),
        conv=dense_init(gen, (cfg.conv_width, dn)) * 0.1,
        wq=dense_init(gen, (dn, dn)),
        wk=dense_init(gen, (dn, dn)),
        wv=dense_init(gen, (dn, dn)),
        w_if=dense_init(gen, (dn, 2 * h)),  # input+forget gates per head
        b_if=torch.cat([torch.zeros((h,), device=dev),
                        3.0 + torch.arange(h, dtype=torch.float32,
                                           device=dev)]),
        skip=torch.ones((dn,), device=dev),
        w_down=dense_init(gen, (dn, d)),
    )


def _mlstm_cell_step(state, q, k, v, ig, fg):
    """One time step.  state = (C [B,H,hd,hd], n [B,H,hd], m [B,H]);
    q/k/v [B,H,hd]; ig/fg [B,H] (pre-activation)."""
    c, n, m = state
    log_f = -softplus(-fg)  # log sigmoid
    m_new = torch.maximum(log_f + m, ig)
    i_p = torch.exp(ig - m_new)[..., None]
    f_p = torch.exp(log_f + m - m_new)[..., None]
    n = f_p * n + i_p * k
    c = f_p[..., None] * c + i_p[..., None] * (
        v[..., :, None] * k[..., None, :])
    qn = torch.clamp_min(
        torch.abs(torch.einsum("bhd,bhd->bh", n, q)), 1.0)[..., None]
    h = torch.einsum("bhde,bhe->bhd", c, q) / qn
    return (c, n, m_new), h


def mlstm_apply(p, x, *, cfg, cache=None, mode="train"):
    """Returns (y, cache); cache = {C, n, m, conv}."""
    adt = x.dtype
    b, t, _ = x.shape
    nh = cfg.n_heads
    dn = p["w_up"].shape[1]
    hd = dn // nh

    up = dot(x, p["w_up"])
    gate = dot(x, p["w_gate"])
    cv, conv_state = _conv1d(
        up, p["conv"], None if cache is None else cache["conv"]
    )
    # silu's last multiply, left in f32: the reference's
    # ``cv.astype(f32) @ w_if`` reads it so as XLA compiles it
    cv32 = cv.to(torch.float32) * sigmoid(cv).to(torch.float32)
    cv = cv32.to(adt)
    q = dot(cv, p["wq"]).reshape(b, t, nh, hd)
    k = dot(cv, p["wk"]).reshape(b, t, nh, hd)
    v = dot(up, p["wv"]).reshape(b, t, nh, hd)
    gif = cv32 @ p["w_if"] + p["b_if"]
    ig, fg = gif[..., :nh], gif[..., nh:]  # [B,T,H]

    if cache is None:
        state = (x.new_zeros((b, nh, hd, hd), dtype=torch.float32),
                 x.new_zeros((b, nh, hd), dtype=torch.float32),
                 x.new_zeros((b, nh), dtype=torch.float32))
    else:
        state = (cache["C"], cache["n"], cache["m"])

    # the reference's ``k / sqrt(hd)`` reaches its astype(f32) unrounded
    qf, vf = q.to(torch.float32), v.to(torch.float32)
    kf = k.to(torch.float32) / math.sqrt(hd)
    steps = 1 if mode == "decode" else t
    hs = []
    for i in range(steps):
        state, h_i = _mlstm_cell_step(state, qf[:, i], kf[:, i], vf[:, i],
                                      ig[:, i], fg[:, i])
        hs.append(h_i)
    h = torch.stack(hs, dim=1)  # [B,T,H,hd]

    h = h.reshape(b, -1, dn).to(adt)
    h = h + p["skip"].to(adt) * cv[:, :h.shape[1]]
    y = dot(h * silu(gate[:, :h.shape[1]]), p["w_down"])
    new_cache = None
    if mode in ("prefill", "decode"):
        cc, nn_, mm = state
        new_cache = {"C": cc, "n": nn_, "m": mm,
                     "conv": conv_state.to(torch.float32)}
    return y, new_cache


# --------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------- #


def slstm_init(gen, cfg):
    d = cfg.d_model
    f = int(cfg.slstm_ff_factor * d)
    dev = gen.device
    return params(
        w_in=dense_init(gen, (d, 4 * d)),  # z, i, f, o pre-acts
        r_in=dense_init(gen, (d, 4 * d)) * 0.5,  # recurrent (blockwise)
        b_in=torch.cat([torch.zeros((d,), device=dev),
                        torch.zeros((d,), device=dev),
                        torch.full((d,), 3.0, device=dev),
                        torch.zeros((d,), device=dev)]),
        ff_wi=dense_init(gen, (d, 2 * f)),
        ff_wo=dense_init(gen, (f, d)),
    )


def _slstm_cell_step(state, inp, w_r, b):
    """state = (c, n, m, h_prev) each [B, D]; inp = x_t [B, 4D] pre-proj."""
    c, n, m, h_prev = state
    pre = inp + h_prev @ w_r + b  # [B, 4D]
    d = c.shape[-1]
    z = torch.tanh(pre[:, :d])
    ig = pre[:, d:2 * d]
    fg = pre[:, 2 * d:3 * d]
    o = sigmoid(pre[:, 3 * d:])
    log_f = -softplus(-fg)
    m_new = torch.maximum(log_f + m, ig)
    i_p = torch.exp(ig - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c = f_p * c + i_p * z
    n = f_p * n + i_p
    h = o * c / torch.clamp_min(n, 1.0)
    return (c, n, m_new, h), h


def slstm_apply(p, x, *, cfg, cache=None, mode="train"):
    """Returns (y, cache); cache = {c, n, m, h}."""
    adt = x.dtype
    b, t, d = x.shape
    pre = x.to(torch.float32) @ p["w_in"]  # [B,T,4D]
    if cache is None:
        state = tuple(x.new_zeros((b, d), dtype=torch.float32)
                      for _ in range(4))
    else:
        state = (cache["c"], cache["n"], cache["m"], cache["h"])

    hs = []
    for i in range(1 if mode == "decode" else t):
        state, h_i = _slstm_cell_step(state, pre[:, i], p["r_in"],
                                      p["b_in"])
        hs.append(h_i)
    h = torch.stack(hs, dim=1).to(adt)

    f2 = p["ff_wi"].shape[1] // 2
    ff = dot(h, p["ff_wi"])
    h = gelu(ff[..., :f2]) * ff[..., f2:]
    y = dot(h, p["ff_wo"])
    new_cache = None
    if mode in ("prefill", "decode"):
        c, n, m, hh = state
        new_cache = {"c": c, "n": n, "m": m, "h": hh}
    return y, new_cache


def _replicated(apply):
    def group_apply(ps, xs, *, cfg, group, caches=None, mode="train"):
        names = sorted(ps)
        caches = [None] * group.n if caches is None else caches
        w = [group.whole(ps[k]) for k in names]
        outs = group.each(
            lambda x, c, *ws: apply(dict(zip(names, ws)), x, cfg=cfg,
                                    cache=c, mode=mode),
            xs, caches, *w)
        return [o and o[0] for o in outs], [o and o[1] for o in outs]
    return group_apply


mlstm_apply_group = _replicated(mlstm_apply)
mlstm_apply_group.__name__ = "mlstm_apply_group"
mlstm_apply_group.__doc__ = """:func:`mlstm_apply` over a model group, computed whole on every
rank: the weights are gathered (``"all-gather"``) and no rank's work is
split.  The block's q / k / v projections read the whole conv output
and its gates every head, so a split by heads would gather the
activations of each layer; xlstm-350m's 4 heads do not divide a
16-rank group either.  Every rank's cache is whole."""
slstm_apply_group = _replicated(slstm_apply)
slstm_apply_group.__name__ = "slstm_apply_group"
slstm_apply_group.__doc__ = """:func:`slstm_apply` over a model group, computed whole on every
rank with gathered weights: the recurrence ``h_{t-1} @ r_in`` mixes
every channel at every time step, so a split would gather at each
step.  Every rank's cache is whole."""
