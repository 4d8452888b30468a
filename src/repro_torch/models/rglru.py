"""RG-LRU recurrent block (recurrentgemma / Griffin).

The reference's ``models/rglru.py`` in PyTorch.  Real-Gated Linear
Recurrent Unit:

  r_t = sigmoid(x_t W_a + b_a)              (recurrence gate)
  i_t = sigmoid(x_t W_x + b_x)              (input gate)
  a_t = exp(c * softplus(Lambda) * (-r_t))  (per-channel decay, c = 8)
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t)

Train/prefill runs the linear recurrence ``h_t = a_t h_{t-1} + b_t`` as
a loop over time in f32 (the reference's ``associative_scan`` adds in
tree order, so the two agree to rounding); decode is a single step.  The
surrounding block follows Griffin: dual branches (gate via GeLU,
recurrent via conv1d -> RG-LRU), merged and projected out.  The temporal
conv1d keeps a (width-1)-token state for decode.
"""
from __future__ import annotations

import torch

from .layers import dense_init, dot, gelu, params, sigmoid, softplus

__all__ = ["C_FACTOR", "rglru_apply", "rglru_init"]

C_FACTOR = 8.0


def rglru_init(gen, cfg):
    d = cfg.d_model
    r = cfg.rnn_width or d
    dev = gen.device
    return params(
        wx=dense_init(gen, (d, r)),  # input branch
        wy=dense_init(gen, (d, r)),  # gate branch
        conv=dense_init(gen, (cfg.conv_width, r)) * 0.1,
        wa=dense_init(gen, (r, r)),
        ba=torch.zeros((r,), device=dev),
        wi=dense_init(gen, (r, r)),
        bi=torch.zeros((r,), device=dev),
        # softplus(lam) spread so the decay a^c spans a useful range
        lam=torch.linspace(0.5, 4.0, r, dtype=torch.float32, device=dev),
        wo=dense_init(gen, (r, d)),
    )


def _conv1d(x, w, state=None, *, f32_sum: bool = False):
    """Causal depthwise conv over time; x [B,T,R], w [W,R].

    Returns (y, new_state [B, W-1, R]) -- state carries the last W-1
    inputs for streaming decode.  The taps add in order, in x's dtype;
    with ``f32_sum`` the last add is left in f32 and ``y`` is f32, as XLA
    compiles the reference's ``conv(...).astype(f32)`` (the add's round
    trip through x's dtype dropped).
    """
    width = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # [B, T+W-1, R]
    t = x.shape[1]
    taps = [xp[:, i:i + t] * w[i].to(x.dtype) for i in range(width)]
    if f32_sum and width > 1:
        y = sum(taps[:-1]).to(torch.float32) + taps[-1].to(torch.float32)
    else:
        y = sum(taps)
    return y, xp[:, xp.shape[1] - (width - 1):]


def _lru_scan(a, b, h0=None):
    """h_t = a_t h_{t-1} + b_t over time; a, b [B,T,R].

    In ``jax.lax.associative_scan``'s order: pairs of neighbours combine
    (``(a_l a_r, a_r b_l + b_r)``), the pairs scan recursively, and the
    even elements combine with the scanned odd ones, so every sum rounds
    as the reference's does."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    return _assoc_scan(a, b)[1]


def _assoc_scan(a, b):
    """The scan of the pairs ``(a, b)`` along dim 1, recursively."""
    n = a.shape[1]
    if n < 2:
        return a, b
    al, bl, ar, br = a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]
    oa, ob = _assoc_scan(al * ar, ar * bl + br)
    a2, b2 = a[:, 2::2], b[:, 2::2]
    if n % 2 == 0:
        oa_, ob_ = oa[:, :-1], ob[:, :-1]
    else:
        oa_, ob_ = oa, ob
    ea = torch.cat([a[:, :1], oa_ * a2], dim=1)
    eb = torch.cat([b[:, :1], a2 * ob_ + b2], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _interleave(even, odd):
    """Elements ``even[0], odd[0], even[1], odd[1], ...`` along dim 1."""
    n = even.shape[1] + odd.shape[1]
    out = torch.stack([even[:, :odd.shape[1]], odd], dim=2).flatten(1, 2)
    if n % 2:
        out = torch.cat([out, even[:, -1:]], dim=1)
    return out


def rglru_apply(p, x, *, cfg, cache=None, mode="train"):
    """Returns (y, new_cache); cache = {"h": [B,R], "conv": [B,W-1,R]}."""
    adt = x.dtype

    gate = gelu(dot(x, p["wy"]))
    u = dot(x, p["wx"])
    uf, conv_state = _conv1d(
        u, p["conv"], None if cache is None else cache["conv"], f32_sum=True
    )
    uf = uf.to(torch.float32)
    rgate = sigmoid(uf @ p["wa"] + p["ba"])
    igate = sigmoid(uf @ p["wi"] + p["bi"])
    a = torch.exp(-C_FACTOR * softplus(p["lam"]) * rgate)  # [B,T,R]
    gated_in = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (
        igate * uf)

    if mode == "decode":
        h = a[:, 0] * cache["h"] + gated_in[:, 0]
        out = h[:, None]
        new_cache = {"h": h, "conv": conv_state.to(torch.float32)}
    else:
        out = _lru_scan(a, gated_in, None if cache is None else cache["h"])
        new_cache = None
        if mode == "prefill":
            new_cache = {"h": out[:, -1],
                         "conv": conv_state.to(torch.float32)}

    y = dot(out.to(adt) * gate, p["wo"])
    return y, new_cache
