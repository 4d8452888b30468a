"""Core transformer layers: norms, position encodings, GQA attention, MLP.

The reference's ``models/layers.py`` in PyTorch, with its arithmetic:
parameters are kept in f32 and cast to the activation dtype at each
matmul; norms, RoPE, attention logits and softmax are f32, masked logits
``-1e30``.  A block's parameters are a ``torch.nn.ParameterDict`` (the
reference's dict of arrays); every block exposes ``*_init(gen, cfg)``
(an explicit ``torch.Generator``, on the device the parameters go to)
and ``*_apply(p, x, *, cfg, ...) -> (y, cache)`` with ``mode in
{"train", "prefill", "decode"}``.

Supports the variations required by the assigned architectures:
  * GQA with any kv-head count (incl. MQA kv=1 and MHA kv=H)
  * qk-norm (qwen3), qkv bias (qwen1.5/codeqwen)
  * sliding-window ("local") attention (recurrentgemma)
  * RoPE, M-RoPE (qwen2-vl section-wise), sinusoidal (musicgen), none
  * gated (SiLU/GeLU) and plain MLPs; RMSNorm and LayerNorm

Attention is plain ``einsum`` and softmax, as the reference computes it.
A decode step writes the new key and value into the cache in place and
returns it; the cache's ``pos`` (the next write position) is a host int.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

__all__ = [
    "act_fn", "apply_rope", "attn_apply", "attn_apply_group", "attn_init",
    "attn_split", "dense_init", "embed_group", "mlp_apply_group",
    "norm_apply_group", "unembed_group",
    "dot", "gelu", "mlp_apply", "mlp_init", "norm_apply", "norm_init",
    "rope_freqs", "sigmoid", "silu", "sinusoidal_embedding", "softplus",
    "Unseeded",
]

# --------------------------------------------------------------------- #
# initialization helpers
# --------------------------------------------------------------------- #


class Unseeded:
    """Stands in for the ``torch.Generator`` of the ``*_init`` functions
    where only shapes matter: every weight is made on ``device`` and
    nothing is drawn (the dry run's parameters, fake tensors on a
    placeholder, where a random draw has no values to write)."""

    def __init__(self, device):
        self.device = device


def dense_init(gen, shape, in_axis: int = 0, dtype=torch.float32):
    """Truncated normal on [-2, 2] times ``1/sqrt(fan_in)``, the
    reference's distribution (not its numbers), drawn from ``gen`` on its
    device (an :class:`Unseeded` ``gen`` draws nothing)."""
    std = 1.0 / math.sqrt(shape[in_axis])
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    if not isinstance(gen, Unseeded):
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(dtype)


def params(**tensors) -> nn.ParameterDict:
    """A block's parameters, frozen (serving computes no gradients)."""
    return nn.ParameterDict({
        k: nn.Parameter(v, requires_grad=False) for k, v in tensors.items()})


ROW_BLOCK = 64  # rows of every GEMM call under :func:`dot`'s CPU rule


def _fixed_rows(a, b):
    """``a [M, K] @ b [K, N]`` in f32, as GEMM calls of exactly
    ``ROW_BLOCK`` rows each (the last one zero-padded): every row is
    summed by the same kernel in the same order, whatever ``M`` is."""
    m, k = a.shape
    pad = -m % ROW_BLOCK
    if pad:
        a = torch.cat([a, a.new_zeros((pad, k))])
    return torch.cat([a[i:i + ROW_BLOCK] @ b
                      for i in range(0, m + pad, ROW_BLOCK)])[:m]


class _RowFree(torch.autograd.Function):
    """:func:`dot`'s CPU rule; the backward is the plain product's."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        a32, b32 = a.to(torch.float32), b.to(torch.float32)
        if b.dim() == 2:  # a [..., K] @ b [K, N]
            out = _fixed_rows(a32.reshape(-1, a.shape[-1]), b32)
            out = out.reshape(a.shape[:-1] + b.shape[-1:])
        else:  # experts: a [B, E, C, K] @ b [E, K, N] -> [B, E, C, N]
            out = torch.stack([
                _fixed_rows(a32[:, e].reshape(-1, a.shape[-1]), b32[e])
                .reshape(a.shape[0], a.shape[2], b.shape[-1])
                for e in range(b.shape[0])], dim=1)
        return out.to(a.dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if b.dim() == 2:  # as matmul folds a [..., K] into rows
            if ctx.needs_input_grad[0]:
                ga = g @ b.T
            if ctx.needs_input_grad[1]:
                gb = (a.reshape(-1, a.shape[-1]).T
                      @ g.reshape(-1, g.shape[-1]))
        else:
            if ctx.needs_input_grad[0]:
                ga = torch.einsum("becn,ekn->beck", g, b)
            if ctx.needs_input_grad[1]:
                gb = torch.einsum("beck,becn->ekn", a, g)
        return ga, gb


def dot(x, w):
    """The models' product of activations and a weight, ``w`` cast to
    ``x``'s dtype first: ``x [..., K] @ w [K, N]``, or per expert
    ``x [B, E, C, K] @ w [E, K, N] -> [B, E, C, N]`` (the reference's
    ``einsum("becd,edf->becf")``).

    In bf16 on the CPU its value is the f32 product of the widened
    operands, rounded to bf16, summed by GEMM calls of exactly
    ``ROW_BLOCK`` rows: the CPU's GEMMs pick their kernel, and with it
    the order of a row's sum, by the number of rows (one row, or up to
    16 at some widths), so a decode step's rows rounded unlike the same
    rows inside a forward (ROADMAP.md, fault B).  XLA:CPU's product does
    not depend on the rows either.  In f32, and on the card (cuBLAS), it
    is the plain product.  The gradient is the plain product's.
    """
    w = w.to(x.dtype)
    if x.dtype in (torch.float32, torch.float64) or x.device.type != "cpu":
        return x @ w if w.dim() == 2 else torch.einsum(
            "becd,edf->becf", x, w)
    return _RowFree.apply(x, w)


def softplus(x):
    """``jax.nn.softplus``: ``log(1 + exp(x))`` without a threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation, op by op in
    ``x``'s dtype with its constants rounded to that dtype, as the
    reference computes it (``F.gelu`` rounds once, from f32, and differs
    in bf16's last bit)."""
    c0 = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    c1 = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype,
                      device=x.device)
    return x * (0.5 * (1 + torch.tanh(c1 * (x + c0 * x ** 3))))


def sigmoid(x):
    """``jax.nn.sigmoid`` as XLA expands it, ``1 / (1 + exp(-x))``, each
    op rounded to ``x``'s dtype (``torch.sigmoid`` rounds once and
    differs in bf16's last bit)."""
    return 1 / (1 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu``: ``x * sigmoid(x)``, each op rounded to ``x``'s
    dtype."""
    return x * sigmoid(x)


def act_fn(name: str):
    return silu if name == "silu" else gelu


# --------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------- #


def norm_init(d, kind: str = "rmsnorm", device=None):
    p = {"scale": torch.ones((d,), device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), device=device)
    return params(**p)


def norm_apply(p, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# position encodings
# --------------------------------------------------------------------- #


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, *, sections=None, theta: float = 10000.0):
    """Rotary embedding; ``x``: [B, T, N, hd], positions: [B, T] (int).

    ``sections``: M-RoPE (qwen2-vl) -- per-section *pair* counts summing
    to hd//2; ``positions`` then has shape [n_sections, B, T] (temporal /
    height / width streams; the text stub feeds the same ids to all
    three, which is exactly M-RoPE's behaviour on text tokens).
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # [hd/2]
    if sections is None:
        ang = positions[..., None].to(torch.float32) * freqs  # [B,T,hd/2]
    else:
        assert sum(sections) == hd // 2, (sections, hd)
        parts, start = [], 0
        for i, sec in enumerate(sections):
            f = freqs[start:start + sec]
            parts.append(positions[i][..., None].to(torch.float32) * f)
            start += sec
        ang = torch.cat(parts, dim=-1)  # [B,T,hd/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_embedding(positions, d_model: int):
    """Classic transformer sinusoidal table, evaluated at ``positions``."""
    half = d_model // 2
    freqs = torch.exp(
        -math.log(10000.0)
        * torch.arange(half, dtype=torch.float32, device=positions.device)
        / half)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------- #
# attention (GQA / MQA / MHA, optional sliding window)
# --------------------------------------------------------------------- #


def attn_init(gen, cfg):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = gen.device
    p = {
        "wq": dense_init(gen, (d, h * hd)),
        "wk": dense_init(gen, (d, kv * hd)),
        "wv": dense_init(gen, (d, kv * hd)),
        "wo": dense_init(gen, (h * hd, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), device=dev)
        p["bk"] = torch.zeros((kv * hd,), device=dev)
        p["bv"] = torch.zeros((kv * hd,), device=dev)
    out = params(**p)
    if cfg.qk_norm:
        out["q_norm_scale"] = nn.Parameter(torch.ones((hd,), device=dev),
                                           requires_grad=False)
        out["k_norm_scale"] = nn.Parameter(torch.ones((hd,), device=dev),
                                           requires_grad=False)
    return out


def _attn_mask(q_pos, k_pos, window: int):
    """[.., Tq, Tk] boolean mask: causal, optionally banded."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window > 0:
        m &= k_pos[..., None, :] > q_pos[..., :, None] - window
    return m


def _attend(qh, k, v, valid, scale):
    """Softmax attention in f32: ``qh`` [B,T,KV,G,hd], ``k``/``v``
    [B,S,KV,hd], ``valid`` broadcastable to [B,KV,G,T,S]."""
    logits = torch.einsum("bqkgd,bskd->bkgqs", qh.to(torch.float32),
                          k.to(torch.float32)) * scale
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", w, v.to(torch.float32))


def _proj(p, x, name: str, n: int, cfg, positions):
    """Attention's ``q``, ``k`` or ``v`` of ``n`` heads: the product,
    the bias, and for ``q`` / ``k`` the qk-norm and the rotary
    embedding; [B, T, n, hd]."""
    b, t, _ = x.shape
    y = dot(x, p["w" + name])
    if cfg.qkv_bias:
        y = y + p["b" + name].to(x.dtype)
    y = y.reshape(b, t, n, cfg.head_dim)
    if name == "v":
        return y
    if cfg.qk_norm:
        y = norm_apply({"scale": p[name + "_norm_scale"]}, y, cfg.norm_eps)
    if cfg.rope == "rope":
        y = apply_rope(y, positions)
    elif cfg.rope == "mrope":
        mpos = positions[None].expand((3,) + tuple(positions.shape))
        y = apply_rope(y, mpos, sections=cfg.mrope_sections)
    return y


def _prefill_cache(k, v, cfg, window: int):
    """The cache a prefill of ``k`` / ``v`` [B, T, KV, hd] leaves."""
    b, t, kv, hd = k.shape
    c = window if window > 0 else cfg.max_cache
    cdt = cfg.cache_dtype
    if window > 0 and t >= c:
        # ring layout: slot = pos % c; roll so that the slot of
        # the next token (pos = t) holds the oldest entry
        shift = t % c
        ck = torch.roll(k[:, t - c:].to(cdt), shift, dims=1)
        cv = torch.roll(v[:, t - c:].to(cdt), shift, dims=1)
    else:
        ck = k.new_zeros((b, c, kv, hd), dtype=cdt)
        cv = v.new_zeros((b, c, kv, hd), dtype=cdt)
        ck[:, :t] = k.to(cdt)
        cv[:, :t] = v.to(cdt)
    return {"k": ck, "v": cv, "pos": t}


def attn_apply(p, x, *, cfg, positions, cache=None, mode="train",
               window: int = 0):
    """Returns (y, new_cache).

    cache (prefill out / decode in-out):
      {"k": [B, C, KV, hd], "v": ..., "pos": int next-write position}
      For windowed attention C == window and writes wrap (rolling buffer).
    """
    b, t, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    adt = x.dtype

    q = _proj(p, x, "q", h, cfg, positions)
    k = _proj(p, x, "k", kv, cfg, positions)
    v = _proj(p, x, "v", kv, cfg, positions)

    scale = 1.0 / math.sqrt(hd)
    g = h // kv  # query groups per kv head

    if mode == "decode":
        # t == 1; read the rolling/linear cache, write at pos (in place)
        assert cache is not None
        ck, cv, pos = cache["k"], cache["v"], int(cache["pos"])
        c = ck.shape[1]
        slot = pos % c if window > 0 else pos
        ck[:, slot] = k[:, 0].to(ck.dtype)
        cv[:, slot] = v[:, 0].to(cv.dtype)
        k_pos = torch.arange(c, device=x.device)
        if window > 0:
            k_pos = k_pos + (pos - pos % c)
            k_pos = torch.where(k_pos > pos, k_pos - c, k_pos)  # unwrap
            valid = (k_pos <= pos) & (k_pos > pos - window)
        else:
            valid = (k_pos <= pos) & (k_pos >= 0)
        o = _attend(q.reshape(b, 1, kv, g, hd), ck, cv, valid, scale)
        o = o.reshape(b, 1, h * hd).to(adt)
        new_cache = {"k": ck, "v": cv, "pos": pos + 1}
    else:
        mask = _attn_mask(positions, positions, window)  # [B,T,T]
        o = _attend(q.reshape(b, t, kv, g, hd), k, v,
                    mask[:, None, None], scale)
        o = o.reshape(b, t, h * hd).to(adt)
        new_cache = None
        if mode == "prefill":
            new_cache = _prefill_cache(k, v, cfg, window)
    y = dot(o, p["wo"])
    return y, new_cache


def _attn_rows(p, x, *, cfg, positions, rows, mode, window: int = 0):
    """Attention for the query rows ``rows = (lo, hi)`` of ``x``
    against every key: ``(y [B, hi - lo, D], cache)``, the cache of the
    whole sequence in prefill."""
    b, t, _ = x.shape
    lo, hi = rows
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    k = _proj(p, x, "k", kv, cfg, positions)
    v = _proj(p, x, "v", kv, cfg, positions)
    q = _proj(p, x[:, lo:hi], "q", h, cfg, positions[:, lo:hi])
    mask = _attn_mask(positions[:, lo:hi], positions, window)
    o = _attend(q.reshape(b, hi - lo, kv, h // kv, hd), k, v,
                mask[:, None, None], 1.0 / math.sqrt(hd))
    o = o.reshape(b, hi - lo, h * hd).to(x.dtype)
    cache = _prefill_cache(k, v, cfg, window) if mode == "prefill" else None
    return dot(o, p["wo"]), cache


def attn_split(cfg, n: int):
    """How attention splits over ``n`` model ranks: ``("heads", q, kv)``
    with each rank's query heads ``q[r]`` and kv heads ``kv[r]`` (a kv
    head is computed on every rank whose query heads read it), where
    the query heads divide and each rank's heads keep their groups;
    else ``("rows", None, None)``: each rank takes ``1 / n`` of the
    query rows against the whole ``k`` and ``v`` (the reference's
    ``attn_q_shard``)."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if h % n == 0:
        g, hl = h // kv, h // n
        qb = [(r * hl, (r + 1) * hl) for r in range(n)]
        kb = [(q0 // g, -(-q1 // g)) for q0, q1 in qb]
        if all(k1 - k0 == 1 or (q0 % g == 0 and hl % g == 0)
               for (q0, _), (k0, k1) in zip(qb, kb)):
            return "heads", qb, kb
    return "rows", None, None


def attn_apply_group(ps, xs, *, cfg, group, positions, caches=None,
                     mode="train", window: int = 0):
    """:func:`attn_apply` over a model group (``dist.collectives
    .ModelGroup``): ``ps`` maps each parameter to its ``Pieces``, ``xs``
    and ``positions`` are per-rank lists, ``caches`` a per-rank list of
    this layer's caches.  Returns ``(ys, caches)``, per rank.

    Split by query heads (:func:`attn_split`): rank ``r`` projects its
    heads' ``q`` and the ``k`` / ``v`` of the kv heads they read, attends
    and applies its rows of ``wo``; one all-reduce sums the ranks'
    partial outputs.  Its cache holds its kv heads.  Where the heads do
    not divide, split by query rows: each rank projects ``k`` and ``v``
    for the whole sequence with the whole weights (relaid out at use)
    and its rows' ``q``, and an all-gather joins the rows; a decode
    step, or a length the ranks do not divide, is computed whole on
    every rank.  Such a rank's cache holds every kv head."""
    n, hd = group.n, cfg.head_dim
    how, qb, kb = attn_split(cfg, n)
    caches = [None] * n if caches is None else caches
    names = sorted(ps)
    if how == "heads":
        def cols(b):
            return [(a * hd, c * hd) for a, c in b]
        bounds = {"q": cols(qb), "k": cols(kb), "v": cols(kb)}
        w = {}
        for k in names:
            if k in ("wq", "wk", "wv"):
                w[k] = group.take(ps[k], 1, bounds[k[1]])
            elif k in ("bq", "bk", "bv"):
                w[k] = group.take(ps[k], 0, bounds[k[1]])
            elif k == "wo":
                w[k] = group.take(ps[k], 0, bounds["q"])
            else:  # the qk-norm scales
                w[k] = group.whole(ps[k])

        def one(r, x, pos, c, *ws):
            lc = dataclasses.replace(
                cfg, n_heads=qb[r][1] - qb[r][0],
                n_kv_heads=kb[r][1] - kb[r][0], head_dim_override=hd)
            return attn_apply(dict(zip(names, ws)), x, cfg=lc,
                              positions=pos, cache=c, mode=mode,
                              window=window)

        outs = group.each(one, range(n), xs, positions, caches,
                          *[w[k] for k in names])
        ys = group.all_reduce([o and o[0] for o in outs])
        return ys, [o and o[1] for o in outs]
    w = [group.whole(ps[k]) for k in names]
    t = xs[group.live[0]].shape[1]
    if mode == "decode" or t % n:
        outs = group.each(
            lambda x, pos, c, *ws: attn_apply(
                dict(zip(names, ws)), x, cfg=cfg, positions=pos, cache=c,
                mode=mode, window=window),
            xs, positions, caches, *w)
        return [o and o[0] for o in outs], [o and o[1] for o in outs]
    rows = group.bounds(t)
    outs = group.each(
        lambda rw, x, pos, *ws: _attn_rows(
            dict(zip(names, ws)), x, cfg=cfg, positions=pos, rows=rw,
            mode=mode, window=window),
        rows, xs, positions, *w)
    ys = group.all_gather([o and o[0] for o in outs], dim=1)
    return ys, [o and o[1] for o in outs]


# --------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------- #


def mlp_init(gen, cfg, d_ff=None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    p = {"wi": dense_init(gen, (d, f)), "wo": dense_init(gen, (f, d))}
    if cfg.gated_mlp:
        p["wg"] = dense_init(gen, (d, f))
    return params(**p)


def mlp_apply(p, x, *, cfg):
    adt = x.dtype
    act = act_fn(cfg.act)
    h = dot(x, p["wi"])
    if "wg" in p:
        h = act(dot(x, p["wg"])) * h
    else:
        h = act(h)
    return dot(h, p["wo"])


def mlp_apply_group(ps, xs, *, cfg, group):
    """:func:`mlp_apply` over a model group: rank ``r`` takes columns
    ``r`` of ``wi`` / ``wg`` and the same rows of ``wo``, and one
    all-reduce sums the partial outputs.  A width the ranks do not
    divide is computed whole on every rank, with the whole weights."""
    names = sorted(ps)
    f = ps["wi"].shape[1]
    if f % group.n:
        w = [group.whole(ps[k]) for k in names]
        return group.each(
            lambda x, *ws: mlp_apply(dict(zip(names, ws)), x, cfg=cfg),
            xs, *w)
    cb = group.bounds(f)
    w = [group.take(ps[k], 0 if k == "wo" else 1, cb) for k in names]
    ys = group.each(
        lambda x, *ws: mlp_apply(dict(zip(names, ws)), x, cfg=cfg), xs, *w)
    return group.all_reduce(ys)


def norm_apply_group(ps, xs, *, group, eps: float = 1e-6):
    """:func:`norm_apply` on every rank's copy of ``xs``, the scale (and
    bias) whole (a scanned layer's norm is split at rest)."""
    names = sorted(ps)
    w = [group.whole(ps[k]) for k in names]
    return group.each(
        lambda x, *ws: norm_apply(dict(zip(names, ws)), x, eps), xs, *w)


def embed_group(leaf, ids, *, group, dtype):
    """Vocab-parallel embedding: rank ``r`` looks up the rows it holds
    (``embed`` is split over the vocabulary), the other tokens read
    zero, and an all-reduce in f32 sums the ranks' lookups (exactly: one
    term of each sum is not zero).  A vocabulary the ranks do not
    divide is looked up whole on every rank."""
    v = leaf.shape[0]
    if v % group.n:
        return group.each(lambda w, i: w[i].to(dtype), group.whole(leaf),
                          ids)
    vb = group.bounds(v)

    def one(w, i, b):
        lo, hi = b
        inside = (i >= lo) & (i < hi)
        rows = w[torch.clamp(i - lo, 0, hi - lo - 1)]
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))

    xs = group.all_reduce(group.each(one, group.take(leaf, 0, vb), ids, vb))
    return group.each(lambda x: x.to(dtype), xs)


def unembed_group(leaf, xs, *, group, tied: bool):
    """Vocab-parallel logits in f32: rank ``r``'s columns of the
    unembedding (``embed``'s rows, transposed, when ``tied``).  Returns
    ``(logits, bounds)``, ``bounds[r]`` rank ``r``'s vocabulary range;
    where the ranks do not divide the vocabulary every rank computes
    every logit and ``bounds`` is ``None``."""
    vdim = 0 if tied else 1
    v = leaf.shape[vdim]

    def one(x, w):
        return dot(x, w.T if tied else w).to(torch.float32)

    if v % group.n:
        return group.each(one, xs, group.whole(leaf)), None
    vb = group.bounds(v)
    return group.each(one, xs, group.take(leaf, vdim, vb)), vb
