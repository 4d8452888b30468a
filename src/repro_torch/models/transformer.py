"""Unified decoder assembly over heterogeneous block patterns.

The reference's ``models/transformer.py`` in PyTorch.  Layer ``i`` is of
kind ``cfg.block_pattern[i % period]``: the reference groups the layers
into full periods under ``jax.lax.scan`` (period-stacked parameters)
plus a trailing partial period; here the same layers, in the same order,
are one ``torch.nn.ModuleList`` run in a Python loop, each layer a
module of its own.  ``scan_layers`` and ``remat`` are JAX compile knobs
and change nothing.  :func:`params_from_reference` unstacks the
reference's parameter tree into that layout.

Modes: "train" (full-seq causal, no cache), "prefill" (full-seq, emits
cache), "decode" (one token, consumes+emits cache).
"""
from __future__ import annotations

import torch
from torch import nn

from . import layers as L
from .moe import moe_apply, moe_init
from .rglru import rglru_apply, rglru_init
from .xlstm import mlstm_apply, mlstm_init, slstm_apply, slstm_init

__all__ = ["LMParams", "forward", "init_cache", "init_params",
           "params_from_reference"]


class LMParams(nn.Module):
    """A decoder's parameters, f32: ``embed`` ([V, D], ``None`` when the
    inputs are embeddings), ``unembed`` ([D, V], ``None`` when tied to
    ``embed``), ``final_norm`` and ``layers`` (one ``nn.ModuleDict`` per
    layer: ``ln1``, the block under its kind's name, and ``ln2`` /
    ``mix`` where the block has a channel mixer)."""

    def __init__(self, embed, unembed, final_norm, layers):
        super().__init__()
        frozen = (lambda t: None if t is None
                  else nn.Parameter(t, requires_grad=False))
        self.embed = frozen(embed)
        self.unembed = frozen(unembed)
        self.final_norm = final_norm
        self.layers = nn.ModuleList(layers)


# --------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------- #


def _layer_init(gen, kind: str, cfg):
    dev = gen.device
    p = {"ln1": L.norm_init(cfg.d_model, cfg.norm, dev)}
    if kind in ("attn", "local"):
        p["attn"] = L.attn_init(gen, cfg)
        p["ln2"] = L.norm_init(cfg.d_model, cfg.norm, dev)
        p["mix"] = (moe_init(gen, cfg) if cfg.moe_experts
                    else L.mlp_init(gen, cfg))
    elif kind == "rglru":
        p["rglru"] = rglru_init(gen, cfg)
        p["ln2"] = L.norm_init(cfg.d_model, cfg.norm, dev)
        p["mix"] = L.mlp_init(gen, cfg)
    elif kind == "mlstm":
        p["mlstm"] = mlstm_init(gen, cfg)
    elif kind == "slstm":
        p["slstm"] = slstm_init(gen, cfg)
    else:
        raise ValueError(kind)
    return nn.ModuleDict(p)


def init_params(cfg, gen: torch.Generator) -> LMParams:
    """Random parameters from ``gen``, on its device: the reference's
    distributions (truncated normal +-2 times ``1/sqrt(fan_in)`` for every
    dense weight), not its numbers."""
    embed = unembed = None
    if cfg.embed_inputs:
        embed = L.dense_init(gen, (cfg.vocab_size, cfg.d_model), in_axis=1)
    if not (cfg.tie_embeddings and cfg.embed_inputs):
        unembed = L.dense_init(gen, (cfg.d_model, cfg.vocab_size))
    final_norm = L.norm_init(cfg.d_model, cfg.norm, gen.device)
    layers = [_layer_init(gen, kind, cfg) for kind in cfg.pattern_kinds]
    return LMParams(embed, unembed, final_norm, layers)


def _load_block(tree, device) -> nn.ModuleDict:
    """One layer's reference subtree (numpy leaves) as port tensors."""
    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    out = {}
    for name, sub in tree.items():
        flat = {}
        for key, leaf in sub.items():
            if isinstance(leaf, dict):  # attn's q_norm / k_norm
                for k2, v2 in leaf.items():
                    flat[f"{key}_{k2}"] = t(v2)
            else:
                flat[key] = t(leaf)
        out[name] = L.params(**flat)
    return nn.ModuleDict(out)


def params_from_reference(tree, cfg, device="cpu") -> LMParams:
    """The reference's ``init_params`` tree (numpy leaves, e.g.
    ``jax.tree.map(np.asarray, params)``) in the port's layout: the
    ``scan`` leaves ``[n_per, ...]`` unstacked into layers ``i * period +
    j``, then ``rem``'s layers, ``embed`` / ``unembed`` and
    ``final_norm``."""
    period = len(cfg.block_pattern)
    n_per, rem = divmod(cfg.n_layers, period)
    layers = []
    for i in range(n_per):
        for j in range(period):
            sub = tree["scan"][f"l{j}"]
            layers.append(_load_block(_index(sub, i), device))
    for j in range(rem):
        layers.append(_load_block(tree["rem"][f"l{j}"], device))

    def t(name):
        return (torch.as_tensor(tree[name], dtype=torch.float32,
                                device=device) if name in tree else None)

    final_norm = L.params(**{k: torch.as_tensor(v, device=device)
                             for k, v in tree["final_norm"].items()})
    return LMParams(t("embed"), t("unembed"), final_norm, layers)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# --------------------------------------------------------------------- #
# caches
# --------------------------------------------------------------------- #


def _layer_cache(kind: str, cfg, batch: int, device):
    hd, kv = cfg.head_dim, cfg.n_kv_heads

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    if kind in ("attn", "local"):
        c = cfg.window if kind == "local" else cfg.max_cache
        return {"k": zeros(batch, c, kv, hd, dtype=cfg.cache_dtype),
                "v": zeros(batch, c, kv, hd, dtype=cfg.cache_dtype),
                "pos": 0}
    r = cfg.rnn_width or cfg.d_model
    if kind == "rglru":
        return {"h": zeros(batch, r),
                "conv": zeros(batch, cfg.conv_width - 1, r)}
    if kind == "mlstm":
        dn = cfg.mlstm_expansion * cfg.d_model
        nh = cfg.n_heads
        return {"C": zeros(batch, nh, dn // nh, dn // nh),
                "n": zeros(batch, nh, dn // nh),
                "m": zeros(batch, nh),
                "conv": zeros(batch, cfg.conv_width - 1, dn)}
    if kind == "slstm":
        d = cfg.d_model
        return {"c": zeros(batch, d), "n": zeros(batch, d),
                "m": zeros(batch, d), "h": zeros(batch, d)}
    raise ValueError(kind)


def init_cache(cfg, batch: int, device="cpu") -> list:
    """An empty cache per layer, in layer order."""
    return [_layer_cache(kind, cfg, batch, device)
            for kind in cfg.pattern_kinds]


# --------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------- #


def _residual_norm(p, x, a, cfg):
    """``x + a`` in the activation dtype, and the norm of that sum.  The
    norm reads the sum before it is rounded: XLA fuses the reference's
    ``(x + a).astype(f32)`` into one f32 add and drops the round trip
    through the activation dtype."""
    s = x.to(torch.float32) + a.to(torch.float32)
    return s.to(x.dtype), L.norm_apply(p, s, cfg.norm_eps).to(x.dtype)


def _layer_apply(kind, p, x, *, cfg, positions, cache, mode):
    aux = 0.0
    h = L.norm_apply(p["ln1"], x, cfg.norm_eps)
    if kind in ("attn", "local"):
        a, c = L.attn_apply(
            p["attn"], h, cfg=cfg, positions=positions, cache=cache,
            mode=mode, window=cfg.window if kind == "local" else 0,
        )
        x, h2 = _residual_norm(p["ln2"], x, a, cfg)
        if cfg.moe_experts:
            m, aux = moe_apply(p["mix"], h2, cfg=cfg)
        else:
            m = L.mlp_apply(p["mix"], h2, cfg=cfg)
        x = x + m
    elif kind == "rglru":
        a, c = rglru_apply(p["rglru"], h, cfg=cfg, cache=cache, mode=mode)
        x, h2 = _residual_norm(p["ln2"], x, a, cfg)
        x = x + L.mlp_apply(p["mix"], h2, cfg=cfg)
    elif kind == "mlstm":
        a, c = mlstm_apply(p["mlstm"], h, cfg=cfg, cache=cache, mode=mode)
        x = x + a
    elif kind == "slstm":
        a, c = slstm_apply(p["slstm"], h, cfg=cfg, cache=cache, mode=mode)
        x = x + a
    else:
        raise ValueError(kind)
    return x, c, aux


@torch.no_grad()
def forward(params: LMParams, cfg, inputs, *, positions, cache=None,
            mode="train", last_token_only: bool = False):
    """Run the decoder.

    Args:
      inputs: int tokens [B, T] (``cfg.embed_inputs``) or precomputed
        embeddings [B, T, D] (vlm/audio frontend stubs).
      positions: [B, T] integer global positions.
      cache: the per-layer list from ``init_cache`` or a prefill
        ("decode"; written in place), or None.
      mode: train | prefill | decode.
      last_token_only: unembed only the final position (serving prefill).

    Returns:
      (logits [B, T, V] float32, new per-layer cache list or None, aux
      loss as a float32 scalar tensor)
    """
    adt = cfg.activation_dtype
    if cfg.embed_inputs:
        x = params.embed[inputs].to(adt)
    else:
        x = inputs.to(adt)
    if cfg.rope == "sinusoidal":
        x = x + L.sinusoidal_embedding(positions, cfg.d_model).to(adt)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = []
    for i, (kind, p) in enumerate(zip(cfg.pattern_kinds, params.layers)):
        x, c, aux = _layer_apply(
            kind, p, x, cfg=cfg, positions=positions,
            cache=None if cache is None else cache[i], mode=mode,
        )
        aux_total = aux_total + aux
        new_cache.append(c)

    if last_token_only:
        x = x[:, -1:]
    x = L.norm_apply(params.final_norm, x, cfg.norm_eps)
    w = params.embed.T if params.unembed is None else params.unembed
    logits = (x @ w.to(adt)).to(torch.float32)
    out_cache = new_cache if mode in ("prefill", "decode") else None
    return logits, out_cache, aux_total
