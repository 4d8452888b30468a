"""Unified decoder assembly over heterogeneous block patterns.

The reference's ``models/transformer.py`` in PyTorch.  Layer ``i`` is of
kind ``cfg.block_pattern[i % period]``: the reference groups the layers
into full periods under ``jax.lax.scan`` (period-stacked parameters)
plus a trailing partial period; here the same layers, in the same order,
are one ``torch.nn.ModuleList`` run in a Python loop, each layer a
module of its own.  ``scan_layers`` is a JAX compile knob and changes
nothing; ``remat`` checkpoints each full period in training, as the
reference's ``jax.checkpoint`` of its scan body does (:func:`forward`).
:func:`params_from_reference` unstacks the reference's parameter tree
into that layout.

Modes: "train" (full-seq causal, no cache), "prefill" (full-seq, emits
cache), "decode" (one token, consumes+emits cache).
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

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
    ``mix`` where the block has a channel mixer).

    Every parameter is made frozen (``requires_grad=False``), so serving
    builds no autograd graph; training asks for gradients on the copies
    it differentiates (``models.lm.make_train_step``).  ``stack`` is
    ``(n_per, period)``: the first ``n_per * period`` layers are the ones
    the reference stacks into ``n_per`` periods under its scan
    (``dist.sharding.param_specs`` reads it; ``(0, 1)``: none)."""

    def __init__(self, embed, unembed, final_norm, layers, stack=(0, 1)):
        super().__init__()
        frozen = (lambda t: None if t is None
                  else nn.Parameter(t, requires_grad=False))
        self.embed = frozen(embed)
        self.unembed = frozen(unembed)
        self.final_norm = final_norm
        self.layers = nn.ModuleList(layers)
        self.stack = tuple(stack)


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


def init_params(cfg, gen) -> LMParams:
    """Random parameters from ``gen`` (a ``torch.Generator``), on its
    device: the reference's distributions (truncated normal +-2 times
    ``1/sqrt(fan_in)`` for every dense weight), not its numbers.  With
    ``layers.Unseeded(device)`` the same tree with no values drawn (the
    dry run's abstract parameters)."""
    embed = unembed = None
    if cfg.embed_inputs:
        embed = L.dense_init(gen, (cfg.vocab_size, cfg.d_model), in_axis=1)
    if not (cfg.tie_embeddings and cfg.embed_inputs):
        unembed = L.dense_init(gen, (cfg.d_model, cfg.vocab_size))
    final_norm = L.norm_init(cfg.d_model, cfg.norm, gen.device)
    layers = [_layer_init(gen, kind, cfg) for kind in cfg.pattern_kinds]
    return LMParams(embed, unembed, final_norm, layers, stack=_stack(cfg))


def _stack(cfg) -> tuple:
    """``(n_per, period)``: the reference's scanned periods."""
    period = len(cfg.block_pattern)
    return cfg.n_layers // period, period


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
    return LMParams(t("embed"), t("unembed"), final_norm, layers,
                    stack=_stack(cfg))


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
    s = _add32(x, a)
    return s.to(x.dtype), L.norm_apply(p, s, cfg.norm_eps).to(x.dtype)


def _add32(x, a):
    """``x + a`` of two activation-dtype tensors, in f32 and not rounded."""
    return x.to(torch.float32) + a.to(torch.float32)


def _layer_apply(kind, p, x, *, cfg, positions, cache, mode, xs=None):
    """One layer.  ``x`` is the residual stream in the activation dtype;
    ``xs``, when given, is the same sum before it was rounded, which the
    first norm reads in its place (see :func:`forward`).  Returns ``(x,
    cache, aux, xs)``: the new stream, rounded and not."""
    aux = 0.0
    h = L.norm_apply(p["ln1"], x if xs is None else xs,
                     cfg.norm_eps).to(x.dtype)
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
    elif kind == "rglru":
        a, c = rglru_apply(p["rglru"], h, cfg=cfg, cache=cache, mode=mode)
        x, h2 = _residual_norm(p["ln2"], x, a, cfg)
        m = L.mlp_apply(p["mix"], h2, cfg=cfg)
    elif kind == "mlstm":
        m, c = mlstm_apply(p["mlstm"], h, cfg=cfg, cache=cache, mode=mode)
    elif kind == "slstm":
        m, c = slstm_apply(p["slstm"], h, cfg=cfg, cache=cache, mode=mode)
    else:
        raise ValueError(kind)
    xs = _add32(x, m)
    return xs.to(x.dtype), c, aux, xs


def _save_products(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of products without batch
    dimensions (the reference's ``dots_with_no_batch_dims_saveable``),
    recompute the rest (attention's batched einsums among them)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(remat: str):
    """``checkpoint``'s ``context_fn`` for ``cfg.remat`` (``None``: no
    checkpoint)."""
    if remat == "none":
        return None
    if remat == "full":
        return ckpt.noop_context_fn
    if remat == "dots":
        return functools.partial(ckpt.create_selective_checkpoint_contexts,
                                 _save_products)
    raise ValueError(f"remat {remat!r}: none, full or dots")


def forward(params: LMParams, cfg, inputs, *, positions, cache=None,
            mode="train", last_token_only: bool = False):
    """Run the decoder (differentiable: it builds an autograd graph only
    where a parameter asks for gradients, which serving's never do).

    The residual stream rounds to the activation dtype after each add,
    and a norm reads the sum before that rounding, as XLA compiles the
    reference's ``norm(x + a)`` (the ``astype(f32)`` of a bf16 add reads
    its f32 result), except across the reference's scan: its carry, the
    stream at the end of each full period of ``cfg.block_pattern``, is
    stored rounded, so the next period's first norm reads the rounded
    stream.  The final norm reads the last add unrounded when the
    reference's trailing partial period ran last.

    In training (``mode="train"``) with ``cfg.remat`` ``"full"`` or
    ``"dots"``, each full period runs under
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, whose
    inputs and outputs are the scan's carry (the rounded stream and the
    aux sum): the backward recomputes the period (``"dots"`` keeping the
    outputs of ``mm`` / ``addmm``).  The trailing partial period is not
    checkpointed, as in the reference.  The values are those of
    ``"none"``, bit for bit.

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
    n_per, period = _stack(cfg)
    layers = list(zip(cfg.pattern_kinds, params.layers))
    remat = _remat_context(cfg.remat) if mode == "train" else None

    def run(lo, hi, x, aux_total, caches=None):
        """Layers ``lo .. hi - 1``: ``(x, aux_total, xs)``."""
        xs = None
        for i in range(lo, hi):
            kind, p = layers[i]
            x, c, aux, xs = _layer_apply(
                kind, p, x, cfg=cfg, positions=positions,
                cache=None if cache is None else cache[i], mode=mode, xs=xs,
            )
            aux_total = aux_total + aux
            if caches is not None:
                caches.append(c)
        return x, aux_total, xs

    # the full periods: the scan's carry (x, aux) is stored rounded, so
    # each period starts from the rounded stream
    for per in range(n_per):
        lo = per * period
        if remat is None:
            x, aux_total, _ = run(lo, lo + period, x, aux_total, new_cache)
        else:  # training: no caches; the decoder draws no random numbers
            x, aux_total = ckpt.checkpoint(
                lambda x, a, lo=lo: run(lo, lo + period, x, a)[:2],
                x, aux_total, use_reentrant=False, context_fn=remat,
                preserve_rng_state=False)
    x, aux_total, xs = run(n_per * period, len(layers), x, aux_total,
                           new_cache)

    if xs is not None:
        x = xs
    if last_token_only:
        x = x[:, -1:]
    x = L.norm_apply(params.final_norm, x, cfg.norm_eps).to(adt)
    w = params.embed.T if params.unembed is None else params.unembed
    logits = L.dot(x, w).to(torch.float32)
    out_cache = new_cache if mode in ("prefill", "decode") else None
    return logits, out_cache, aux_total
