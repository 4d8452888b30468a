"""The reference's ``launch/hlo_analysis.py``, as far as the port has a
counterpart: the documented min-traffic model :func:`analytic_min_hbm`,
and the names ``HW``, ``Hardware`` and ``roofline``, defined once in
``launch.hardware`` (the H100's rates) and ``launch.roofline`` and
re-exported here, so that every name of the reference's module is found
where it was.

``analyze_collectives`` is not ported: it parses the collectives of
compiled HLO text, which the port never makes.  The port's dry run runs
its own program on fake tensors instead (``core.lowering``), and the
trace's tally of the copies between devices,
``core.lowering.Lowered.collectives()``, stands in for it, in the same
shape (``ops``, ``ici_bytes``, ``dci_bytes``, ``by_kind``).

>>> import types
>>> from repro_torch.configs import get_config
>>> mesh = types.SimpleNamespace(shape={"data": 16, "model": 16}, size=256)
>>> cfg = get_config("qwen3-4b", max_cache=1024)
>>> analytic_min_hbm(cfg, "train", 64, 1024, mesh) > analytic_min_hbm(
...     cfg, "train", 16, 1024, mesh) > 0
True
"""
from __future__ import annotations

from .hardware import HW, Hardware
from .roofline import roofline

__all__ = ["HW", "Hardware", "analytic_min_hbm", "roofline"]


def analytic_min_hbm(cfg, kind: str, batch: int, seq: int, mesh) -> float:
    """Documented min-HBM-traffic model, bytes per device per step.

    The reference's formula, term by term, in plain Python floats (so
    both give the same float).  It assumes the reference's layout:
    parameters sharded ``tp = mesh.shape["model"]`` ways and the batch
    over the other axes.

    train:   params fwd+bwd reads + AdamW m/v/p read+write (fp32) +
             remat-saved activations (w+r) + layer hot intermediates +
             logits (w+r, fp32)
    prefill: params read + activations + full logits (the unembed is
             applied to every position)
    decode:  params read + full KV/state cache read + 1-slot write
    """
    tp = mesh.shape.get("model", 1)
    dp = max(1, mesh.size // tp)
    p_shard = cfg.param_count() / tp
    toks = batch * seq / dp  # per-device tokens
    d, v = cfg.d_model, cfg.vocab_size

    # per-token per-layer intermediate traffic (bf16), TP-sharded
    per_tok = 0.0
    for k in cfg.pattern_kinds:
        if k in ("attn", "local"):
            hd = cfg.head_dim
            per_tok += (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + d
            if cfg.moe_experts:
                f_act = (
                    cfg.moe_top_k * cfg.moe_d_ff
                    * cfg.moe_capacity_factor
                )
            else:
                f_act = cfg.d_ff * (2 if cfg.gated_mlp else 1)
            per_tok += 2 * f_act + d
        elif k == "rglru":
            r = cfg.rnn_width or d
            per_tok += 4 * r + 2 * cfg.d_ff + d
        elif k == "mlstm":
            per_tok += 6 * cfg.mlstm_expansion * d
        elif k == "slstm":
            per_tok += 8 * d + 2 * int(cfg.slstm_ff_factor * d)
    act_bytes = toks * (per_tok / tp) * 2  # bf16

    if kind == "train":
        # params: fwd read + bwd read (f32) ; opt: r+w of m, v, p (f32)
        param_traffic = p_shard * 4 * (2 + 6)
        remat_saves = toks * d * 2 * cfg.n_layers * 2  # save + reload
        logits = toks * (v / tp) * 4 * 2
        return param_traffic + 3 * act_bytes + remat_saves + logits
    if kind == "prefill":
        return p_shard * 4 + act_bytes + toks * (v / tp) * 4
    # decode: one token; dominated by weights + cache sweep
    cache_bytes = 0.0
    for k in cfg.pattern_kinds:
        if k == "attn":
            cache_bytes += (
                2 * cfg.max_cache * cfg.n_kv_heads * cfg.head_dim * 2
            )
        elif k == "local":
            cache_bytes += (
                2 * cfg.window * cfg.n_kv_heads * cfg.head_dim * 2
            )
        elif k == "mlstm":
            dn = cfg.mlstm_expansion * d
            cache_bytes += (dn // cfg.n_heads) * dn * 4
        elif k == "rglru":
            cache_bytes += (cfg.rnn_width or d) * 4 * cfg.conv_width
        elif k == "slstm":
            cache_bytes += 4 * d * 4
    cache_dev = cache_bytes * batch / dp / max(
        1, tp if cfg.n_kv_heads % tp == 0 else 1
    )
    return p_shard * 4 + cache_dev + act_bytes
