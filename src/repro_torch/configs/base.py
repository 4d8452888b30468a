"""Architecture configuration schema shared by all assigned archs.

The reference's ``ArchConfig`` field for field, with torch dtypes for
``cache_dtype`` and ``activation_dtype``.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Static architecture + runtime configuration.

    ``block_pattern`` is cycled over layers (e.g. recurrentgemma's
    ``("rglru", "rglru", "local")``); layers are scanned period-wise with a
    trailing partial period unrolled.
    """

    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim_override: int | None = None
    block_pattern: tuple = ("attn",)
    window: int = 0  # sliding window for "local" blocks
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    rope: str = "rope"  # rope | mrope | sinusoidal | none
    mrope_sections: tuple = (16, 24, 24)
    # channel mixing
    act: str = "silu"
    gated_mlp: bool = True
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-6
    # embeddings
    embed_inputs: bool = True  # False: frontend stub feeds embeddings
    tie_embeddings: bool = False
    # recurrent blocks
    rnn_width: int | None = None
    conv_width: int = 4
    mlstm_expansion: int = 2
    slstm_ff_factor: float = 1.3334
    # runtime knobs (not architecture identity)
    max_cache: int = 0  # KV capacity for prefill/decode lowering
    cache_dtype: object = torch.bfloat16
    activation_dtype: object = torch.bfloat16
    # remat: in training, each full period of block_pattern is
    # recomputed in the backward ("full": all of it; "dots": all but the
    # outputs of products without batch dimensions), as the reference's
    # jax.checkpoint of its scan body (models.transformer.forward)
    remat: str = "none"  # none | full | dots
    # scan_layers is the reference's JAX compile knob: kept for its field
    # set, no effect here (the port runs the layers in a Python loop)
    scan_layers: bool = True
    # the reference's SPMD sharding hints for XLA's propagation: kept for
    # its field set, no effect on one device
    shard_hints: bool = False
    attn_q_shard: bool = False
    attn_heads_merge: bool = False
    dp_axes: tuple = ("pod", "data")

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """True if no full-attention block (long-context decode viable)."""
        return "attn" not in self.block_pattern

    @property
    def pattern_kinds(self) -> tuple:
        return tuple(
            self.block_pattern[i % len(self.block_pattern)]
            for i in range(self.n_layers)
        )

    def param_count(self) -> int:
        """Analytic parameter count (for 6*N*D roofline bookkeeping)."""
        d, hd = self.d_model, self.head_dim
        n = 0
        if self.embed_inputs:
            n += self.vocab_size * d
        n += d * self.vocab_size  # unembed (tied -> still counted once)
        if self.tie_embeddings and self.embed_inputs:
            n -= d * self.vocab_size
        for kind in self.pattern_kinds:
            if kind in ("attn", "local"):
                n += d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
                if self.moe_experts:
                    n += d * self.moe_experts  # router
                    n += (
                        self.moe_experts * 3 * d * self.moe_d_ff
                    )
                else:
                    n += d * self.d_ff * (3 if self.gated_mlp else 2)
            elif kind == "rglru":
                r = self.rnn_width or d
                n += 2 * d * r + 2 * r * r + r * d  # branches+gates+out
                n += d * self.d_ff * (3 if self.gated_mlp else 2)
            elif kind == "mlstm":
                dn = self.mlstm_expansion * d
                n += 2 * d * dn + 3 * dn * dn + dn * d
            elif kind == "slstm":
                f = int(self.slstm_ff_factor * d)
                n += 8 * d * d + d * 2 * f + f * d
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k of the expert pool)."""
        if not self.moe_experts:
            return self.param_count()
        n = self.param_count()
        n_layers_moe = sum(
            1 for k in self.pattern_kinds if k in ("attn", "local")
        )
        full = n_layers_moe * self.moe_experts * 3 * self.d_model * (
            self.moe_d_ff
        )
        active = n_layers_moe * self.moe_top_k * 3 * self.d_model * (
            self.moe_d_ff
        )
        return n - full + active
