"""The LM substrate of the PyTorch port (``repro_torch.configs``,
``repro_torch.models``) against the JAX package on the CPU: the configs
field for field, every layer kind on its own, and the decoder's forward
for every architecture, on the same weights (``params_from_reference``)
and the same inputs made with numpy from a seed.

Tolerances, as max abs difference over max|.| of the reference: f32
activations and caches 1e-4; the default bf16 2e-2.  In bf16 the MoE
archs' routers can meet near ties: where the port's own router puts the
k-th and (k+1)-th expert within ``NEAR_TIE`` of each other, a last-bit
difference upstream may pick the other expert, and the tokens from there
on in that sequence (causal attention carries it forward) are left out
of the comparison; ``MAX_TIED`` bounds how many that may be (with two
sequences, one of them).  ``NEAR_TIE`` is what one last-bit difference
of one bf16 input element can move a router probability by at these
widths.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as REF_ARCH_NAMES
from repro.configs import get_config as ref_config
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import rglru as jrg
from repro.models import transformer as jt
from repro.models import xlstm as jx
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trg
from repro_torch.models import transformer as tt
from repro_torch.models import xlstm as tx

B, T = 2, 24
TOL = {"f32": 1e-4, "bf16": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
NEAR_TIE = 1e-3  # router probability margin between the k-th and k+1-th
MAX_TIED = 0.5  # at most this share of tokens left out (bf16 MoE only)


# --------------------------------------------------------------------- #
# helpers shared with test_torch_lm_serve.py
# --------------------------------------------------------------------- #
def configs(name, dtype, **kw):
    """(reference config, port config) of ``name``'s SMOKE at ``dtype``
    ("f32" or "bf16") for activations and caches."""
    jd, td = DTYPES[dtype]
    return (ref_config(name, smoke=True, activation_dtype=jd, cache_dtype=jd,
                       **kw),
            get_config(name, smoke=True, activation_dtype=td, cache_dtype=td,
                       **kw))


@functools.lru_cache(maxsize=None)
def ref_model(name, dtype, max_cache=T + 8):
    """The reference's parameters (seeded) and the port's copy of them."""
    jc, tc = configs(name, dtype, max_cache=max_cache,
                     moe_capacity_factor=8.0)
    jp = jt.init_params(jc, jax.random.PRNGKey(0))
    tp = tt.params_from_reference(jax.tree.map(np.asarray, jp), tc)
    return jc, tc, jp, tp


def inputs(cfg, t, seed=0):
    """Tokens [B, t] int32 or embeddings [B, t, D] f32, from numpy."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)
    return rng.standard_normal((B, t, cfg.d_model)).astype(np.float32)


def positions(t):
    return np.ascontiguousarray(
        np.broadcast_to(np.arange(t, dtype=np.int32), (B, t)))


def rel(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def first_near_tie(tp, tc, x_in, dtype):
    """Per batch row, the first position at which the port's router, at
    any MoE layer, has its k-th and (k+1)-th probabilities within
    ``NEAR_TIE`` (the sequence length where none does).  Only bf16 MoE
    archs have such rows; elsewhere every position compares."""
    t = x_in.shape[1]
    first = np.full(B, t)
    if dtype == "f32" or not tc.moe_experts:
        return first
    pos = torch.from_numpy(positions(t))
    x = torch.from_numpy(x_in)
    x = (tp.embed[x.long()] if tc.embed_inputs else x).to(
        tc.activation_dtype)
    for kind, p in zip(tc.pattern_kinds, tp.layers):
        h = tl.norm_apply(p["ln1"], x, tc.norm_eps)
        a, _ = tl.attn_apply(p["attn"], h, cfg=tc, positions=pos)
        _, h2 = tt._residual_norm(p["ln2"], x, a, tc)
        probs = torch.softmax(h2.float() @ p["mix"]["router"], -1)
        top = probs.sort(-1, descending=True).values
        k = tc.moe_top_k
        tied = (top[..., k - 1] - top[..., k] < NEAR_TIE).numpy()
        for row in range(B):
            hits = np.flatnonzero(tied[row])
            if hits.size:
                first[row] = min(first[row], hits[0])
        x = tt._layer_apply(kind, p, x, cfg=tc, positions=pos, cache=None,
                            mode="train")[0]
    return first


# --------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------- #
def test_registry_matches_reference():
    assert ARCH_NAMES == REF_ARCH_NAMES
    from repro.configs import SHAPES as REF_SHAPES

    assert SHAPES == REF_SHAPES
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("nope")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_configs_match_reference_field_for_field(name):
    for smoke in (False, True):
        got = dataclasses.asdict(get_config(name, smoke=smoke))
        want = dataclasses.asdict(ref_config(name, smoke=smoke))
        assert (got.pop("cache_dtype"), got.pop("activation_dtype")) == \
            (torch.bfloat16, torch.bfloat16)
        assert (want.pop("cache_dtype"), want.pop("activation_dtype")) == \
            (jnp.bfloat16, jnp.bfloat16)
        assert got == want
        cfg, ref = get_config(name, smoke=smoke), ref_config(name, smoke=smoke)
        assert cfg.param_count() == ref.param_count()
        assert cfg.active_param_count() == ref.active_param_count()
        assert cfg.head_dim == ref.head_dim
        assert cfg.pattern_kinds == ref.pattern_kinds
    # the port's own init draws every tensor the reference's tree holds
    jc, tc, jp, _ = ref_model(name, "f32")
    ours = tt.init_params(tc, torch.Generator().manual_seed(0))
    ref_sizes = sorted(x.size for x in jax.tree.leaves(jp))
    assert sum(p.numel() for p in ours.parameters()) == sum(ref_sizes)


# --------------------------------------------------------------------- #
# each layer kind on its own
# --------------------------------------------------------------------- #
def _block(ref_params):
    """A reference block's parameters as the port's ``ParameterDict``."""
    return tt._load_block({"b": jax.tree.map(np.asarray, ref_params)},
                          "cpu")["b"]


def _x(cfg, t=T, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, t, cfg.d_model)).astype(np.float32)


def _attn_case(arch, window=0):
    """Train and prefill (outputs, cache), then one decode step."""
    def run(dtype):
        jc, tc = configs(arch, dtype, max_cache=T + 4)
        jp = jl.attn_init(jax.random.PRNGKey(3), jc)
        tp = _block(jp)
        x = _x(jc)
        jd, td = DTYPES[dtype]
        pos = positions(T)
        out = []
        for mode in ("train", "prefill"):
            jy, jcache = jax.jit(lambda p, x, m=mode: jl.attn_apply(
                p, x, cfg=jc, positions=pos, mode=m, window=window))(
                jp, jnp.asarray(x, jd))
            ty, tcache = tl.attn_apply(
                tp, torch.from_numpy(x).to(td), cfg=tc,
                positions=torch.from_numpy(pos), mode=mode, window=window)
            out.append((ty, jy))
        # copies: the decode step below writes the port's cache in place
        out += [(tcache["k"].clone(), jcache["k"]),
                (tcache["v"].clone(), jcache["v"])]
        # one decode step on the prefilled cache
        x1 = _x(jc, 1, seed=2)
        p1 = np.full((B, 1), T, np.int32)
        jy, jcache = jax.jit(lambda p, c, x: jl.attn_apply(
            p, x, cfg=jc, positions=p1, cache=c, mode="decode",
            window=window))(jp, jcache, jnp.asarray(x1, jd))
        ty, tcache = tl.attn_apply(
            tp, torch.from_numpy(x1).to(td), cfg=tc,
            positions=torch.from_numpy(p1), cache=tcache, mode="decode",
            window=window)
        assert tcache["pos"] == int(jcache["pos"]) == T + 1
        return out + [(ty, jy), (tcache["k"], jcache["k"])]
    return run


def _mlp_case(arch):
    def run(dtype):
        jc, tc = configs(arch, dtype)
        jp = jl.mlp_init(jax.random.PRNGKey(4), jc)
        x = _x(jc)
        jd, td = DTYPES[dtype]
        jy = jax.jit(lambda p, x: jl.mlp_apply(p, x, cfg=jc))(
            jp, jnp.asarray(x, jd))
        return [(tl.mlp_apply(_block(jp), torch.from_numpy(x).to(td),
                              cfg=tc), jy)]
    return run


def _moe_case(arch):
    def run(dtype):
        jc, tc = configs(arch, dtype)
        jp = jmoe.moe_init(jax.random.PRNGKey(5), jc)
        x = _x(jc)
        jd, td = DTYPES[dtype]
        jy, jaux = jax.jit(lambda p, x: jmoe.moe_apply(p, x, cfg=jc))(
            jp, jnp.asarray(x, jd))
        ty, taux = tmoe.moe_apply(_block(jp), torch.from_numpy(x).to(td),
                                  cfg=tc)
        return [(ty, jy), (taux[None], np.asarray(jaux)[None])]
    return run


def _recurrent_case(init, apply, t_apply, arch, cache_keys):
    """Prefill, then one decode step on its cache: outputs and caches."""
    def run(dtype):
        jc, tc = configs(arch, dtype)
        jp = init(jax.random.PRNGKey(6), jc)
        tp = _block(jp)
        x = _x(jc)
        jd, td = DTYPES[dtype]
        out = []
        jy, jcache = jax.jit(lambda p, x: apply(p, x, cfg=jc,
                                                mode="prefill"))(
            jp, jnp.asarray(x, jd))
        ty, tcache = t_apply(tp, torch.from_numpy(x).to(td), cfg=tc,
                             mode="prefill")
        out.append((ty, jy))
        out += [(tcache[k], jcache[k]) for k in cache_keys]
        x1 = _x(jc, 1, seed=2)
        jy, jcache = jax.jit(lambda p, c, x: apply(
            p, x, cfg=jc, cache=c, mode="decode"))(
            jp, jcache, jnp.asarray(x1, jd))
        ty, tcache = t_apply(tp, torch.from_numpy(x1).to(td), cfg=tc,
                             cache=tcache, mode="decode")
        out.append((ty, jy))
        out += [(tcache[k], jcache[k]) for k in cache_keys]
        return out
    return run


def _norm_case(kind):
    def run(dtype):
        jd, td = DTYPES[dtype]
        rng = np.random.default_rng(7)
        x = (rng.standard_normal((B, T, 40)) * 3 + 1).astype(np.float32)
        p = {"scale": rng.standard_normal(40).astype(np.float32)}
        if kind == "layernorm":
            p["bias"] = rng.standard_normal(40).astype(np.float32)
        jy = jl.norm_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x, jd))
        ty = tl.norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x).to(td))
        return [(ty, jy)]
    return run


def _positions_case(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, T, 3, 16)).astype(np.float32)
    pos = positions(T) * 7
    mpos = np.stack([pos, pos + 1, pos * 2])
    return [
        (tl.apply_rope(torch.from_numpy(x).to(td), torch.from_numpy(pos)),
         jl.apply_rope(jnp.asarray(x, jd), pos)),
        (tl.apply_rope(torch.from_numpy(x).to(td), torch.from_numpy(mpos),
                       sections=(2, 3, 3)),
         jl.apply_rope(jnp.asarray(x, jd), mpos, sections=(2, 3, 3))),
        (tl.sinusoidal_embedding(torch.from_numpy(pos), 64),
         jl.sinusoidal_embedding(pos, 64)),
    ]


def _activations_case(dtype):
    jd, td = DTYPES[dtype]
    x = (np.random.default_rng(9).standard_normal(4096) * 4).astype(
        np.float32)
    xj, xt = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    return [(tl.gelu(xt), jax.nn.gelu(xj)), (tl.silu(xt), jax.nn.silu(xj)),
            (tl.sigmoid(xt), jax.nn.sigmoid(xj)),
            (tl.softplus(xt.float()), jax.nn.softplus(xj.astype(jnp.float32)))]


def _layer_case(arch, kind):
    """One whole layer (``_layer_apply``: the block between its norms and
    residual adds) in train and prefill mode, as the reference's layer
    compiles alone: its input and output in the activation dtype."""
    def run(dtype):
        jc, tc = configs(arch, dtype, max_cache=T + 4,
                         moe_capacity_factor=8.0)
        jp = jt._layer_init(jax.random.PRNGKey(10), kind, jc)
        tp = tt._load_block(jax.tree.map(np.asarray, jp), "cpu")
        x = _x(jc)
        jd, td = DTYPES[dtype]
        pos = positions(T)
        out = []
        for mode in ("train", "prefill"):
            jy = jax.jit(lambda p, x, m=mode: jt._layer_apply(
                kind, p, x, cfg=jc, positions=pos, cache=None, mode=m)[0])(
                jp, jnp.asarray(x, jd))
            ty = tt._layer_apply(kind, tp, torch.from_numpy(x).to(td),
                                 cfg=tc, positions=torch.from_numpy(pos),
                                 cache=None, mode=mode)[0]
            out.append((ty, jy))
        return out
    return run


LAYER_CASES = {
    "layer-rglru": _layer_case("recurrentgemma-9b", "rglru"),
    "layer-local": _layer_case("recurrentgemma-9b", "local"),
    "layer-mlstm": _layer_case("xlstm-350m", "mlstm"),
    "layer-slstm": _layer_case("xlstm-350m", "slstm"),
    "layer-attn-moe": _layer_case("moonshot-v1-16b-a3b", "attn"),
    "attn-rope-qknorm": _attn_case("qwen3-4b"),
    "attn-qkv-bias": _attn_case("codeqwen1.5-7b"),
    "attn-mrope": _attn_case("qwen2-vl-7b"),
    "attn-sinusoidal-none": _attn_case("musicgen-large"),
    "attn-local-window": _attn_case("recurrentgemma-9b", window=16),
    "mlp-gated-silu": _mlp_case("qwen3-4b"),
    "mlp-plain-gelu": _mlp_case("musicgen-large"),
    "mlp-gated-gelu": _mlp_case("recurrentgemma-9b"),
    "moe-top2": _moe_case("grok-1-314b"),
    "moe-top2-of-8": _moe_case("moonshot-v1-16b-a3b"),
    "rglru": _recurrent_case(jrg.rglru_init, jrg.rglru_apply,
                             trg.rglru_apply, "recurrentgemma-9b",
                             ("h", "conv")),
    "mlstm": _recurrent_case(jx.mlstm_init, jx.mlstm_apply, tx.mlstm_apply,
                             "xlstm-350m", ("C", "n", "m", "conv")),
    "slstm": _recurrent_case(jx.slstm_init, jx.slstm_apply, tx.slstm_apply,
                             "xlstm-350m", ("c", "n", "m", "h")),
    "rmsnorm": _norm_case("rmsnorm"),
    "layernorm": _norm_case("layernorm"),
    "rope-mrope-sinusoidal": _positions_case,
    "activations": _activations_case,
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_kind_matches_reference(case, dtype):
    for i, (got, want) in enumerate(LAYER_CASES[case](dtype)):
        assert rel(got.to(torch.float32).numpy() if torch.is_tensor(got)
                   else got, want) <= TOL[dtype], (case, i)


# --------------------------------------------------------------------- #
# the decoder
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_forward_matches_reference(name, dtype):
    """Train-mode logits over T+1 positions, every architecture."""
    jc, tc, jp, tp = ref_model(name, dtype)
    x = inputs(jc, T + 1)
    pos = positions(T + 1)
    want = np.asarray(jax.jit(lambda p, x: jt.forward(
        p, jc, x, positions=pos, mode="train")[0])(jp, x))
    got, cache, aux = tt.forward(tp, tc, torch.from_numpy(x),
                                 positions=torch.from_numpy(pos))
    assert cache is None and aux.dtype == torch.float32
    got = got.numpy()
    first = first_near_tie(tp, tc, x, dtype)
    keep = np.arange(T + 1)[None, :] < first[:, None]  # [B, T+1]
    assert keep.mean() >= 1 - MAX_TIED, first
    err = np.abs(got - want).max(-1)[keep].max() / np.abs(want).max()
    assert err <= TOL[dtype], (name, dtype, err, first)


# --------------------------------------------------------------------- #
# where the bf16 bits hold (ROADMAP.md queue 3, fault A)
# --------------------------------------------------------------------- #
# cases whose every activation-dtype output is the reference's, bit for
# bit: the norms, the MLPs, the recurrent blocks alone and as whole
# layers (the residual adds and the norms that read them unrounded), the
# attention cases but MHA's and the sinusoidal one (XLA:CPU's f32 exp in
# the softmax is not torch's, and its last bits reach a bf16 rounding
# there)
BITS_HOLD = ("activations", "attn-local-window", "attn-mrope",
             "attn-rope-qknorm", "layer-local", "layer-mlstm", "layer-rglru",
             "layer-slstm", "layernorm", "mlp-gated-gelu", "mlp-gated-silu",
             "mlp-plain-gelu", "mlstm", "moe-top2", "moe-top2-of-8", "rglru",
             "rmsnorm", "rope-mrope-sinusoidal", "slstm")


@pytest.mark.parametrize("case", BITS_HOLD)
def test_bf16_outputs_hold_the_reference_bits(case):
    n = 0
    for i, (got, want) in enumerate(LAYER_CASES[case]("bf16")):
        if torch.is_tensor(got) and got.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                got.to(torch.float32).numpy(),
                np.asarray(want, np.float32), err_msg=f"{case} output {i}")
            n += 1
    assert n, case


def _forward_err(name, n_layers=None):
    """max |port - reference| / max|reference| of the bf16 train-mode
    logits, the reference's default compile (``scan_layers=True``)."""
    kw = {} if n_layers is None else {"n_layers": n_layers}
    jc, tc = configs(name, "bf16", max_cache=T + 8, moe_capacity_factor=8.0,
                     **kw)
    jp = jt.init_params(jc, jax.random.PRNGKey(0))
    tp = tt.params_from_reference(jax.tree.map(np.asarray, jp), tc)
    x = inputs(jc, T + 1)
    pos = positions(T + 1)
    want = np.asarray(jax.jit(lambda p, x: jt.forward(
        p, jc, x, positions=pos, mode="train")[0])(jp, x))
    with torch.no_grad():
        got = tt.forward(tp, tc, torch.from_numpy(x),
                         positions=torch.from_numpy(pos))[0].numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name,n_layers", [
    ("smollm-135m", None), ("musicgen-large", None),
    ("moonshot-v1-16b-a3b", None), ("xlstm-350m", None),
    ("recurrentgemma-9b", 3), ("recurrentgemma-9b", 4)])
def test_bf16_forward_holds_the_reference_bits(name, n_layers):
    """The full bf16 forward, bit for bit, where every block's bits hold:
    xlstm's mLSTM / sLSTM period and recurrentgemma's first period (its
    norms reading the residual sums unrounded inside the scan's period,
    rounded across its carry) and the first layer after it."""
    assert _forward_err(name, n_layers) == 0.0


def test_recurrentgemma_at_its_real_depth():
    """recurrentgemma-9b at its published 38 layers (12 scanned periods +
    2), SMOKE width, bf16: within the bound.  Past the first period the
    f32 gates (XLA:CPU's exp, sigmoid and softplus are not torch's) move
    a bf16 rounding now and then; ROADMAP.md logs the value."""
    assert _forward_err("recurrentgemma-9b", 38) <= TOL["bf16"]


def _decode_gaps(**kw):
    """qwen3-4b's blocks with ``kw`` replaced, the reference's weights
    (seed 0), batch 4, a 32-token prefill: (port, reference) max abs
    difference of the bf16 decode of token 32 against the forward over
    33 tokens at position 32."""
    from repro.models import lm as jlm
    from repro_torch.models import lm as tlm

    jc = dataclasses.replace(ref_config("qwen3-4b"), **kw)
    tc = dataclasses.replace(get_config("qwen3-4b"), **kw)
    jp = jt.init_params(jc, jax.random.PRNGKey(0))
    tp = tt.params_from_reference(jax.tree.map(np.asarray, jp), tc)
    b, p = 4, 32
    x = np.random.default_rng(0).integers(0, jc.vocab_size,
                                          (b, p + 1)).astype(np.int32)
    pos = np.ascontiguousarray(np.broadcast_to(
        np.arange(p + 1, dtype=np.int32), (b, p + 1)))
    jf = np.asarray(jax.jit(lambda q, x: jt.forward(
        q, jc, x, positions=pos, mode="train")[0])(jp, x))[:, p]
    _, jcache = jax.jit(lambda q, x: jlm.prefill(q, jc, x))(jp, x[:, :p])
    _, _, jd = jax.jit(lambda q, c, t: jlm.decode_step(
        q, jc, c, t, jnp.int32(p)))(jp, jcache, x[:, p:])
    xt = torch.from_numpy(x)
    with torch.no_grad():
        tf = tt.forward(tp, tc, xt, positions=torch.from_numpy(pos))[0][:, p]
        _, cache = tlm.prefill(tp, tc, xt[:, :p])
        td = tlm.decode_step(tp, tc, cache, xt[:, p:], p)[2]
    return (float((td - tf).abs().max()),
            float(np.abs(np.asarray(jd) - jf).max()))


def test_bf16_decode_against_forward_no_worse_than_the_reference():
    """Fault B at a cut width (qwen3-4b's blocks at d_model 512, 4 layers,
    vocab 8192): the port's bf16 decode step against its own forward
    differs no more than the reference's does."""
    port_gap, ref_gap = _decode_gaps(
        n_layers=4, d_model=512, n_heads=4, n_kv_heads=2, d_ff=1536,
        vocab_size=8192, max_cache=40)
    assert ref_gap > 0  # the reference's own decode leaves its forward
    assert port_gap <= ref_gap, (port_gap, ref_gap)


def test_bf16_decode_against_forward_at_full_width():
    """Fault B where it showed: qwen3-4b at its full width, cut to 2
    layers.  The CPU's GEMMs summed a row in an order set by the call's
    row count (4 rows in decode, 132 in the forward), so the port's gap
    was 0.03125 against the reference's 0.0234; ``layers.dot`` sums
    every row alike, and the port's gap must be no larger."""
    port_gap, ref_gap = _decode_gaps(n_layers=2, max_cache=40)
    assert ref_gap > 0
    assert port_gap <= ref_gap, (port_gap, ref_gap)


def test_bf16_product_does_not_depend_on_the_row_count():
    """The cause of fault B, at the q projection's shape (2560 x 4096):
    the decode's 4 rows (token 32 of each of 4 sequences) give the same
    bf16 bits alone as inside the forward's 132 rows."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((132, 2560)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((2560, 4096))
                          / np.sqrt(2560)).astype(np.float32))
    rows = torch.tensor([32, 65, 98, 131])
    whole = tl.dot(x, w)
    alone = tl.dot(x[rows], w)
    assert alone.dtype == torch.bfloat16
    assert torch.equal(alone, whole[rows])
    # and one row alone, as a GEMM of one row picks yet another kernel
    assert torch.equal(tl.dot(x[rows[:1]], w), whole[rows[:1]])
