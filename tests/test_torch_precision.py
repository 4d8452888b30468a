"""Precision policies of the PyTorch port against the JAX package:
``adaptive_scale``, ``adaptive_scale_cols``, ``qcast`` and the quantized
tier's ``quantize_block_vals`` / ``dequantize_block_vals`` give the same
bits, edge values included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jp
from repro_torch.core import precision as tp

F32_TINY = np.finfo(np.float32).tiny


def _edge_magnitudes():
    """Exact powers of two and their float32 neighbours, zero, the
    smallest normal and subnormal, the largest finite value, and
    negatives of each.  (Half-way log2 values have their own test.)"""
    pow2 = np.ldexp(np.float32(1.0), np.arange(-149, 128)).astype(np.float32)
    nb = pow2[1:-1].view(np.int32)
    near = np.concatenate([nb - 1, nb + 1]).view(np.float32)
    special = np.array(
        [0.0, F32_TINY, np.float32(1e-45), np.finfo(np.float32).max, 1.0,
         3e-6, 65504.0], np.float32,
    )
    m = np.concatenate([pow2, near, special])
    return np.concatenate([m, -m]).astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _name(dtype):
    """torch and jnp dtypes under one spelling (``float8_e4m3fn``...)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    return np.dtype(dtype).name


def test_policies_mirror_reference():
    assert sorted(tp.POLICIES) == sorted(jp.POLICIES)
    for name in tp.POLICIES:
        t, j = tp.get_policy(name), jp.get_policy(name)
        assert t.name == j.name and t.adaptive == j.adaptive
        assert t.comm_bytes == j.comm_bytes
        assert t.vals_bytes == j.vals_bytes
        assert t.quantized == j.quantized
        assert _name(t.vals_dtype) == _name(j.vals_dtype)
        assert _name(t.storage) == _name(j.storage)
        assert _name(t.compute) == _name(j.compute)
    assert tp.ALIASES == jp.ALIASES
    assert tp.get_policy("int8") is tp.get_policy("q8")
    assert tp.get_policy("q8").vals_dtype == torch.int8
    assert tp.get_policy("fp8").vals_dtype == torch.float8_e4m3fn
    assert tp.get_policy("q8").vals_bytes == 1
    assert not tp.get_policy("mixed").quantized
    assert tp.get_policy("f32") is tp.get_policy("single")
    assert tp.get_policy("f64") is tp.get_policy("double")
    assert tp.get_policy("f16") is tp.get_policy("half")
    # true f64 in the port (the reference computes f32 without x64)
    assert tp.get_policy("double").compute == torch.float64


def test_unported_and_unknown_policies_raise():
    """The quantized rungs, once unported, resolve to the reference's
    policies; an unknown name still raises, listing every policy."""
    for name in ("q8", "int8", "fp8"):
        pol = tp.get_policy(name)
        ref = jp.get_policy(name)
        assert pol.quantized and pol.name == ref.name
        assert pol.storage == torch.float16 and pol.compute == torch.float32
        assert _name(pol.vals_dtype) == _name(ref.vals_dtype)
    with pytest.raises(KeyError) as ei:
        tp.get_policy("fp32")
    for name in sorted(tp.POLICIES):
        assert name in str(ei.value)


@pytest.mark.parametrize("target", [256.0, 1.0, 0.75, 3e4])
def test_adaptive_scale_bit_equal_on_edges(target):
    for m in _edge_magnitudes():
        x = np.array([m, m / 3], np.float32)
        t = tp.adaptive_scale(torch.from_numpy(x), target=target)
        j = jp.adaptive_scale(jnp.asarray(x), target=target)
        assert t.dtype == torch.float32 and t.shape == ()
        assert _bits(t.numpy()) == _bits(j), (m, float(t), float(j))


@pytest.mark.parametrize("target", [1.0, 256.0])
def test_adaptive_scale_cols_bit_equal(target):
    """One column per magnitude: 200k log-uniform values plus the edges."""
    rng = np.random.default_rng(0)
    m = np.concatenate([
        np.exp(rng.uniform(-85, 85, size=200_000)).astype(np.float32),
        _edge_magnitudes(),
    ])
    x = np.stack([m, m * np.float32(0.5), -m / 7]).astype(np.float32)
    t = tp.adaptive_scale_cols(torch.from_numpy(x), target).numpy()
    j = np.asarray(jp.adaptive_scale_cols(jnp.asarray(x), target))
    assert t.shape == j.shape == (m.size,)
    np.testing.assert_array_equal(_bits(t), _bits(j))


def test_half_way_neighbours_differ_only_where_log_rounds_differently():
    """Within a few ulps of a half-integer log2 the exponent rides on the
    last bit of float32 ``log``, which XLA's CPU and PyTorch round
    differently for some inputs (ROADMAP.md queue 3).  Pin that every
    disagreement is one of those, by one octave at most."""
    k = np.arange(-90, 90)
    centre = (2.0 ** (k + 0.5)).astype(np.float32).view(np.int32)
    ulps = np.arange(-3, 4, dtype=np.int32)
    q = (centre[:, None] + ulps[None, :]).ravel().view(np.float32)
    m = (np.float32(256.0) / q).astype(np.float32)
    t = tp.adaptive_scale_cols(torch.from_numpy(m[None, :]), 256.0).numpy()
    j = np.asarray(jp.adaptive_scale_cols(jnp.asarray(m[None, :]), 256.0))
    differ = t != j
    assert differ.mean() < 0.05
    ratio = t[differ] / j[differ]
    assert np.isin(ratio, [0.5, 2.0]).all()
    q_used = (np.float32(256.0) / m[differ]).astype(np.float32)
    tlog = torch.log(torch.from_numpy(q_used)).numpy()
    jlog = np.asarray(jnp.log(jnp.asarray(q_used)))
    assert (tlog != jlog).all()


@pytest.mark.parametrize("dtype", ["f16", "bf16"])
def test_qcast_bit_equal(dtype):
    tdt = {"f16": torch.float16, "bf16": torch.bfloat16}[dtype]
    jdt = {"f16": jnp.float16, "bf16": jnp.bfloat16}[dtype]
    rng = np.random.default_rng(1)
    for scale in (3e-6, 1.0, 7e3, 1e30):
        x = (scale * rng.standard_normal((64, 5))).astype(np.float32)
        tq, tinv = tp.qcast(torch.from_numpy(x), tdt, adaptive=True)
        jq, jinv = jp.qcast(jnp.asarray(x), jdt, adaptive=True)
        np.testing.assert_array_equal(
            tq.to(torch.float32).numpy(), np.asarray(jq, np.float32)
        )
        assert _bits(tinv.numpy()) == _bits(jinv)
        # non-adaptive: a plain cast
        tq, tinv = tp.qcast(torch.from_numpy(x), tdt)
        jq, _ = jp.qcast(jnp.asarray(x), jdt)
        np.testing.assert_array_equal(
            tq.to(torch.float32).numpy(), np.asarray(jq, np.float32)
        )
        assert float(tinv) == 1.0


def test_qcast_wide_dtype_is_identity():
    x = torch.tensor([1.0, 2.0])
    q, inv = tp.qcast(x, torch.float32, adaptive=True)
    assert float(inv) == 1.0 and torch.equal(q, x)
    q, inv = tp.qcast(x, torch.float64, adaptive=True)
    assert q.dtype == torch.float64 and float(inv) == 1.0


def test_qcast_roundtrip_protects_small_values():
    """Values that underflow a plain fp16 cast survive adaptive qcast."""
    x = torch.tensor([3e-6, 5e-6, -4e-6])
    q, inv = tp.qcast(x, torch.float16, adaptive=True)
    np.testing.assert_allclose((q.float() * inv).numpy(), x.numpy(),
                               rtol=1e-3)


def _quant_cases(rng):
    """[N, 4, 64] blocks: random magnitudes over 40 octaves, plus zero,
    subnormal and tiny blocks and blocks whose maximum is exactly
    ``127 * 2**k`` or ``240 * 2**k`` or a float32 neighbour of it (the
    integer-log2 edges of the floor)."""
    n_rand = 600
    rand = (rng.random((n_rand, 4, 64)) - 0.5) * np.exp2(
        rng.integers(-20, 20, size=(n_rand, 1, 1))
    )
    edges = []
    for target in (127.0, 240.0):
        for kk in range(-30, 31, 3):
            for ulp in (-1, 0, 1):
                top = np.float32(target * 2.0 ** kk).view(np.int32) + ulp
                blk = rng.random((4, 64)) * np.float32(target * 2.0 ** kk)
                blk.flat[rng.integers(0, 256)] = top.view(np.float32)
                edges.append(blk)
    special = np.zeros((4, 4, 64))
    special[1] = 1e-45  # subnormal maximum
    special[2] = F32_TINY * rng.random((4, 64))
    special[3] = -rng.random((4, 64))  # negative maximum
    return np.concatenate([rand, np.stack(edges), special]).astype(np.float32)


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_quantize_block_vals_bit_equal(qdtype):
    tdt = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[qdtype]
    jdt = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[qdtype]
    v = _quant_cases(np.random.default_rng(5))
    # the shards' [B, S, R, K] layout: every (b, s) is a block
    v = v.reshape(-1, 2, 4, 64)
    q, e = tp.quantize_block_vals(torch.from_numpy(v), tdt)
    jq, je = jp.quantize_block_vals(jnp.asarray(v), jdt)
    assert q.dtype == tdt and q.shape == v.shape
    assert e.dtype == torch.int32 and e.shape == v.shape[:2]
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(
        q.view(torch.uint8).numpy(), np.asarray(jq).view(np.uint8)
    )
    d = tp.dequantize_block_vals(q, e)
    jd = jp.dequantize_block_vals(jq, je)
    np.testing.assert_array_equal(_bits(d.numpy()), _bits(jd))
    # nothing clips: the grid error stays within half a step of the block
    step = np.exp2(e.numpy().astype(np.float64))[..., None, None]
    err = np.abs(d.numpy().astype(np.float64) - v)
    if qdtype == "int8":
        assert (err <= 0.5 * step + 1e-30).all()
    else:  # e4m3: 3 mantissa bits, relative half-step 2**-4 above 2**-6
        assert (err <= np.maximum(np.abs(v) * 2.0 ** -4, 2.0 ** -10 * step)
                + 1e-30).all()


def test_fp8_rounding_at_half_way_points_and_subnormals():
    """Both frameworks round f32 -> e4m3fn to nearest-even straight from
    f32: every e4m3 grid midpoint (ties go to the even code), a float32
    ulp on each side of it, and the subnormal range."""
    grid = torch.arange(0, 127, dtype=torch.uint8).view(
        torch.float8_e4m3fn
    ).to(torch.float32).numpy()  # every finite non-negative e4m3 value
    mid = ((grid[:-1].astype(np.float64) + grid[1:]) / 2).astype(np.float32)
    ints = mid.view(np.int32)
    probes = np.concatenate([
        mid, (ints - 1).view(np.float32), (ints + 1).view(np.float32),
        np.linspace(0, 2.0 ** -6, 301, dtype=np.float32),
    ])
    probes = np.concatenate([probes, -probes]).astype(np.float32)
    t = torch.from_numpy(probes).to(torch.float8_e4m3fn).view(torch.uint8)
    j = np.asarray(jnp.asarray(probes).astype(jnp.float8_e4m3fn)).view(
        np.uint8
    )
    np.testing.assert_array_equal(t.numpy(), j)
    # ties to even: the midpoint between codes 2n and 2n+1 takes 2n
    up = torch.from_numpy(mid[::2].copy()).to(torch.float8_e4m3fn)
    assert (up.view(torch.uint8).numpy() % 2 == 0).all()
    # through quantize_block_vals, whose scale puts each block's max on 240
    blk = np.concatenate([np.float32([240.0]), mid[mid < 240]])
    q, e = tp.quantize_block_vals(torch.from_numpy(blk[None]), torch.float8_e4m3fn)
    jq, je = jp.quantize_block_vals(jnp.asarray(blk[None]), jnp.float8_e4m3fn)
    assert int(e) == int(je) == 0
    np.testing.assert_array_equal(
        q.view(torch.uint8).numpy(), np.asarray(jq).view(np.uint8)
    )


@pytest.mark.parametrize("fn", ["adaptive_scale", "adaptive_scale_cols",
                                "qcast"])
def test_group_factor_is_the_references_pmax(fn):
    """A list of per-rank tensors stands for the reference's
    ``axis_name``: every rank applies the one factor that ``pmax`` over
    the ranks gives (the reference run here under ``vmap`` with a named
    axis), bit for bit, each on its own device."""
    import jax

    rng = np.random.default_rng(9)
    parts = (rng.standard_normal((4, 24, 5))
             * np.exp2(rng.integers(-12, 12, size=(4, 1, 5)))
             ).astype(np.float32)
    parts[2, :, 1] = 0.0  # one rank with a zero slice
    ranks = [torch.from_numpy(p) for p in parts]
    if fn == "qcast":
        jc, jinv = jax.vmap(
            lambda x: jp.qcast(x, jnp.float16, adaptive=True,
                               axis_name="r"), axis_name="r")(parts)
        tc, tinv = tp.qcast(ranks, torch.float16, adaptive=True)
        for p in range(4):
            np.testing.assert_array_equal(
                tc[p].view(torch.int16).numpy(),
                np.asarray(jc[p]).view(np.int16))
            np.testing.assert_array_equal(_bits(tinv[p].numpy()),
                                          _bits(jinv[p]))
        wide, ones = tp.qcast(ranks, torch.float32, adaptive=True)
        assert all(torch.equal(w, r) for w, r in zip(wide, ranks))
        assert all(float(o) == 1.0 for o in ones)
        return
    jref = jax.vmap(lambda x: getattr(jp, fn)(x, axis_name="r"),
                    axis_name="r")(parts)
    got = getattr(tp, fn)(ranks)
    assert len(got) == 4
    for p in range(4):
        assert got[p].device == ranks[p].device
        np.testing.assert_array_equal(_bits(got[p].numpy()),
                                      _bits(jref[p]))
    # the group's factor is the factor of the ranks' rows together
    whole = getattr(tp, fn)(torch.from_numpy(parts.reshape(-1, 5)))
    np.testing.assert_array_equal(_bits(got[0].numpy()),
                                  _bits(whole.numpy()))
