"""Precision policies of the PyTorch port against the JAX package:
``adaptive_scale``, ``adaptive_scale_cols`` and ``qcast`` give the same
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


def test_policies_mirror_reference():
    for name in ("double", "single", "half", "mixed", "bf16", "mixed_bf16"):
        t, j = tp.get_policy(name), jp.get_policy(name)
        assert t.name == j.name and t.adaptive == j.adaptive
        assert t.comm_bytes == j.comm_bytes
        assert t.vals_bytes == j.vals_bytes
        assert str(t.storage).split(".")[-1] == np.dtype(j.storage).name
        assert str(t.compute).split(".")[-1] == np.dtype(j.compute).name
    assert tp.ALIASES == jp.ALIASES
    assert tp.get_policy("f32") is tp.get_policy("single")
    assert tp.get_policy("f64") is tp.get_policy("double")
    assert tp.get_policy("f16") is tp.get_policy("half")
    # true f64 in the port (the reference computes f32 without x64)
    assert tp.get_policy("double").compute == torch.float64


def test_unported_and_unknown_policies_raise():
    for name in ("q8", "int8", "fp8"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tp.get_policy(name)
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
