"""Blocked-ELL SpMM of the PyTorch port against the JAX package.

On the CPU the port's ``spmm_block_ell`` runs its plain version, held
here against the JAX Pallas kernel (interpret mode, as the JAX tests run
it) with the reference tolerances.  The CUDA kernel itself is held
against the plain version in ``test_torch_kernel_gpu.py``."""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.xct_spmm import spmm_block_ell as jax_spmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import xct_spmm as txs

SWEEP = [
    # (B, S, R, K, BUF, C, F): tests/test_kernel_spmm.py's sweep, with
    # non-divisible B/S and non-power-of-two BUF
    (1, 1, 8, 8, 16, 64, 1),
    (2, 2, 16, 8, 32, 128, 4),
    (3, 1, 32, 16, 64, 256, 8),
    (2, 3, 8, 32, 40, 96, 16),
    (5, 2, 16, 16, 24, 64, 2),
]
JNP = {"f32": jnp.float32, "f16": jnp.float16, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}


def _seed(*parts) -> int:
    return zlib.crc32(repr(parts).encode())


def _random_ell(rng, b, s, r, k, buf, c, f):
    inds = rng.integers(0, buf, size=(b, s, r, k)).astype(np.int16)
    vals = (rng.random((b, s, r, k)) * (rng.random((b, s, r, k)) > 0.3)
            ).astype(np.float32)
    winmap = rng.integers(0, c, size=(b, s, buf)).astype(np.int32)
    x = rng.normal(size=(c, f)).astype(np.float32)
    return inds, vals, winmap, x


def _tol(storage, compute):
    """The JAX kernel tests' tolerances (test_kernel_spmm.py:74, :132)."""
    if storage == "f32" and compute == "f32":
        return 1e-5
    return 2e-2 if compute == "f32" else 5e-2


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("storage", ["f32", "f16", "bf16"])
@pytest.mark.parametrize("compute", ["f32", "f16"])
def test_plain_matches_jax_kernel(shape, storage, compute):
    b, s, r, k, buf, c, f = shape
    rng = np.random.default_rng(_seed(shape, storage, compute))
    inds, vals, winmap, x = _random_ell(rng, b, s, r, k, buf, c, f)
    out = txs.spmm_block_ell(
        torch.from_numpy(inds), torch.from_numpy(vals).to(TORCH[storage]),
        torch.from_numpy(winmap), torch.from_numpy(x).to(TORCH[storage]),
        compute_dtype=TORCH[compute],
    )
    assert out.dtype == torch.float32 and out.shape == (b, r, f)
    ref = jax_spmm(
        jnp.asarray(inds), jnp.asarray(vals).astype(JNP[storage]),
        jnp.asarray(winmap), jnp.asarray(x).astype(JNP[storage]),
        compute_dtype=JNP[compute],
    )
    tol = _tol(storage, compute)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol
    )


@pytest.mark.parametrize("shape", SWEEP)
def test_spmm_ref_matches_jax_ref(shape):
    b, s, r, k, buf, c, f = shape
    rng = np.random.default_rng(_seed("ref", shape))
    inds, vals, winmap, x = _random_ell(rng, b, s, r, k, buf, c, f)
    out = tref.spmm_ref(
        torch.from_numpy(inds), torch.from_numpy(vals),
        torch.from_numpy(winmap), torch.from_numpy(x),
    )
    ref = jref.spmm_ref(
        jnp.asarray(inds), jnp.asarray(vals), jnp.asarray(winmap),
        jnp.asarray(x),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    # the oracle and the kernel's plain version agree too
    plain = txs.spmm_block_ell_plain(
        torch.from_numpy(inds), torch.from_numpy(vals),
        torch.from_numpy(winmap), torch.from_numpy(x),
    )
    np.testing.assert_allclose(plain.numpy().reshape(b * r, f),
                               out.numpy(), rtol=1e-5, atol=1e-5)


def test_coo_apply_matches_jax(small_system):
    _, a, _ = small_system
    coo = a.tocoo()
    x = np.random.default_rng(3).normal(size=(a.shape[1], 3)).astype(
        np.float32
    )
    out = tref.coo_apply(
        torch.from_numpy(coo.row), torch.from_numpy(coo.col),
        torch.from_numpy(coo.data), torch.from_numpy(x), a.shape[0],
    )
    ref = jref.coo_apply(
        jnp.asarray(coo.row), jnp.asarray(coo.col), jnp.asarray(coo.data),
        jnp.asarray(x), a.shape[0],
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), a @ x, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", ["proj", "back"])
@pytest.mark.parametrize("pair", [("f16", "f32"), ("f32", "f32")])
def test_apply_operator_matches_jax_on_plan_shards(small_system, name, pair):
    _, _, plan = small_system
    op = getattr(plan, name)
    storage, compute = pair
    f = 4
    x = np.random.default_rng(_seed(name, pair)).normal(
        size=(op.n_cols_pad, f)
    ).astype(np.float32)
    out = tops.apply_operator(
        torch.from_numpy(op.inds[0]), torch.from_numpy(op.vals[0]),
        torch.from_numpy(op.winmap[0]), torch.from_numpy(x),
        storage_dtype=TORCH[storage], compute_dtype=TORCH[compute],
        winsegs=torch.from_numpy(op.winsegs[0]),
        segoff=torch.from_numpy(op.segoff[0]),
    )
    ref = jops.apply_operator(
        jnp.asarray(op.inds[0]), jnp.asarray(op.vals[0]),
        jnp.asarray(op.winmap[0]), jnp.asarray(x),
        storage_dtype=JNP[storage], compute_dtype=JNP[compute],
        winsegs=jnp.asarray(op.winsegs[0]), segoff=jnp.asarray(op.segoff[0]),
    )
    tol = _tol(storage, compute)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)
    # tables built from winmap inside the call give the same result
    again = tops.apply_operator(
        torch.from_numpy(op.inds[0]), torch.from_numpy(op.vals[0]),
        torch.from_numpy(op.winmap[0]), torch.from_numpy(x),
        storage_dtype=TORCH[storage], compute_dtype=TORCH[compute],
    )
    assert torch.equal(again, out)
    ref_path = tops.apply_operator(
        torch.from_numpy(op.inds[0]), torch.from_numpy(op.vals[0]),
        torch.from_numpy(op.winmap[0]), torch.from_numpy(x),
        storage_dtype=TORCH[storage], compute_dtype=TORCH[compute],
        use_ref=True,
    )
    np.testing.assert_allclose(ref_path.numpy(), out.numpy(),
                               rtol=tol, atol=tol)


def test_unported_modes_raise_without_fallback():
    rng = np.random.default_rng(0)
    inds, vals, winmap, x = (
        torch.from_numpy(a) for a in _random_ell(rng, *SWEEP[1])
    )
    for kw, exc in [
        (dict(staging="gather"), NotImplementedError),
        (dict(dma="per_row"), NotImplementedError),
        (dict(scales=torch.zeros((2, 2), dtype=torch.int32)),
         NotImplementedError),
        (dict(staging="bogus"), ValueError),
        (dict(dma="bogus"), ValueError),
        (dict(winsegs=torch.zeros((2, 2, 8, 3), dtype=torch.int32)),
         NotImplementedError),
    ]:
        with pytest.raises(exc):
            tops.apply_operator(inds, vals, winmap, x, **kw)


def test_cpu_dispatch_runs_plain_and_counts_no_launch():
    rng = np.random.default_rng(1)
    inds, vals, winmap, x = (
        torch.from_numpy(a) for a in _random_ell(rng, *SWEEP[3])
    )
    before = txs.spmm_block_ell.launches
    out = txs.spmm_block_ell(inds, vals, winmap, x)
    assert txs.spmm_block_ell.launches == before
    assert torch.equal(out, txs.spmm_block_ell_plain(inds, vals, winmap, x))


def test_shared_memory_footprint():
    # the slice's proj shard: R=K=32, BUF=776, F=16
    assert txs.smem_bytes(32, 32, 776, 16, 2) == 776 * 16 * 2 + 2048 + 2048
    assert txs.smem_bytes(32, 32, 776, 16, 8) == 776 * 16 * 8 + 8192 + 2048
    assert txs.smem_bytes(32, 32, 776, 16, 8) < txs.SMEM_LIMIT
    # odd sizes are padded to 16-byte boundaries
    assert txs.smem_bytes(8, 8, 16, 1, 4) == 64 + 256 + 128
    assert txs.smem_bytes(1, 1, 3, 1, 2) == 16 * 3
