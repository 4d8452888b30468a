"""CGNR and the minibatch pipeline of the PyTorch port, against the JAX
package with dense-A closures and against least-squares ground truth."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipeline import pipelined_apply as jax_pipelined
from repro.core.solver import cgnr as jax_cgnr
from repro_torch.core.pipeline import pipelined_apply, side_streams
from repro_torch.core.solver import cgnr


def _torch_ops(a, dtype=torch.float32):
    at = torch.from_numpy(a).to(dtype)

    def fwd(x):
        return at @ x.to(dtype)

    def bwd(y):
        return at.T @ y.to(dtype)

    def dot(u, v):
        return torch.sum(u.float() * v.float(), dim=0)

    return fwd, bwd, dot


def _jax_ops(a):
    aj = jnp.asarray(a)

    def fwd(x):
        return aj @ x.astype(jnp.float32)

    def bwd(y):
        return aj.T @ y.astype(jnp.float32)

    def dot(u, v):
        return jnp.sum(u.astype(jnp.float32) * v.astype(jnp.float32), axis=0)

    return fwd, bwd, dot


@pytest.mark.parametrize(
    "storage,tol",
    [(None, 1e-4), ("f16", 5e-3)],
    ids=["f32", "f16-storage"],
)
def test_cgnr_matches_jax(storage, tol):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(60, 24)).astype(np.float32)
    y = (a @ rng.normal(size=(24, 3))).astype(np.float32)
    tst = {None: None, "f16": torch.float16}[storage]
    jst = {None: None, "f16": jnp.float16}[storage]
    x, res = cgnr(*_torch_ops(a)[:2], torch.from_numpy(y),
                  torch.zeros((24, 3)), 12, _torch_ops(a)[2],
                  storage_dtype=tst)
    fwd, bwd, dot = _jax_ops(a)
    jx, jres = jax_cgnr(fwd, bwd, jnp.asarray(y), jnp.zeros((24, 3)), 12,
                        dot, storage_dtype=jst)
    assert x.dtype == (tst or torch.float32) and res.shape == (12, 3)
    scale = np.abs(np.asarray(jx, np.float32)).max()
    np.testing.assert_allclose(x.float().numpy(), np.asarray(jx, np.float32),
                               rtol=tol, atol=tol * scale)
    np.testing.assert_allclose(res.numpy(), np.asarray(jres),
                               rtol=tol, atol=tol * float(jres[0, 0]))


def test_cgnr_solves_least_squares():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(60, 24)).astype(np.float32)
    x_true = rng.normal(size=(24, 3)).astype(np.float32)
    fwd, bwd, dot = _torch_ops(a)
    x, res = cgnr(fwd, bwd, torch.from_numpy(a @ x_true),
                  torch.zeros((24, 3)), 40, dot)
    np.testing.assert_allclose(x.numpy(), x_true, atol=2e-3)
    assert (np.diff(res[:, 0].numpy()) < 1e-3).all()


def test_cgnr_per_slice_independence():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(40, 16)).astype(np.float32)
    y = (a @ rng.normal(size=(16, 2))).astype(np.float32)
    fwd, bwd, dot = _torch_ops(a)
    x1, _ = cgnr(fwd, bwd, torch.from_numpy(y), torch.zeros((16, 2)), 10,
                 dot)
    y2 = y.copy()
    y2[:, 1] *= 100.0
    x2, _ = cgnr(fwd, bwd, torch.from_numpy(y2), torch.zeros((16, 2)), 10,
                 dot)
    np.testing.assert_allclose(x1[:, 0].numpy(), x2[:, 0].numpy(),
                               rtol=1e-5)


def test_cgnr_double_is_true_f64():
    """The port's double policy computes in f64; held against the JAX
    package (which computes its ``float64`` in f32 without x64) at f32
    tolerance."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(50, 20)).astype(np.float32)
    y = (a @ rng.normal(size=(20, 2))).astype(np.float32)
    fwd, bwd, dot = _torch_ops(a, torch.float64)
    x, _ = cgnr(fwd, bwd, torch.from_numpy(y), torch.zeros((20, 2)), 15,
                dot, compute_dtype=torch.float64)
    assert x.dtype == torch.float64
    jx, _ = jax_cgnr(*_jax_ops(a)[:2], jnp.asarray(y), jnp.zeros((20, 2)),
                     15, _jax_ops(a)[2], compute_dtype=jnp.float64)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-4)


def test_cgnr_zero_iterations():
    a = np.eye(4, dtype=np.float32)
    fwd, bwd, dot = _torch_ops(a)
    x, res = cgnr(fwd, bwd, torch.ones((4, 2)), torch.zeros((4, 2)), 0, dot)
    assert res.shape == (0, 2) and torch.equal(x, torch.zeros((4, 2)))


@pytest.mark.parametrize("overlap", [False, True])
def test_pipelined_apply_matches_jax_slice_order(overlap):
    rng = np.random.default_rng(2)
    m = rng.normal(size=(7, 5)).astype(np.float32)
    x = rng.normal(size=(5, 12)).astype(np.float32)
    w = np.arange(1, 4, dtype=np.float32)  # reduce distinguishes chunks

    def kernel(xc):
        return torch.from_numpy(m) @ xc

    def reduce(band):
        return band[:3] * torch.from_numpy(w)[:, None] + band[3:6]

    out = pipelined_apply(kernel, reduce, torch.from_numpy(x), 4,
                          overlap=overlap)
    ref = jax_pipelined(
        lambda xc: jnp.asarray(m) @ xc,
        lambda band: band[:3] * jnp.asarray(w)[:, None] + band[3:6],
        jnp.asarray(x), 4, overlap=overlap,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_pipelined_overlap_equals_sync():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))
    calls = []

    def kernel(xc):
        calls.append("k")
        return xc * 2

    def reduce(band):
        calls.append("r")
        return band + 1

    sync = pipelined_apply(kernel, reduce, x, 2, overlap=False)
    assert calls == ["k", "r"] * 4
    calls.clear()
    over = pipelined_apply(kernel, reduce, x, 2, overlap=True)
    assert calls == ["k", "k", "r", "k", "r", "k", "r", "r"]
    assert torch.equal(sync, over)
    with pytest.raises(ValueError, match="fuse"):
        pipelined_apply(kernel, reduce, x, 3)


def test_side_streams_only_for_cuda_devices():
    """The CPU gets no side stream, so ``overlap=True`` there keeps the
    issue order above on the current stream."""
    assert side_streams(["cpu", torch.device("cpu")]) == {}
    assert side_streams([]) == {}


@pytest.mark.parametrize("iters", [0, 6])
def test_cgnr_on_sharded_vectors_matches_one_tensor(iters):
    """``cgnr`` on row blocks (``core.sharded.Sharded``, dots summed per
    block in f64 and then across the blocks) against the one-tensor
    solve: the same arithmetic row by row, the dots in another order."""
    from repro_torch.core.sharded import Sharded

    rng = np.random.default_rng(3)
    a = rng.standard_normal((40, 24)).astype(np.float32)
    y = torch.from_numpy(rng.standard_normal((40, 3)).astype(np.float32))
    at = torch.from_numpy(a)
    rows_y, rows_x = (0, 10, 40), (0, 16, 24)

    def blocks(t, cuts):
        return Sharded([t[i:j] for i, j in zip(cuts, cuts[1:])])

    def fwd(x):
        return blocks(at @ x.cpu(), rows_y)

    def bwd(r):
        return blocks(at.T @ r.cpu(), rows_x)

    def dot(u, v):
        total = sum(torch.sum(p * q, 0, dtype=torch.float64)
                    for p, q in zip(u.parts, v.parts))
        return Sharded([total.to(torch.float32)] * len(u.parts))

    def dot_one(u, v):
        return torch.sum(u * v, 0, dtype=torch.float64).to(torch.float32)

    x, res = cgnr(fwd, bwd, blocks(y, rows_y), blocks(torch.zeros(24, 3),
                                                      rows_x), iters, dot)
    x1, res1 = cgnr(lambda v: at @ v, lambda v: at.T @ v, y,
                    torch.zeros(24, 3), iters, dot_one)
    torch.testing.assert_close(x.cpu(), x1, rtol=1e-5, atol=1e-6)
    assert res.parts[0].shape == res1.shape == (iters, 3)
    torch.testing.assert_close(res.parts[1], res1, rtol=1e-5, atol=1e-6)
