"""The yardstick and the plain reference, at sizes checked by hand."""
import numpy as np
import torch

from xctbench import roofline
from xctbench.reference.cgnr import cgnr, operator
from xctbench.reference.geometry import XCTGeometry, build_system_matrix
from xctbench.reference.phantom import phantom_slices


def test_spmm_bytes_from_hand_counted_nonzeros():
    # two angles, 0 and 90 degrees: each of the n rays of an angle runs
    # along a row or a column of the n x n image and crosses its n voxels
    n, fuse = 3, 16
    a = build_system_matrix(XCTGeometry(n=n, n_angles=2))
    nnz = 2 * n * n
    assert a.nnz == nnz
    rays, vox = 2 * n, n * n
    assert roofline.spmm_bytes(a.nnz, vox, rays, fuse, "mixed") == \
        nnz * (2 + 2) + (vox + rays) * fuse * 2
    assert roofline.spmm_bytes(a.nnz, vox, rays, fuse, "single") == \
        nnz * (4 + 2) + (vox + rays) * fuse * 4
    assert roofline.spmm_bytes(a.nnz, vox, rays, fuse, "q8") == \
        nnz * (1 + 2) + (vox + rays) * fuse * 2


def test_spmm_least_time():
    kind = "NVIDIA H100 80GB HBM3"
    s, by = roofline.spmm_min_s(120_322_504, 262_144, 196_608, 16, "mixed",
                                kind)
    assert by == "bytes"
    assert abs(s - (120_322_504 * 4 + 458_752 * 32) / 3.35e12) < 1e-15
    assert roofline.spmm_min_s(1, 1, 1, 16, "mixed", "another card") is None


def test_cgnr_matches_dense_least_squares():
    a = build_system_matrix(XCTGeometry(n=6, n_angles=10))
    rng = np.random.default_rng(0)
    y = rng.normal(size=(a.shape[0], 3))
    fwd, back = operator(a, "cpu")
    x, res = cgnr(fwd, back, torch.from_numpy(y), 400)
    want = np.linalg.lstsq(a.toarray().astype(np.float64), y, rcond=None)[0]
    assert np.allclose(x.numpy(), want, rtol=1e-7, atol=1e-7 * np.abs(
        want).max())
    resid = np.linalg.norm(y - a.toarray() @ want, axis=0)
    assert np.allclose(res[-1].numpy(), resid, rtol=1e-7)
    assert (np.diff(res.numpy(), axis=0) <= 1e-12).all()  # never rises


def test_operator_transpose():
    a = build_system_matrix(XCTGeometry(n=8, n_angles=6))
    fwd, back = operator(a, "cpu")
    dense = torch.from_numpy(a.toarray().astype(np.float64))
    v = torch.randn(a.shape[0], 2, dtype=torch.float64)
    assert torch.allclose(back @ v, dense.T @ v)
    u = torch.randn(a.shape[1], 2, dtype=torch.float64)
    assert torch.allclose(fwd @ u, dense @ u)


def test_phantom_is_seeded():
    def make(seed):
        g = torch.Generator().manual_seed(seed)
        return phantom_slices(16, 64, torch.tensor([10, 11, 40]), g)

    a, b = make(2**31 + 5), make(2**31 + 5)
    assert a.shape == (256, 3) and torch.equal(a, b)
    assert not torch.equal(a, make(6))
    assert (a >= 0).all() and a.max() > 0
