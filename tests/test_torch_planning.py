"""Host planning of the PyTorch port against the JAX package: Hilbert
ordering, Siddon geometry, phantoms, window segment tables and
``build_plan`` are byte-identical; ``plan_from_arrays`` round-trips."""
import numpy as np
import pytest
import scipy.sparse as sp

from repro.core import geometry as jgeo
from repro.core import hilbert as jhil
from repro.core import partition as jpart
from repro.data import phantom as jph
from repro.kernels import ops as jops
from repro_torch.core import geometry as tgeo
from repro_torch.core import hilbert as thil
from repro_torch.core import partition as tpart
from repro_torch.data import phantom as tph
from repro_torch.kernels import ops as tops


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize(
    "w,h,tile", [(1, 1, 1), (5, 3, 2), (32, 32, 4), (48, 32, 8), (17, 29, 3)]
)
def test_hilbert_identical(w, h, tile):
    _same(thil.gilbert2d(w, h), jhil.gilbert2d(w, h))
    _same(thil.hilbert_order(w, h), jhil.hilbert_order(w, h))
    _same(thil.hilbert_argsort(w, h), jhil.hilbert_argsort(w, h))
    tp, ts = thil.tile_hilbert_order(w, h, tile)
    jp, js = jhil.tile_hilbert_order(w, h, tile)
    _same(tp, jp)
    assert ts == js


@pytest.mark.parametrize(
    "n,angles,n_det", [(32, 48, None), (17, 10, 20), (24, 7, None)]
)
def test_system_matrix_identical(n, angles, n_det):
    ta = tgeo.build_system_matrix(tgeo.XCTGeometry(n, angles, n_det))
    ja = jgeo.build_system_matrix(jgeo.XCTGeometry(n, angles, n_det))
    assert ta.shape == ja.shape
    for field in ("indptr", "indices", "data"):
        _same(getattr(ta, field), getattr(ja, field))
    assert tgeo.estimate_nnz_per_ray(n) == jgeo.estimate_nnz_per_ray(n)


def test_phantom_and_measurements_identical(small_system):
    _, a, _ = small_system
    _same(tph.phantom_slices(32, 6, seed=3),
          jph.phantom_slices(32, 6, seed=3))
    _same(tph.phantom_slices(32, 6, seed=3, start=2, stop=5),
          jph.phantom_slices(32, 6, seed=3, start=2, stop=5))
    x = jph.phantom_slices(32, 4, seed=1)
    _same(tph.simulate_measurements(a, x, noise=0.01, seed=5, chunk=3),
          jph.simulate_measurements(a, x, noise=0.01, seed=5, chunk=3))


def _winmaps(rng):
    yield rng.integers(0, 300, size=(3, 2, 40)).astype(np.int32)
    runs = np.sort(rng.choice(500, size=(4, 3, 64)), axis=-1).astype(np.int32)
    yield runs
    yield np.broadcast_to(np.arange(56, dtype=np.int32), (2, 2, 56)).copy()
    yield np.arange(24, dtype=np.int32)[None, :] + np.zeros((5, 1), np.int32)


@pytest.mark.parametrize("case", range(4))
def test_segment_tables_identical(case):
    rng = np.random.default_rng(case)
    wm = list(_winmaps(rng))[case]
    buf = wm.shape[-1]
    tseg = tops.winmap_segments(wm)
    jseg = jops.winmap_segments(wm)
    _same(tseg, jseg)
    for t, j in zip(tops.sort_segments_by_class(tseg, buf),
                    jops.sort_segments_by_class(jseg, buf)):
        _same(t, j)
    assert tops.dma_issue_count(tseg) == jops.dma_issue_count(jseg)
    assert tops.segment_histogram(tseg) == jops.segment_histogram(jseg)


def test_segment_mode_tuples_match_reference():
    from repro.kernels.traffic import DMA_MODES, STAGINGS
    from repro.kernels.xct_spmm import _dma_classes as jcls
    from repro_torch.kernels.xct_spmm import _dma_classes as tcls

    assert tops.STAGINGS == STAGINGS and tops.DMA_MODES == DMA_MODES
    for buf in (0, 1, 7, 8, 40, 776, 1024):
        assert tcls(buf) == jcls(buf)


def _plans(a, **kw):
    geo = dict(n=32, n_angles=48)
    tplan = tpart.build_plan(
        tgeo.XCTGeometry(**geo), tpart.PartitionConfig(**kw), a=a
    )
    jplan = jpart.build_plan(
        jgeo.XCTGeometry(**geo), jpart.PartitionConfig(**kw), a=a
    )
    return tplan, jplan


@pytest.mark.parametrize(
    "kw",
    [
        dict(tile=4, rows_per_block=16, nnz_per_stage=16),
        dict(tile=4, rows_per_block=16, nnz_per_stage=16,
             slot_order="first_seen"),
        dict(tile=8, rows_per_block=32, nnz_per_stage=32),
        dict(n_data=4, socket=2, tile=4, rows_per_block=16,
             nnz_per_stage=8),
    ],
    ids=["runs", "first_seen", "r32k32", "p4-socket2"],
)
def test_build_plan_identical(small_system, kw):
    _, a, _ = small_system
    tplan, jplan = _plans(a, **kw)
    td = tpart.plan_to_arrays(tplan)
    jd = tpart.plan_to_arrays(jplan)
    assert sorted(td) == sorted(jd)
    for k in td:
        _same(td[k], jd[k])
    for name in ("proj", "back"):
        top, jop = getattr(tplan, name), getattr(jplan, name)
        assert top.flat_rows == jop.flat_rows
        assert top.padded_nnz == jop.padded_nnz
        assert top.hbm_bytes() == jop.hbm_bytes()


def test_chunk_layout_helpers_identical():
    for p, g in [(1, 1), (4, 2), (8, 4), (6, 3)]:
        _same(tpart.socket_chunk_layout(p, g),
              jpart.socket_chunk_layout(p, g))
        sigma = jpart.socket_chunk_layout(p, g)
        _same(tpart._block_positions(sigma, 8),
              jpart._block_positions(sigma, 8))
        assert tpart.default_socket(p, g) == jpart.default_socket(p, g)
    with pytest.raises(ValueError):
        tpart.socket_chunk_layout(6, 4)


def test_plan_from_arrays_round_trips(small_system):
    geo, _, jplan = small_system
    d = tpart.plan_to_arrays(jplan)
    cfg = tpart.PartitionConfig(
        tile=4, rows_per_block=16, nnz_per_stage=16
    )
    tplan = tpart.plan_from_arrays(
        d, tgeo.XCTGeometry(geo.n, geo.n_angles), cfg
    )
    assert isinstance(tplan, tpart.Plan)
    assert tplan.row_pos is None and tplan.col_pos is None
    back = tpart.plan_to_arrays(tplan)
    assert sorted(back) == sorted(d)
    for k in d:
        _same(back[k], d[k])
    assert tplan.proj.n_rows_pad == jplan.proj.n_rows_pad
    assert len(tplan.back.foot_rows) == 1
    with pytest.raises(ValueError, match="n_data"):
        tpart.plan_from_arrays(
            d, tplan.geo, tpart.PartitionConfig(n_data=2)
        )


def test_port_plan_applies_like_scipy(small_system):
    """The shards of a port plan, applied densely, reproduce A."""
    geo, a, _ = small_system
    tplan, _ = _plans(a, tile=4, rows_per_block=16, nnz_per_stage=16)
    op = tplan.proj
    _, b, s, r, k = op.inds.shape
    cols = np.take_along_axis(
        op.winmap[0][:, :, None, :].repeat(r, 2),
        op.inds[0].astype(np.int64), axis=3,
    )
    rows = np.broadcast_to(op.row_map[0][:, None, :, None], cols.shape)
    m = sp.coo_matrix(
        (op.vals[0].ravel(), (rows.ravel(), cols.ravel())),
        shape=(op.n_rows_pad + 1, op.n_cols_pad),
    ).tocsr()[: op.n_rows_pad]
    dense = np.zeros((op.n_rows_pad, op.n_cols_pad), np.float32)
    dense[: geo.n_rays, : geo.n_vox] = a[tplan.row_perm][:, tplan.col_perm].toarray()
    np.testing.assert_allclose(m.toarray(), dense, rtol=1e-6, atol=1e-6)
