"""Host planning of the PyTorch port against the JAX package: Hilbert
ordering, Siddon geometry, phantoms, window segment tables,
``build_plan``, the sparse-exchange tables and their estimates,
``plan_key`` and the host functions of ``dist/fault.py`` are
byte-identical; ``plan_from_arrays`` round-trips."""
import dataclasses

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


# --------------------------------------------------------------------- #
# the planning leftovers: exchange tables, estimates, plan_key
# --------------------------------------------------------------------- #
_EXCHANGE_PLANS: dict = {}


def _exchange_plans(a, n_data, socket):
    key = (n_data, socket)
    if key not in _EXCHANGE_PLANS:
        _EXCHANGE_PLANS[key] = _plans(
            a, n_data=n_data, socket=socket, tile=4, rows_per_block=16,
            nnz_per_stage=16,
        )
    return _EXCHANGE_PLANS[key]


@pytest.mark.parametrize(
    "n_data,socket,fast",
    [(2, 1, 2), (2, 2, 2), (4, 1, 2), (4, 2, 2), (4, 1, 4), (4, 2, 4)],
)
def test_exchange_tables_identical(small_system, n_data, socket, fast):
    from repro.dist import topology as jtopo
    from repro_torch.dist import topology as ttopo

    _, a, _ = small_system
    tplan, jplan = _exchange_plans(a, n_data, socket)
    n_slow = n_data // fast
    ladder = [("model", fast), ("data", n_slow)]
    for name in ("proj", "back"):
        top, jop = getattr(tplan, name), getattr(jplan, name)
        tsend, trecv, tv = tpart.build_sparse_exchange(top)
        jsend, jrecv, jv = jpart.build_sparse_exchange(jop)
        _same(tsend, jsend)
        _same(trecv, jrecv)
        assert tv == jv
        th = tpart.build_hier_sparse_exchange(top, fast)
        jh = jpart.build_hier_sparse_exchange(jop, fast)
        for t, j in zip(th[:3], jh[:3]):
            _same(t, j)
        assert th[3:] == jh[3:]
        for aware in (None, True, False):
            assert tpart.estimate_hier_sparse(
                top, fast, n_slow, socket_aware=aware
            ) == jpart.estimate_hier_sparse(
                jop, fast, n_slow, socket_aware=aware
            )
        tparams = tpart.exchange_volume_params(
            top, ttopo.Topology.from_sizes(ladder))
        jparams = jpart.exchange_volume_params(
            jop, jtopo.Topology.from_sizes(ladder))
        assert tparams == jparams
        assert tparams["merged_rows"] == fast * th[3]
    with pytest.raises(ValueError, match="does not divide"):
        tpart.build_hier_sparse_exchange(tplan.proj, 3)


@pytest.mark.parametrize("socket", [1, 2])
def test_abstract_shard_estimates_identical(socket):
    """``estimate_hier_sparse`` and ``exchange_volume_params`` on shards
    without arrays (the reference's ``estimate_plan`` leaves), as the
    port's branch for any non-ndarray ``row_map`` reads them."""
    import types

    from repro.dist import topology as jtopo
    from repro_torch.dist import topology as ttopo

    def shard(**extra):
        return types.SimpleNamespace(
            row_map=None, n_rows_pad=65536, est_v=120, est_foot=21000.0,
            est_socket=socket, **extra)

    for fast, n_slow in ((2, 2), (4, 2), (2, 8), (1, 4)):
        for aware in (None, True, False):
            assert tpart.estimate_hier_sparse(
                shard(), fast, n_slow, socket_aware=aware
            ) == jpart.estimate_hier_sparse(
                shard(), fast, n_slow, socket_aware=aware
            )
        ladder = [("model", fast), ("data", n_slow)]
        assert tpart.exchange_volume_params(
            shard(), ttopo.Topology.from_sizes(ladder)
        ) == jpart.exchange_volume_params(
            shard(), jtopo.Topology.from_sizes(ladder)
        )
    bare = types.SimpleNamespace(row_map=None, n_rows_pad=4096)
    assert tpart.estimate_hier_sparse(bare, 2, 2) == \
        jpart.estimate_hier_sparse(bare, 2, 2)


@pytest.mark.parametrize("wire", ["native", "q8"])
def test_hier_sparse_wire_bytes_identical(wire):
    for v2, n_slow, f, cb in ((1024, 4, 16, 2), (8, 1, 1, 4),
                              (40, 3, 7, 1), (0, 2, 16, 2)):
        assert tpart.hier_sparse_wire_bytes(
            v2, n_slow, f, comm_bytes=cb, wire=wire
        ) == jpart.hier_sparse_wire_bytes(
            v2, n_slow, f, comm_bytes=cb, wire=wire
        )
    with pytest.raises(ValueError, match="unknown wire"):
        tpart.hier_sparse_wire_bytes(8, 2, 4, wire="q4")


@dataclasses.dataclass(frozen=True)
class _Knobs:
    precision: str = "mixed"
    fuse: int = 16
    alpha: float = 0.5
    dtype: type = np.float16
    flag: bool | None = None


@pytest.mark.parametrize(
    "geo,cfg,runtime",
    [
        (dict(n=32, n_angles=48), {}, {}),
        (dict(n=32, n_angles=48, n_det=32), {}, {}),
        (dict(n=64, n_angles=96, vox=2.0), dict(n_data=4, socket=2), {}),
        (dict(n=32, n_angles=48), dict(value_dtype=np.float32),
         dict(precision="q8", comm_mode="hier-sparse", fuse=16, tol=1.0,
              seed=3, on=True, off=None, dt=np.int16, dn=np.dtype("int8"))),
        (dict(n=32, n_angles=48), dict(slot_order="first_seen"),
         dict(knobs=_Knobs(), other=_Knobs(alpha=1e-3, flag=True))),
    ],
    ids=["default", "n_det-alias", "p4-socket2", "scalars", "dataclasses"],
)
def test_plan_key_identical(geo, cfg, runtime):
    def key(mod_geo, mod_part, rt):
        return mod_part.plan_key(
            mod_geo.XCTGeometry(**geo), mod_part.PartitionConfig(**cfg), **rt
        )

    tk = key(tgeo, tpart, runtime)
    assert tk == key(jgeo, jpart, runtime)
    assert tk.startswith("xct-") and len(tk) == 20
    # a dataclass of the port's own carries the same fields as the
    # reference's: the same key
    assert key(tgeo, tpart, dict(runtime, part=tpart.PartitionConfig())) \
        == key(jgeo, jpart, dict(runtime, part=jpart.PartitionConfig()))


def test_plan_key_properties():
    g = tgeo.XCTGeometry(32, 48)
    base = tpart.plan_key(g, precision="mixed", comm_mode="hier")
    assert base == tpart.plan_key(g, comm_mode="hier", precision="mixed")
    assert base == tpart.plan_key(tgeo.XCTGeometry(32, 48, n_det=32),
                                  precision="mixed", comm_mode="hier")
    assert base != tpart.plan_key(g, precision="mixed", comm_mode="rs")
    assert tpart.plan_key(g, x=1) != tpart.plan_key(g, x=1.0)
    assert tpart.plan_key(g, tpart.PartitionConfig(socket=2)) != \
        tpart.plan_key(g)
    for bad in ([1, 2], {"a": 1}, object()):
        with pytest.raises(TypeError, match="cannot fingerprint"):
            tpart.plan_key(g, knob=bad)
        with pytest.raises(TypeError, match="cannot fingerprint"):
            jpart.plan_key(jgeo.XCTGeometry(32, 48), knob=bad)


# --------------------------------------------------------------------- #
# dist/fault.py: host-side straggler handling
# --------------------------------------------------------------------- #
def _monitor_record(mod, k_mad, window, times):
    mon = mod.StragglerMonitor(k_mad=k_mad, window=window)
    flags = []
    for worker, secs in times:
        mon.record(worker, secs)
        flags.append(mon.stragglers())
    return mon.stats(), flags


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_monitor_identical(seed):
    from repro.dist import fault as jfault
    from repro_torch.dist import fault as tfault

    rng = np.random.default_rng(seed)
    workers = [f"w{i}" for i in range(int(rng.integers(2, 9)))]
    times = []
    for step in range(12):
        for w in workers:
            t = float(rng.normal(1.0, 0.05))
            if w == workers[-1] and step > 5:
                t *= float(rng.choice([1.0, 3.0]))
            times.append((w, t))
    for k_mad, window in ((3.0, 4), (1.5, 2), (5, 1)):
        assert _monitor_record(tfault, k_mad, window, times) == \
            _monitor_record(jfault, k_mad, window, times)
    constant = [(w, 1.0) for w in workers * 3]
    assert _monitor_record(tfault, 3.0, 4, constant) == \
        _monitor_record(jfault, 3.0, 4, constant)


def test_rebalance_and_checkpoint_period_identical():
    from repro.dist import fault as jfault
    from repro_torch.dist import fault as tfault

    cases = [
        ({}, [], 0.5),
        ({0: (0, 10), 1: (10, 20), 2: (20, 30)}, [1], 0.5),
        ({0: (0, 10), 1: (10, 20), 2: (20, 30)}, [1], 1.0),
        ({"a": (4, 9), "b": (9, 9), "c": (9, 17)}, ["c", "b"], 0.3),
        ({0: (0, 1), 1: (1, 2)}, [0, 1], 0.5),
        ({0: (0, 7), 1: (7, 8), 2: (8, 40), 3: (40, 41)}, [2, 9], 0.75),
    ]
    for ranges, bad, shed in cases:
        assert tfault.rebalance(ranges, bad, shed) == \
            jfault.rebalance(ranges, bad, shed)
    for cost, nodes, mtbf in ((30.0, 1, 5.0e6), (2.5, 512, 5.0e6),
                              (60, 0, 1e5), (1e-3, 4096, 8.64e4)):
        assert tfault.suggest_checkpoint_period(cost, nodes, mtbf) == \
            jfault.suggest_checkpoint_period(cost, nodes, mtbf)
    assert tfault.__all__ == jfault.__all__
