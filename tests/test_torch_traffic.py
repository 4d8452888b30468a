"""The port's traffic model, ``estimate_plan`` and slab sizing against the
JAX package, on the CPU: ``spmm_traffic`` key for key and value for
value over a grid, the segment estimates on real and abstract shards,
``estimate_plan``'s shapes and ``est_*`` attributes, and ``suggest_slab``
as the reference's model plus the port's stated extras (its
``smem_bytes`` is the port's own: the dynamic shared memory an SM gives
row 1's launch, where the reference has VMEM)."""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.configs.xct_datasets import DATASETS
from repro.core import partition as jpart
from repro.core.geometry import XCTGeometry as JGeo
from repro.core.recon import ReconConfig as JConfig
from repro.dist import Topology as JTopology
from repro.kernels import traffic as jtraffic
from repro.stream import suggest_slab as jax_suggest_slab
from repro_torch.core import geometry as tgeo
from repro_torch.core import partition as tpart
from repro_torch.core.precision import get_policy
from repro_torch.core.recon import ReconConfig
from repro_torch.dist import Topology
from repro_torch.kernels import traffic as ttraffic
from repro_torch.kernels import xct_spmm as txs
from repro_torch.stream import SlabPlan, suggest_slab
from repro_torch.stream.scheduler import port_extras

SHAPES = [(8, 2, 64, 64, 768), (3, 5, 16, 16, 40), (1, 1, 32, 32, 8)]


@pytest.mark.parametrize("slot_order", ["runs", "first_seen"])
@pytest.mark.parametrize("dma", ttraffic.DMA_MODES)
@pytest.mark.parametrize("staging", ["fused", "gather"])
def test_spmm_traffic_matches_reference(staging, dma, slot_order):
    for shape, vb, f, seg in itertools.product(
        SHAPES, (None, 1, 2, 4), (1, 16), (None, 7.5)
    ):
        kw = dict(storage_bytes=2 if vb != 4 else 4, vals_bytes=vb,
                  staging=staging, dma=dma, segments_per_stage=seg,
                  slot_order=slot_order)
        got = ttraffic.spmm_traffic(*shape, f, **kw)
        want = jtraffic.spmm_traffic(*shape, f, **kw)
        assert got == want, (shape, vb, f, seg)
    assert ttraffic.DMA_MODES == jtraffic.DMA_MODES
    assert ttraffic.STAGINGS == jtraffic.STAGINGS
    for fn in (ttraffic.spmm_traffic, jtraffic.spmm_traffic):
        with pytest.raises(ValueError, match="unknown"):
            fn(*SHAPES[0], 16, staging="bogus")
        with pytest.raises(ValueError, match="unknown"):
            fn(*SHAPES[0], 16, dma="bogus")


def test_traffic_helpers_and_the_unpriced_copy_overhead():
    for buf in (1, 8, 72, 424, 776, 1024):
        for order in ("runs", "first_seen"):
            assert ttraffic.est_segments_per_stage(buf, order) == \
                jtraffic.est_segments_per_stage(buf, order)
        assert ttraffic.staged_window_bytes(3, buf, 16, 2) == \
            jtraffic.staged_window_bytes(3, buf, 16, 2)
    with pytest.raises(ValueError, match="slot_order"):
        ttraffic.est_segments_per_stage(8, "bogus")
    # the reference's 1e-7 s was priced for another copy engine: the
    # port's figure is the H100's, measured by tune.calibrate, and an
    # overhead of None (a device not measured) still raises
    assert ttraffic.PER_COPY_OVERHEAD_S == 3.22e-11
    with pytest.raises(ValueError, match="not measured"):
        ttraffic.dma_issue_seconds(10, 100.0, 1e9, None)
    assert ttraffic.dma_issue_seconds(10, 100.0, 1e9, 2e-7) == \
        jtraffic.dma_issue_seconds(10, 100.0, 1e9, 2e-7)


@pytest.fixture(scope="module")
def port_plan(small_system):
    geo, _, plan = small_system
    return tpart.plan_from_arrays(
        tpart.plan_to_arrays(plan),
        tgeo.XCTGeometry(geo.n, geo.n_angles),
        tpart.PartitionConfig(tile=4, rows_per_block=16, nnz_per_stage=16),
    )


def _estimates(n, p, socket=1):
    kw = dict(n_data=p, socket=socket)
    return (tpart.estimate_plan(tgeo.XCTGeometry(n, n), tpart.PartitionConfig(
        **kw)), jpart.estimate_plan(JGeo(n, n), jpart.PartitionConfig(**kw)))


def test_segments_per_stage_on_real_and_abstract_shards(small_system,
                                                        port_plan):
    _, _, plan = small_system
    for name in ("proj", "back"):
        got = ttraffic.op_segments_per_stage(getattr(port_plan, name))
        assert got == jtraffic.op_segments_per_stage(getattr(plan, name))
        assert 0 < got <= getattr(plan, name).winsegs.shape[-2]
    est, jest = _estimates(64, 4)
    for name in ("proj", "back"):
        op = getattr(est, name)
        assert isinstance(op.winsegs, tpart.ShapeSpec)
        assert ttraffic.op_segments_per_stage(op) == \
            jtraffic.op_segments_per_stage(getattr(jest, name)) == \
            float(op.winsegs.shape[-2])
    bare = dataclasses.replace(port_plan.proj, winsegs=None)
    assert ttraffic.op_segments_per_stage(bare) is None


@pytest.mark.parametrize(
    "n,p,socket",
    [(n, p, 1) for n in (64, 256) for p in (1, 4, 16)]
    + [(64, 4, 2), (256, 16, 4)],
)
def test_estimate_plan_matches_reference(n, p, socket):
    est, jest = _estimates(n, p, socket)
    assert est.row_perm is None and est.col_perm is None
    for name in ("proj", "back"):
        op, jop = getattr(est, name), getattr(jest, name)
        for leaf in ("inds", "vals", "winmap", "winsegs", "segoff",
                     "row_map"):
            got, want = getattr(op, leaf), getattr(jop, leaf)
            assert isinstance(got, tpart.ShapeSpec)
            assert (got.shape, got.dtype, got.ndim, got.size) == (
                tuple(want.shape), np.dtype(want.dtype), want.ndim,
                want.size)
        for attr in ("n_rows_pad", "n_cols_pad", "rows_per_dev",
                     "cols_per_dev", "nnz", "est_v", "est_foot",
                     "est_socket", "padded_nnz", "flat_rows"):
            assert getattr(op, attr) == getattr(jop, attr), attr
        assert op.foot_rows is None
        for vb in (None, 1, 2, 4):
            assert op.hbm_bytes(vb) == jop.hbm_bytes(vb)
        for fast, slow in ((1, p), (2, max(1, p // 2))):
            assert tpart.estimate_hier_sparse(op, fast, slow) == \
                jpart.estimate_hier_sparse(jop, fast, slow)


def test_shape_spec_is_frozen_and_holds_no_data():
    spec = tpart.ShapeSpec([2, 3], np.int16)
    assert spec.shape == (2, 3) and spec.dtype == np.dtype(np.int16)
    assert spec.ndim == 2 and spec.size == 6
    with pytest.raises(dataclasses.FrozenInstanceError):
        spec.shape = (1,)
    assert {f.name for f in dataclasses.fields(spec)} == {"shape", "dtype"}


def _topos():
    return (Topology.from_sizes([("model", 1)]),
            JTopology.from_sizes([("model", 1)]))


def _check_against_reference(got, plan, jplan, precision, cfg, jcfg, topo,
                             jtopo, budget, n_slices, overlap=True):
    """The reference's terms plus the port's stated extras; the slab the
    budget then holds; and the reference's traffic at that slab."""
    extra = port_extras(plan, get_policy(precision))
    assert (got.extra_fixed_bytes, got.extra_per_slice_bytes) == extra
    assert extra[0] > 0 and extra[1] > 0
    ref = jax_suggest_slab(jplan, jcfg, jtopo, 1 << 62, overlap=overlap)
    assert got.fixed_bytes == ref.fixed_bytes + extra[0]
    assert got.per_slice_bytes == ref.per_slice_bytes + extra[1]
    granule = got.granule
    y = (budget - got.fixed_bytes) // got.per_slice_bytes // granule * granule
    if n_slices is not None:
        y = min(y, (n_slices // granule) * granule or granule)
    assert got.y_slab == y
    # the reference at a budget that fits the same slab: every other field
    same = jax_suggest_slab(
        jplan, jcfg, jtopo, ref.fixed_bytes + y * ref.per_slice_bytes,
        overlap=overlap)
    assert same.y_slab == got.y_slab
    for field in ("granule", "slab_hbm_bytes", "slab_flops"):
        assert getattr(got, field) == getattr(same, field), field
    assert got.slab_bytes == got.fixed_bytes + y * got.per_slice_bytes
    assert got.n_slabs(48) == -(-48 // y)


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("precision", ["single", "mixed", "q8", "double"])
def test_suggest_slab_matches_reference_on_a_real_plan(
        small_system, port_plan, precision, overlap):
    """``suggest_slab`` is the reference's model, term for term, plus the
    port's extras (``port_extras``: the scatter passes and the solve's
    transients, which the port's peak device memory showed the reference's
    model does not count)."""
    _, _, plan = small_system
    topo, jtopo = _topos()
    cfg = ReconConfig(precision=precision, comm_mode="rs", fuse=2)
    jcfg = JConfig(precision=precision, comm_mode="rs", fuse=2)
    fixed = suggest_slab(port_plan, cfg, topo, 1 << 40).fixed_bytes
    for budget, n_slices in ((fixed + 3_000_000, None), (fixed + 3_000_000, 8),
                             (1 << 40, 48)):
        got = suggest_slab(port_plan, cfg, topo, budget, n_slices=n_slices,
                           overlap=overlap)
        assert isinstance(got, SlabPlan)
        _check_against_reference(got, port_plan, plan, precision, cfg, jcfg,
                                 topo, jtopo, budget, n_slices, overlap)
        # the port's field: row 1's shared memory per SM, from
        # launch_geometry's ring (no card needed)
        sb = get_policy(precision).storage_bytes
        assert got.smem_bytes == max(
            txs.sm_smem_bytes("sorted", op.inds.shape[2], op.inds.shape[3],
                              op.inds.shape[4], op.winmap.shape[-1], 2, sb)
            for op in (port_plan.proj, port_plan.back))
        assert 0 < got.smem_bytes <= 233_472
    # where the budget holds whole volumes the slab is the reference's
    big = suggest_slab(port_plan, cfg, topo, 1 << 40, n_slices=48)
    assert big.y_slab == jax_suggest_slab(plan, jcfg, jtopo, 1 << 40,
                                          n_slices=48).y_slab == 48
    with pytest.raises(ValueError, match="cannot hold one solve granule"):
        suggest_slab(port_plan, cfg, topo, fixed)


def test_suggest_slab_at_the_xct_shale_scale_allocates_nothing():
    """The paper's xct-shale over its 64 data ranks, planned from shapes
    alone: the port's sizing equals the reference's."""
    ds = DATASETS["xct-shale"]
    est = tpart.estimate_plan(tgeo.XCTGeometry(ds.n, ds.k),
                              tpart.PartitionConfig(n_data=ds.p_data))
    jest = jpart.estimate_plan(JGeo(ds.n, ds.k),
                               jpart.PartitionConfig(n_data=ds.p_data))
    topo = Topology.from_sizes([("model", ds.p_data)])
    jtopo = JTopology.from_sizes([("model", ds.p_data)])
    for precision in ("mixed", "q8"):
        cfg = ReconConfig(precision=precision, fuse=16)
        jcfg = JConfig(precision=precision, fuse=16)
        # the budget spans the 64 ranks' cards (operator bytes are summed
        # over the shards)
        for budget in (ds.p_data * 16 * 2**30, ds.p_data * 80 * 2**30):
            got = suggest_slab(est, cfg, topo, budget, n_slices=ds.m)
            _check_against_reference(got, est, jest, precision, cfg, jcfg,
                                     topo, jtopo, budget, ds.m)
            assert got.y_slab >= 16 and got.smem_bytes > 0
