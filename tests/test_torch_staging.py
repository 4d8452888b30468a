"""The staging layer of ``Reconstructor`` on the CPU device.

The sinogram's packing into stored (Hilbert) order, its per-slice
power-of-two normalization, the initial iterate, the volume's unpacking
and its division by the scale run on the device, through host buffers
kept across calls.  Every result is held bit for bit against the host
formulas they replace, restated here: ``pack_sino`` / ``pack_tomo`` as a
scatter into zeros, the abs-max and ``exp2(round(log2(1 / max(m,
1e-30))))`` in f32, ``unpack_tomo`` as a gather, and ``/ scale``.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import geometry as tgeo
from repro_torch.core import partition as tpart
from repro_torch.core.recon import ReconConfig, Reconstructor
from repro_torch.data.phantom import phantom_slices
from repro_torch.dist import Topology
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.resil import inject as tinject
from repro_torch.resil.errors import NonFiniteSolveError

PCFG = dict(tile=4, rows_per_block=16, nnz_per_stage=16)


@pytest.fixture(scope="module")
def system():
    """n=32: the operator, one-rank and four-rank plans, and a sinogram
    of 8 slices."""
    geo = tgeo.XCTGeometry(n=32, n_angles=48)
    a = tgeo.build_system_matrix(geo)
    one = tpart.build_plan(geo, tpart.PartitionConfig(**PCFG), a=a)
    four = tpart.build_plan(geo, tpart.PartitionConfig(n_data=4, **PCFG), a=a)
    x = phantom_slices(32, 8)
    return a, one, four, x, (a @ x).astype(np.float32)


def _rec(system, layout, precision):
    """A CPU reconstructor: ``one`` rank, ``four`` ranks on one device (a
    2x2 mesh), two batch ``groups`` of one rank, or ``host``: one rank
    with the device staging path off, as where a group spans devices."""
    _, one, four, _, _ = system
    cfg = ReconConfig(precision=precision, comm_mode="rs", fuse=2)
    if layout == "four":
        topo = Topology.from_mesh(
            make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4),
            data_axes=("model", "data"), batch_axes=())
        return Reconstructor(four, dataclasses.replace(cfg, comm_mode="hier"),
                             topology=topo)
    if layout == "groups":
        topo = Topology.from_mesh(
            make_mesh((2, 1), ("data", "model"), devices=["cpu"] * 2),
            data_axes=("model",), batch_axes=("data",))
        return Reconstructor(one, cfg, topology=topo)
    rec = Reconstructor(one, cfg, device="cpu")
    if layout == "host":
        rec._sets = None
    return rec


# the host formulas the device path replaces
def ref_pack(a, pad, n, perm, pos):
    out = np.zeros((pad, a.shape[1]), np.float32)
    out[slice(None, n) if pos is None else pos[:n]] = np.asarray(a)[perm]
    return out


def ref_pack_sino(plan, y):
    return ref_pack(y, plan.proj.n_rows_pad, plan.geo.n_rays, plan.row_perm,
                    plan.row_pos)


def ref_pack_tomo(plan, x):
    return ref_pack(x, plan.proj.n_cols_pad, plan.geo.n_vox, plan.col_perm,
                    plan.col_pos)


def ref_scale(y_packed):
    m = np.abs(y_packed).max(axis=0)
    return np.exp2(np.round(np.log2(1.0 / np.maximum(m, 1e-30)))).astype(
        np.float32)


def ref_unpack_tomo(plan, x_curve):
    n, pos = plan.geo.n_vox, plan.col_pos
    rank = np.empty(n, np.int64)
    rank[plan.col_perm] = np.arange(n) if pos is None else pos[:n]
    return np.asarray(x_curve)[rank]


def ref_reconstruct(rec, sino, iters, x0_nat=None):
    """The reconstruction with host staging: the same solve on the
    host-packed, host-normalized inputs, unpacked and rescaled on the
    host."""
    plan = rec.plan
    y = ref_pack_sino(plan, sino)
    scale = ref_scale(y)
    x0 = (ref_pack_tomo(plan, x0_nat) * scale if x0_nat is not None
          else np.zeros((rec.tomo_pad, sino.shape[1]), np.float32))
    with torch.no_grad():
        x, res = rec._solve(rec._shard(y * scale), rec._shard(x0), iters)
    x = rec._download(x)
    res = rec._download(res.first_ranks())
    return ref_unpack_tomo(plan, x) / scale, res / scale


@pytest.mark.parametrize("warm", ["zeros", "x0"])
@pytest.mark.parametrize("layout", ["one", "four", "groups", "host"])
@pytest.mark.parametrize("precision", ["mixed", "single"])
def test_reconstruct_equals_host_staging(system, precision, layout, warm):
    """``reconstruct``'s volume and residuals, and ``stage_sino``'s packed
    ``y`` and ``scale``, equal the host formulas bit for bit."""
    _, _, _, x_true, sino = system
    rec = _rec(system, layout, precision)
    staged = rec.stage_sino(sino)
    want_y = ref_pack_sino(rec.plan, sino)
    want_scale = ref_scale(want_y)
    np.testing.assert_array_equal(staged.scale, want_scale)
    assert staged.scale.dtype == np.float32
    np.testing.assert_array_equal(staged.y.cpu().numpy(),
                                  want_y * want_scale)
    assert all(t.is_contiguous() for t in staged.y.parts)
    x0 = None if warm == "zeros" else (0.5 * x_true).astype(np.float32)
    x, res = rec.reconstruct(sino, iters=4, x0_nat=x0)
    want_x, want_res = ref_reconstruct(rec, sino, 4, x0)
    assert x.dtype == want_x.dtype and res.dtype == want_res.dtype
    np.testing.assert_array_equal(x, want_x)
    np.testing.assert_array_equal(res, want_res)
    # a pre-staged slab gives the same answer
    again = rec.reconstruct(staged, iters=4, x0_nat=x0)
    np.testing.assert_array_equal(again[0], want_x)
    np.testing.assert_array_equal(again[1], want_res)


@pytest.mark.parametrize("layout", ["one", "groups"])
def test_x0_in_double_packs_as_the_host(system, layout):
    """An ``x0_nat`` in float64 rounds to f32 as the host's packing does."""
    _, _, _, x_true, sino = system
    rec = _rec(system, layout, "single")
    x0 = x_true * (1 + 1e-9)
    x, res = rec.reconstruct(sino, iters=2, x0_nat=x0)
    want_x, want_res = ref_reconstruct(rec, sino, 2, x0)
    np.testing.assert_array_equal(x, want_x)
    np.testing.assert_array_equal(res, want_res)


@pytest.mark.parametrize("slices", [8, 64])
def test_narrow_and_wide_slabs(system, slices):
    """A slab of 8 slices (rows of 32 bytes, gathered element by element)
    and one of 64 (256-byte rows, gathered by rows) both stage and
    unpack as the host formulas do."""
    a, one, _, _, _ = system
    rec = Reconstructor(one, ReconConfig(precision="mixed", fuse=2),
                        device="cpu")
    x = phantom_slices(32, slices)
    sino = (a @ x).astype(np.float32)
    staged = rec.stage_sino(sino)
    want_y = ref_pack_sino(one, sino)
    np.testing.assert_array_equal(staged.y.cpu().numpy(),
                                  want_y * ref_scale(want_y))
    got = rec.reconstruct(staged, iters=1, x0_nat=x)
    want = ref_reconstruct(rec, sino, 1, x)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # views with negative strides and big-endian arrays stage as copies
    for odd in (sino[:, ::-1], sino.astype(">f4")):
        want_y = ref_pack_sino(one, odd)
        np.testing.assert_array_equal(rec.stage_sino(odd).y.cpu().numpy(),
                                      want_y * ref_scale(want_y))


@pytest.mark.parametrize("k", [-7, 0, 3, 20])
def test_scale_at_the_rounding_edge(system, k):
    """Maxima at ``2**k * sqrt(2)`` and one ulp either side (where
    ``round(log2(1 / m))`` changes) give the host formula's scale."""
    _, one, _, _, sino = system
    rec = Reconstructor(one, ReconConfig(precision="mixed", fuse=2),
                        device="cpu")
    edge = np.float32(2.0 ** k * np.sqrt(2.0))
    peaks = [np.nextafter(edge, np.float32(0)), edge,
             np.nextafter(edge, np.float32(np.inf)),
             -edge, np.float32(2.0 ** k), np.float32(0.0)]
    y = (sino[:, :6] / np.abs(sino).max() * 2.0 ** (k - 1)).astype(np.float32)
    y[:, 5] = 0.0
    rows = np.random.default_rng(k + 50).choice(len(y), 6, replace=False)
    for j, (r, p) in enumerate(zip(rows, peaks)):
        y[r, j] = p
    y = np.concatenate([y, np.zeros_like(y[:, :2])], axis=1)  # 8 slices
    staged = rec.stage_sino(y)
    want = ref_scale(ref_pack_sino(one, y))
    np.testing.assert_array_equal(staged.scale, want)
    np.testing.assert_array_equal(staged.y.cpu().numpy(),
                                  ref_pack_sino(one, y) * want)


def test_injected_nonfinite_still_raises(system):
    """A ``nonfinite`` fault at ``recon/solve`` poisons the host volume:
    the host tests it again and raises with the usual message."""
    _, one, _, _, sino = system
    rec = Reconstructor(one, ReconConfig(precision="mixed", fuse=2),
                        device="cpu")
    plan = tinject.FaultPlan(seed=5).add("recon/solve", "nonfinite",
                                         attempts=None)
    with tinject.activate(plan) as handle:
        with pytest.raises(NonFiniteSolveError,
                           match=r"solve produced 1 non-finite value\(s\) "
                                 r"over 8 slices \(precision=mixed\)"):
            rec.reconstruct(sino, iters=2)
    assert [f[-1] for f in handle.fired] == ["nonfinite"]


def test_nan_in_the_staged_slab_raises_without_a_fault_plan(system):
    """A NaN in the staged ``y`` blows the solve up; the device's count
    of non-finite values raises with no fault plan active."""
    _, one, _, _, sino = system
    rec = Reconstructor(one, ReconConfig(precision="single", fuse=2),
                        device="cpu")
    staged = rec.stage_sino(sino)
    row = np.flatnonzero(ref_pack_sino(one, sino)[:, 3])[0]  # a real ray
    staged.y.parts[0][row, 3] = float("nan")
    assert not tinject.active()
    with pytest.raises(NonFiniteSolveError,
                       match=r"non-finite value\(s\) over 8 slices"):
        rec.reconstruct(staged, iters=2)


def test_threads_stage_their_own_slabs(system):
    """Two threads staging different slabs of one shape while a third
    reconstructs each get their own slab back."""
    _, one, _, _, sino = system
    rec = Reconstructor(one, ReconConfig(precision="mixed", fuse=2),
                        device="cpu")
    slabs = [sino, sino[::-1].copy() * 3, sino * 0.25]
    want = ref_reconstruct(rec, slabs[2], 3)
    out, errors = {}, []

    def run(name, fn):
        try:
            for i in range(6):
                out[name, i] = fn()
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k, (
        lambda k=k: rec.stage_sino(slabs[k])))) for k in (0, 1)]
    threads.append(threading.Thread(target=run, args=(2, (
        lambda: rec.reconstruct(slabs[2], iters=3)))))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for k in (0, 1):
        y = ref_pack_sino(one, slabs[k])
        for i in range(6):
            staged = out[k, i]
            np.testing.assert_array_equal(staged.scale, ref_scale(y))
            np.testing.assert_array_equal(staged.y.cpu().numpy(),
                                          y * ref_scale(y))
    for i in range(6):
        np.testing.assert_array_equal(out[2, i][0], want[0])
        np.testing.assert_array_equal(out[2, i][1], want[1])


def test_staging_buffers_are_reused(system):
    """After ``n`` calls of one shape: one buffer per direction and
    ``n - 1`` reuses; a new shape takes a buffer of its own, and every
    call returns a fresh volume.  With tracing off nothing is counted."""
    _, one, _, _, sino = system
    m = tmetrics.Metrics()
    old = tmetrics.set_metrics(m)
    old_tracer = ttrace.get_tracer()
    ttrace.enable()  # the counters count while tracing, as the exchange's
    try:
        rec = Reconstructor(one, ReconConfig(precision="mixed", fuse=2),
                            device="cpu")
        xs = [rec.reconstruct(sino, iters=2)[0] for _ in range(4)]
        for d in ("up", "down"):
            assert m.get("staging_pinned_alloc_total", dir=d) == 1
            assert m.get("staging_pinned_reuse_total", dir=d) == 3
        assert len({x.ctypes.data for x in xs}) == 4
        np.testing.assert_array_equal(xs[0], xs[3])
        rec.reconstruct(sino[:, :4], iters=2)
        for d in ("up", "down"):
            assert m.get("staging_pinned_alloc_total", dir=d) == 2
        ttrace.disable()
        rec.reconstruct(sino, iters=2)
        assert m.get("staging_pinned_reuse_total", dir="up") == 3
    finally:
        tmetrics.set_metrics(old)
        ttrace.set_tracer(old_tracer)
