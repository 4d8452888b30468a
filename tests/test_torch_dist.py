"""The port's partial-data exchange against the JAX package, on the CPU.

  * accounting: ``Topology`` / ``CommPlan`` give the reference's steps,
    level fractions, bytes per level and per link, and ``describe()``
    strings for every mode on three ladders;
  * ladders: ``reduce_partials`` (direct | rs | hier) and
    ``hierarchical_psum`` over four CPU ranks match the dense sum, in f32
    and through an f16 wire (the reference's tolerances,
    ``tests/test_dist_equivalence.py``);
  * system level: the port's ``Reconstructor`` on a 2x2 CPU
    ``DeviceMesh`` against the JAX ``Reconstructor`` on a forced 4-device
    mesh (one subprocess: the device count must be set before JAX
    initializes), for the five modes under ``single`` and ``mixed``, the
    int8 wire, and 8-iteration ``mixed`` solves; against the JAX kernel
    path (Pallas in interpret mode) bit for bit under ``mixed`` and
    ``single``, every mode; and with two batch groups of two data ranks
    each;
  * the ordered scatter-add: ``ordered_index_add`` equals a sequential
    loop and the reference's ``.at[].add``, bit for bit;
  * rank order: a port output chunk moved to another rank fails the same
    comparison, once per piece of code that owns the order.
"""
import dataclasses
import math
import os
import subprocess
import sys
import types
import zlib

import numpy as np
import pytest
import torch

from repro.dist import collectives as jcoll
from repro.dist import topology as jtopo
from repro_torch.core import geometry as tgeo
from repro_torch.core import partition as tpart
from repro_torch.core import recon as trecon
from repro_torch.dist import collectives as tcoll
from repro_torch.dist import topology as ttopo
from repro_torch.launch import mesh as tmesh

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")

LADDERS = {
    "model2-data2": [("model", 2), ("data", 2)],
    "model4-data2-pod2dci": [("model", 4), ("data", 2), ("pod", 2, "dci")],
    "one-level": [("model", 4)],
}
MODES = ("direct", "rs", "hier", "sparse", "hier-sparse", "hier-sparse-q8")
PARAMS = dict(pair_slots=24, dense_rows=1024, merged_rows=192,
              cross_rows=64, comm_bytes=2)


def _plan_record(mod, sizes, mode, with_params):
    topo = mod.Topology.from_sizes(sizes)
    kw = dict(PARAMS) if with_params else {}
    if mode == "hier-sparse-q8":
        mode, kw["wire"] = "hier-sparse", "q8"
    plan = topo.plan(mode, **kw)
    dense = 3.0e6
    return dict(
        levels=[dataclasses.astuple(lv) for lv in topo.levels],
        n_data=topo.n_data, n_batch=topo.n_batch,
        data_axes=topo.data_axes, topo=topo.describe(),
        steps=[(s.op, s.axes, s.link, repr(s.wire_frac))
               for s in plan.steps],
        fracs=[repr(f) for f in plan.level_fracs],
        level_bytes=[repr(b) for b in plan.level_bytes(dense)],
        by_link={k: repr(v)
                 for k, v in plan.wire_bytes_by_link(dense).items()},
        slow=repr(plan.slow_link_bytes(dense)),
        describe=plan.describe(),
    )


@pytest.mark.parametrize("with_params", [True, False],
                         ids=["tables", "no-tables"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ladder", sorted(LADDERS))
def test_comm_plan_accounting_matches_reference(ladder, mode, with_params):
    sizes = LADDERS[ladder]
    assert _plan_record(ttopo, sizes, mode, with_params) == _plan_record(
        jtopo, sizes, mode, with_params
    )


def test_module_constants_and_errors_match_reference():
    assert ttopo.MODES == jtopo.MODES
    assert ttopo.LINK_CLASSES == jtopo.LINK_CLASSES
    assert tmesh.mesh_axis_classes() == {"data": "ici", "model": "ici"}
    assert tmesh.mesh_axis_classes(True)["pod"] == "dci"
    for mod in (ttopo, jtopo):
        topo = mod.Topology.from_sizes([("model", 2), ("data", 2)])
        with pytest.raises(ValueError, match="unknown comm mode"):
            topo.plan("bogus")
        with pytest.raises(ValueError, match="wire='q8'"):
            topo.plan("hier", wire="q8")
        with pytest.raises(ValueError, match="unknown wire"):
            topo.plan("hier-sparse", wire="q4")
        with pytest.raises(ValueError, match="at least one level"):
            mod.Topology.from_sizes([]).plan("hier-sparse")


def test_from_mesh_matches_reference_on_the_same_shape():
    """``from_mesh`` reads only the mesh's axis sizes, so a DeviceMesh and
    a stand-in with the same ``shape`` give the same topology."""
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4
    stand_in = types.SimpleNamespace(shape=dict(mesh.shape))
    for kw in (dict(data_axes=("model", "data"), batch_axes=()),
               dict(), dict(link_classes={"data": "dci"})):
        t = ttopo.Topology.from_mesh(mesh, **kw)
        j = jtopo.Topology.from_mesh(stand_in, **kw)
        assert t.levels == tuple(
            ttopo.Level(*dataclasses.astuple(lv)) for lv in j.levels
        )
        assert (t.batch_axes, t.n_data, t.n_batch, t.describe()) == (
            j.batch_axes, j.n_data, j.n_batch, j.describe()
        )
    with pytest.raises(ValueError, match="not in mesh axes"):
        ttopo.Topology.from_mesh(mesh, data_axes=("pod",))


def test_rank_order_and_groups():
    """Rank p = f * n_slow + t over data axes (model, data); a step's
    groups share the other axes' coordinates; devices follow the mesh."""
    devs = ["cpu"] * 4
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), devices=devs)
    topo = ttopo.Topology.from_mesh(mesh, data_axes=("model", "data"),
                                    batch_axes=())
    assert topo.groups(("model",)) == [[0, 2], [1, 3]]
    assert topo.groups(("data",)) == [[0, 1], [2, 3]]
    assert topo.groups(("model", "data")) == [[0, 1, 2, 3]]
    assert topo.groups(("data", "model")) == [[0, 2, 1, 3]]
    assert topo.rank_devices() == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="mesh-bound"):
        ttopo.Topology.from_sizes([("model", 2)]).rank_devices()
    with pytest.raises(ValueError, match="not in data axes"):
        topo.groups(("pod",))


def test_rank_devices_per_batch_group():
    """Batch group ``b`` takes the mesh devices at its batch coordinates
    (first batch axis major), the data ranks in rank order."""
    devs = np.empty((2, 3, 2), dtype=object)
    for i, idx in enumerate(np.ndindex(devs.shape)):
        devs[idx] = torch.device("cpu", i)
    mesh = ttopo.DeviceMesh(devs, ("pod", "data", "model"))
    topo = ttopo.Topology.from_mesh(mesh, data_axes=("model",),
                                    batch_axes=("pod", "data"))
    assert topo.n_batch == 6 and topo.n_data == 2
    for b in range(6):
        pod, data = divmod(b, 3)
        assert topo.rank_devices(b) == [devs[pod, data, m] for m in (0, 1)]
    assert topo.rank_devices() == topo.rank_devices(0)
    with pytest.raises(ValueError, match="batch group 6 of 6"):
        topo.rank_devices(6)


def test_make_mesh_never_moves_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is available"):
        tmesh.make_mesh((1, 2), ("data", "model"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh((2, 2), ("data", "model"), devices=["cuda:0"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices and 1 is"):
        tmesh.make_mesh((1, 4), ("data", "model"))
    with pytest.raises(ValueError, match="needs 4 devices, got 2"):
        tmesh.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 2)


# --------------------------------------------------------------------- #
# raw ladders on four CPU ranks
# --------------------------------------------------------------------- #
RANK_LADDERS = {
    "model2-data2": [("model", 2), ("data", 2)],
    "model4": [("model", 4)],
}


@pytest.mark.parametrize("mode", ["direct", "rs", "hier"])
@pytest.mark.parametrize("ladder", sorted(RANK_LADDERS))
def test_reduction_ladders_match_dense_sum(ladder, mode):
    topo = ttopo.Topology.from_sizes(RANK_LADDERS[ladder])
    pd, rows, f = 4, 32, 3
    parts = np.random.default_rng(0).standard_normal(
        (pd, rows, f)).astype(np.float32)
    dense = parts.sum(0)
    xs = [torch.from_numpy(p) for p in parts]
    got = tcoll.reduce_partials(xs, topo, mode=mode)
    assert [tuple(c.shape) for c in got] == [(rows // pd, f)] * pd
    assert np.abs(torch.cat(got).numpy() - dense).max() < 1e-5
    # fp16 wire: cast each partial before the ladder (what qcast does)
    half = tcoll.reduce_partials([x.half() for x in xs], topo, mode=mode)
    relh = np.abs(torch.cat(half).float().numpy() - dense).max() / (
        np.abs(dense).max())
    assert relh < 5e-3
    # all-reduce semantics: every rank sees the dense sum
    for out in tcoll.hierarchical_psum(xs, topo, mode=mode):
        assert np.abs(out.numpy() - dense).max() < 1e-4
    with pytest.raises(TypeError, match="Topology"):
        tcoll.reduce_partials(xs, ("model",), mode=mode)


def test_wire_q8_pack_bit_equal():
    """The int8 wire's payload and per-(peer, slice) inverse scales are the
    reference's bit for bit, zero bands and power-of-two edges included."""
    rng = np.random.default_rng(3)
    msgs = (rng.standard_normal((2, 24, 5))
            * np.exp2(rng.integers(-20, 8, size=(2, 1, 5)))
            ).astype(np.float32)
    msgs[1, :, 2] = 0.0
    msgs[0, 3, 4] = 127.0 * 2.0 ** -7
    for dtype in (np.float32, np.float16):
        m = msgs.astype(dtype)
        tq, tinv = tcoll._wire_q8_pack(torch.from_numpy(m))
        jq, jinv = jcoll._wire_q8_pack(m)
        assert tq.dtype == torch.int8 and tinv.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))


# --------------------------------------------------------------------- #
# system level against the JAX Reconstructor on a forced 4-device mesh
# --------------------------------------------------------------------- #
_JAX_SIDE = """
import sys
import numpy as np, jax
from repro.core.geometry import XCTGeometry, build_system_matrix
from repro.core.partition import PartitionConfig, build_plan
from repro.core.recon import Reconstructor, ReconConfig
from repro.data.phantom import phantom_slices
from repro.dist import Topology

geo = XCTGeometry(n=32, n_angles=48)
A = build_system_matrix(geo)
plan = build_plan(geo, PartitionConfig(n_data=4, tile=4,
                  rows_per_block=16, nnz_per_stage=16), a=A)
mesh = jax.make_mesh((2, 2), ("data", "model"))
topo = Topology.from_mesh(mesh, data_axes=("model", "data"),
                          batch_axes=())
rng = np.random.default_rng(1)
x = rng.random((geo.n_vox, 4)).astype(np.float32)
y = (A @ x).astype(np.float32)
out = {"x": x, "y": y}
for key in sys.argv[2].split(","):
    mode, prec, wire = key.split("/")
    rec = Reconstructor(plan, topology=topo, cfg=ReconConfig(
        precision=prec, comm_mode=mode, fuse=2, wire=wire, use_ref=True))
    out["project:" + key] = np.asarray(rec.project(x))
    out["backproject:" + key] = np.asarray(rec.backproject(y))
sino = (A @ phantom_slices(32, 4)).astype(np.float32)
out["sino"] = sino
for mode in ("hier", "hier-sparse"):
    rec = Reconstructor(plan, topology=topo, cfg=ReconConfig(
        precision="mixed", comm_mode=mode, fuse=2, use_ref=True))
    xr, res = rec.reconstruct(sino, iters=8)
    out["reconstruct:" + mode] = np.asarray(xr)
    out["resnorms:" + mode] = np.asarray(res)
# the kernel path (Pallas in interpret mode), whose f16 and f32 bits the
# port's kernel and ordered scatter-adds reproduce
for mode in ("direct", "rs", "hier", "sparse", "hier-sparse"):
    for prec, tag in (("mixed", ""), ("single", "/single")):
        rec = Reconstructor(plan, topology=topo, cfg=ReconConfig(
            precision=prec, comm_mode=mode, fuse=2))
        out["kernel:project:" + mode + tag] = np.asarray(rec.project(x))
        out["kernel:backproject:" + mode + tag] = np.asarray(
            rec.backproject(y))
# two batch groups ("data") of two data ranks ("model")
plan2 = build_plan(geo, PartitionConfig(n_data=2, tile=4,
                   rows_per_block=16, nnz_per_stage=16), a=A)
topo2 = Topology.from_mesh(mesh, data_axes=("model",), batch_axes=("data",))
rec = Reconstructor(plan2, topology=topo2, cfg=ReconConfig(
    precision="mixed", comm_mode="hier", fuse=2, use_ref=True))
assert rec.n_batch == 2
out["batch:project"] = np.asarray(rec.project(x))
out["batch:backproject"] = np.asarray(rec.backproject(y))
xr, res = rec.reconstruct(sino, iters=8)
out["batch:reconstruct"] = np.asarray(xr)
out["batch:resnorms"] = np.asarray(res)
np.savez(sys.argv[1], **out)
print("OK")
"""
FIVE = ("direct", "rs", "hier", "sparse", "hier-sparse")
CASES = [f"{m}/{p}/native" for p in ("single", "mixed") for m in FIVE] + [
    "hier-sparse/mixed/q8", "hier-sparse/q8/q8"]
TOL = {"single": 1e-4, "mixed": 5e-3, "q8": 2.5e-2}  # the reference's


def _tol(key):
    mode, prec, wire = key.split("/")
    return TOL["q8"] if wire == "q8" else TOL[prec]


@pytest.fixture(scope="module")
def jax_mesh_outputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_mesh") / "out.npz"
    env = dict(os.environ, PYTHONPATH=_SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, str(path), ",".join(CASES)],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return dict(np.load(path))


@pytest.fixture(scope="module")
def port_mesh():
    geo = tgeo.XCTGeometry(n=32, n_angles=48)
    a = tgeo.build_system_matrix(geo)
    plan = tpart.build_plan(
        geo, tpart.PartitionConfig(n_data=4, tile=4, rows_per_block=16,
                                   nnz_per_stage=16), a=a)
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    topo = ttopo.Topology.from_mesh(mesh, data_axes=("model", "data"),
                                    batch_axes=())
    return plan, topo


def _port_rec(port_mesh, key):
    plan, topo = port_mesh
    mode, prec, wire = key.split("/")
    return trecon.Reconstructor(
        plan, trecon.ReconConfig(precision=prec, comm_mode=mode, fuse=2,
                                 wire=wire), topology=topo)


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("key", CASES)
def test_mesh_project_backproject_match_jax(jax_mesh_outputs, port_mesh,
                                            key):
    d = jax_mesh_outputs
    rec = _port_rec(port_mesh, key)
    assert [a["proj_inds"].device for a in rec._arrays] == rec.devices
    mode, prec, wire = key.split("/")
    for fn, inp in (("project", d["x"]), ("backproject", d["y"])):
        got = getattr(rec, fn)(inp)
        ref = d[f"{fn}:{key}"]
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert _rel(got, ref) < _tol(key), (fn, key, _rel(got, ref))
        if prec == "single":
            # the plain f32 step rounds once, as the JAX kernel path's
            # contracted step does, so single equals it bit for bit
            np.testing.assert_array_equal(got, d[f"kernel:{fn}:{mode}/single"])


@pytest.mark.parametrize("precision,tol", [("single", 2e-6),
                                           ("mixed", 5e-3)])
def test_hier_sparse_matches_direct_on_the_port(jax_mesh_outputs, port_mesh,
                                                precision, tol):
    """The reference's own check, on the port: the two-stage exchange
    reorders only the summation of the same partials along a row."""
    d = jax_mesh_outputs
    hs = _port_rec(port_mesh, f"hier-sparse/{precision}/native")
    de = _port_rec(port_mesh, f"direct/{precision}/native")
    for fn, inp in (("project", d["x"]), ("backproject", d["y"])):
        assert _rel(getattr(hs, fn)(inp), getattr(de, fn)(inp)) < tol


@pytest.mark.parametrize("mode", ["hier", "hier-sparse"])
def test_mesh_reconstruct_matches_jax(jax_mesh_outputs, port_mesh, mode):
    """8 mixed iterations at P=4, at the tolerance of
    ``test_torch_recon.py::test_port_matches_jax_reconstructor``."""
    d = jax_mesh_outputs
    x, res = _port_rec(port_mesh, f"{mode}/mixed/native").reconstruct(
        d["sino"], iters=8)
    jx, jres = d[f"reconstruct:{mode}"], d[f"resnorms:{mode}"]
    np.testing.assert_allclose(x, jx, rtol=5e-3, atol=5e-3 * np.abs(jx).max())
    np.testing.assert_allclose(res, jres, rtol=5e-3,
                               atol=5e-3 * np.abs(jres).max())
    assert (res[-1] < res[0]).all()


@pytest.mark.parametrize("mode", FIVE)
def test_mesh_matches_jax_kernel_path_bit_for_bit(jax_mesh_outputs,
                                                  port_mesh, mode):
    """Mixed project and backproject at P=4 equal the JAX kernel path's
    bits under every mode: the kernel's f16 steps and the ordered
    scatter-adds round where XLA's do (``sparse`` once differed by
    6.1e-4 / 5.4e-4 of max|.|, its scatter summing in f32)."""
    d = jax_mesh_outputs
    rec = _port_rec(port_mesh, f"{mode}/mixed/native")
    for fn, inp in (("project", d["x"]), ("backproject", d["y"])):
        np.testing.assert_array_equal(getattr(rec, fn)(inp),
                                      d[f"kernel:{fn}:{mode}"])


def test_batch_groups_match_jax(jax_mesh_outputs, port_mesh):
    """Two batch groups of two data ranks (a 2x2 mesh, data axis "model",
    batch axis "data") against the JAX ``Reconstructor`` on the same
    mesh: one projection and backprojection and an 8-iteration mixed
    solve, at the mixed tolerance 5e-3."""
    d = jax_mesh_outputs
    plan4, _ = port_mesh
    plan = tpart.build_plan(plan4.geo, dataclasses.replace(plan4.cfg,
                                                           n_data=2))
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    topo = ttopo.Topology.from_mesh(mesh, data_axes=("model",),
                                    batch_axes=("data",))
    rec = trecon.Reconstructor(
        plan, trecon.ReconConfig(precision="mixed", comm_mode="hier",
                                 fuse=2), topology=topo)
    assert rec.n_batch == 2 and topo.n_data == 2
    for fn, inp in (("project", d["x"]), ("backproject", d["y"])):
        assert _rel(getattr(rec, fn)(inp), d[f"batch:{fn}"]) < 5e-3, fn
    x, res = rec.reconstruct(d["sino"], iters=8)
    jx, jres = d["batch:reconstruct"], d["batch:resnorms"]
    np.testing.assert_allclose(x, jx, rtol=5e-3, atol=5e-3 * np.abs(jx).max())
    np.testing.assert_allclose(res, jres, rtol=5e-3,
                               atol=5e-3 * np.abs(jres).max())
    with pytest.raises(ValueError, match="batch x fuse = 4"):
        rec.project(d["x"][:, :2])


def _sequential_add(n_rows, index, src, limit):
    """The reference's semantics spelled out: one update at a time, in
    index order, each rounded to the operand's dtype."""
    out = np.zeros((n_rows, src.shape[1]), src.dtype)
    for i, d in enumerate(index):
        if 0 <= d < limit:
            out[d] = (out[d] + src[i]).astype(src.dtype)
    return out


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
@pytest.mark.parametrize("table", ["repeats", "padding", "all-one-row",
                                   "empty"])
def test_ordered_index_add_matches_sequential_and_xla(table, dtype):
    import jax.numpy as jnp

    rng = np.random.default_rng(zlib.crc32(repr((table, dtype)).encode()))
    rows, slots, f = 24, 200, 5
    index = rng.integers(0, rows, size=slots)
    if table == "padding":
        index[rng.random(slots) < 0.3] = rows  # the trash row
    elif table == "all-one-row":
        index[:] = 7
    elif table == "empty":
        index[:] = rows
    src = (rng.standard_normal((slots, f))
           * np.exp2(rng.integers(-4, 6, size=(slots, 1)))).astype(dtype)
    passes = tcoll.ScatterPasses.build(index, rows)
    counts = np.bincount(index[index < rows], minlength=rows)
    assert passes.depth == counts.max()
    # no row twice in a pass; every slot of pass 0 on a row or a trash
    # row of its own
    first = passes.first.numpy()
    assert len(set(first.tolist())) == slots
    assert (first < rows).sum() == (counts > 0).sum()
    assert passes.trash == slots - (counts > 0).sum()
    b = passes.bounds
    for lo, hi in zip(b[:-1], b[1:]):
        assert len(set(passes.dst[lo:hi].tolist())) == hi - lo > 0
    got = tcoll.ordered_index_add(passes, torch.from_numpy(src)).numpy()
    want = _sequential_add(rows, index, src, rows)
    xla = np.asarray(jnp.zeros((rows, f), dtype).at[index].add(
        src, mode="drop"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, xla)


def _swap_ranks(chunks):
    """Ranks 1 and 2 trade places: (fast 0, slow 1) <-> (fast 1, slow 0)."""
    chunks = list(chunks)
    chunks[1], chunks[2] = chunks[2], chunks[1]
    return chunks


OWNERS = {
    # CommPlan.reduce_partials: which rank owns which chunk
    "reduce_partials": ("hier/single/native", "comm_plan"),
    # the flat sparse tables' (sender, receiver) pairs
    "sparse_exchange": ("sparse/single/native", "exchange"),
    # the hierarchical tables' p = f * n_slow + t
    "hier_sparse_exchange": ("hier-sparse/single/native", "exchange"),
    # Topology.groups: a member's index within its group
    "topology_groups": ("hier/single/native", "groups"),
    # the Reconstructor's split of the input over the ranks' shards
    "rank_shards": ("direct/single/native", "shards"),
}


@pytest.mark.parametrize("owner", sorted(OWNERS))
def test_a_chunk_on_the_wrong_rank_fails(jax_mesh_outputs, port_mesh,
                                         owner, monkeypatch):
    """The parity check sees the rank order: moving one piece of the
    port's output to another rank, at the code that owns the order,
    breaks it."""
    d = jax_mesh_outputs
    key, where = OWNERS[owner]
    rec = _port_rec(port_mesh, key)
    ref = d[f"project:{key}"]
    assert _rel(rec.project(d["x"]), ref) < _tol(key)
    if where == "comm_plan":
        orig = ttopo.CommPlan.reduce_partials
        monkeypatch.setattr(ttopo.CommPlan, "reduce_partials",
                            lambda self, xs: _swap_ranks(orig(self, xs)))
    elif where == "exchange":
        orig = trecon.sparse_exchange
        monkeypatch.setattr(trecon, "sparse_exchange",
                            lambda *a, **k: _swap_ranks(orig(*a, **k)))
    elif where == "groups":
        orig = ttopo.Topology.groups
        monkeypatch.setattr(ttopo.Topology, "groups",
                            lambda self, axes: [g[::-1]
                                                for g in orig(self, axes)])
    else:
        rec._arrays = _swap_ranks(rec._arrays)
    assert not _rel(rec.project(d["x"]), ref) < _tol(key)


def test_reconstructor_checks_match_reference(jax_mesh_outputs, port_mesh):
    plan, topo = port_mesh
    cfg = trecon.ReconConfig(comm_mode="hier", fuse=2)
    small = tmesh.make_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="P_d=4"):
        trecon.Reconstructor(plan, cfg, topology=ttopo.Topology.from_mesh(
            small))
    with pytest.raises(ValueError, match="wire='q8'"):
        trecon.Reconstructor(plan, trecon.ReconConfig(wire="q8"),
                             topology=topo)
    with pytest.raises(ValueError, match="mesh-bound"):
        trecon.Reconstructor(plan, cfg, topology=ttopo.Topology.from_sizes(
            [("model", 2), ("data", 2)]))
    with pytest.raises(ValueError, match="not both"):
        trecon.Reconstructor(plan, cfg, "cpu", topology=topo)
    # batch axes of size > 1 solve: two groups of the four data ranks
    # give the one group's bits (the same minibatches), and so the
    # reference's projections at the mixed tolerance
    batched = tmesh.make_mesh((2, 4), ("data", "model"),
                              devices=["cpu"] * 8)
    brec = trecon.Reconstructor(plan, cfg, topology=ttopo.Topology.from_mesh(
        batched))
    one = trecon.Reconstructor(plan, cfg, topology=ttopo.Topology.from_mesh(
        tmesh.make_mesh((1, 4), ("data", "model"), devices=["cpu"] * 4)))
    assert brec.n_batch == 2 and len(brec.groups) == 2
    d = jax_mesh_outputs
    for fn, inp in (("project", d["x"]), ("backproject", d["y"])):
        got = getattr(brec, fn)(inp)
        np.testing.assert_array_equal(got, getattr(one, fn)(inp))
        assert _rel(got, d[f"{fn}:hier/mixed/native"]) < 5e-3, fn
    socket2 = tpart.build_plan(
        plan.geo, dataclasses.replace(plan.cfg, socket=2))
    one_level = tmesh.make_mesh((1, 4), ("data", "model"),
                                devices=["cpu"] * 4)
    with pytest.warns(UserWarning, match="socket=2"):
        trecon.Reconstructor(socket2, cfg, topology=ttopo.Topology.from_mesh(
            one_level))


def test_sparse_modes_on_one_rank_match_the_local_path():
    """Without a topology the sparse modes run on their P=1 tables, as
    the reference's do on a one-device mesh."""
    geo = tgeo.XCTGeometry(n=32, n_angles=48)
    plan = tpart.build_plan(geo, tpart.PartitionConfig(
        tile=4, rows_per_block=16, nnz_per_stage=16))
    x = np.random.default_rng(2).random((geo.n_vox, 4)).astype(np.float32)
    outs = {m: trecon.Reconstructor(
        plan, trecon.ReconConfig(precision="single", comm_mode=m, fuse=2),
        device="cpu").project(x) for m in FIVE}
    for m in FIVE:
        assert _rel(outs[m], outs["direct"]) < 2e-6, m
    assert math.isfinite(float(outs["sparse"].sum()))
