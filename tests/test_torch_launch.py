"""repro_torch's launch/ on the CPU, held against the JAX package.

The paper's datasets, the §Perf sweep, the dry run's cost model and
socket sweep, the roofline, the production mesh and the abstract
lowering (``Reconstructor(abstract=True).lower_cg``).  The port prices
with the H100's rates; side by side with the reference it is given the
reference's rates and per-copy overhead, and then its numbers equal the
reference's exactly.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512 placeholder devices
when it is imported, so everything of the reference that needs it runs
in one subprocess (``_REF_SIDE``), started before the port's cases and
read when they need it.
"""
import dataclasses
import doctest
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs.xct_datasets import DATASETS as JDATASETS
from repro.launch import hlo_analysis as jhlo
from repro.launch import xct_perf as jperf
from repro.kernels import traffic as jtraffic
from repro_torch.configs import XCT_DATASETS
from repro_torch.configs.xct_datasets import DATASETS
from repro_torch.core.geometry import XCTGeometry, build_system_matrix
from repro_torch.core.partition import (
    PartitionConfig,
    build_hier_sparse_exchange,
    build_plan,
    default_socket,
    estimate_plan,
)
from repro_torch.core.recon import ReconConfig, Reconstructor
from repro_torch.dist import Topology
from repro_torch.dist.collectives import ScatterPasses
from repro_torch.kernels import xct_spmm as txs
from repro_torch.launch import dryrun, hardware, mesh as tmesh, roofline
from repro_torch.launch import xct_perf

_ROOT = os.path.join(os.path.dirname(__file__), "..")
_SRC = os.path.join(_ROOT, "src")
REF_RATES = hardware.Hardware(
    peak_flops=jhlo.HW.peak_flops, hbm_bw=jhlo.HW.hbm_bw,
    ici_bw=jhlo.HW.ici_bw, dci_bw=jhlo.HW.dci_bw,
)
SMALL = dict(tile=4, rows_per_block=16, nnz_per_stage=16)

_REF_SIDE = r"""
import contextlib, io, json, sys
from repro.launch import dryrun  # XLA_FLAGS: 512 placeholder devices
import jax
from repro.configs.xct_datasets import DATASETS
from repro.core.geometry import XCTGeometry, build_system_matrix
from repro.core.partition import (PartitionConfig, build_plan,
                                  default_socket, estimate_plan)
from repro.core.recon import ReconConfig, Reconstructor
from repro.dist import Topology
from repro.launch.hlo_analysis import roofline
from repro.launch.xct_perf import sweep_topology

path, out = sys.argv[1], {}
geo = XCTGeometry(n=32, n_angles=48)
a = build_system_matrix(geo)
small = dict(tile=4, rows_per_block=16, nnz_per_stage=16)
plan1 = build_plan(geo, PartitionConfig(n_data=1, **small), a=a)
plan4 = build_plan(geo, PartitionConfig(n_data=4, socket=2, **small), a=a)
devs = jax.devices()
for key, plan, shape, data, batch, mode in (
        ("one", plan1, (1, 1), ("model",), ("data",), "hier"),
        ("mesh", plan4, (2, 2), ("model", "data"), (), "hier-sparse")):
    mesh = jax.make_mesh(shape, ("data", "model"),
                         devices=devs[:shape[0] * shape[1]])
    rec = Reconstructor(plan, topology=Topology.from_mesh(
        mesh, data_axes=data, batch_axes=batch), cfg=ReconConfig(
        precision="mixed", comm_mode=mode, fuse=16))
    _, compiled = rec.lower_cg(16, iters=2)
    out["args:" + key] = int(
        compiled.memory_analysis().argument_size_in_bytes)
topo4 = Topology.from_sizes([("model", 2, "ici"), ("data", 2, "dci")])
for mode in ("hier", "hier-sparse"):
    for prec in ("mixed", "q8"):
        out[f"analytic:real:{mode}:{prec}"] = dryrun.xct_analytic(
            plan4, ReconConfig(precision=prec, comm_mode=mode), topo4,
            fuse=16, iters=2)
ds = DATASETS["xct-brain"]
plan = estimate_plan(
    XCTGeometry(n=ds.n, n_angles=ds.k),
    PartitionConfig(n_data=512, tile=32, rows_per_block=64,
                    nnz_per_stage=64, socket=default_socket(512, 16)))
for mode in ("hier", "sparse", "hier-sparse"):
    out[f"analytic:brain:{mode}"] = dryrun.xct_analytic(
        plan, ReconConfig(precision="mixed_bf16", comm_mode=mode),
        sweep_topology(512), fuse=16, iters=2)
out["socket_sweep"] = dryrun.socket_sweep()
buf = io.StringIO()
sys.argv = ["dryrun", "--socket-sweep"]
with contextlib.redirect_stdout(buf):
    dryrun.main()
out["cli:socket_sweep"] = buf.getvalue()
try:
    dryrun.lower_xct_cell("xct-shale", False)
    out["shale:raises"] = ""
except ValueError as e:
    out["shale:raises"] = str(e)
# xct-shale's cell on the port's layout: 64 data ranks, model 16 x data 4
ds = DATASETS["xct-shale"]
geo = XCTGeometry(n=ds.n, n_angles=ds.k)
plan = estimate_plan(geo, PartitionConfig(
    n_data=64, tile=32, rows_per_block=64, nnz_per_stage=64,
    socket=default_socket(64, 16)))
an = dryrun.xct_analytic(
    plan, ReconConfig(precision="mixed_bf16", comm_mode="hier", fuse=16,
                      use_ref=True),
    Topology.from_sizes([("model", 16, "ici"), ("data", 4, "ici")]), 16, 2)
out["shale:analytic"] = an
out["shale:roofline"] = roofline(
    an["flops_dev"], an["hbm_dev"], an["ici_dev"], 0.0,
    4.0 * geo.n_rays * 1.195 * ds.n * 16 * 2 / 64,
    hbm_bytes_analytic=an["hbm_dev"])
with open(path, "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module", autouse=True)
def ref(tmp_path_factory):
    """The reference's numbers, computed in a subprocess started with the
    module's first case, which runs beside the port's cases until the
    first one reads them."""
    path = tmp_path_factory.mktemp("ref") / "out.json"
    env = dict(os.environ, PYTHONPATH=_SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_SIDE, str(path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    cache = {}

    def get(key):
        if not cache:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
            cache.update(json.loads(path.read_text()))
        return cache[key]

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def plans():
    geo = XCTGeometry(n=32, n_angles=48)
    a = build_system_matrix(geo)
    return {
        1: build_plan(geo, PartitionConfig(n_data=1, **SMALL), a=a),
        4: build_plan(geo, PartitionConfig(n_data=4, socket=2, **SMALL),
                      a=a),
    }


def _fake_topology():
    return Topology.from_mesh(tmesh.make_fake_mesh((2, 2), ("data", "model")),
                              data_axes=("model", "data"), batch_axes=())


# --------------------------------------------------------------------- #
# configs, sweep, roofline, mesh
# --------------------------------------------------------------------- #
def test_datasets_equal_the_reference_field_for_field():
    assert XCT_DATASETS is DATASETS
    assert list(DATASETS) == list(JDATASETS)
    for name, ds in DATASETS.items():
        assert dataclasses.asdict(ds) == dataclasses.asdict(JDATASETS[name])


@pytest.mark.parametrize("wire", ["native", "q8"])
@pytest.mark.parametrize("dma", ["coalesced", "per_row"])
@pytest.mark.parametrize("staging", ["fused", "gather"])
@pytest.mark.parametrize("precision", ["mixed", "q8"])
def test_sweep_rows_equal_the_reference(precision, staging, dma, wire):
    """Priced with the reference's rates and per-copy overhead, every row
    of the §Perf sweep is the reference's, exactly."""
    kw = dict(iters=2, staging=staging, dma=dma, precision=precision,
              wire=wire)
    got = xct_perf.sweep(**kw, hw=REF_RATES,
                         per_copy_overhead=jtraffic.PER_COPY_OVERHEAD_S)
    assert got == jperf.sweep(**kw)


def test_sweep_h100_rates_reprice_the_same_bytes_and_flops():
    """With its own rates (the H100's and its measured per-copy overhead)
    the sweep prices the reference's FLOPs, bytes and issues anew."""
    from repro_torch.kernels.traffic import PER_COPY_OVERHEAD_S

    got, want = xct_perf.sweep(iters=2), jperf.sweep(iters=2)
    assert len(got) == len(want) == 20
    hw, jhw = hardware.HW, jhlo.HW
    for g, w in zip(got, want):
        assert (g["mode"], g["fuse"], g["dma_issues"]) == (
            w["mode"], w["fuse"], w["dma_issues"])
        assert g["t_compute"] * hw.peak_flops == pytest.approx(
            w["t_compute"] * jhw.peak_flops, rel=1e-12)
        hbm = (w["t_memory"] - w["dma_issues"] * jtraffic.PER_COPY_OVERHEAD_S
               ) * jhw.hbm_bw
        assert g["t_memory"] == pytest.approx(
            g["dma_issues"] * PER_COPY_OVERHEAD_S + hbm / hw.hbm_bw,
            rel=1e-9)
        assert g["t_memory"] != w["t_memory"]


def test_sweep_main_writes_its_json(tmp_path, capsys):
    out = tmp_path / "sweep.json"
    assert xct_perf.main(["--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert rows == json.loads(json.dumps(xct_perf.sweep()))
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].split() == ["mode", "F", "comp_s", "mem_s", "coll_s",
                                  "dom", "ms/slice", "frac"]
    assert len(printed) == 1 + len(rows)


@pytest.mark.parametrize("analytic", [None, 3.1e9])
@pytest.mark.parametrize("terms", [(2e12, 4e9, 3e8, 0.0, 1e12),
                                   (1e10, 9e10, 2e9, 4e8, 8e9),
                                   (0.0, 1e6, 0.0, 0.0, 0.0)])
def test_roofline_equals_the_reference(terms, analytic):
    kw = {} if analytic is None else {"hbm_bytes_analytic": analytic}
    assert roofline.roofline(*terms, hw=REF_RATES, **kw) == jhlo.roofline(
        *terms, **kw)


def test_roofline_table_has_the_reference_form(tmp_path, capsys):
    rows = [{"status": "ok", "arch": "xct-brain", "shape": "cg2x16sl",
             "roofline": roofline.roofline(1e12, 2e12, 3e9, 0.0, 5e11,
                                           hbm_bytes_analytic=2e12)},
            {"status": "error: x", "arch": "xct-shale", "shape": "?"}]
    path = tmp_path / "cells.json"
    path.write_text(json.dumps(rows))
    roofline.emit(str(path))
    out = capsys.readouterr().out
    assert roofline.HEADER in out
    assert "1 ok / 2 cells" in out
    assert roofline.fmt_row(rows[1]).startswith("| xct-shale")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_ladder_is_the_reference_sweep_topology(multi_pod):
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    data = ("model", "data", "pod") if multi_pod else ("model", "data")
    topo = Topology.from_mesh(mesh, data_axes=data, batch_axes=())
    assert topo.describe() == jperf.sweep_topology(mesh.size).describe()
    assert mesh.size == (512 if multi_pod else 256)
    assert [str(d) for d in mesh.devices.flat] == [
        f"cuda:{i}" for i in range(mesh.size)]


def test_placeholder_mesh_binds_only_abstract():
    """A real Reconstructor on placeholder devices raises; it never moves
    to the CPU."""
    plan = estimate_plan(XCTGeometry(n=64, n_angles=48),
                         PartitionConfig(n_data=4, socket=2))
    topo = _fake_topology()
    with pytest.raises(ValueError, match="placeholder"):
        Reconstructor(plan, ReconConfig(), topology=topo)
    with pytest.raises(RuntimeError, match="CUDA"):
        Reconstructor(plan, ReconConfig(), topology=Topology.from_mesh(
            tmesh.DeviceMesh([["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]],
                             ("data", "model")),
            data_axes=("model", "data"), batch_axes=()))
    rec = Reconstructor(plan, ReconConfig(), topology=topo, abstract=True)
    with pytest.raises(ValueError, match="abstract"):
        rec.project(np.zeros((plan.geo.n_vox, 16), np.float32))


def test_lower_xct_cell_xct_shale(ref):
    """The cell runs on the CPU (the reference's raises: it binds the
    64-rank plan to all 256 devices); its keys are the reference's with
    the traced collectives, and its analytic model and roofline equal the
    reference's under the reference's rates."""
    rec = dryrun.lower_xct_cell("xct-shale", False, use_ref=False,
                                hw=REF_RATES)
    keys = {"status", "arch", "shape", "mesh", "comm_mode", "compile_s",
            "p_data", "memory", "flops_per_dev", "hbm_bytes_per_dev",
            "ici_bytes_per_dev", "dci_bytes_per_dev", "analytic",
            "roofline"}
    assert set(rec) == keys | {"collectives_traced", "rank0_bytes",
                               "card_bytes"}
    assert (rec["status"], rec["p_data"], rec["shape"]) == (
        "ok", 64, "cg2x64sl")
    assert rec["analytic"] == ref("shale:analytic")
    assert rec["roofline"] == ref("shale:roofline")
    mem = rec["memory"]
    assert {"temp_bytes", "arg_bytes"} <= set(mem)
    assert rec["rank0_bytes"] == mem["rank0"]["peak"] > mem["rank0"][
        "argument"]
    assert rec["card_bytes"] == hardware.HW.hbm_bytes == 80e9
    coll = rec["collectives_traced"]
    assert {"ops", "ici_bytes", "dci_bytes", "by_kind"} <= set(coll)
    assert coll["dci_bytes"] == 0 and coll["ici_bytes"] > 0
    # 4 batch groups on one pod, each on its own columns: nothing moves
    # a group's vectors, and rank 0 holds no more than the other ranks
    assert not set(coll["by_kind"]) & {"batch", "other", "split", "gather"}
    assert mem["rank0"]["peak"] <= 1.05 * mem["peak_others"], mem
    assert "P_d=64" in ref("shale:raises")


# --------------------------------------------------------------------- #
# the dry run's cost model, against the reference
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["hier", "hier-sparse"])
@pytest.mark.parametrize("precision", ["mixed", "q8"])
def test_xct_analytic_equals_the_reference_on_a_real_plan(ref, plans, mode,
                                                           precision):
    topo = Topology.from_sizes([("model", 2, "ici"), ("data", 2, "dci")])
    got = dryrun.xct_analytic(
        plans[4], ReconConfig(precision=precision, comm_mode=mode), topo,
        fuse=16, iters=2)
    assert got == ref(f"analytic:real:{mode}:{precision}")


@pytest.mark.parametrize("mode", ["hier", "sparse", "hier-sparse"])
def test_xct_analytic_equals_the_reference_at_xct_brain(ref, mode):
    ds = DATASETS["xct-brain"]
    plan = estimate_plan(
        XCTGeometry(n=ds.n, n_angles=ds.k),
        PartitionConfig(n_data=512, tile=32, rows_per_block=64,
                        nnz_per_stage=64, socket=default_socket(512, 16)))
    got = dryrun.xct_analytic(
        plan, ReconConfig(precision="mixed_bf16", comm_mode=mode),
        xct_perf.sweep_topology(512), fuse=16, iters=2)
    assert got == ref(f"analytic:brain:{mode}")


def test_socket_sweep_and_its_cli_equal_the_reference(ref, capsys):
    assert dryrun.socket_sweep() == ref("socket_sweep")
    assert dryrun.main(["--socket-sweep"]) == 0
    printed = capsys.readouterr().out
    assert json.loads(printed) == json.loads(ref("cli:socket_sweep"))


@pytest.mark.parametrize("flags", [["--arch", "qwen3-4b"],
                                   ["--all"], ["--shape", "train_4k"]])
def test_lm_cells_run(flags, capsys):
    """The LM flags trace their cells (``--arch``: every shape of it,
    ``--shape``: every arch at it), here at SMOKE widths: exit 0, every
    record ``ok`` but the long-context cells of full-attention archs,
    which the reference skips too."""
    assert dryrun.main(flags + ["--smoke"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert recs
    for r in recs:
        assert r["status"] == "ok" or (r["status"] ==
                                       "skipped(full-attention)"
                                       and r["shape"] == "long_500k"), r
        assert r["arch"] == flags[1] if flags[0] == "--arch" else True
    n_arch = len(dryrun.ARCH_NAMES)
    assert len(recs) == {"--arch": 4, "--all": 4 * n_arch,
                         "--shape": n_arch}[flags[0]]


def test_cli_of_the_dry_run_in_a_process_of_its_own():
    """``python -m repro_torch.launch.dryrun --arch ... --shape ...``
    prints an ``ok`` record and imports nothing of JAX."""
    env = dict(os.environ, PYTHONPATH=_SRC)
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy\n"
         "sys.argv = ['dryrun', '--arch', 'qwen3-4b', '--shape', "
         "'train_4k', '--smoke']\n"
         "try:\n"
         "    runpy.run_module('repro_torch.launch.dryrun', "
         "run_name='__main__')\n"
         "except SystemExit as e:\n"
         "    assert 'jax' not in sys.modules\n"
         "    raise\n"],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    rec = json.loads(r.stdout.splitlines()[-1])
    assert rec["status"] == "ok" and rec["arch"] == "qwen3-4b"
    assert rec["cost_source"] == "trace(every layer)"


# --------------------------------------------------------------------- #
# lower_cg on fake tensors
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def lowered(plans):
    """One rank (``hier``) and a fake 2x2 mesh (``hier-sparse``), mixed,
    the kernel path, with the kernel's fake counted and its launch
    forbidden."""
    calls = []
    band, launch = txs._band_like, txs._launch

    def counted(inds, x):
        calls.append(inds.shape)
        return band(inds, x)

    def forbidden(*a, **k):
        raise AssertionError("a kernel launched under the trace")

    txs._band_like, txs._launch = counted, forbidden
    try:
        out = {}
        for key, n, mode in (("one", 1, "hier"), ("mesh", 4, "hier-sparse")):
            cfg = ReconConfig(precision="mixed", comm_mode=mode, fuse=16)
            kw = {} if n == 1 else {"topology": _fake_topology()}
            rec = Reconstructor(plans[n], cfg, abstract=True, **kw)
            out[key] = (rec, rec.lower_cg(16, iters=2), len(calls))
            calls.clear()
    finally:
        txs._band_like, txs._launch = band, launch
    return out


@pytest.mark.parametrize("key,ranks", [("one", 1), ("mesh", 4)])
def test_lower_cg_runs_the_kernels_fakes_only(lowered, key, ranks):
    """2 operators x (iters + 1) applications x one minibatch per rank,
    each through the custom op's fake (a launch would have raised); every
    rank holds its rows of the inputs and the solution, and the residual
    norms, and every rank's peak is at least what it holds."""
    rec, low, fakes = lowered[key]
    assert fakes == 2 * 3 * ranks
    mem = low.memory_analysis()
    for p in range(ranks):
        assert mem.per_rank["input"][p] == \
            (rec.sino_pad + rec.tomo_pad) // ranks * 16 * 4
        assert mem.per_rank["output"][p] == \
            (rec.tomo_pad // ranks * 16 + 2 * 16) * 4
    r0 = mem.rank0
    assert r0["peak"] >= r0["argument"] + r0["input"] + r0["output"]
    assert mem.peak_size_in_bytes == max(mem.per_rank["peak"])
    assert (mem.per_rank["peak"] >= mem.per_rank["argument"]).all()
    assert (mem.per_rank["temp"][1:] > 0).all()
    # every copy between devices carries its exchange's tag (one rank
    # has its vectors where they are and copies nothing); the vectors
    # stay sharded, so nothing splits or gathers them
    kinds = set(low.collectives()["by_kind"])
    assert kinds == ({"reduce-scatter", "all-to-all", "pmax", "psum"}
                     if ranks > 1 else set()), kinds


@pytest.mark.parametrize("key,ranks,mode", [("one", 1, "hier"),
                                            ("mesh", 4, "hier-sparse")])
def test_lower_cg_arguments_equal_the_cpu_bind(lowered, plans, key, ranks,
                                               mode):
    """Rank by rank, the abstract argument bytes are the bytes of the
    tensors a real Reconstructor binds (here on the CPU)."""
    cfg = ReconConfig(precision="mixed", comm_mode=mode, fuse=16)
    kw = {"device": "cpu"} if ranks == 1 else {
        "topology": Topology.from_mesh(
            tmesh.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4),
            data_axes=("model", "data"), batch_axes=())}
    real = Reconstructor(plans[ranks], cfg, **kw)
    _, low, _ = lowered[key]
    assert list(low.memory_analysis().per_rank["argument"]) == \
        real.argument_bytes()
    assert low.argument == real.argument_bytes()


@pytest.mark.parametrize("key,ranks,mode", [("one", 1, "hier"),
                                            ("mesh", 4, "hier-sparse")])
def test_lower_cg_arguments_against_the_reference(ref, lowered, plans, key,
                                                  ranks, mode):
    """The reference's per-device argument bytes (XLA's memory analysis of
    the same CG, kernel path) differ from the port's only by the layout
    differences below, computed from the shapes; nothing is left over."""
    rec, low, _ = lowered[key]
    plan = plans[ranks]
    want = ref("args:" + key)
    for p in range(ranks):
        arrs = rec._arrays[p]
        diff = {}
        for name, op in (("proj", plan.proj), ("back", plan.back)):
            # the class-sorted kernel reads winsegs/segoff and takes BUF
            # from winmap's shape: XLA drops the unread winmap, the port
            # binds it
            diff[name + " winmap"] = op.winmap[p].nbytes
            smap = recv = None
            if mode == "hier-sparse":
                smap, _, recv, _, _ = build_hier_sparse_exchange(op, 2)
            int32 = {"row_map": op.row_map[p].size,
                     "smap": None if smap is None else smap[p].size,
                     "recv": None if recv is None else recv[p].size}
            for k, t in arrs.items():
                table = k[len(name) + 1:]
                if not k.startswith(name + "_"):
                    continue
                if isinstance(t, ScatterPasses):
                    passes = sum(x.untyped_storage().nbytes()
                                 for x in (t.first, t.dst, t.src))
                    # int64 occurrence passes where the reference binds
                    # the int32 table; the sparse modes never read
                    # row_map, so XLA drops it there
                    unread = table == "row_map" and mode == "hier-sparse"
                    diff[f"{name} {table}"] = passes - (
                        0 if unread else 4 * int32[table])
                elif table == "send":  # int64 where the reference's int32
                    diff[f"{name} send"] = t.untyped_storage().nbytes() // 2
        # the reference's y and x0 shards are arguments; the port's are
        # inputs (input_size_in_bytes)
        diff["y, x0"] = -(rec.sino_pad // ranks + rec.tomo_pad // ranks) \
            * 16 * 4
        assert low.argument[p] - want - sum(diff.values()) == 0, diff


def test_lower_cg_abstract_estimate_plan_binds_one_pass_per_table():
    plan = estimate_plan(XCTGeometry(n=64, n_angles=48),
                         PartitionConfig(n_data=4, socket=2))
    for mode in ("hier", "sparse", "hier-sparse"):
        rec = Reconstructor(plan, ReconConfig(comm_mode=mode),
                            topology=_fake_topology(), abstract=True)
        depths = rec.scatter_depths()
        assert depths and all(d == (1, 4) for d in depths.values()), depths
        low = rec.lower_cg(16, iters=1)
        assert any("one pass" in n for n in low.notes)
        coll = low.collectives()
        kinds = set(coll["by_kind"])
        assert {"psum", "pmax"} <= kinds
        assert not kinds & {"other", "split", "gather"}, kinds
        assert coll["ops"] == sum(k["count"]
                                  for k in coll["by_kind"].values())


def test_spmm_wrappers_take_the_custom_ops_fakes_on_meta_tensors():
    """On meta tensors both SpMM entries dispatch the registered custom
    op, whose fake gives the [B, R, F] f32 band; nothing launches or
    counts."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    meta = dict(device="meta")
    b, s, r, k, buf, f = 3, 2, 16, 8, 32, 5
    inds = torch.empty((b, s, r, k), dtype=torch.int16, **meta)
    vals = torch.empty((b, s, r, k), dtype=torch.float16, **meta)
    winmap = torch.empty((b, s, buf), dtype=torch.int32, **meta)
    x = torch.empty((64, f), dtype=torch.float16, **meta)
    window = torch.empty((b, s, buf, f), dtype=torch.float16, **meta)
    txs.reset_launches()
    with Seen() as seen:
        out = txs.spmm_block_ell(inds, vals, winmap, x)
        staged = txs.spmm_block_ell_staged(inds, vals, window)
    for t in (out, staged):
        assert t.is_meta and t.dtype == torch.float32
        assert tuple(t.shape) == (b, r, f)
    assert seen.ops == ["repro_torch.spmm_block_ell.default",
                        "repro_torch.spmm_block_ell_staged.default"]
    assert not any(txs.LAUNCHES.values())
    assert txs.spmm_block_ell.launches == 0
    assert txs.spmm_block_ell_staged.launches == 0


@pytest.mark.parametrize("name", [
    "repro_torch.launch.dryrun", "repro_torch.launch.xct_perf",
    "repro_torch.launch.roofline", "repro_torch.launch.mesh",
    "repro_torch.core.lowering", "repro_torch.placement",
])
def test_module_doctests(name):
    result = doctest.testmod(importlib.import_module(name))
    assert result.attempted > 0 and result.failed == 0
