"""End-to-end reconstruction with the PyTorch port on the CPU: the five
system tests of ``test_recon_system.py`` with their tolerances, the port
against the JAX ``Reconstructor`` on the same plan, and the CLI."""
import json

import numpy as np
import pytest
import torch

from repro.core.recon import ReconConfig as JaxConfig
from repro.core.recon import Reconstructor as JaxReconstructor
from repro_torch.core import geometry as tgeo
from repro_torch.core import partition as tpart
from repro_torch.core.recon import ReconConfig, Reconstructor
from repro_torch.dist import Topology
from repro_torch.launch.mesh import make_mesh
from repro_torch.resil.errors import NonFiniteSolveError


@pytest.fixture(scope="module")
def port_plan(small_system):
    """The fixture's reference plan, carried into the port."""
    geo, _, plan = small_system
    return tpart.plan_from_arrays(
        tpart.plan_to_arrays(plan),
        tgeo.XCTGeometry(geo.n, geo.n_angles),
        tpart.PartitionConfig(tile=4, rows_per_block=16, nnz_per_stage=16),
    )


def _rec(plan, **kw):
    kw.setdefault("comm_mode", "rs")
    kw.setdefault("fuse", 2)
    return Reconstructor(plan, cfg=ReconConfig(**kw), device="cpu")


def _rel(x, x_true):
    return np.linalg.norm(x - x_true, axis=0) / np.linalg.norm(x_true, axis=0)


def test_project_backproject_match_scipy(small_system, phantom32, port_plan):
    _, a, _ = small_system
    x, y = phantom32
    rec = _rec(port_plan, precision="single")
    np.testing.assert_allclose(rec.project(x), a @ x, rtol=2e-4, atol=2e-4)
    ref = a.T @ y
    np.testing.assert_allclose(
        rec.backproject(y), ref, rtol=2e-4, atol=2e-4 * np.abs(ref).max()
    )


def test_reconstruction_converges(phantom32, port_plan):
    x_true, y = phantom32
    x, res = _rec(port_plan, precision="single").reconstruct(y, iters=25)
    assert _rel(x, x_true).mean() < 0.2
    assert res[-1, 0] < 0.05 * res[0, 0]


@pytest.mark.parametrize("precision",
                         ["mixed", "half", "mixed_bf16", "q8", "fp8"])
def test_reduced_precision_tracks_single(phantom32, port_plan, precision):
    x_true, y = phantom32
    errs = {}
    for prec in ("single", precision):
        x, _ = _rec(port_plan, precision=prec).reconstruct(y, iters=15)
        errs[prec] = _rel(x, x_true).mean()
    assert errs[precision] < errs["single"] + 0.03


def test_overlap_pipeline_matches_sync(phantom32, port_plan):
    _, y = phantom32
    outs = [
        _rec(port_plan, precision="single", overlap=ov).reconstruct(
            y, iters=5
        )[0]
        for ov in (False, True)
    ]
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)


def test_oracle_path_matches_kernel_path(phantom32, port_plan):
    _, y = phantom32
    outs = [
        _rec(port_plan, precision="mixed", use_ref=ref).reconstruct(
            y, iters=5
        )[0]
        for ref in (False, True)
    ]
    np.testing.assert_allclose(outs[0], outs[1], rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize(
    "precision,tol,extra",
    [pytest.param("single", 1e-4, {}, id="single-0.0001"),
     pytest.param("double", 1e-4, {}, id="double-0.0001"),
     pytest.param("mixed", 5e-3, {}, id="mixed-0.005"),
     pytest.param("half", 5e-3, {}, id="half-0.005"),
     pytest.param("bf16", 5e-3, {}, id="bf16-0.005"),
     pytest.param("mixed_bf16", 5e-3, {}, id="mixed_bf16-0.005"),
     pytest.param("q8", 5e-3, {}, id="q8-0.005"),
     pytest.param("fp8", 5e-3, {}, id="fp8-0.005"),
     pytest.param("mixed", 5e-3, {"staging": "gather"},
                  id="mixed-gather-0.005"),
     pytest.param("mixed", 5e-3, {"dma": "per_row"},
                  id="mixed-per_row-0.005")],
)
def test_port_matches_jax_reconstructor(small_system, phantom32, port_plan,
                                        precision, tol, extra):
    """Same plan, same sinogram, 5 iterations.  ``double`` is true f64 in
    the port and f32 in the JAX package (no x64): f32 tolerance.  Under
    ``single`` and ``mixed`` one projection and one backprojection equal
    the JAX kernel path's bit for bit; the solve differs in the last
    bits, because the CG's row sums reduce in another order than XLA's
    (ROADMAP.md, queue 3)."""
    _, _, plan = small_system
    x_true, y = phantom32
    port = _rec(port_plan, precision=precision, **extra)
    x, res = port.reconstruct(y, iters=5)
    jrec = JaxReconstructor(
        plan, cfg=JaxConfig(precision=precision, comm_mode="rs", fuse=2,
                            **extra)
    )
    if precision in ("single", "mixed"):
        for fn, inp in (("project", x_true), ("backproject", y)):
            np.testing.assert_array_equal(getattr(port, fn)(inp),
                                          np.asarray(getattr(jrec, fn)(inp)))
    jx, jres = jrec.reconstruct(y, iters=5)
    jx = np.asarray(jx)
    np.testing.assert_allclose(x, jx, rtol=tol,
                               atol=tol * np.abs(jx).max())
    np.testing.assert_allclose(res, np.asarray(jres), rtol=tol,
                               atol=tol * np.abs(jres).max())


@pytest.mark.parametrize("precision", ["q8", "fp8"])
def test_bound_quantized_arrays_match_jax(small_system, port_plan,
                                          precision):
    """The packed values and exponents bound at init are the reference's
    byte for byte (``Reconstructor._arrays``), for both operators."""
    _, _, plan = small_system
    rec = _rec(port_plan, precision=precision)
    jrec = JaxReconstructor(
        plan, cfg=JaxConfig(precision=precision, comm_mode="rs", fuse=2)
    )
    (arrays,) = rec._arrays  # one rank
    for name in ("proj", "back"):
        vals = arrays[f"{name}_vals"]
        scale = arrays[f"{name}_vscale"]
        assert vals.dtype == rec.policy.vals_dtype
        assert scale.dtype == torch.int32
        jvals = np.asarray(jrec._arrays[f"{name}_vals"])[0]
        jscale = np.asarray(jrec._arrays[f"{name}_vscale"])[0]
        assert vals.shape == jvals.shape and scale.shape == jscale.shape
        np.testing.assert_array_equal(vals.view(torch.uint8).numpy(),
                                      jvals.view(np.uint8))
        np.testing.assert_array_equal(scale.numpy(), jscale)


def test_staging_modes_give_the_default_bits(phantom32, port_plan):
    """``dma="per_row"``, ``staging="gather"`` and the default stage the
    same windows, so the solves agree bit for bit (q8 included)."""
    _, y = phantom32
    for precision in ("mixed", "q8"):
        base = _rec(port_plan, precision=precision).reconstruct(y, iters=3)
        for extra in ({"dma": "per_row"}, {"staging": "gather"}):
            x, res = _rec(port_plan, precision=precision,
                          **extra).reconstruct(y, iters=3)
            np.testing.assert_array_equal(x, base[0])
            np.testing.assert_array_equal(res, base[1])


def test_stage_sino_and_x0(phantom32, port_plan):
    _, y = phantom32
    rec = _rec(port_plan, precision="single")
    staged = rec.stage_sino(y)
    assert staged.y.device.type == "cpu" and staged.n_slices == 4
    assert np.log2(staged.scale).round().tolist() == np.log2(
        staged.scale
    ).tolist()
    x1, r1 = rec.reconstruct(staged, iters=3)
    x2, r2 = rec.reconstruct(y, iters=3)
    np.testing.assert_array_equal(x1, x2)
    # a warm start at the solution keeps the residual at the start's
    x3, r3 = rec.reconstruct(y, iters=2, x0_nat=x2)
    assert r3[0, 0] <= r2[-1, 0] * 1.01


# sha256 (first 16 hex digits) of x.tobytes() + res.tobytes() of 8-iteration
# solves on the port's own n=32 plan, taken on the CPU before the CG vectors
# were sharded per rank: "batch" is two batch groups of one rank each
PARENT_SOLVES = {"single": "062fbbd07844c3ab", "mixed": "ef8ba932dc50f8cc",
                 "q8": "d565b5f0dae86183", "batch": "ef8ba932dc50f8cc"}


@pytest.mark.parametrize("case", sorted(PARENT_SOLVES))
def test_one_rank_solves_keep_the_parent_bits(case):
    """At one rank per group the sharded vectors are one block each, the
    CG dots one f64 sum each: every solve keeps its bits."""
    import hashlib

    from repro_torch.data.phantom import phantom_slices

    geo = tgeo.XCTGeometry(n=32, n_angles=48)
    a = tgeo.build_system_matrix(geo)
    plan = tpart.build_plan(geo, tpart.PartitionConfig(
        tile=4, rows_per_block=16, nnz_per_stage=16), a=a)
    y = (a @ phantom_slices(32, 4)).astype(np.float32)
    if case == "batch":
        topo = Topology.from_mesh(
            make_mesh((2, 1), ("data", "model"), devices=["cpu"] * 2),
            data_axes=("model",), batch_axes=("data",))
        rec = Reconstructor(plan, ReconConfig(precision="mixed", fuse=2),
                            topology=topo)
    else:
        rec = _rec(plan, precision=case)
    x, res = rec.reconstruct(y, iters=8)
    digest = hashlib.sha256(x.tobytes() + res.tobytes()).hexdigest()
    assert digest[:16] == PARENT_SOLVES[case]


def test_vectors_stay_sharded_per_rank(phantom32):
    """Four ranks: the staged sinogram, the iterate and the CG dots are
    sharded by rank (rank p's rows of each vector; the dots the same on
    every block); four ranks sharing one device share one block, and
    the host joins the solution once."""
    from repro_torch.core.sharded import Sharded

    geo = tgeo.XCTGeometry(n=32, n_angles=48)
    a = tgeo.build_system_matrix(geo)
    plan = tpart.build_plan(geo, tpart.PartitionConfig(
        n_data=4, tile=4, rows_per_block=16, nnz_per_stage=16), a=a)
    topo = Topology.from_mesh(
        make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4),
        data_axes=("model", "data"), batch_axes=())
    rec = Reconstructor(plan, ReconConfig(precision="single", comm_mode="hier",
                                          fuse=2), topology=topo)
    _, y = phantom32
    staged = rec.stage_sino(y)
    assert isinstance(staged.y, Sharded) and staged.y.ranks == (4,)
    assert [tuple(t.shape) for t in staged.y.rank_views()] == \
        [(plan.proj.rows_per_dev, 4)] * 4
    np.testing.assert_array_equal(staged.y.cpu().numpy(),
                                  rec.pack_sino(y) * staged.scale)
    proj, back, dot = rec._make_ops()
    r = staged.y
    s = back(r)
    assert [tuple(t.shape) for t in s.rank_views()] == \
        [(plan.back.rows_per_dev, 4)] * 4
    assert [tuple(t.shape) for t in proj(s).rank_views()] == \
        [(plan.proj.rows_per_dev, 4)] * 4
    gamma = dot(s, s)
    whole = s.cpu().to(torch.float64)
    want = (whole * whole).sum(0).to(torch.float32)
    torch.testing.assert_close(gamma.parts[0], want, rtol=1e-6, atol=0)
    x, res = rec._solve(staged.y, rec._shard(np.zeros((rec.tomo_pad, 4),
                                                      np.float32)), 3)
    assert x.ranks == res.ranks == (4,)
    assert rec._download(res.first_ranks()).shape == (3, 4)
    # one block per run of ranks on a device: four distinct devices
    # would give four blocks (the abstract trace's placeholders do)
    assert rec._runs(0) == [(torch.device("cpu"), 4)]


def test_nonfinite_solve_raises(phantom32, port_plan):
    _, y = phantom32
    bad = y.copy()
    bad[3, 1] = np.nan
    with pytest.raises(NonFiniteSolveError):
        _rec(port_plan, precision="single").reconstruct(bad, iters=2)


def test_unported_configurations_raise(small_system, phantom32, port_plan):
    """The sparse modes, the int8 wire, ``n_data > 1`` over a mesh, batch
    axes of size > 1 and the staging, dma and quantized configurations
    that once raised now solve, and the reference's checks raise its
    ``ValueError``."""
    geo, a, plan = small_system
    x_true, y = phantom32

    def solves(rec):
        x, res = rec.reconstruct(y, iters=8)
        assert x.shape == x_true.shape and np.isfinite(x).all()
        assert (res[-1] < res[0]).all()

    # one rank: the sparse modes run on their P=1 tables
    for kw in (dict(comm_mode="sparse"), dict(comm_mode="hier-sparse"),
               dict(comm_mode="hier-sparse", wire="q8"),
               dict(staging="gather"), dict(dma="per_row"),
               dict(precision="q8")):
        solves(_rec(port_plan, **kw))
    # the int8 wire compresses the hier-sparse hop only (the reference's
    # check); _rec's default mode is "rs"
    with pytest.raises(ValueError, match="wire='q8'"):
        _rec(port_plan, wire="q8")
    for kw in (dict(staging="bogus"), dict(dma="bogus"),
               dict(comm_mode="bogus"), dict(wire="bogus")):
        with pytest.raises(ValueError, match="unknown"):
            _rec(port_plan, **kw)
    multi = tpart.build_plan(
        tgeo.XCTGeometry(geo.n, geo.n_angles),
        tpart.PartitionConfig(n_data=2, tile=4, rows_per_block=16,
                              nnz_per_stage=16),
        a=a,
    )
    # without a topology there is one rank: the plan's two shards do not
    # fit it
    with pytest.raises(ValueError, match="P_d=2"):
        _rec(multi)
    two = Topology.from_mesh(
        make_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2)
    )
    for mode in ("rs", "hier-sparse"):
        solves(Reconstructor(multi, ReconConfig(comm_mode=mode, fuse=2),
                             topology=two))
    # a topology of the wrong size for the plan
    with pytest.raises(ValueError, match="P_d=1"):
        Reconstructor(port_plan, ReconConfig(fuse=2), topology=two)
    # slice batches over a batch axis: each group of one rank takes two
    # slices, as the reference's batch shards do.  Its operators are the
    # unbatched minibatch's, bit for bit, and so is its solve; against
    # the reference the solve is held at the mixed tolerance
    batched = Topology.from_mesh(
        make_mesh((2, 1), ("data", "model"), devices=["cpu"] * 2)
    )
    brec = Reconstructor(port_plan, ReconConfig(fuse=2), topology=batched)
    assert brec.n_batch == 2 and len(brec.groups) == 2
    one = _rec(port_plan, comm_mode="hier")
    for fn, inp in (("project", x_true), ("backproject", y)):
        np.testing.assert_array_equal(getattr(brec, fn)(inp),
                                      getattr(one, fn)(inp))
    xb, rb = brec.reconstruct(y, iters=8)
    # the CG dots sum their rows in f64, so the column count does not
    # reach the solve's bits: a group's solve is the one-group solve's
    xo, ro = one.reconstruct(y, iters=8)
    np.testing.assert_array_equal(xb, xo)
    np.testing.assert_array_equal(rb, ro)
    jx, jres = JaxReconstructor(
        plan, cfg=JaxConfig(comm_mode="hier", fuse=2)).reconstruct(y, iters=8)
    np.testing.assert_allclose(xb, np.asarray(jx), rtol=5e-3,
                               atol=5e-3 * np.abs(np.asarray(jx)).max())
    np.testing.assert_allclose(rb, np.asarray(jres), rtol=5e-3,
                               atol=5e-3 * np.abs(np.asarray(jres)).max())
    with pytest.raises(ValueError, match="batch x fuse = 4"):
        brec.project(np.zeros((geo.n_vox, 2), np.float32))
    for mode in ("direct", "rs", "hier", "sparse", "hier-sparse"):
        assert _rec(port_plan, comm_mode=mode).cfg.comm_mode == mode
    with pytest.raises(ValueError, match="multiple"):
        _rec(port_plan).project(np.zeros((geo.n_vox, 3), np.float32))


def test_default_device_is_cuda_and_raises_without_a_card(
    port_plan, monkeypatch
):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Reconstructor(port_plan)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Reconstructor(port_plan, device="cuda")
    from repro_torch.launch import recon as cli

    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--n", "16", "--angles", "8", "--slices", "4",
                  "--iters", "1"])


def test_cli_on_cpu(capsys):
    from repro_torch.launch import recon as cli

    x, res = cli.main(
        ["--n", "32", "--angles", "48", "--slices", "4", "--iters", "5",
         "--fuse", "2", "--precision", "single", "--device", "cpu"]
    )
    out = capsys.readouterr().out
    assert "building system matrix (1536 rays x 1024 vox)" in out
    assert "5 CG iters on 4 slices" in out and "rel err mean" in out
    assert x.shape == (1024, 4) and res.shape == (5, 4)
    assert res[-1, 0] < res[0, 0]


@pytest.mark.parametrize(
    # every option of the reference's CLI is ported: the argv the port
    # used to reject (for --tune-dir) now run; a tune dir that holds no
    # passport for this machine leaves the run untuned, as in the
    # reference
    "argv", [["--stream", "--tune-dir", "d"],
             ["--trace", "t.json", "--stream", "--tune-dir", "d"],
             ["--tune-dir", "d"]],
)
def test_cli_rejects_unported_options(argv, capsys, tmp_path, monkeypatch):
    from repro_torch.launch import recon as cli

    monkeypatch.chdir(tmp_path)
    cli.main(["--n", "32", "--angles", "48", "--slices", "4", "--iters",
              "2", "--fuse", "2", "--device", "cpu"] + argv)
    captured = capsys.readouterr()
    assert "not ported" not in captured.out + captured.err
    assert "tuning passport" not in captured.out
    assert ("drift report (threshold" in captured.out) == (
        "--trace" in argv)


@pytest.mark.parametrize("comm", ["hier", "sparse", "hier-sparse", "direct"])
def test_cli_runs_p_data_4_on_cpu(comm, capsys):
    """``--p-data 4`` splits each slice over four ranks sharing the CPU,
    under every ``--comm`` (the sparse modes included)."""
    from repro_torch.launch import recon as cli

    x, res = cli.main(
        ["--n", "32", "--angles", "48", "--slices", "4", "--iters", "5",
         "--fuse", "2", "--precision", "mixed", "--p-data", "4",
         "--comm", comm, "--device", "cpu"]
    )
    out = capsys.readouterr().out
    assert "Topology over 4 devices, batch axes ('data',)" in out
    assert "socket: axis 'model' x4" in out
    assert "5 CG iters on 4 slices" in out
    assert x.shape == (1024, 4) and np.isfinite(x).all()
    assert res[-1, 0] < 0.5 * res[0, 0]


def test_cli_p_data_needs_as_many_cards(monkeypatch):
    """On ``cuda`` the ranks take one card each: too few cards raise and
    say how many were found, before the host build; never the CPU."""
    from repro_torch.launch import recon as cli

    argv = ["--n", "16", "--angles", "8", "--slices", "4", "--iters", "1",
            "--p-data", "4"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(cli, "build_system_matrix", None)  # never reached
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices and 2 are"):
        cli.main(argv)
    with pytest.raises(SystemExit):
        cli.main(["--p-data", "0", "--device", "cpu"])


def test_cli_passes_precision_and_dma(monkeypatch, capsys):
    """``--precision q8 --dma per_row`` reach the solve's ReconConfig."""
    from repro_torch.launch import recon as cli

    built = []

    class Recording(Reconstructor):
        def __init__(self, plan, cfg, device=None):
            built.append(cfg)
            super().__init__(plan, cfg, device)

    monkeypatch.setattr(cli, "Reconstructor", Recording)
    x, res = cli.main(
        ["--n", "32", "--angles", "48", "--slices", "4", "--iters", "5",
         "--fuse", "2", "--precision", "q8", "--dma", "per_row",
         "--device", "cpu"]
    )
    (cfg,) = built
    assert cfg.precision == "q8" and cfg.dma == "per_row"
    assert x.shape == (1024, 4) and np.isfinite(x).all()
    assert res[-1, 0] < res[0, 0]
    assert "5 CG iters on 4 slices" in capsys.readouterr().out


def test_cli_streams_on_cpu(tmp_path, capsys):
    """``--stream --device cpu``: the sinogram simulated into a store,
    drained under a budget of a few slabs, checkpointed, the volume on
    disk equal to the in-memory solve of each slab; a second run with the
    same ``--workdir`` skips every slab; ``--trace`` writes the spans."""
    from repro_torch.launch import recon as cli
    from repro_torch.stream import SlabStore

    argv = ["--n", "32", "--angles", "48", "--slices", "8", "--iters", "5",
            "--fuse", "2", "--precision", "single", "--device", "cpu",
            "--stream", "--mem-budget", "1.7", "--device-upload", "sync",
            "--workdir", str(tmp_path / "w"),
            "--trace", str(tmp_path / "t.json")]
    result, rel = cli.main(argv)
    out = capsys.readouterr().out
    assert "simulating 8 slices" in out and "streamed 8 slices" in out
    assert "drift report (threshold 0.5" in out and "[default])" in out
    assert result.complete and result.y_slab < 8 and len(result.solved) > 1
    assert rel.shape == (8,) and rel.mean() < 0.5
    assert not result.upload_overlapped
    sino = SlabStore.open(str(tmp_path / "w" / "sino"))
    geo = tgeo.XCTGeometry(32, 48)
    plan = tpart.build_plan(geo, tpart.PartitionConfig(),
                            a=tgeo.build_system_matrix(geo))
    rec = Reconstructor(plan, cfg=ReconConfig(precision="single", fuse=2),
                        device="cpu")
    for j0, j1 in result.volume.slabs():
        x, _ = rec.reconstruct(sino.read(j0, j1), iters=5)
        np.testing.assert_array_equal(result.volume.read(j0, j1), x)
    with open(tmp_path / "t.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"stream/slab", "stream/solve", "recon/solve"} <= names
    again, _ = cli.main(argv[:-2])
    assert again.solved == [] and len(again.skipped) == len(result.solved)


def test_cli_stream_exits_3_when_a_slab_is_quarantined(tmp_path, capsys):
    from repro_torch.launch import recon as cli
    from repro_torch.resil import FaultPlan, inject

    plan = FaultPlan(seed=3).add("store/read", "io_error", key=2,
                                 attempts=None)
    with inject.activate(plan):
        with pytest.raises(SystemExit) as ei:
            cli.main(["--n", "32", "--angles", "48", "--slices", "4",
                      "--iters", "3", "--fuse", "2", "--precision",
                      "single", "--device", "cpu", "--stream",
                      "--mem-budget", "1.7", "--max-retries", "0",
                      "--workdir", str(tmp_path / "w")])
    assert ei.value.code == 3
    out = capsys.readouterr().out
    assert "PARTIAL: quarantined slab(s) at j0=[2]" in out
