"""End-to-end reconstruction with the PyTorch port on the CPU: the five
system tests of ``test_recon_system.py`` with their tolerances, the port
against the JAX ``Reconstructor`` on the same plan, and the CLI."""
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
    the port and f32 in the JAX package (no x64): f32 tolerance."""
    _, _, plan = small_system
    _, y = phantom32
    x, res = _rec(port_plan, precision=precision, **extra).reconstruct(
        y, iters=5
    )
    jrec = JaxReconstructor(
        plan, cfg=JaxConfig(precision=precision, comm_mode="rs", fuse=2,
                            **extra)
    )
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


def test_nonfinite_solve_raises(phantom32, port_plan):
    _, y = phantom32
    bad = y.copy()
    bad[3, 1] = np.nan
    with pytest.raises(NonFiniteSolveError):
        _rec(port_plan, precision="single").reconstruct(bad, iters=2)


def test_unported_configurations_raise(small_system, phantom32, port_plan):
    """What the port still lacks raises, naming ROADMAP.md; the sparse
    modes, the int8 wire, ``n_data > 1`` over a mesh and the staging, dma
    and quantized configurations that once raised now solve, and the
    reference's checks raise its ``ValueError``."""
    geo, a, _ = small_system
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
    # slice batches over a batch axis are not ported
    batched = Topology.from_mesh(
        make_mesh((2, 1), ("data", "model"), devices=["cpu"] * 2)
    )
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Reconstructor(port_plan, ReconConfig(fuse=2), topology=batched)
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
    "argv", [["--stream"], ["--trace", "t.json"], ["--tune-dir", "d"]],
)
def test_cli_rejects_unported_options(argv, capsys):
    from repro_torch.launch import recon as cli

    with pytest.raises(SystemExit) as ei:
        cli.main(["--device", "cpu"] + argv)
    assert ei.value.code == 2
    assert "ROADMAP.md" in capsys.readouterr().err


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
