"""The CUDA kernels against their plain PyTorch versions, on the card.

Row 1 (class-sorted segments), row 2 (unsorted segments), row 3 (one
copy per window row), row 4 (pre-gathered windows) and row 1q (int8 /
fp8 values with per-block exponents) are each held against their plain
version, and rows 2-4 and 1q against row 1's kernel, bit for bit.

Every test here carries the ``gpu`` marker and skips where no CUDA
device is present.  The file imports no JAX, so it runs on the GPU
machine as it is:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernel_gpu.py
"""
import zlib

import numpy as np
import pytest
import torch

from repro_torch.core import precision as tprec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import xct_spmm as txs

SWEEP = [
    # (B, S, R, K, BUF, C, F): tests/test_kernel_spmm.py's sweep
    (1, 1, 8, 8, 16, 64, 1),
    (2, 2, 16, 8, 32, 128, 4),
    (3, 1, 32, 16, 64, 256, 8),
    (2, 3, 8, 32, 40, 96, 16),
    (5, 2, 16, 16, 24, 64, 2),
    # the launch geometry's edges: S=7 is no multiple of the stages in
    # flight (4 at f16) nor of row 4's cluster (2, 4 or 7 CTAs); K=12
    # leaves a partial register chunk and F=3 rows no 16-byte multiple
    (3, 7, 32, 32, 64, 256, 16),
    (2, 9, 16, 12, 24, 64, 3),
    # a random winmap over many columns: about 300 segments a stage, more
    # than row 2's 256 threads read in one pass of descriptors
    (2, 3, 16, 16, 320, 4096, 8),
    # an odd BUF: most stages' winmap rows start off a 16-byte boundary,
    # and no warp instruction of row 3 covers a window's rows evenly
    (2, 5, 16, 16, 37, 128, 16),
    # R=K=64: the autotuner's other block shape (repro_torch.tune)
    (2, 3, 64, 64, 96, 256, 16),
]
# R=32 with fuse=64: wider than the first kernel design took (R*F <= 1024)
WIDE = (3, 5, 32, 16, 48, 128, 64)
TORCH = {"f64": torch.float64, "f32": torch.float32, "f16": torch.float16,
         "bf16": torch.bfloat16, "int8": torch.int8,
         "fp8": torch.float8_e4m3fn}
PAIRS = [("f64", "f64"), ("f32", "f32"), ("f16", "f16"), ("f16", "f32"),
         ("bf16", "bf16"), ("bf16", "f32")]


def _seed(*parts) -> int:
    return zlib.crc32(repr(parts).encode())


def _random_ell(rng, b, s, r, k, buf, c, f):
    inds = rng.integers(0, buf, size=(b, s, r, k)).astype(np.int16)
    vals = (rng.random((b, s, r, k)) * (rng.random((b, s, r, k)) > 0.3)
            ).astype(np.float32)
    winmap = rng.integers(0, c, size=(b, s, buf)).astype(np.int32)
    x = rng.normal(size=(c, f)).astype(np.float32)
    return inds, vals, winmap, x


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the GPU machine")
    return torch.device("cuda")


def _cuda_inputs(shape, storage, dev, seed):
    b, s, r, k, buf, c, f = shape
    rng = np.random.default_rng(seed)
    inds, vals, winmap, x = _random_ell(rng, b, s, r, k, buf, c, f)
    segs, off = tops.sort_segments_by_class(
        tops.winmap_segments(winmap), buf
    )
    st = TORCH[storage]
    return [
        torch.from_numpy(inds).to(dev),
        torch.from_numpy(vals).to(dev, st),
        torch.from_numpy(winmap).to(dev),
        torch.from_numpy(x).to(dev, st),
        torch.from_numpy(segs).to(dev),
        torch.from_numpy(off).to(dev),
    ]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("pair", PAIRS)
def test_cuda_kernel_matches_plain(cuda, shape, pair):
    storage, compute = pair
    inds, vals, winmap, x, segs, off = _cuda_inputs(
        shape, storage, cuda, _seed("cuda", shape, pair)
    )
    before = txs.spmm_block_ell.launches
    out = txs.spmm_block_ell(
        inds, vals, winmap, x, compute_dtype=TORCH[compute],
        winsegs=segs, segoff=off,
    )
    torch.cuda.synchronize()
    assert txs.spmm_block_ell.launches == before + 1
    plain = txs.spmm_block_ell_plain(
        inds, vals, winmap, x, compute_dtype=TORCH[compute]
    )
    tol = 1e-5 if storage in ("f32", "f64") else 2e-2
    torch.testing.assert_close(out, plain, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("pair", PAIRS)
def test_cuda_stagings_match_row1(cuda, shape, pair):
    """Rows 2, 3 and 4 give row 1's kernel output bit for bit and agree
    with their plain versions; each launch lands on its own count."""
    storage, compute = pair
    ct = TORCH[compute]
    inds, vals, winmap, x, segs, off = _cuda_inputs(
        shape, storage, cuda, _seed("stagings", shape, pair)
    )
    unsorted = torch.from_numpy(
        tops.winmap_segments(winmap.cpu().numpy())
    ).to(cuda)
    txs.reset_launches()
    row1 = txs.spmm_block_ell(inds, vals, winmap, x, compute_dtype=ct,
                              winsegs=segs, segoff=off)
    row2 = txs.spmm_block_ell(inds, vals, winmap, x, compute_dtype=ct,
                              winsegs=unsorted)
    row3 = txs.spmm_block_ell(inds, vals, winmap, x, compute_dtype=ct)
    window = x[winmap.long()].contiguous()
    row4 = txs.spmm_block_ell_staged(inds, vals, window, compute_dtype=ct)
    torch.cuda.synchronize()
    assert txs.LAUNCHES == dict(sorted=1, sorted_q=0, unsorted=1,
                                unsorted_q=0, per_row=1, per_row_q=0,
                                staged=1)
    assert txs.spmm_block_ell.launches == 3
    assert txs.spmm_block_ell_staged.launches == 1
    for out in (row2, row3, row4):
        assert torch.equal(out, row1)
    tol = 1e-5 if storage in ("f32", "f64") else 2e-2
    torch.testing.assert_close(
        row2, txs.spmm_block_ell_plain(inds, vals, winmap, x,
                                       compute_dtype=ct, winsegs=unsorted),
        rtol=tol, atol=tol,
    )
    torch.testing.assert_close(
        row4, txs.spmm_block_ell_staged_plain(inds, vals, window,
                                              compute_dtype=ct),
        rtol=tol, atol=tol,
    )


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("staging", ["sorted", "unsorted", "per_row"])
def test_cuda_quantized_kernels(cuda, shape, qdtype, staging):
    """Row 1q on each fused staging equals its plain version and row 1's
    f32/f32 kernel on the dequantized values with the window pre-rounded
    to f16, bit for bit."""
    inds, vals, winmap, x, segs, off = _cuda_inputs(
        shape, "f32", cuda, _seed("q", shape, qdtype, staging)
    )
    q, e = tprec.quantize_block_vals(vals.cpu(), TORCH[qdtype])
    q, e = q.to(cuda), e.to(cuda)
    x16 = x.to(torch.float16)
    unsorted = torch.from_numpy(
        tops.winmap_segments(winmap.cpu().numpy())
    ).to(cuda)
    tables = dict(sorted=dict(winsegs=segs, segoff=off),
                  unsorted=dict(winsegs=unsorted), per_row={})[staging]
    txs.reset_launches()
    out = txs.spmm_block_ell(inds, q, winmap, x16, scales=e, **tables)
    torch.cuda.synchronize()
    assert txs.LAUNCHES[staging + "_q"] == 1
    plain = txs.spmm_block_ell_plain(inds, q, winmap, x16, scales=e,
                                     winsegs=tables.get("winsegs"))
    assert torch.equal(out, plain)
    wide = tprec.dequantize_block_vals(q, e)
    row1 = txs.spmm_block_ell(inds, wide, winmap, x16.float(),
                              winsegs=segs, segoff=off)
    assert torch.equal(out, row1)


@pytest.mark.gpu
@pytest.mark.parametrize("pair", PAIRS)
def test_cuda_wide_fuse_rows_1_1q_4(cuda, pair):
    """R=32, F=64: rows 1 and 4 equal their plain versions and each
    other bit for bit for every pair; row 1q (int8 and fp8) its plain
    version and row 1's f32 kernel on the dequantized values."""
    storage, compute = pair
    ct = TORCH[compute]
    inds, vals, winmap, x, segs, off = _cuda_inputs(
        WIDE, storage, cuda, _seed("wide", pair)
    )
    row1 = txs.spmm_block_ell(inds, vals, winmap, x, compute_dtype=ct,
                              winsegs=segs, segoff=off)
    window = x[winmap.long()].contiguous()
    row4 = txs.spmm_block_ell_staged(inds, vals, window, compute_dtype=ct)
    plain = txs.spmm_block_ell_plain(inds, vals, winmap, x,
                                     compute_dtype=ct)
    torch.cuda.synchronize()
    assert torch.equal(row1, plain)
    assert torch.equal(row4, plain)
    if pair != ("f32", "f32"):
        return
    for qdtype in (torch.int8, torch.float8_e4m3fn):
        q, e = (t.to(cuda) for t in tprec.quantize_block_vals(vals.cpu(),
                                                              qdtype))
        x16 = x.to(torch.float16)
        out = txs.spmm_block_ell(inds, q, winmap, x16, scales=e,
                                 winsegs=segs, segoff=off)
        assert torch.equal(out, txs.spmm_block_ell_plain(
            inds, q, winmap, x16, scales=e))
        assert torch.equal(out, txs.spmm_block_ell(
            inds, tprec.dequantize_block_vals(q, e), winmap, x16.float(),
            winsegs=segs, segoff=off))


def _permuted_table(winmap, rng, extra_pads=5):
    """Row 2's run-order table with its slots shuffled per (b, s), so that
    pads (len 0) sit between the live slots, not only after them."""
    segs = tops.winmap_segments(winmap)
    b, s, nseg, _ = segs.shape
    pads = np.zeros((b, s, extra_pads, 3), np.int32)
    segs = np.concatenate([segs, pads], axis=2)
    order = np.argsort(rng.random(segs.shape[:3]), axis=-1)
    segs = np.take_along_axis(segs, order[..., None], axis=2)
    live = segs[..., 2] > 0
    # some pad precedes some live slot in the table
    assert (np.cumsum(~live, axis=-1) * live).any()
    return segs


def _misaligned(x):
    """``x`` copied to an address 2 bytes past a 16-byte boundary."""
    flat = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    out = flat[1:1 + x.numel()].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 != 0 and out.is_contiguous()
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["bulk", "loops"])
def test_cuda_sorted_routes_give_the_same_bits(cuda, route):
    """Row 1 fills its ring by one bulk copy per segment where window
    rows are 16-byte multiples and ``x`` is 16-byte aligned, else by the
    class loops element by element (here: the same ``x`` 2 bytes off):
    the same windows, so the same bits."""
    for i, shape in enumerate(SWEEP + [WIDE]):
        inds, vals, winmap, x, segs, off = _cuda_inputs(
            shape, "f16", cuda, _seed("route", i)
        )
        if route == "loops":
            x = _misaligned(x)
        out = txs.spmm_block_ell(inds, vals, winmap, x, winsegs=segs,
                                 segoff=off)
        plain = txs.spmm_block_ell_plain(inds, vals, winmap, x)
        torch.cuda.synchronize()
        assert torch.equal(out, plain), shape


@pytest.mark.gpu
@pytest.mark.parametrize("values", ["f16", "int8"])
@pytest.mark.parametrize("case", ["permuted_pads", "odd_buf", "element"])
def test_cuda_rows_2_3_routes_give_row1_bits(cuda, case, values):
    """Rows 2 and 3 equal their plain versions and row 1's kernel bit for
    bit on the inputs that steer their copy routes: a run-order table
    with its slots permuted and pads between live slots, one run long
    enough for a bulk copy (row 2's issuing lanes walk every slot); an
    odd BUF, whose winmap rows are not 16-byte aligned; and the element
    loops, taken for F=3 and for an x 2 bytes off a 16-byte boundary.
    f16/f32 values, and int8 with exponents."""
    rng = np.random.default_rng(_seed("routes", case, values))
    shape = {"permuted_pads": (3, 4, 32, 16, 64, 512, 16),
             "odd_buf": (3, 5, 32, 16, 37, 256, 16),
             "element": (2, 3, 16, 16, 40, 128, 3)}[case]
    inds, vals, winmap, x = _random_ell(rng, *shape)
    if case == "permuted_pads":
        # a run of 20 consecutive columns: a 16-row (512 B) piece
        winmap[:, :, 10:30] = np.arange(100, 120, dtype=np.int32)
    table = (_permuted_table(winmap, rng) if case == "permuted_pads"
             else tops.winmap_segments(winmap))
    segs, off = tops.sort_segments_by_class(tops.winmap_segments(winmap),
                                            shape[4])
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    inds, winmap, table, segs, off = map(t, (inds, winmap, table, segs, off))
    x = t(x).to(torch.float16)
    kw = {}
    if values == "int8":
        vals, kw["scales"] = (u.to(cuda) for u in tprec.quantize_block_vals(
            torch.from_numpy(vals), torch.int8))
    else:
        vals = t(vals).to(torch.float16)
    xs = [x]
    if case == "element":
        # 16-byte rows (F=16) on an x 2 bytes off: the element loops too
        wide = rng.normal(size=(shape[5], 16)).astype(np.float32)
        xs.append(_misaligned(t(wide).to(torch.float16)))
    for xi in xs:
        row1 = txs.spmm_block_ell(inds, vals, winmap, xi, winsegs=segs,
                                  segoff=off, **kw)
        row2 = txs.spmm_block_ell(inds, vals, winmap, xi, winsegs=table,
                                  **kw)
        row3 = txs.spmm_block_ell(inds, vals, winmap, xi, **kw)
        torch.cuda.synchronize()
        plain2 = txs.spmm_block_ell_plain(inds, vals, winmap, xi,
                                          winsegs=table, **kw)
        plain3 = txs.spmm_block_ell_plain(inds, vals, winmap, xi, **kw)
        assert torch.equal(row2, plain2) and torch.equal(row3, plain3)
        assert torch.equal(row2, row1) and torch.equal(row3, row1)


@pytest.mark.gpu
@pytest.mark.parametrize("entry", txs.ENTRIES, ids=lambda e: "_".join(
    str(v).replace("torch.", "") for v in e))
def test_cuda_geometry_fits_the_resident_ctas(cuda, entry):
    """Every entry holds two CTAs per SM (its launch bounds); the ring is
    sized for no more CTAs than its registers let an SM hold, and f16
    windows of the n=512 proj shard leave room for two of them (f64 ones
    for one)."""
    staging, vals, window, compute = entry
    name = txs._entry_name(*entry)
    resident = txs._resident(name)
    assert resident >= 2
    sb = torch.empty((), dtype=window).element_size()
    _, geo = txs._plan(staging, vals, window, compute, 26, 32, 32, 776, 16,
                       sb)
    assert geo == txs.launch_geometry(staging, 26, 32, 32, 776, 16, sb,
                                      resident=resident)
    held = min(resident, 233_472 // (geo.smem + 1024))
    assert held >= (2 if sb == 2 else 1)
    assert geo.smem <= txs.SMEM_LIMIT


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True])
def test_cuda_chunked_gather_matches_row1(cuda, quantized):
    """Row 4 as ``apply_operator(staging="gather")`` runs it: several
    chunks of row-blocks, each one launch of clusters, give the fused
    path's bits."""
    b, s, r, k, buf, c, f = 10, 7, 32, 32, 64, 512, 16
    rng = np.random.default_rng(_seed("chunked", quantized))
    inds, vals, winmap, x = (torch.from_numpy(a).to(cuda) for a in
                             _random_ell(rng, b, s, r, k, buf, c, f))
    kw = {}
    if quantized:
        vals, kw["scales"] = (t.to(cuda) for t in tprec.quantize_block_vals(
            vals.cpu(), torch.int8))
    fused = tops.apply_operator(inds, vals, winmap, x, **kw)
    for bpc in (1, 3, 4, None):
        txs.reset_launches()
        out = tops.apply_operator(inds, vals, winmap, x, staging="gather",
                                  blocks_per_call=bpc, **kw)
        torch.cuda.synchronize()
        assert txs.LAUNCHES["staged"] == (-(-b // bpc) if bpc else 1)
        assert torch.equal(out, fused), bpc


@pytest.mark.gpu
def test_cuda_wrapper_checks(cuda):
    inds, vals, winmap, x, segs, off = _cuda_inputs(
        SWEEP[1], "f32", cuda, 0
    )
    with pytest.raises(ValueError, match="no kernel"):
        txs.spmm_block_ell(inds, vals, winmap, x,
                           compute_dtype=torch.float16,
                           winsegs=segs, segoff=off)
    with pytest.raises(ValueError, match="contiguous"):
        txs.spmm_block_ell(inds, vals, winmap, x.t().contiguous().t(),
                           winsegs=segs, segoff=off)
    # scales select the quantized kernels, which take int8 / fp8 values
    scales = torch.zeros(inds.shape[:2], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="quantized"):
        txs.spmm_block_ell(inds, vals, winmap, x, scales=scales,
                           winsegs=segs, segoff=off)
    q = vals.to(torch.int8)
    with pytest.raises(ValueError, match="scales"):
        txs.spmm_block_ell(inds, q, winmap, x.half(), winsegs=segs,
                           segoff=off)
    with pytest.raises(ValueError, match="window"):
        txs.spmm_block_ell_staged(inds, vals, x)
    # a window too large for one CTA names BUF and F
    big = torch.zeros((1, 1, 4000), dtype=torch.int32, device=cuda)
    bsegs, boff = (
        torch.from_numpy(t).to(cuda) for t in tops.sort_segments_by_class(
            tops.winmap_segments(np.arange(4000, dtype=np.int32)[None, None]),
            4000,
        )
    )
    xb = torch.zeros((4000, 16), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="BUF=4000, F=16"):
        txs.spmm_block_ell(inds[:1, :1], vals[:1, :1], big, xb,
                           winsegs=bsegs, segoff=boff)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "precision,extra",
    [("single", {}), ("mixed", {}), ("double", {}), ("q8", {}), ("fp8", {}),
     ("mixed", {"dma": "per_row"}), ("mixed", {"staging": "gather"})],
)
def test_cuda_reconstructor_matches_cpu(cuda, precision, extra):
    """The whole solve on the card goes through the path's kernel and
    agrees with the same solve on the CPU (plain versions)."""
    from repro_torch.core.geometry import XCTGeometry, build_system_matrix
    from repro_torch.core.partition import PartitionConfig, build_plan
    from repro_torch.core.recon import ReconConfig, Reconstructor
    from repro_torch.data.phantom import phantom_slices

    geo = XCTGeometry(n=32, n_angles=48)
    a = build_system_matrix(geo)
    plan = build_plan(geo, PartitionConfig(tile=4, rows_per_block=16,
                                           nnz_per_stage=16), a=a)
    x_true = phantom_slices(32, 4)
    y = (a @ x_true).astype(np.float32)
    cfg = ReconConfig(precision=precision, comm_mode="rs", fuse=2, **extra)
    txs.reset_launches()
    xg, rg = Reconstructor(plan, cfg=cfg).reconstruct(y, iters=5)
    applications = 2 * (5 + 1) * 2
    if extra.get("staging") == "gather":
        assert txs.spmm_block_ell_staged.launches >= applications
        assert txs.spmm_block_ell.launches == 0
    else:
        key = ("per_row" if extra.get("dma") == "per_row" else "sorted") + (
            "_q" if precision in ("q8", "fp8") else ""
        )
        assert txs.LAUNCHES[key] == applications
        assert txs.spmm_block_ell.launches == applications
    xc, rc = Reconstructor(plan, cfg=cfg, device="cpu").reconstruct(
        y, iters=5
    )
    tol = 1e-4 if precision in ("single", "double") else 5e-3
    np.testing.assert_allclose(xg, xc, rtol=tol, atol=tol * np.abs(xc).max())
    np.testing.assert_allclose(rg, rc, rtol=tol, atol=tol * np.abs(rc).max())


_MESH_PLAN: dict = {}


def _mesh_plan():
    """n=32 plan over four ranks, socket layout 2, with its operator."""
    if "plan" not in _MESH_PLAN:
        from repro_torch.core.geometry import XCTGeometry, build_system_matrix
        from repro_torch.core.partition import PartitionConfig, build_plan

        geo = XCTGeometry(n=32, n_angles=48)
        a = build_system_matrix(geo)
        _MESH_PLAN["plan"] = build_plan(
            geo, PartitionConfig(n_data=4, socket=2, tile=4,
                                 rows_per_block=16, nnz_per_stage=16), a=a)
        _MESH_PLAN["a"] = a
    return _MESH_PLAN["plan"], _MESH_PLAN["a"]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "mode,precision,wire",
    [(m, p, "native") for p in ("single", "mixed")
     for m in ("direct", "rs", "hier", "sparse", "hier-sparse")]
    + [("hier-sparse", "mixed", "q8"), ("hier-sparse", "q8", "q8")],
)
def test_cuda_one_card_mesh_matches_cpu(cuda, mode, precision, wire,
                                        monkeypatch):
    """Four ranks on a 2x2 mesh of one card equal the same mesh on the
    CPU (plain versions) under every mode; every rank's arrays and every
    exchange tensor sit on the card; each rank launches the kernel once
    per minibatch and application."""
    from repro_torch.core import recon as trecon
    from repro_torch.dist import Topology
    from repro_torch.dist import topology as ttopo
    from repro_torch.launch.mesh import make_mesh

    plan, a = _mesh_plan()
    cfg = trecon.ReconConfig(precision=precision, comm_mode=mode, fuse=2,
                             wire=wire)

    def topo(dev):
        mesh = make_mesh((2, 2), ("data", "model"), devices=[dev] * 4)
        return Topology.from_mesh(mesh, data_axes=("model", "data"),
                                  batch_axes=())

    seen = []

    def watch(fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            seen.extend(t.device for t in out)
            return out
        return wrapped

    monkeypatch.setattr(trecon, "sparse_exchange",
                        watch(trecon.sparse_exchange))
    monkeypatch.setattr(ttopo.CommPlan, "reduce_partials",
                        watch(ttopo.CommPlan.reduce_partials))
    rg = trecon.Reconstructor(plan, cfg, topology=topo(cuda))
    rc = trecon.Reconstructor(plan, cfg, topology=topo("cpu"))
    card = torch.device("cuda", torch.cuda.current_device())
    assert rg.devices == [card] * 4
    assert {t.device for arrs in rg._arrays for t in arrs.values()} == {card}
    rng = np.random.default_rng(5)
    x = rng.random((plan.geo.n_vox, 4)).astype(np.float32)
    y = (a @ x).astype(np.float32)
    tol = 2.5e-2 if wire == "q8" else (1e-4 if precision == "single"
                                       else 5e-3)
    key = "sorted_q" if precision == "q8" else "sorted"
    for fn, inp in (("project", x), ("backproject", y)):
        txs.reset_launches()
        seen.clear()
        got = getattr(rg, fn)(inp)
        assert txs.LAUNCHES[key] == 4 * 2  # four ranks, two minibatches
        assert txs.spmm_block_ell.launches == 8
        assert seen and set(seen) == {card}
        ref = getattr(rc, fn)(inp)
        assert np.abs(got - ref).max() < tol * np.abs(ref).max(), fn


def _small_plan():
    """n=32 plan on one rank, with its operator and phantom sinogram."""
    if "one" not in _MESH_PLAN:
        from repro_torch.core.geometry import XCTGeometry, build_system_matrix
        from repro_torch.core.partition import PartitionConfig, build_plan
        from repro_torch.data.phantom import phantom_slices

        geo = XCTGeometry(n=32, n_angles=48)
        a = build_system_matrix(geo)
        _MESH_PLAN["one"] = build_plan(geo, PartitionConfig(
            tile=4, rows_per_block=16, nnz_per_stage=16), a=a)
        _MESH_PLAN["sino"] = (a @ phantom_slices(32, 8)).astype(np.float32)
    return _MESH_PLAN["one"], _MESH_PLAN["sino"]


def _mesh_topology(dev):
    from repro_torch.dist import Topology
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), devices=[dev] * 4)
    return Topology.from_mesh(mesh, data_axes=("model", "data"),
                              batch_axes=())


@pytest.mark.gpu
@pytest.mark.parametrize(
    "ranks,mode,precision,wire",
    [(1, "rs", "mixed", "native"), (1, "rs", "q8", "native"),
     (4, "hier", "mixed", "native"), (4, "sparse", "mixed", "native"),
     (4, "hier-sparse", "mixed", "native"), (4, "hier-sparse", "q8", "q8")],
)
def test_cuda_overlap_gives_the_serial_bits(cuda, ranks, mode, precision,
                                            wire):
    """The reduce phase on a side stream beside the next minibatch's
    kernel gives the serial order's bits, on one rank and on four ranks
    of one card (whose side stream they share)."""
    from repro_torch.core.recon import ReconConfig, Reconstructor

    if ranks == 1:
        plan, sino = _small_plan()
    else:
        plan, a = _mesh_plan()
        _, sino = _small_plan()
    outs = []
    for overlap in (False, True):
        cfg = ReconConfig(precision=precision, comm_mode=mode, wire=wire,
                          fuse=2, overlap=overlap)
        rec = (Reconstructor(plan, cfg) if ranks == 1 else
               Reconstructor(plan, cfg, topology=_mesh_topology(cuda)))
        assert len(rec._side) == (1 if overlap else 0)
        outs.append(rec.reconstruct(sino, iters=5))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["sparse", "hier-sparse"])
def test_cuda_sparse_exchange_is_reproducible(cuda, mode):
    """Two P=4 solves give the same bits: every scatter-add pass writes
    each row once, so no two f16 atomics meet."""
    from repro_torch.core.recon import ReconConfig, Reconstructor

    plan, _ = _mesh_plan()
    _, sino = _small_plan()
    rec = Reconstructor(plan, ReconConfig(comm_mode=mode, fuse=2),
                        topology=_mesh_topology(cuda))
    first, again = (rec.reconstruct(sino, iters=5) for _ in range(2))
    np.testing.assert_array_equal(first[0], again[0])
    np.testing.assert_array_equal(first[1], again[1])


@pytest.mark.gpu
def test_cuda_p4_solve_with_sharded_vectors_is_reproducible(cuda):
    """Four ranks of one card hold their rows of every CG vector in one
    block on the card; a mixed ``hier`` solve gives its second run's
    bits."""
    from repro_torch.core.recon import ReconConfig, Reconstructor

    plan, _ = _mesh_plan()
    _, sino = _small_plan()
    rec = Reconstructor(plan, ReconConfig(comm_mode="hier", fuse=2),
                        topology=_mesh_topology(cuda))
    staged = rec.stage_sino(sino)
    assert staged.y.ranks == (4,) and staged.y.device.type == "cuda"
    assert [t.shape[0] for t in staged.y.rank_views()] == \
        [plan.proj.rows_per_dev] * 4
    first, again = (rec.reconstruct(staged, iters=5) for _ in range(2))
    np.testing.assert_array_equal(first[0], again[0])
    np.testing.assert_array_equal(first[1], again[1])


@pytest.mark.gpu
def test_cuda_batch_groups_on_one_card(cuda):
    """A (2, 1) mesh of one card: two batch groups of one rank, each on
    its half of the slices, give the one-group projections bit for bit."""
    from repro_torch.core.recon import ReconConfig, Reconstructor
    from repro_torch.dist import Topology
    from repro_torch.launch.mesh import make_mesh

    plan, sino = _small_plan()
    topo = Topology.from_mesh(make_mesh((2, 1), ("data", "model"),
                                        devices=[cuda] * 2))
    rec = Reconstructor(plan, ReconConfig(fuse=2), topology=topo)
    one = Reconstructor(plan, ReconConfig(fuse=2))
    assert rec.n_batch == 2
    np.testing.assert_array_equal(rec.backproject(sino),
                                  one.backproject(sino))
    x, res = rec.reconstruct(sino, iters=5)
    assert np.isfinite(x).all() and (res[-1] < res[0]).all()


@pytest.mark.gpu
def test_cuda_span_fence_waits_for_the_side_streams(cuda, monkeypatch):
    """The ``recon/solve`` span ends after the device work it wraps: its
    duration is at least the CUDA-event time from before the solve to
    events queued, when the host reaches the fence, on the caller's
    stream and on the side stream (the reductions included)."""
    from repro_torch.core.recon import ReconConfig, Reconstructor
    from repro_torch.obs import trace as ttrace

    plan, a = _mesh_plan()
    _, sino = _small_plan()
    rec = Reconstructor(plan, ReconConfig(comm_mode="hier-sparse", fuse=2),
                        topology=_mesh_topology(cuda))
    staged = rec.stage_sino(sino)
    rec.reconstruct(staged, iters=2)  # warm-up
    (side,) = rec._side.values()
    ends = []
    fence = ttrace.Span.fence

    def fence_after_events(self, value):
        for stream in (torch.cuda.current_stream(), side):
            ends.append(stream.record_event(
                torch.cuda.Event(enable_timing=True)))
        return fence(self, value)

    monkeypatch.setattr(ttrace.Span, "fence", fence_after_events)
    old = ttrace.get_tracer()
    tracer = ttrace.enable()
    try:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        rec.reconstruct(staged, iters=10)
    finally:
        ttrace.set_tracer(old)
    (span,) = tracer.spans("recon/solve")
    device_ms = max(start.elapsed_time(e) for e in ends)
    assert device_ms > 0
    assert (span["t1"] - span["t0"]) * 1e3 >= 0.98 * device_ms


@pytest.mark.gpu
def test_cuda_profiled_solve_names_its_device_work(cuda, tmp_path):
    """Under the profiler, 90% or more of a solve's device time outside
    the SpMM kernels was launched inside a ``solve/*`` or ``recon/*``
    range (the benchmark's attribution, ``xctbench/ranges.py``), and the
    reduce phase runs on a stream of its own, the side stream: in
    ``solve/reduce`` only the join of the minibatches runs on the SpMM's
    stream."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core.recon import ReconConfig, Reconstructor
    from xctbench import devtrace, ranges

    plan, sino = _small_plan()
    rec = Reconstructor(plan, ReconConfig(fuse=2))
    rec.reconstruct(sino, iters=2)  # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(devtrace.MARKER):
            rec.reconstruct(sino, iters=5)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ops = ranges.ops(path)
    rest = [o for o in ops if not o.spmm]
    assert rest and sum(o.dur for o in rest if o.owner is not None) >= \
        0.9 * sum(o.dur for o in rest)
    spmm_streams = {o.stream for o in ops if o.spmm}
    reduce = [o for o in ops if o.owner == "solve/reduce"]
    side = {o.stream for o in reduce} - spmm_streams
    assert len(side) == 1 and len(spmm_streams) == 1
    assert all(o.stream in side or "Cat" in o.name for o in reduce)
    assert sum(o.stream in side for o in reduce) > len(reduce) // 2


# p + v * x with p = v = 1 + 2**-23, x = 2**-24 * (1 - 2**-23): the exact
# sum lies 2**-70 below an f32 midpoint, so rounding the product first,
# or an f64 sum then f32, takes the wrong neighbour; one fused
# multiply-add does not
_HARD = (1 + 2.0 ** -23, 1 + 2.0 ** -23, 2.0 ** -24 * (1 - 2.0 ** -23))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SWEEP + [WIDE])
def test_cuda_f32_kernel_rounds_the_step_once(cuda, shape):
    """At f32/f32 row 1's step is one fused multiply-add, as the plain
    version's (and XLA's contraction of the reference's step): the kernel
    equals the plain version bit for bit on the sweep, and on a sum that
    rounding twice gets wrong."""
    inds, vals, winmap, x, segs, off = _cuda_inputs(
        shape, "f32", cuda, _seed("fma", shape))
    out = txs.spmm_block_ell(inds, vals, winmap, x, winsegs=segs,
                             segoff=off)
    plain = txs.spmm_block_ell_plain(inds, vals, winmap, x)
    assert torch.equal(out, plain)
    # eight rows, each 1 * p then v * x, on four columns
    inds = torch.tensor([[[[0, 1]] * 8]], dtype=torch.int16, device=cuda)
    vals = torch.tensor([[[[1.0, _HARD[1]]] * 8]], device=cuda)
    xs = torch.tensor([[_HARD[0]] * 4, [_HARD[2]] * 4], device=cuda)
    winmap = torch.tensor([[[0, 1]]], dtype=torch.int32, device=cuda)
    segs, off = (torch.from_numpy(a).to(cuda) for a in
                 tops.sort_segments_by_class(
                     tops.winmap_segments(winmap.cpu().numpy()), 2))
    out = txs.spmm_block_ell(inds, vals, winmap, xs, winsegs=segs,
                             segoff=off)
    want = float(np.float32(_HARD[0]))
    assert out.flatten().tolist() == [want] * 32
    assert torch.equal(out, txs.spmm_block_ell_plain(inds, vals, winmap, xs))


@pytest.mark.gpu
@pytest.mark.parametrize("upload", ["overlap", "sync"])
def test_cuda_streaming_two_slabs_match_in_memory(cuda, upload, tmp_path):
    """A 2-slab drain on the card: each slab equals the in-memory solve
    of the same 4 slices bit for bit, with the upload in the prefetch
    thread or on the critical path, and row 1 ran for every solve."""
    from repro_torch.core.recon import ReconConfig, Reconstructor
    from repro_torch.stream import SlabStore, reconstruct_streaming

    plan, sino = _small_plan()
    rec = Reconstructor(plan, ReconConfig(precision="mixed", fuse=2))
    store = SlabStore.from_array(str(tmp_path / "sino"), sino, slab=2)
    txs.reset_launches()
    res = reconstruct_streaming(rec, store, str(tmp_path / "vol"), iters=5,
                                y_slab=4, device_upload=upload)
    assert res.complete and res.solved == [0, 4]
    assert res.upload_overlapped == (upload == "overlap")
    assert txs.LAUNCHES["sorted"] == 2 * 2 * (5 + 1) * 2
    for j0, j1 in res.volume.slabs():
        x, r = rec.reconstruct(sino[:, j0:j1], iters=5)
        np.testing.assert_array_equal(res.volume.read(j0, j1), x)
        np.testing.assert_array_equal(res.resnorms[:, j0:j1], r)


@pytest.mark.gpu
def test_cuda_stage_sino_uploads_on_its_own_stream(cuda):
    """``stage_sino`` from another thread copies on the reconstructor's
    staging stream: it returns while the default stream is still busy
    with earlier work, and the staged slab is on the card."""
    import threading

    from repro_torch.core.recon import ReconConfig, Reconstructor

    plan, sino = _small_plan()
    rec = Reconstructor(plan, ReconConfig(fuse=2))
    assert rec._stage_stream is not None
    assert rec._stage_stream != torch.cuda.default_stream(cuda)
    rec.stage_sino(sino)  # warm-up: pinned-memory pool, allocator
    default = torch.cuda.default_stream(cuda)
    torch.cuda.synchronize()
    out = {}
    torch.cuda._sleep(int(4e9))  # about 2 s of the default stream
    worker = threading.Thread(
        target=lambda: out.update(staged=rec.stage_sino(sino),
                                  busy=not default.query()))
    worker.start()
    worker.join()
    assert out["busy"], "the upload waited for the default stream"
    torch.cuda.synchronize()
    staged = out["staged"]
    assert staged.y.device.type == "cuda"
    np.testing.assert_array_equal(staged.y.cpu().numpy(),
                                  rec.pack_sino(sino) * staged.scale)


def _host_staged_solve(rec, sino, iters, x0_nat):
    """The solve staged by the host formulas: ``pack_sino`` /
    ``pack_tomo`` as a scatter into zeros, the abs-max and the
    power-of-two scale in f32, the host-packed vectors uploaded, and the
    volume gathered back and divided by the scale on the host."""
    plan = rec.plan

    def pack(a, pad, n, perm, pos):
        out = np.zeros((pad, a.shape[1]), np.float32)
        out[slice(None, n) if pos is None else pos[:n]] = a[perm]
        return out

    y = pack(sino, rec.sino_pad, plan.geo.n_rays, plan.row_perm,
             plan.row_pos)
    m = np.abs(y).max(axis=0)
    scale = np.exp2(np.round(np.log2(1.0 / np.maximum(m, 1e-30)))).astype(
        np.float32)
    x0 = (pack(x0_nat, rec.tomo_pad, plan.geo.n_vox, plan.col_perm,
               plan.col_pos) * scale if x0_nat is not None
          else np.zeros((rec.tomo_pad, sino.shape[1]), np.float32))
    with torch.no_grad():
        x, res = rec._solve(rec._shard(y * scale), rec._shard(x0), iters)
    rank = np.empty(plan.geo.n_vox, np.int64)
    pos = plan.col_pos
    rank[plan.col_perm] = (np.arange(plan.geo.n_vox) if pos is None
                           else pos[:plan.geo.n_vox])
    return (rec._download(x)[rank] / scale,
            rec._download(res.first_ranks()) / scale)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["mixed", "single", "mixed-x0", "mixed-p4"])
def test_cuda_device_staging_equals_host_formulas(cuda, case):
    """On the card, ``reconstruct``'s volume and residuals equal the host
    formulas' bit for bit (one rank, a warm start, four ranks of one
    card); the host buffers are pinned, and a second call of the same
    shape allocates none."""
    from repro_torch.core.recon import ReconConfig, Reconstructor
    from repro_torch.obs import metrics as tmetrics
    from repro_torch.obs import trace as ttrace

    precision = case.split("-")[0]
    plan, sino = _small_plan()
    if case.endswith("p4"):
        plan, _ = _mesh_plan()
        rec = Reconstructor(plan, ReconConfig(comm_mode="hier", fuse=2),
                            topology=_mesh_topology(cuda))
    else:
        rec = Reconstructor(plan, ReconConfig(precision=precision, fuse=2))
    x0 = None
    if case.endswith("x0"):
        x0 = np.random.default_rng(3).random(
            (plan.geo.n_vox, sino.shape[1])).astype(np.float32)
    metrics = tmetrics.Metrics()
    old, old_tracer = tmetrics.set_metrics(metrics), ttrace.get_tracer()
    ttrace.enable()  # the counters count while tracing
    try:
        got = [rec.reconstruct(sino, iters=5, x0_nat=x0) for _ in range(2)]
    finally:
        tmetrics.set_metrics(old)
        ttrace.set_tracer(old_tracer)
    want = _host_staged_solve(rec, sino, 5, x0)
    for x, res in got:
        np.testing.assert_array_equal(x, want[0])
        np.testing.assert_array_equal(res, want[1])
    ups = 2 if x0 is not None else 1  # the sinogram's buffer and x0's
    assert metrics.get("staging_pinned_alloc_total", dir="up") == ups
    assert metrics.get("staging_pinned_alloc_total", dir="down") == 1
    assert metrics.get("staging_pinned_reuse_total", dir="up") == ups
    assert metrics.get("staging_pinned_reuse_total", dir="down") == 1
    assert all(buf.is_pinned() for buf, _ in rec._buffers._bufs.values())


def _serve_spec(sino, **kw):
    """A job on ``_small_plan``'s geometry and partition, mixed, fuse 2."""
    from repro_torch.core.geometry import XCTGeometry
    from repro_torch.core.partition import PartitionConfig
    from repro_torch.core.recon import ReconConfig
    from repro_torch.serve import JobSpec

    kw.setdefault("iters", 5)
    kw.setdefault("y_slab", 4)
    kw.setdefault("rcfg", ReconConfig(precision="mixed", fuse=2))
    return JobSpec(
        geo=XCTGeometry(n=32, n_angles=48), sino=sino,
        pcfg=PartitionConfig(tile=4, rows_per_block=16, nnz_per_stage=16),
        **kw)


@pytest.mark.gpu
def test_cuda_served_job_equals_in_memory_slabs(cuda, tmp_path):
    """Two jobs batched through a ``ReconServer`` on the card: each slab of
    each volume equals the in-memory solve of its 4 slices bit for bit,
    whatever it was batched with, and row 1 ran for every solve."""
    from repro_torch.core.recon import ReconConfig, Reconstructor
    from repro_torch.serve import ReconServer

    plan, sino = _small_plan()
    rec = Reconstructor(plan, ReconConfig(precision="mixed", fuse=2))
    srv = ReconServer(2 << 30, workdir=str(tmp_path))
    assert srv.device == cuda
    txs.reset_launches()
    jobs = [srv.submit(_serve_spec(s)) for s in (sino, sino[:, ::-1].copy())]
    assert srv.drain() == 2 and srv.cache.stats()["builds"] == 1
    assert txs.LAUNCHES["sorted"] == 2 * 2 * 2 * (5 + 1) * 2
    for job in jobs:
        assert job.status == "done"
        for j0, j1 in job.volume.slabs():
            x, r = rec.reconstruct(job.spec.read_slab(j0, j1), iters=5)
            np.testing.assert_array_equal(job.volume.read(j0, j1), x)
            np.testing.assert_array_equal(job.resnorms[:, j0:j1], r)


@pytest.mark.gpu
def test_cuda_background_server(cuda, tmp_path):
    """The scheduler thread solves on the card, with the prefetch thread
    staging the next slab: the volume equals the synchronous server's."""
    from repro_torch.serve import ReconServer

    _, sino = _small_plan()
    sync = ReconServer(2 << 30, workdir=str(tmp_path / "sync"))
    want = sync.submit(_serve_spec(sino))
    sync.drain()
    srv = ReconServer(2 << 30, workdir=str(tmp_path / "bg"))
    srv.start()
    try:
        jobs = [srv.submit(_serve_spec(sino)) for _ in range(2)]
        for job in jobs:
            assert job.wait(timeout=300) and job.status == "done"
    finally:
        srv.stop()
    assert srv._thread is None
    for job in jobs:
        np.testing.assert_array_equal(job.volume.to_array(),
                                      want.volume.to_array())


@pytest.mark.gpu
def test_cuda_plan_cache_eviction_frees_the_card(cuda, tmp_path):
    """A plan cache bounded to one entry: a second key (the same operator,
    another config) evicts the first, and the card holds one operator
    afterwards, not two: nothing but the cache held the evicted
    ``Reconstructor``.  Emptying the cache returns the card to where it
    started."""
    from repro_torch.core.recon import ReconConfig
    from repro_torch.serve import ReconServer

    def allocated():
        torch.cuda.synchronize(cuda)
        torch.empty(1, device=cuda)  # lets the allocator retire frees
        return torch.cuda.memory_allocated(cuda)

    _, sino = _small_plan()
    srv = ReconServer(2 << 30, workdir=str(tmp_path), cache_bytes=1)
    base = allocated()
    first = srv.submit(_serve_spec(sino))
    srv.drain()
    one = allocated() - base
    assert first.status == "done" and one > 0
    second = srv.submit(_serve_spec(
        sino, rcfg=ReconConfig(precision="mixed", fuse=2, overlap=False)))
    assert second.plan_key != first.plan_key
    srv.drain()
    assert second.status == "done"
    st = srv.cache.stats()
    assert (st["builds"], st["evictions"], st["entries"]) == (2, 1, 1)
    assert abs(allocated() - base - one) < one // 2
    srv.cache._entries.clear()
    assert allocated() == base


@pytest.mark.gpu
def test_cuda_calibrate_per_copy_overhead(cuda):
    """On the card the calibration times row 1 with CUDA events: a finite,
    positive overhead tagged ``measured``, the strided table issuing far
    more copies than the contiguous one."""
    import math

    from repro_torch.tune import calibrate_per_copy_overhead

    txs.reset_launches()
    cal = calibrate_per_copy_overhead()
    assert cal["overhead_source"] == "measured"
    assert math.isfinite(cal["per_copy_overhead_s"])
    assert cal["per_copy_overhead_s"] > 0
    assert cal["strided_issues"] > 100 * cal["contig_issues"]
    assert txs.LAUNCHES["sorted"] > 0


def _plan64(n_data=1):
    """n=64 plan (one rank, or four with socket 2) and its phantom
    sinogram of 16 slices."""
    key = ("plan64", n_data)
    if key not in _MESH_PLAN:
        from repro_torch.core.geometry import XCTGeometry, build_system_matrix
        from repro_torch.core.partition import PartitionConfig, build_plan
        from repro_torch.data.phantom import phantom_slices

        geo = XCTGeometry(n=64, n_angles=96)
        a = build_system_matrix(geo)
        _MESH_PLAN[key] = build_plan(geo, PartitionConfig(
            n_data=n_data, socket=2 if n_data > 1 else 1, tile=8,
            rows_per_block=32, nnz_per_stage=32), a=a)
        _MESH_PLAN["sino64"] = (a @ phantom_slices(64, 16)).astype(
            np.float32)
    return _MESH_PLAN[key], _MESH_PLAN["sino64"]


@pytest.mark.gpu
@pytest.mark.parametrize("ranks,mode", [(1, "hier"), (4, "hier-sparse")])
def test_cuda_lower_cg_argument_bytes_equal_the_bound_tensors(cuda, ranks,
                                                              mode):
    """At n=64 the abstract reconstructor's argument bytes are, rank by
    rank, the bytes of the tensors a real one binds on the card (each
    storage's ``nbytes``), and the traced peak is at least the arguments
    and the inputs; the real solve's peak is printed beside it."""
    from repro_torch.core.recon import ReconConfig, Reconstructor
    from repro_torch.core.recon import _bound_tensors
    from repro_torch.dist import Topology
    from repro_torch.launch.mesh import make_fake_mesh

    plan, sino = _plan64(ranks)
    cfg = ReconConfig(precision="mixed", comm_mode=mode, fuse=16)
    if ranks == 1:
        fake = Reconstructor(plan, cfg, abstract=True)
        real = Reconstructor(plan, cfg)
    else:
        fake = Reconstructor(plan, cfg, abstract=True, topology=(
            Topology.from_mesh(make_fake_mesh((2, 2), ("data", "model")),
                               data_axes=("model", "data"), batch_axes=())))
        real = Reconstructor(plan, cfg, topology=_mesh_topology(cuda))
    lowered = fake.lower_cg(16, iters=2)
    mem = lowered.memory_analysis()
    bound = [sum(t.untyped_storage().nbytes() for t in _bound_tensors(a))
             for a in real._arrays]
    assert list(mem.per_rank["argument"]) == bound
    assert mem.rank0["peak"] >= bound[0] + mem.rank0["input"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    real.reconstruct(sino, iters=2)
    print(f"ranks={ranks} abstract peak {mem.rank0['peak']} real peak "
          f"{torch.cuda.max_memory_allocated()}")


@pytest.mark.gpu
def test_cuda_fake_trace_launches_no_kernel(cuda):
    """A trace goes through the kernel entries' custom ops and their
    fakes: no launch, no count; the same entry on CUDA tensors
    launches and counts."""
    from repro_torch.core.recon import ReconConfig, Reconstructor

    plan, sino = _plan64()
    cfg = ReconConfig(precision="mixed", fuse=16)
    txs.reset_launches()
    lowered = Reconstructor(plan, cfg, abstract=True).lower_cg(16, iters=2)
    torch.cuda.synchronize()
    assert txs.spmm_block_ell.launches == 0
    assert all(n == 0 for n in txs.LAUNCHES.values())
    assert lowered.memory_analysis().temp_size_in_bytes > 0
    Reconstructor(plan, cfg).reconstruct(sino, iters=2)
    assert txs.LAUNCHES["sorted"] == txs.spmm_block_ell.launches == 6
