"""Blocked-ELL SpMM of the PyTorch port against the JAX package.

On the CPU the port's ``spmm_block_ell`` / ``spmm_block_ell_staged`` run
their plain versions, held here against the JAX Pallas kernels
(interpret mode, as the JAX tests run them) with the reference
tolerances: the class-sorted (row 1), unsorted-segment (row 2), per-row
(row 3) and pre-gathered window (row 4) kernels, and the quantized form
(row 1q) of the first three.  The port's own contract -- every staging
gives row 1's bits, and the quantized form gives the bits of the float
path on the dequantized values -- is pinned here on the plain versions
and in ``test_torch_kernel_gpu.py`` on the CUDA kernels."""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jprec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.xct_spmm import spmm_block_ell as jax_spmm
from repro.kernels.xct_spmm import spmm_block_ell_staged as jax_staged
from repro_torch.core import precision as tprec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import xct_spmm as txs

SWEEP = [
    # (B, S, R, K, BUF, C, F): tests/test_kernel_spmm.py's sweep, with
    # non-divisible B/S and non-power-of-two BUF
    (1, 1, 8, 8, 16, 64, 1),
    (2, 2, 16, 8, 32, 128, 4),
    (3, 1, 32, 16, 64, 256, 8),
    (2, 3, 8, 32, 40, 96, 16),
    (5, 2, 16, 16, 24, 64, 2),
]
JNP = {"f32": jnp.float32, "f16": jnp.float16, "bf16": jnp.bfloat16,
       "int8": jnp.int8, "fp8": jnp.float8_e4m3fn}
TORCH = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16,
         "int8": torch.int8, "fp8": torch.float8_e4m3fn}
PAIRS = [("f32", "f32"), ("f16", "f32"), ("bf16", "bf16")]


def _seed(*parts) -> int:
    return zlib.crc32(repr(parts).encode())


def _random_ell(rng, b, s, r, k, buf, c, f):
    inds = rng.integers(0, buf, size=(b, s, r, k)).astype(np.int16)
    vals = (rng.random((b, s, r, k)) * (rng.random((b, s, r, k)) > 0.3)
            ).astype(np.float32)
    winmap = rng.integers(0, c, size=(b, s, buf)).astype(np.int32)
    x = rng.normal(size=(c, f)).astype(np.float32)
    return inds, vals, winmap, x


def _tol(storage, compute):
    """The JAX kernel tests' tolerances (test_kernel_spmm.py:74, :132)."""
    if storage == "f32" and compute == "f32":
        return 1e-5
    return 2e-2 if compute == "f32" else 5e-2


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("storage", ["f32", "f16", "bf16"])
@pytest.mark.parametrize("compute", ["f32", "f16"])
def test_plain_matches_jax_kernel(shape, storage, compute):
    b, s, r, k, buf, c, f = shape
    rng = np.random.default_rng(_seed(shape, storage, compute))
    inds, vals, winmap, x = _random_ell(rng, b, s, r, k, buf, c, f)
    out = txs.spmm_block_ell(
        torch.from_numpy(inds), torch.from_numpy(vals).to(TORCH[storage]),
        torch.from_numpy(winmap), torch.from_numpy(x).to(TORCH[storage]),
        compute_dtype=TORCH[compute],
    )
    assert out.dtype == torch.float32 and out.shape == (b, r, f)
    ref = jax_spmm(
        jnp.asarray(inds), jnp.asarray(vals).astype(JNP[storage]),
        jnp.asarray(winmap), jnp.asarray(x).astype(JNP[storage]),
        compute_dtype=JNP[compute],
    )
    tol = _tol(storage, compute)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol
    )


@pytest.mark.parametrize("shape", SWEEP)
def test_spmm_ref_matches_jax_ref(shape):
    b, s, r, k, buf, c, f = shape
    rng = np.random.default_rng(_seed("ref", shape))
    inds, vals, winmap, x = _random_ell(rng, b, s, r, k, buf, c, f)
    out = tref.spmm_ref(
        torch.from_numpy(inds), torch.from_numpy(vals),
        torch.from_numpy(winmap), torch.from_numpy(x),
    )
    ref = jref.spmm_ref(
        jnp.asarray(inds), jnp.asarray(vals), jnp.asarray(winmap),
        jnp.asarray(x),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    # the oracle and the kernel's plain version agree too
    plain = txs.spmm_block_ell_plain(
        torch.from_numpy(inds), torch.from_numpy(vals),
        torch.from_numpy(winmap), torch.from_numpy(x),
    )
    np.testing.assert_allclose(plain.numpy().reshape(b * r, f),
                               out.numpy(), rtol=1e-5, atol=1e-5)


def test_coo_apply_matches_jax(small_system):
    _, a, _ = small_system
    coo = a.tocoo()
    x = np.random.default_rng(3).normal(size=(a.shape[1], 3)).astype(
        np.float32
    )
    out = tref.coo_apply(
        torch.from_numpy(coo.row), torch.from_numpy(coo.col),
        torch.from_numpy(coo.data), torch.from_numpy(x), a.shape[0],
    )
    ref = jref.coo_apply(
        jnp.asarray(coo.row), jnp.asarray(coo.col), jnp.asarray(coo.data),
        jnp.asarray(x), a.shape[0],
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), a @ x, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", ["proj", "back"])
@pytest.mark.parametrize("pair", [("f16", "f32"), ("f32", "f32")])
def test_apply_operator_matches_jax_on_plan_shards(small_system, name, pair):
    _, _, plan = small_system
    op = getattr(plan, name)
    storage, compute = pair
    f = 4
    x = np.random.default_rng(_seed(name, pair)).normal(
        size=(op.n_cols_pad, f)
    ).astype(np.float32)
    out = tops.apply_operator(
        torch.from_numpy(op.inds[0]), torch.from_numpy(op.vals[0]),
        torch.from_numpy(op.winmap[0]), torch.from_numpy(x),
        storage_dtype=TORCH[storage], compute_dtype=TORCH[compute],
        winsegs=torch.from_numpy(op.winsegs[0]),
        segoff=torch.from_numpy(op.segoff[0]),
    )
    ref = jops.apply_operator(
        jnp.asarray(op.inds[0]), jnp.asarray(op.vals[0]),
        jnp.asarray(op.winmap[0]), jnp.asarray(x),
        storage_dtype=JNP[storage], compute_dtype=JNP[compute],
        winsegs=jnp.asarray(op.winsegs[0]), segoff=jnp.asarray(op.segoff[0]),
    )
    tol = _tol(storage, compute)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)
    # tables built from winmap inside the call give the same result
    again = tops.apply_operator(
        torch.from_numpy(op.inds[0]), torch.from_numpy(op.vals[0]),
        torch.from_numpy(op.winmap[0]), torch.from_numpy(x),
        storage_dtype=TORCH[storage], compute_dtype=TORCH[compute],
    )
    assert torch.equal(again, out)
    ref_path = tops.apply_operator(
        torch.from_numpy(op.inds[0]), torch.from_numpy(op.vals[0]),
        torch.from_numpy(op.winmap[0]), torch.from_numpy(x),
        storage_dtype=TORCH[storage], compute_dtype=TORCH[compute],
        use_ref=True,
    )
    np.testing.assert_allclose(ref_path.numpy(), out.numpy(),
                               rtol=tol, atol=tol)


def test_plain_f32_equals_jax_kernel_path_bit_for_bit(small_system):
    """At f32/f32 the plain step rounds ``part + v * x`` once, as XLA's
    contraction of the Pallas step into one fused multiply-add does: the
    n=32 proj shard, seed-1 ``x`` of 2 columns, equals the JAX kernel
    path (Pallas in interpret mode) bit for bit.  Rounding the product
    first differed in 687 of 1024 outputs, by 1.5e-7 of max|.|."""
    _, _, plan = small_system
    op = plan.proj
    x = np.random.default_rng(1).normal(size=(op.n_cols_pad, 2)).astype(
        np.float32)
    t = [torch.from_numpy(a[0]) for a in (op.inds, op.vals, op.winmap,
                                          op.winsegs, op.segoff)]
    out = txs.spmm_block_ell(t[0], t[1], t[2], torch.from_numpy(x),
                             winsegs=t[3], segoff=t[4])
    ref = jax_spmm(
        jnp.asarray(op.inds[0]), jnp.asarray(op.vals[0]),
        jnp.asarray(op.winmap[0]), jnp.asarray(x),
        compute_dtype=jnp.float32, winsegs=jnp.asarray(op.winsegs[0]),
        segoff=jnp.asarray(op.segoff[0]),
    )
    assert np.array_equal(out.numpy(), np.asarray(ref))
    # the product rounded first, the old plain step, does not
    twice = torch.zeros_like(out)
    window = torch.from_numpy(x)[t[2].long()]
    for si in range(t[0].shape[1]):
        part = torch.zeros_like(out)
        idx = t[0][:, si].long()
        for kk in range(t[0].shape[-1]):
            g = torch.take_along_dim(
                window[:, si], idx[:, :, kk, None].expand(*out.shape), dim=1)
            part = part + t[1][:, si, :, kk, None] * g
        twice += part
    assert not np.array_equal(twice.numpy(), np.asarray(ref))


def _round_f32(exact):
    """The f32 nearest to a Fraction, ties to even (the oracle)."""
    from fractions import Fraction

    c = np.float32(float(exact))
    cands = [np.nextafter(c, np.float32(-np.inf)), c,
             np.nextafter(c, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(v.view(np.uint32)) & 1))


# p + v * x with p = v = 1 + 2**-23, x = 2**-24 * (1 - 2**-23): the exact
# sum lies 2**-70 below the f32 midpoint 1 + 3 * 2**-24, which an f64 sum
# rounds onto, and ties-to-even then takes the wrong neighbour
_HARD = (1 + 2.0 ** -23, 1 + 2.0 ** -23, 2.0 ** -24 * (1 - 2.0 ** -23))


def test_fma_f32_rounds_once():
    """``fma_f32`` is the correctly rounded ``p + v * x`` on random values
    over wide exponent gaps and on a sum that an f64 sum followed by an
    f32 rounding gets wrong; the plain version's stage takes it too."""
    from fractions import Fraction

    rng = np.random.default_rng(17)
    n = 3000
    p = (rng.normal(size=n) * np.exp2(rng.integers(-40, 40, n))).astype(
        np.float32)
    v = rng.normal(size=n).astype(np.float32)
    x = (rng.normal(size=n) * np.exp2(rng.integers(-40, 40, n))).astype(
        np.float32)
    p[0], v[0], x[0] = (np.float32(a) for a in _HARD)
    got = txs.fma_f32(torch.from_numpy(p), torch.from_numpy(v).double()
                      * torch.from_numpy(x).double()).numpy()
    want = np.array([_round_f32(Fraction(float(a)) + Fraction(float(b))
                                * Fraction(float(c)))
                     for a, b, c in zip(p, v, x)], np.float32)
    np.testing.assert_array_equal(got, want)
    naive = (p.astype(np.float64) + v.astype(np.float64) * x).astype(
        np.float32)
    assert naive[0] != want[0] == np.float32(_HARD[0])
    # one row, two slots: 1 * p, then v * x
    inds = torch.tensor([[[[0, 1]]]], dtype=torch.int16)
    vals = torch.tensor([[[[1.0, _HARD[1]]]]], dtype=torch.float32)
    xs = torch.tensor([[_HARD[0]], [_HARD[2]]], dtype=torch.float32)
    winmap = torch.tensor([[[0, 1]]], dtype=torch.int32)
    out = txs.spmm_block_ell_plain(inds, vals, winmap, xs)
    assert out.item() == float(np.float32(_HARD[0]))


def test_unported_modes_raise_without_fallback():
    """The modes that raised before the port had their kernels now run
    and agree with the JAX kernels; unknown modes still raise."""
    rng = np.random.default_rng(0)
    arrays = _random_ell(rng, *SWEEP[1])
    inds, vals, winmap, x = (torch.from_numpy(a) for a in arrays)
    j_args = [jnp.asarray(a) for a in arrays]
    q, e = tprec.quantize_block_vals(vals, torch.int8)
    jq, je = jprec.quantize_block_vals(j_args[1], jnp.int8)
    segs = tops.winmap_segments(arrays[2])
    for kw, jkw, tv, jv in [
        (dict(staging="gather"), dict(staging="gather"), vals, j_args[1]),
        (dict(dma="per_row"), dict(dma="per_row"), vals, j_args[1]),
        (dict(scales=e), dict(scales=je), q, jq),
        (dict(winsegs=torch.from_numpy(segs)),
         dict(winsegs=jnp.asarray(segs)), vals, j_args[1]),
    ]:
        out = tops.apply_operator(inds, tv, winmap, x, **kw)
        ref = jops.apply_operator(j_args[0], jv, j_args[2], j_args[3], **jkw)
        tol = _tol("f16", "f32")  # apply_operator's default pair
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   rtol=tol, atol=tol)
    for kw in (dict(staging="bogus"), dict(dma="bogus")):
        with pytest.raises(ValueError):
            tops.apply_operator(inds, vals, winmap, x, **kw)


def test_cpu_dispatch_runs_plain_and_counts_no_launch():
    rng = np.random.default_rng(1)
    inds, vals, winmap, x = (
        torch.from_numpy(a) for a in _random_ell(rng, *SWEEP[3])
    )
    before = txs.spmm_block_ell.launches
    counts = dict(txs.LAUNCHES)
    out = txs.spmm_block_ell(inds, vals, winmap, x)
    assert txs.spmm_block_ell.launches == before
    assert torch.equal(out, txs.spmm_block_ell_plain(inds, vals, winmap, x))
    window = x[winmap.long()]
    staged_before = txs.spmm_block_ell_staged.launches
    out = txs.spmm_block_ell_staged(inds, vals, window)
    assert txs.spmm_block_ell_staged.launches == staged_before
    assert txs.LAUNCHES == counts
    txs.reset_launches()
    assert set(txs.LAUNCHES.values()) == {0}
    assert txs.spmm_block_ell.launches == 0


def test_shared_memory_footprint():
    """The CTA's shared memory: a ring of windows, the stage partials,
    the accumulator and one mbarrier per ring slot."""
    # the slice's proj shard in f16 (R=32, BUF=776, F=16): 8 ring slots,
    # 8 partials (two rounds of 4 stages), the accumulator, 8 barriers
    assert txs.smem_bytes(32, 776, 16, 2, 8, 8) == (
        8 * 776 * 16 * 2 + 8 * 2048 + 2048 + 8 * 8)
    # f64: two slots of 776 rows of 128 B
    assert txs.smem_bytes(32, 776, 16, 8, 2, 2) == (
        2 * 776 * 128 + 2 * 2048 + 2048 + 16)
    assert txs.smem_bytes(32, 776, 16, 8, 2, 2) < txs.SMEM_LIMIT
    # window rows are padded to 16 bytes, every region to 16 bytes
    assert txs.smem_bytes(8, 16, 1, 4, 1, 2) == 16 * 16 + 64 + 32 + 8
    assert txs.smem_bytes(1, 3, 1, 2, 1, 2) == 3 * 16 + 16 + 16 + 8
    assert txs.smem_bytes(8, 16, 3, 8, 2, 4) == 2 * 16 * 32 + 384 + 96 + 16
    # row 4's cluster CTAs keep all their stage partials, no accumulator
    assert txs.smem_bytes(32, 776, 16, 2, 4, 4, acc=False) == (
        4 * 776 * 32 + 4 * 2048 + 32)
    # R*F is bounded by shared memory only: R=32, F=64 in f32
    assert txs.smem_bytes(32, 416, 64, 4, 2, 2) == (
        2 * 416 * 256 + 2 * 8192 + 8192 + 16)
    for staging in ("sorted", "staged"):
        geo = txs.launch_geometry(staging, 26, 32, 32, 776, 16, 2)
        assert geo.smem == txs.smem_bytes(
            32, 776, 16, 2, geo.depth, geo.part_buffers,
            acc=geo.cluster == 1)


# (S, BUF) of the n=512 shards: proj [6648, 26, 32, 32] with BUF 776,
# back [8192, 20, 32, 32] with BUF 416
N512 = {"proj": (26, 776), "back": (20, 416)}


@pytest.mark.parametrize("store_bytes", [8, 4, 2])
@pytest.mark.parametrize("name", ["proj", "back"])
@pytest.mark.parametrize("staging", ["sorted", "unsorted", "per_row",
                                     "staged"])
def test_launch_geometry_at_the_n512_shards(store_bytes, name, staging):
    """At the slice's shapes (R=K=32, F=16) every pair, f64 included,
    gets a ring of at least two windows, so copies overlap the compute;
    the stages in flight fill the 256 threads; row 4 splits the stages
    of a row-block over a cluster of at most 8 CTAs."""
    s, buf = N512[name]
    geo = txs.launch_geometry(staging, s, 32, 32, buf, 16, store_bytes)
    assert geo.depth >= 2
    assert geo.smem <= txs.SMEM_LIMIT
    assert geo.depth % geo.inflight == 0
    threads_per_stage = 32 * (16 * store_bytes // 16)
    assert geo.inflight * threads_per_stage <= 256
    if staging == "staged":
        assert 2 <= geo.cluster <= 8
        # every CTA of the cluster has stages, and they cover S
        assert (geo.cluster - 1) * geo.stages_per_cta < s
        assert geo.cluster * geo.stages_per_cta >= s
        assert geo.part_buffers == geo.stages_per_cta
    else:
        assert geo.cluster == 1 and geo.stages_per_cta == s
        assert geo.lookahead >= 1  # windows issued a round ahead
        assert geo.part_buffers == 2 * geo.inflight
    if store_bytes == 2 and staging != "staged":
        # f16: 2 stages at once (64 threads each), one round of windows
        # ahead, in the shared memory of two CTAs per SM on proj (4
        # stages per SM against 3 from three CTAs) and of three on back
        # (6 stages per SM either way; the tie goes to more CTAs)
        assert (geo.inflight, geo.depth) == (2, 4)
        ctas = {"proj": 2, "back": 3}[name]
        assert geo.smem <= 233_472 // ctas - 1024


@pytest.mark.parametrize("resident", [1, 2, 3, 4])
@pytest.mark.parametrize("staging", ["sorted", "unsorted", "per_row",
                                     "staged"])
def test_launch_geometry_follows_the_resident_ctas(staging, resident):
    """The ring is sized for no more CTAs per SM than the kernel's
    registers let an SM hold, and of the rings for one, two or three
    CTAs it takes one whose CTAs compute the most stages at once on an
    SM (f16, both n=512 shards); at three resident it is the ring taken
    where ``resident`` is not given."""
    for name in ("proj", "back"):
        s, buf = N512[name]
        geo = txs.launch_geometry(staging, s, 32, 32, buf, 16, 2,
                                  resident=resident)

        def held(g):
            return min(resident, 233_472 // (g.smem + 1024))

        assert held(geo) >= min(2, resident)
        for ctas in range(1, min(3, resident) + 1):
            other = txs._sized_for(ctas, staging, s, 32, 32, buf, 16, 2)
            assert held(geo) * geo.inflight >= held(other) * other.inflight
        if resident == 3:
            assert geo == txs.launch_geometry(staging, s, 32, 32, buf, 16, 2)


def test_launch_geometry_single_buffered_and_too_large():
    """A window that fits only once runs single-buffered (depth 1); one
    that does not fit at all raises, naming BUF and F."""
    geo = txs.launch_geometry("sorted", 5, 32, 32, 3000, 16, 4)
    assert (geo.depth, geo.inflight, geo.lookahead) == (1, 1, 0)
    geo = txs.launch_geometry("staged", 5, 32, 32, 3000, 16, 4)
    assert geo.depth == 1 and geo.cluster * geo.stages_per_cta >= 5
    with pytest.raises(ValueError, match="BUF=4000, F=16"):
        txs.launch_geometry("sorted", 1, 8, 8, 4000, 16, 4)
    # a single round (S no larger than the stages in flight) needs no
    # lookahead: every stage gets its own slot
    geo = txs.launch_geometry("sorted", 3, 32, 32, 64, 16, 2)
    assert (geo.depth, geo.inflight) == (3, 3)
    # F wider than the CTA's threads: one stage at a time, threads loop
    # over the vectors of F (R=32, F=64 in f32 is 512 vectors)
    geo = txs.launch_geometry("sorted", 3, 32, 16, 48, 64, 4)
    assert geo.inflight == 1 and geo.lookahead >= 1


@pytest.mark.parametrize("staging", ["sorted", "staged", "q8"])
def test_wide_fuse_plain_matches_jax_kernel(staging):
    """R=32, F=64 (the paper's R with fuse=64), which the first kernel
    design refused: the plain versions against the JAX Pallas kernels."""
    b, s, r, k, buf, c, f = 2, 3, 32, 16, 48, 128, 64
    rng = np.random.default_rng(_seed("wide", staging))
    inds, vals, winmap, x = _random_ell(rng, b, s, r, k, buf, c, f)
    tol = _tol("f16", "f32")
    if staging == "staged":
        window = x[winmap]
        out = txs.spmm_block_ell_staged(
            _as(True, inds), _as(True, vals, "f16"),
            _as(True, window, "f16"))
        ref = jax_staged(_as(False, inds), _as(False, vals, "f16"),
                         _as(False, window, "f16"))
    else:
        segs, off = _fused_tables(winmap, "sorted", buf)
        kw, jkw = {}, {}
        tv, jv = _as(True, vals, "f16"), _as(False, vals, "f16")
        if staging == "q8":
            tv, kw["scales"] = tprec.quantize_block_vals(
                torch.from_numpy(vals), torch.int8)
            jv, jkw["scales"] = jprec.quantize_block_vals(
                jnp.asarray(vals), jnp.int8)
        out = txs.spmm_block_ell(
            _as(True, inds), tv, _as(True, winmap), _as(True, x, "f16"),
            winsegs=_as(True, segs), segoff=_as(True, off), **kw)
        ref = jax_spmm(
            _as(False, inds), jv, _as(False, winmap), _as(False, x, "f16"),
            winsegs=_as(False, segs), segoff=_as(False, off), **jkw)
    assert out.shape == (b, r, f)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def test_kernel_entries_cover_every_policy_and_path():
    """One CUDA entry per (staging, vals, window, compute) a path can
    reach: the six float pairs on all four stagings, int8/fp8 values on
    the three fused ones, and f32 values on f16 windows for the gather
    path of the quantized tier."""
    entries = set(txs.ENTRIES)
    assert len(entries) == len(txs.ENTRIES) == 31
    for st, ct in txs.KERNEL_PAIRS:
        for staging in ("sorted", "unsorted", "per_row", "staged"):
            assert (staging, st, st, ct) in entries
    for q in (torch.int8, torch.float8_e4m3fn):
        for staging in ("sorted", "unsorted", "per_row"):
            assert (staging, q, torch.float16, torch.float32) in entries
        assert ("staged", q, torch.float16, torch.float32) not in entries
    assert ("staged", torch.float32, torch.float16, torch.float32) in entries
    assert set(txs.LAUNCHES) == {
        "sorted", "sorted_q", "unsorted", "unsorted_q", "per_row",
        "per_row_q", "staged",
    }
    # every entry is defined in the CUDA source: the staged ones by name,
    # the fused ones by one XCT_SPMM_FUSED(<staging>, ...) line each
    src = txs._SOURCE.read_text()
    for staging, v, w, c in txs.ENTRIES:
        types = "_".join(txs._NAMES[t] for t in (v, w, c))
        if staging == "staged":
            assert f"xct_spmm_staged_{types}," in src
        else:
            assert f"xct_spmm_##TAG##_{types}," in src
            assert f"XCT_SPMM_FUSED({staging}," in src


def _fused_tables(winmap, staging, buf):
    """(winsegs, segoff) numpy tables selecting one fused kernel."""
    if staging == "per_row":
        return None, None
    segs = tops.winmap_segments(winmap)
    if staging == "unsorted":
        return segs, None
    return tops.sort_segments_by_class(segs, buf)


def _as(t, a, dtype=None):
    """numpy -> torch (t=True) or jnp (t=False); None stays None."""
    if a is None:
        return None
    if t:
        out = torch.from_numpy(a)
        return out if dtype is None else out.to(TORCH[dtype])
    out = jnp.asarray(a)
    return out if dtype is None else out.astype(JNP[dtype])


@pytest.mark.parametrize("shape", SWEEP[::2])
@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("staging", ["unsorted", "per_row"])
def test_fused_stagings_match_jax_kernel(shape, pair, staging):
    """Rows 2 and 3: the unsorted-segment and per-row kernels' plain
    versions against the JAX kernels they stand for."""
    b, s, r, k, buf, c, f = shape
    storage, compute = pair
    rng = np.random.default_rng(_seed(staging, shape, pair))
    inds, vals, winmap, x = _random_ell(rng, b, s, r, k, buf, c, f)
    segs, off = _fused_tables(winmap, staging, buf)
    outs = []
    for t in (True, False):
        fn = txs.spmm_block_ell if t else jax_spmm
        cdt = (TORCH if t else JNP)[compute]
        outs.append(np.asarray(fn(
            _as(t, inds), _as(t, vals, storage), _as(t, winmap),
            _as(t, x, storage), compute_dtype=cdt, winsegs=_as(t, segs),
            segoff=_as(t, off),
        ), np.float32))
    tol = _tol(storage, compute)
    np.testing.assert_allclose(outs[0], outs[1], rtol=tol, atol=tol)


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


@pytest.mark.parametrize("pair", PAIRS)
def test_unsorted_plain_matches_jax_kernel_on_permuted_pads(pair):
    """Row 2 on a run-order table whose slots are permuted, with pads
    between live slots and a 16-row piece of a 20-column run (a bulk copy
    on the card): the plain version against the JAX kernel, which takes
    pads anywhere, and against row 1's bits on the class-sorted table."""
    b, s, r, k, buf, c, f = 2, 3, 16, 16, 64, 256, 8
    storage, compute = pair
    rng = np.random.default_rng(_seed("permuted", pair))
    inds, vals, winmap, x = _random_ell(rng, b, s, r, k, buf, c, f)
    winmap[:, :, 10:30] = np.arange(100, 120, dtype=np.int32)
    segs = _permuted_table(winmap, rng)
    outs = []
    for t in (True, False):
        fn = txs.spmm_block_ell if t else jax_spmm
        outs.append(np.asarray(fn(
            _as(t, inds), _as(t, vals, storage), _as(t, winmap),
            _as(t, x, storage), compute_dtype=(TORCH if t else JNP)[compute],
            winsegs=_as(t, segs),
        ), np.float32))
    tol = _tol(storage, compute)
    np.testing.assert_allclose(outs[0], outs[1], rtol=tol, atol=tol)
    row1 = txs.spmm_block_ell_plain(
        _as(True, inds), _as(True, vals, storage), _as(True, winmap),
        _as(True, x, storage), compute_dtype=TORCH[compute])
    np.testing.assert_array_equal(outs[0], row1.numpy())


@pytest.mark.parametrize("shape", SWEEP[1:3])
@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("staging", ["sorted", "unsorted", "per_row"])
def test_quantized_plain_matches_jax_kernel(shape, qdtype, staging):
    """Row 1q on each fused staging: packed values and per-block
    exponents from both packages (bit-equal) through the port's plain
    version and the JAX kernel with ``scales``, f16 window, f32 compute."""
    b, s, r, k, buf, c, f = shape
    rng = np.random.default_rng(_seed("q", shape, qdtype, staging))
    inds, vals, winmap, x = _random_ell(rng, b, s, r, k, buf, c, f)
    vals = vals * np.exp2(rng.integers(-6, 7, size=(b, s, 1, 1))).astype(
        np.float32
    )
    segs, off = _fused_tables(winmap, staging, buf)
    q, e = tprec.quantize_block_vals(torch.from_numpy(vals), TORCH[qdtype])
    jq, je = jprec.quantize_block_vals(jnp.asarray(vals), JNP[qdtype])
    out = txs.spmm_block_ell(
        _as(True, inds), q, _as(True, winmap), _as(True, x, "f16"),
        winsegs=_as(True, segs), segoff=_as(True, off), scales=e,
    )
    ref = jax_spmm(
        _as(False, inds), jq, _as(False, winmap), _as(False, x, "f16"),
        winsegs=_as(False, segs), segoff=_as(False, off), scales=je,
    )
    tol = _tol("f16", "f32")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)
    # the port's contract: the float path on the dequantized values, with
    # the window pre-rounded to f16, gives the same bits
    wide = tprec.dequantize_block_vals(q, e)
    x16 = _as(True, x, "f16").to(torch.float32)
    same = txs.spmm_block_ell_plain(_as(True, inds), wide, _as(True, winmap),
                                    x16)
    assert torch.equal(out, same)


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("pair", PAIRS)
def test_staged_plain_matches_jax_kernel(shape, pair):
    """Row 4: the pre-gathered window kernel's plain version against
    ``spmm_block_ell_staged`` on the same gathered windows."""
    b, s, r, k, buf, c, f = shape
    storage, compute = pair
    rng = np.random.default_rng(_seed("staged", shape, pair))
    inds, vals, winmap, x = _random_ell(rng, b, s, r, k, buf, c, f)
    window = x[winmap]  # [B, S, BUF, F]
    out = txs.spmm_block_ell_staged(
        _as(True, inds), _as(True, vals, storage), _as(True, window, storage),
        compute_dtype=TORCH[compute],
    )
    assert out.dtype == torch.float32 and out.shape == (b, r, f)
    ref = jax_staged(
        _as(False, inds), _as(False, vals, storage),
        _as(False, window, storage), compute_dtype=JNP[compute],
    )
    tol = _tol(storage, compute)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("quantized", [False, True])
def test_gather_apply_operator_matches_jax(chunked, quantized):
    """``staging="gather"``: windows gathered into memory, chunked over
    row-blocks (3 chunks of 2) or in one call, against the reference's
    gather path; q8 values are widened to f32 first, as it does."""
    b, s, r, k, buf, c, f = 6, 2, 8, 8, 16, 64, 4
    rng = np.random.default_rng(_seed("gather", chunked, quantized))
    inds, vals, winmap, x = _random_ell(rng, b, s, r, k, buf, c, f)
    kw = dict(staging="gather", blocks_per_call=2 if chunked else None)
    tv, jv = torch.from_numpy(vals), jnp.asarray(vals)
    if quantized:
        tv, te = tprec.quantize_block_vals(tv, torch.int8)
        jv, je = jprec.quantize_block_vals(jv, jnp.int8)
    out = tops.apply_operator(
        _as(True, inds), tv, _as(True, winmap), _as(True, x),
        scales=te if quantized else None, **kw,
    )
    ref = jops.apply_operator(
        _as(False, inds), jv, _as(False, winmap), _as(False, x),
        scales=je if quantized else None, **kw,
    )
    tol = _tol("f16", "f32")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)
    # chunking changes nothing, and the fused default gives the same bits
    other = tops.apply_operator(
        _as(True, inds), tv, _as(True, winmap), _as(True, x),
        scales=te if quantized else None, staging="gather",
        blocks_per_call=None if chunked else 2,
    )
    assert torch.equal(other, out)
    fused = tops.apply_operator(
        _as(True, inds), tv, _as(True, winmap), _as(True, x),
        scales=te if quantized else None,
    )
    assert torch.equal(fused, out)


def test_gather_chunking_follows_the_64mb_budget():
    """The reference's chunk sizes: the largest divisor of B whose
    gathered windows fit 64 MB (proj at n=512: 277 chunks of 24)."""
    assert tops.staged_window_bytes(26, 776, 16, 2) == 26 * 776 * 16 * 2
    assert tops._gather_blocks_per_call(6648, 26, 776, 16, 2) == 24
    assert tops._gather_blocks_per_call(8192, 20, 416, 16, 2) == 128
    assert tops._gather_blocks_per_call(8, 2, 16, 4, 2) == 8
    assert tops._gather_blocks_per_call(7, 26, 776, 16, 2, budget=1) == 1


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize(
    "pair", [("f64", "f64"), ("f32", "f32"), ("f16", "f16"), ("f16", "f32"),
             ("bf16", "bf16"), ("bf16", "f32")],
)
def test_stagings_give_row1_bits(shape, pair):
    """Port-internal: with the same window contents, the unsorted
    (row 2), per-row (row 3) and pre-gathered (row 4) plain versions give
    the class-sorted kernel's plain output bit for bit, for all six
    pairs; so does the quantized form against the float path on the
    dequantized values."""
    b, s, r, k, buf, c, f = shape
    storage, compute = pair
    st = {"f64": torch.float64, **TORCH}[storage]
    ct = {"f64": torch.float64, **TORCH}[compute]
    rng = np.random.default_rng(_seed("bits", shape, pair))
    inds, vals, winmap, x = (
        torch.from_numpy(a) for a in _random_ell(rng, b, s, r, k, buf, c, f)
    )
    vals, x = vals.to(st), x.to(st)
    row1 = txs.spmm_block_ell_plain(inds, vals, winmap, x, compute_dtype=ct)
    segs = torch.from_numpy(tops.winmap_segments(winmap.numpy()))
    row2 = txs.spmm_block_ell(inds, vals, winmap, x, compute_dtype=ct,
                              winsegs=segs)
    row4 = txs.spmm_block_ell_staged(inds, vals, x[winmap.long()],
                                     compute_dtype=ct)
    assert torch.equal(row2, row1)
    assert torch.equal(row4, row1)
    if pair == ("f16", "f32"):
        q, e = tprec.quantize_block_vals(vals.float(), torch.float8_e4m3fn)
        row1q = txs.spmm_block_ell(inds, q, winmap, x, scales=e)
        wide = tprec.dequantize_block_vals(q, e)
        assert torch.equal(row1q, txs.spmm_block_ell_plain(
            inds, wide, winmap, x.float()))


def test_rows_from_segments_reads_the_table():
    """Row 2's plain staging rebuilds the winmap from an unsorted table
    (and from its class-sorted permutation); pad slots copy nothing."""
    rng = np.random.default_rng(4)
    wm = np.sort(rng.choice(500, size=(3, 2, 40), replace=True), axis=-1)
    wm = wm.astype(np.int32)
    segs = tops.winmap_segments(wm, pad_to=16)
    assert (segs[..., 2] == 0).any()  # pad slots present
    srt, _ = tops.sort_segments_by_class(segs, 40)
    for table in (segs, srt):
        for si in range(2):
            rows = txs._rows_from_segments(torch.from_numpy(table[:, si]), 40)
            np.testing.assert_array_equal(rows.numpy(), wm[:, si])


@pytest.mark.parametrize("name", ["proj", "back"])
@pytest.mark.parametrize("mode", ["unsorted", "per_row", "gather", "q8",
                                  "fp8"])
def test_apply_operator_modes_match_jax_on_plan_shards(small_system, name,
                                                       mode):
    """Every new path on the small plan's real shards (long Hilbert runs,
    padded slots) at the mixed pair, against the reference."""
    _, _, plan = small_system
    op = getattr(plan, name)
    x = np.random.default_rng(_seed(name, mode)).normal(
        size=(op.n_cols_pad, 4)
    ).astype(np.float32)
    tvals, jvals = torch.from_numpy(op.vals[0]), jnp.asarray(op.vals[0])
    tkw, jkw = {}, {}
    if mode == "unsorted":
        segs = tops.winmap_segments(op.winmap[0])
        tkw["winsegs"], jkw["winsegs"] = torch.from_numpy(segs), segs
    elif mode == "per_row":
        tkw["dma"] = jkw["dma"] = "per_row"
    elif mode == "gather":
        tkw["staging"] = jkw["staging"] = "gather"
    else:
        tvals, tkw["scales"] = tprec.quantize_block_vals(tvals, TORCH[
            "int8" if mode == "q8" else "fp8"])
        jvals, jkw["scales"] = jprec.quantize_block_vals(jvals, JNP[
            "int8" if mode == "q8" else "fp8"])
    out = tops.apply_operator(
        torch.from_numpy(op.inds[0]), tvals, torch.from_numpy(op.winmap[0]),
        torch.from_numpy(x), **tkw,
    )
    ref = jops.apply_operator(
        jnp.asarray(op.inds[0]), jvals, jnp.asarray(op.winmap[0]),
        jnp.asarray(x), **jkw,
    )
    tol = _tol("f16", "f32")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)
