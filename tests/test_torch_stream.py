"""Out-of-core streaming in the PyTorch port, on the CPU.

The counterparts of ``test_stream.py`` (store integrity, slab parity,
budget, resume, the prefetcher) and of the store, streaming-chaos and
crash-resume tests of ``test_resil.py``, on the port's ``Reconstructor``
(n=32, 48 angles, ``single``, ``fuse=2``, Y=8).  Every streamed slab
equals the port's in-memory solve of the same slab shape bit for bit,
and every healed drain the clean one.  Against the JAX package: the same
store drained by ``repro.stream`` and by the port agrees to the
``single`` tolerance of the recon parity test (not bit for bit: the CG's
row sums reduce in another order than XLA's), and stores and resume
checkpoints cross between the packages in both directions.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro.core.recon import ReconConfig as JaxConfig
from repro.core.recon import Reconstructor as JaxReconstructor
from repro.stream import SlabStore as JaxSlabStore
from repro.stream import reconstruct_streaming as jax_streaming
from repro.stream import simulate_to_store as jax_simulate_to_store
from repro_torch.core import geometry as tgeo
from repro_torch.core import partition as tpart
from repro_torch.core.recon import ReconConfig, Reconstructor, StagedSlab
from repro_torch.data.phantom import phantom_slices, simulate_measurements
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.resil import (
    CorruptShardError,
    FaultPlan,
    InjectedIOError,
    InjectedPreemption,
    RetryPolicy,
    inject,
)
from repro_torch.stream import (
    PrefetchError,
    Prefetcher,
    SlabStore,
    reconstruct_streaming,
    simulate_to_store,
    suggest_slab,
)

Y = 8  # slices in the streaming fixtures (multiple of fuse=2)
FAST = RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0)
TOL = 1e-4  # test_torch_recon.py's single tolerance against JAX


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The drains run many small torch ops: one intra-op thread keeps the
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_plan(small_system):
    geo, _, plan = small_system
    return tpart.plan_from_arrays(
        tpart.plan_to_arrays(plan),
        tgeo.XCTGeometry(geo.n, geo.n_angles),
        tpart.PartitionConfig(tile=4, rows_per_block=16, nnz_per_stage=16),
    )


def _rec(plan, precision="single"):
    return Reconstructor(
        plan, cfg=ReconConfig(precision=precision, comm_mode="rs", fuse=2),
        device="cpu",
    )


@pytest.fixture(scope="module")
def rec(port_plan):
    return _rec(port_plan)


@pytest.fixture(scope="module")
def sino8(small_system):
    geo, a, _ = small_system
    x = phantom_slices(geo.n, Y, seed=5)
    return simulate_measurements(a, x, noise=0.01, seed=5)


@pytest.fixture(scope="module")
def sino_store(small_system, tmp_path_factory):
    """One store for the module: faults act on what a read returns, never
    on the shards."""
    geo, a, _ = small_system
    store = SlabStore.create(str(tmp_path_factory.mktemp("s") / "sino"),
                             geo.n_rays, Y, 2)
    simulate_to_store(a, geo.n, store, noise=0.01, seed=5)
    return store


@pytest.fixture(scope="module")
def clean(rec, sino_store, tmp_path_factory):
    """The uninterrupted drain at ``(iters, y_slab)``, drained once."""
    root = tmp_path_factory.mktemp("clean")
    cache = {}

    def get(iters, y_slab=2):
        if (iters, y_slab) not in cache:
            cache[iters, y_slab] = reconstruct_streaming(
                rec, sino_store, str(root / f"{iters}_{y_slab}"),
                iters=iters, y_slab=y_slab,
            )
        return cache[iters, y_slab]

    return get


@pytest.fixture()
def fresh_obs():
    """Isolated metrics + tracer so counter asserts see only this test."""
    old_t = obs_trace.set_tracer(obs_trace.Tracer(enabled=True))
    old_m = obs_metrics.set_metrics(obs_metrics.Metrics())
    try:
        yield obs_trace.get_tracer(), obs_metrics.get_metrics()
    finally:
        obs_trace.set_tracer(old_t)
        obs_metrics.set_metrics(old_m)


# --------------------------------------------------------------------- #
# store
# --------------------------------------------------------------------- #
def test_slab_store_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    arr = rng.standard_normal((13, 10)).astype(np.float32)
    store = SlabStore.from_array(str(tmp_path / "s"), arr, slab=3)
    assert store.slabs() == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert store.complete()
    np.testing.assert_array_equal(store.to_array(), arr)
    np.testing.assert_array_equal(store.read(2, 8), arr[:, 2:8])
    again = SlabStore.open(str(tmp_path / "s"))
    np.testing.assert_array_equal(again.read(9, 10), arr[:, 9:])


def test_slab_store_guards(tmp_path):
    store = SlabStore.create(str(tmp_path / "s"), 4, 8, 4)
    with pytest.raises(ValueError):  # unaligned start
        store.write(2, np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):  # wrong shape
        store.write(0, np.zeros((4, 3), np.float32))
    with pytest.raises(FileNotFoundError):  # unwritten slab
        store.read(0, 4)
    assert not store.complete()
    with pytest.raises(ValueError):  # conflicting re-create
        SlabStore.create(str(tmp_path / "s"), 4, 8, 2)


def test_simulate_to_store_matches_oneshot(sino_store, sino8):
    np.testing.assert_array_equal(sino_store.to_array(), sino8)


def test_phantom_slab_range_invariant():
    full = phantom_slices(16, 6, seed=2)
    parts = [phantom_slices(16, 6, seed=2, start=j, stop=min(j + 4, 6))
             for j in (0, 4)]
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), full)


def test_simulate_chunk_kwarg_invariant(small_system):
    geo, a, _ = small_system
    x = phantom_slices(geo.n, 6, seed=1)
    np.testing.assert_array_equal(
        simulate_measurements(a, x, noise=0.05, seed=1, chunk=1),
        simulate_measurements(a, x, noise=0.05, seed=1, chunk=64))


def test_slab_store_concurrent_range_reads(tmp_path):
    rng = np.random.default_rng(3)
    arr = rng.standard_normal((17, 12)).astype(np.float32)
    store = SlabStore.from_array(str(tmp_path / "c"), arr, slab=4)
    ranges = [(0, 8), (4, 12), (2, 10), (0, 12)]
    results, errors = {}, []

    def reader(tid, j0, j1):
        try:
            acc = [store.read(j0, j1) for _ in range(20)]
            for a in acc[1:]:
                np.testing.assert_array_equal(acc[0], a)
            results[tid] = acc[0]
        except Exception as e:  # noqa: BLE001
            errors.append((tid, e))

    threads = [threading.Thread(target=reader, args=(i, j0, j1))
               for i, (j0, j1) in enumerate(ranges)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for i, (j0, j1) in enumerate(ranges):
        np.testing.assert_array_equal(results[i], arr[:, j0:j1])


def test_store_records_and_verifies_checksums(tmp_path):
    arr = np.random.default_rng(0).standard_normal((6, 8)).astype(np.float32)
    SlabStore.from_array(str(tmp_path / "s"), arr, slab=4)
    with open(tmp_path / "s" / "manifest.json") as f:
        man = json.load(f)
    assert man["checksum_algo"] == "crc32"
    assert set(man["checksums"]) == {"0_4", "4_8"}
    again = SlabStore.create(str(tmp_path / "s"), 6, 8, 4)
    assert again._checksums == {k: int(v) for k, v in man["checksums"].items()}
    np.testing.assert_array_equal(again.to_array(), arr)


def test_store_detects_on_disk_corruption(tmp_path):
    arr = np.ones((4, 4), np.float32)
    store = SlabStore.from_array(str(tmp_path / "s"), arr, slab=4)
    with open(store._shard_path(0, 4), "r+b") as f:  # flip a payload byte
        f.seek(-3, os.SEEK_END)
        b = f.read(1)
        f.seek(-3, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))
    fresh = SlabStore.open(str(tmp_path / "s"))
    with pytest.raises(CorruptShardError, match="crc"):
        fresh.read(0, 4)
    fresh.write(0, arr)  # a re-write replaces the shard and its crc
    np.testing.assert_array_equal(fresh.read(0, 4), arr)


def test_store_verify_cache_bypassed_while_injecting(tmp_path):
    arr = np.full((3, 2), 7.0, np.float32)
    store = SlabStore.from_array(str(tmp_path / "s"), arr, slab=2)
    np.testing.assert_array_equal(store.read(0, 2), arr)  # verified+cached
    plan = FaultPlan(seed=2).add("store/read", "corrupt", key=0,
                                 attempts=(0,))
    with inject.activate(plan):
        with pytest.raises(CorruptShardError):
            store.read(0, 2)  # the cache must not mask the injected flip
        np.testing.assert_array_equal(store.read(0, 2), arr)  # healed
    np.testing.assert_array_equal(store.read(0, 2), arr)


# --------------------------------------------------------------------- #
# scheduler
# --------------------------------------------------------------------- #
def test_suggest_slab_formula_and_guard(port_plan, rec):
    plan, topo = port_plan, rec.topology
    budget = plan.proj.hbm_bytes() + plan.back.hbm_bytes() + 1_000_000
    sp = suggest_slab(plan, rec.cfg, topo, budget, n_slices=Y)
    assert sp.granule == 2 and sp.y_slab % 2 == 0
    assert sp.slab_bytes <= budget
    # 5 host copies + the overlap-staged device sinogram of slab i+1,
    # and the port's own device terms
    per = (4 * 5 * (plan.proj.n_rows_pad + plan.proj.n_cols_pad)
           + 4 * plan.proj.n_rows_pad)
    assert sp.per_slice_bytes == per + sp.extra_per_slice_bytes
    with pytest.raises(ValueError):  # the operator alone overflows
        suggest_slab(plan, rec.cfg, topo, sp.fixed_bytes)
    sync = suggest_slab(plan, rec.cfg, topo, budget, n_slices=Y,
                        overlap=False)
    assert sync.per_slice_bytes < sp.per_slice_bytes  # one staging copy


def test_prefetcher_orders_and_propagates_errors():
    def fetch(i):
        if i == 3:
            raise RuntimeError("boom")
        return i * 10

    assert list(Prefetcher(fetch, [0, 1, 2], depth=1)) == [
        (0, 0), (1, 10), (2, 20)]
    with pytest.raises(RuntimeError, match="boom"):
        list(Prefetcher(fetch, [3], depth=1))
    assert list(Prefetcher(lambda i: i, [5, 6], enabled=False)) == [
        (5, 5), (6, 6)]


def test_prefetcher_error_names_failing_item():
    def fetch(i):
        if i == 12:
            raise OSError("disk gone")
        return i

    got = []
    with pytest.raises(PrefetchError, match=r"item 12 .*disk gone") as e:
        for item, _ in Prefetcher(fetch, [4, 8, 12, 16], depth=1):
            got.append(item)
    assert got == [4, 8]
    assert e.value.item == 12 and e.value.index == 2
    assert isinstance(e.value.__cause__, OSError)
    with pytest.raises(PrefetchError, match="item 12"):
        list(Prefetcher(fetch, [12], enabled=False))


def test_prefetcher_stage_applies_and_times():
    for enabled in (True, False):
        pre = Prefetcher(lambda i: i * 10, [1, 1], stage=lambda v: v + 5,
                         enabled=enabled)
        assert list(pre) == [(1, 15), (1, 15)]
        assert set(pre.times) == {0, 1}
        for t in pre.times.values():
            assert t["load"] >= 0.0 and t["stage"] >= 0.0
    pre = Prefetcher(lambda a: float(a.sum()), [np.zeros(2)], depth=1)
    out = list(pre)
    assert len(out) == 1 and out[0][1] == 0.0 and 0 in pre.times
    with pytest.raises(PrefetchError, match="item 7"):
        list(Prefetcher(
            lambda i: i, [7],
            stage=lambda v: (_ for _ in ()).throw(ValueError("up")),
        ))


# --------------------------------------------------------------------- #
# driver: parity, budget, resume
# --------------------------------------------------------------------- #
def test_streaming_matches_in_memory_slicewise(rec, sino_store, sino8,
                                               clean):
    """Each streamed slab is bit for bit the in-memory solve of that slab;
    the assembled volume tracks the full-Y solve (another column count,
    so another reduction order in the CG's row sums) to well under the
    phantom scale."""
    res = clean(8, 4)
    assert res.complete and res.solved == [0, 4]
    for j0, j1 in res.volume.slabs():
        x_mem, r_mem = rec.reconstruct(sino8[:, j0:j1], iters=8)
        np.testing.assert_array_equal(res.volume.read(j0, j1), x_mem)
        np.testing.assert_array_equal(res.resnorms[:, j0:j1], r_mem)
    x_full, _ = rec.reconstruct(sino8, iters=8)
    num = np.linalg.norm(res.volume.to_array() - x_full, axis=0)
    assert (num / np.linalg.norm(x_full, axis=0)).max() < 1e-2


def test_streaming_budget_smaller_than_volume_completes(
    rec, port_plan, sino_store, sino8, tmp_path
):
    sp = suggest_slab(port_plan, rec.cfg, rec.topology, 1 << 40)
    full_need = sp.fixed_bytes + Y * sp.per_slice_bytes
    budget = sp.fixed_bytes + (Y // 2) * sp.per_slice_bytes
    assert budget < full_need
    res = reconstruct_streaming(rec, sino_store, str(tmp_path / "vol"),
                                iters=6, mem_budget=budget)
    assert res.complete and len(res.solved) >= 2
    for j0, j1 in res.volume.slabs():
        x_mem, _ = rec.reconstruct(sino8[:, j0:j1], iters=6)
        np.testing.assert_array_equal(res.volume.read(j0, j1), x_mem)


def test_streaming_resume_skips_and_matches(rec, sino_store, tmp_path,
                                            clean):
    base = clean(6)
    ck = str(tmp_path / "ck")
    part = reconstruct_streaming(
        rec, sino_store, str(tmp_path / "v1"), iters=6, y_slab=2,
        ckpt_dir=ck, checkpoint_every=1, max_slabs=2,
    )
    assert part.solved == [0, 2] and not part.complete
    rest = reconstruct_streaming(rec, sino_store, str(tmp_path / "v1"),
                                 iters=6, y_slab=2, ckpt_dir=ck)
    assert rest.skipped == [0, 2] and rest.solved == [4, 6]
    assert rest.complete
    np.testing.assert_array_equal(rest.volume.to_array(),
                                  base.volume.to_array())
    np.testing.assert_array_equal(rest.resnorms, base.resnorms)
    with pytest.raises(ValueError, match="manifest"):
        reconstruct_streaming(rec, sino_store, str(tmp_path / "v1"),
                              iters=6, y_slab=4, ckpt_dir=ck)
    with pytest.raises(ValueError, match="y_slab|checkpoint"):
        reconstruct_streaming(rec, sino_store, str(tmp_path / "v2"),
                              iters=6, y_slab=4, ckpt_dir=ck)


def test_streaming_overlap_is_pure_schedule(rec, sino_store, tmp_path):
    outs = {}
    for overlap in (False, True):
        for upload in ("sync", "overlap"):
            tag = f"{overlap}-{upload}"
            outs[tag] = reconstruct_streaming(
                rec, sino_store, str(tmp_path / tag), iters=5, y_slab=4,
                overlap=overlap, device_upload=upload,
            )
    base = outs["False-sync"].volume.to_array()
    for res in outs.values():
        np.testing.assert_array_equal(base, res.volume.to_array())
    assert outs["True-overlap"].upload_overlapped
    assert not outs["True-sync"].upload_overlapped
    assert not outs["False-overlap"].upload_overlapped
    # the timing split is recorded for every solved slab, in both modes
    for tag in ("True-sync", "True-overlap"):
        res = outs[tag]
        assert len(res.solved) == len(res.load_s) == len(res.upload_s) \
            == len(res.solve_s) == 2
        assert all(t > 0 for t in res.solve_s)
        assert all(t >= 0 for t in res.load_s + res.upload_s)
    with pytest.raises(ValueError, match="device_upload"):
        reconstruct_streaming(rec, sino_store, str(tmp_path / "bad"),
                              iters=2, y_slab=4, device_upload="nope")


def test_staged_slab_reconstruct_matches(rec, sino8):
    y = sino8[:, :4]
    staged = rec.stage_sino(y)
    assert isinstance(staged, StagedSlab) and staged.n_slices == 4
    x_direct, r_direct = rec.reconstruct(y, iters=5)
    x_staged, r_staged = rec.reconstruct(staged, iters=5)
    np.testing.assert_array_equal(x_direct, x_staged)
    np.testing.assert_array_equal(r_direct, r_staged)


def test_streaming_guards(rec, sino_store, tmp_path):
    with pytest.raises(ValueError, match="exactly one"):
        reconstruct_streaming(rec, sino_store, str(tmp_path / "v"), iters=2)
    with pytest.raises(ValueError, match="multiple"):
        reconstruct_streaming(rec, sino_store, str(tmp_path / "v"), iters=2,
                              y_slab=3)
    bad = SlabStore.create(str(tmp_path / "bad"), 7, Y, 2)
    with pytest.raises(ValueError, match="rows"):
        reconstruct_streaming(rec, bad, str(tmp_path / "v"), iters=2,
                              y_slab=2)
    assert os.path.isdir(sino_store.directory)


# --------------------------------------------------------------------- #
# chaos: the drain heals, bit for bit
# --------------------------------------------------------------------- #
def test_streaming_transient_faults_bit_exact(rec, sino_store, tmp_path,
                                              fresh_obs, clean):
    _, m = fresh_obs
    base = clean(6)
    plan = (
        FaultPlan(seed=7)
        .add("store/read", "io_error", key=0, attempts=(0,))
        .add("store/read", "corrupt", key=4, attempts=(0,))
        .add("recon/solve", "nonfinite", key=1, attempts=(0,))
    )
    with inject.activate(plan) as h:
        chaos = reconstruct_streaming(
            rec, sino_store, str(tmp_path / "chaos"), iters=6, y_slab=2,
            retry=FAST,
        )
    assert chaos.complete and chaos.failed_slabs == []
    assert chaos.retries >= 3
    assert sorted(f[3] for f in h.fired) == ["corrupt", "io_error",
                                             "nonfinite"]
    np.testing.assert_array_equal(chaos.volume.to_array(),
                                  base.volume.to_array())
    np.testing.assert_array_equal(chaos.resnorms, base.resnorms)
    assert m.get("retries_total", site="stream/load") >= 1
    assert m.get("retries_total", site="stream/solve") >= 1
    assert m.get("faults_injected_total", site="store/read",
                 kind="io_error") == 1


def test_streaming_quarantines_poison_slab_and_resumes(
    rec, sino_store, tmp_path, fresh_obs, clean
):
    _, m = fresh_obs
    base = clean(6)
    plan = FaultPlan(seed=11).add("store/read", "io_error", key=4,
                                  attempts=None)
    ck = str(tmp_path / "ck")
    with inject.activate(plan):
        part = reconstruct_streaming(
            rec, sino_store, str(tmp_path / "vol"), iters=6, y_slab=2,
            retry=FAST, ckpt_dir=ck,
        )
    assert part.failed_slabs == [4] and not part.complete
    assert sorted(part.solved) == [0, 2, 6]
    assert part.retries > 0
    assert m.get("slabs_quarantined_total") == 1
    for j0, j1 in base.volume.slabs():
        if j0 != 4:
            np.testing.assert_array_equal(part.volume.read(j0, j1),
                                          base.volume.read(j0, j1))
    rest = reconstruct_streaming(rec, sino_store, str(tmp_path / "vol"),
                                 iters=6, y_slab=2, retry=FAST, ckpt_dir=ck)
    assert rest.solved == [4] and rest.complete
    assert sorted(rest.skipped) == [0, 2, 6]
    np.testing.assert_array_equal(rest.volume.to_array(),
                                  base.volume.to_array())


def test_streaming_fail_fast_propagates(rec, sino_store, tmp_path):
    plan = FaultPlan(seed=1).add("store/read", "io_error", key=0,
                                 attempts=None)
    with inject.activate(plan):
        with pytest.raises(Exception) as e:
            reconstruct_streaming(rec, sino_store, str(tmp_path / "v"),
                                  iters=3, y_slab=2, fail_fast=True)
    exc = e.value
    assert isinstance(exc, InjectedIOError) or isinstance(
        getattr(exc, "cause", exc.__cause__), InjectedIOError)


def test_streaming_thread_death_recovers_via_sync_retry(
    rec, sino_store, tmp_path, fresh_obs, clean
):
    _, m = fresh_obs
    base = clean(5)
    plan = FaultPlan(seed=5).add("stream/load", "thread_death", key=1,
                                 attempts=(0,))
    with inject.activate(plan):
        res = reconstruct_streaming(rec, sino_store, str(tmp_path / "v"),
                                    iters=5, y_slab=2, retry=FAST)
    assert res.complete and res.failed_slabs == []
    assert res.retries >= 1
    assert m.get("retries_total", site="stream/slab") == 1
    np.testing.assert_array_equal(res.volume.to_array(),
                                  base.volume.to_array())


def test_streaming_nonfinite_escalates_one_rung(port_plan, sino_store,
                                                tmp_path, fresh_obs):
    """A q8 solve that keeps blowing up re-solves at f32 on the same
    device (the rung-up ``Reconstructor`` shares the topology: on the CPU
    it never asks for a card), equal to the single drain's slab; f64 has
    no rung to go to and quarantines."""
    _, m = fresh_obs
    rec_q8 = _rec(port_plan, "q8")
    fplan = FaultPlan(seed=9).add("recon/solve", "nonfinite", key=2,
                                  attempts=None, when={"precision": "q8"})
    with inject.activate(fplan):
        res = reconstruct_streaming(
            rec_q8, sino_store, str(tmp_path / "v"), iters=5, y_slab=2,
            retry=RetryPolicy(max_attempts=2, base_delay_s=0.0),
        )
    assert res.complete and res.failed_slabs == []
    assert res.escalated == [4]
    assert m.get("stream_escalations_total") == 1
    single, _ = _rec(port_plan).reconstruct(
        sino_store.read(4, 6), iters=5)
    np.testing.assert_array_equal(res.volume.read(4, 6), single)
    rec_f64 = _rec(port_plan, "double")
    fplan2 = FaultPlan(seed=9).add("recon/solve", "nonfinite", key=2,
                                   attempts=None)
    with inject.activate(fplan2):
        res2 = reconstruct_streaming(
            rec_f64, sino_store, str(tmp_path / "v2"), iters=5, y_slab=2,
            retry=RetryPolicy(max_attempts=2, base_delay_s=0.0),
        )
    assert res2.failed_slabs == [4] and not res2.complete


def test_streaming_straggler_shrinks_lookahead(rec, sino_store, tmp_path,
                                               fresh_obs, clean):
    _, m = fresh_obs
    base = clean(4)
    m.reset()
    plan = FaultPlan(seed=4).add("stream/load", "slow", key=2,
                                 attempts=(0,), delay_s=0.5)
    with inject.activate(plan):
        res = reconstruct_streaming(rec, sino_store, str(tmp_path / "v"),
                                    iters=4, y_slab=2, retry=FAST,
                                    straggler_k_mad=4.0)
    assert res.complete and 2 in res.stragglers
    assert m.get("stream_stragglers_total") == 1
    assert m.get("stream_prefetch_lookahead") == 0.0
    np.testing.assert_array_equal(res.volume.to_array(),
                                  base.volume.to_array())


def test_crash_resume_bit_exact_at_every_slab(rec, sino_store, tmp_path,
                                              clean):
    base = clean(4)
    n_slabs = len(base.volume.slabs())
    for k in range(n_slabs):
        out, ck = str(tmp_path / f"v{k}"), str(tmp_path / f"ck{k}")
        plan = FaultPlan(seed=k).add("stream/after_slab", "preempt", key=k,
                                     attempts=(0,))
        with inject.activate(plan):
            with pytest.raises(InjectedPreemption):
                reconstruct_streaming(rec, sino_store, out, iters=4,
                                      y_slab=2, ckpt_dir=ck,
                                      checkpoint_every=1)
        rest = reconstruct_streaming(rec, sino_store, out, iters=4,
                                     y_slab=2, ckpt_dir=ck)
        assert rest.complete
        assert len(rest.skipped) == k + 1
        assert len(rest.solved) == n_slabs - k - 1
        np.testing.assert_array_equal(rest.volume.to_array(),
                                      base.volume.to_array())
        np.testing.assert_array_equal(rest.resnorms, base.resnorms)


# --------------------------------------------------------------------- #
# against the JAX package
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_rec(small_system):
    _, _, plan = small_system
    return JaxReconstructor(
        plan, cfg=JaxConfig(precision="single", comm_mode="rs", fuse=2))


def test_streaming_matches_jax_package(jax_rec, sino_store, clean,
                                       tmp_path):
    """The same store drained by ``repro.stream`` and by the port at the
    same ``y_slab``: the same slab schedule, volumes and residual norms
    within the single tolerance after the recon parity test's 5
    iterations.  Not bit for bit: the operators are
    (``test_torch_recon.py``), the CG's row sums are not."""
    ours = clean(5, 4)
    theirs = jax_streaming(jax_rec, sino_store, str(tmp_path / "jax"),
                           iters=5, y_slab=4)
    assert (ours.y_slab, ours.solved) == (theirs.y_slab, theirs.solved)
    x, jx = ours.volume.to_array(), theirs.volume.to_array()
    np.testing.assert_allclose(x, jx, rtol=TOL, atol=TOL * np.abs(jx).max())
    np.testing.assert_allclose(ours.resnorms, theirs.resnorms, rtol=TOL,
                               atol=TOL * np.abs(theirs.resnorms).max())
    assert np.isfinite(x).all() and not np.array_equal(x, jx)


def test_reference_store_and_checkpoint_resume_in_the_port(
    small_system, jax_rec, rec, sino8, tmp_path
):
    """A store simulated by the reference opens in the port with the same
    bytes; a drain the reference stopped after two slabs resumes in the
    port from the reference's manifest, skipping those slabs."""
    geo, a, _ = small_system
    jstore = JaxSlabStore.create(str(tmp_path / "sino"), geo.n_rays, Y, 2)
    jax_simulate_to_store(a, geo.n, jstore, noise=0.01, seed=5)
    store = SlabStore.open(jstore.directory)
    np.testing.assert_array_equal(store.to_array(), sino8)
    out, ck = str(tmp_path / "vol"), str(tmp_path / "ck")
    part = jax_streaming(jax_rec, jstore, out, iters=4, y_slab=2,
                         ckpt_dir=ck, checkpoint_every=1, max_slabs=2)
    assert part.solved == [0, 2]
    rest = reconstruct_streaming(rec, store, out, iters=4, y_slab=2,
                                 ckpt_dir=ck)
    assert rest.skipped == [0, 2] and rest.solved == [4, 6]
    assert rest.complete
    for j0, j1 in rest.volume.slabs():
        want = (np.asarray(part.volume.read(j0, j1)) if j0 < 4 else
                rec.reconstruct(sino8[:, j0:j1], iters=4)[0])
        np.testing.assert_array_equal(rest.volume.read(j0, j1), want)
    np.testing.assert_array_equal(rest.resnorms[:, :4], part.resnorms[:, :4])


def test_port_store_and_checkpoint_resume_in_the_reference(
    jax_rec, rec, sino_store, sino8, tmp_path
):
    """The other way: the port's store opens in the reference, and a
    drain the port stopped resumes in the reference from the port's
    manifest."""
    jstore = JaxSlabStore.open(sino_store.directory)
    np.testing.assert_array_equal(jstore.to_array(), sino8)
    out, ck = str(tmp_path / "vol"), str(tmp_path / "ck")
    part = reconstruct_streaming(rec, sino_store, out, iters=4, y_slab=4,
                                 ckpt_dir=ck, checkpoint_every=1,
                                 max_slabs=1)
    assert part.solved == [0]
    rest = jax_streaming(jax_rec, jstore, out, iters=4, y_slab=4,
                         ckpt_dir=ck)
    assert rest.skipped == [0] and rest.solved == [4] and rest.complete
    np.testing.assert_array_equal(
        np.asarray(rest.volume.read(0, 4)),
        rec.reconstruct(sino8[:, :4], iters=4)[0])
    np.testing.assert_array_equal(rest.resnorms[:, :4], part.resnorms[:, :4])
