"""repro_torch.serve on the CPU: plan cache, admission, batching, previews.

The counterparts of every case of ``test_serve.py`` on the port's
``ReconServer`` (``device="cpu"``; n=32, 48 angles, ``single``,
``fuse=2``, Y=8, 4-slice slabs), and of ``test_obs.py``'s failed-job
telemetry case.  Then side by side with the JAX package on the same
seeded inputs: the batching functions take the reference's decisions,
``AdmissionController.price`` is the reference's ``JobCost`` plus the
port's own device terms (``stream.scheduler.port_extras``), and a served
job's volume is within ``test_torch_stream.py``'s tolerance of the JAX
server's and equal, bit for bit, to the port's own streamed volume.
"""
import doctest
import importlib
import os
import threading

import numpy as np
import pytest
import torch

from repro.core.partition import PartitionConfig as JPcfg
from repro.core.recon import ReconConfig as JCfg
from repro.dist import Topology as JTopo
from repro.serve import AdmissionController as JAdmission
from repro.serve import Job as JJob
from repro.serve import JobSpec as JJobSpec
from repro.serve import ReconServer as JServer
from repro.serve import fair_order as jfair_order
from repro.serve import form_batch as jform_batch
from repro.serve import interleave_slabs as jinterleave
from repro_torch.core.geometry import XCTGeometry
from repro_torch.core.partition import PartitionConfig, estimate_plan
from repro_torch.core.precision import get_policy
from repro_torch.core.recon import ReconConfig
from repro_torch.data.phantom import phantom_slices, simulate_measurements
from repro_torch.dist import Topology
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.resil import FaultPlan, inject
from repro_torch.serve import (
    AdmissionController,
    Job,
    JobCost,
    JobSpec,
    PlanCache,
    ReconServer,
    fair_order,
    form_batch,
    interleave_slabs,
)
from repro_torch.stream import SlabStore, reconstruct_streaming
from repro_torch.stream.scheduler import port_extras

Y = 8  # slices per job (multiple of fuse=2)
ITERS = 4
Y_SLAB = 4
BUDGET = 2 * 2**30
TOL = 1e-4  # test_torch_stream.py's tolerance against the JAX package


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: one intra-op thread keeps the test workers
    from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def geo(small_system):
    g = small_system[0]
    return XCTGeometry(n=g.n, n_angles=g.n_angles)


@pytest.fixture(scope="module")
def pcfg():
    return PartitionConfig(
        n_data=1, tile=4, rows_per_block=16, nnz_per_stage=16
    )


@pytest.fixture(scope="module")
def rcfg():
    return ReconConfig(precision="single", comm_mode="rs", fuse=2)


@pytest.fixture(scope="module")
def sinos(small_system):
    _, a, _ = small_system
    out = []
    for seed in (11, 12, 13):
        x = phantom_slices(32, Y, seed=seed)
        out.append(simulate_measurements(a, x, noise=0.01, seed=seed))
    return out


def _server(budget=BUDGET, **kw):
    return ReconServer(budget, device="cpu", **kw)


@pytest.fixture(scope="module")
def reference(geo, pcfg, rcfg, sinos, tmp_path_factory):
    """Each job's volume, run ALONE through the port's streaming driver,
    on the plan the server builds."""
    from repro_torch.core.partition import build_plan
    from repro_torch.core.recon import Reconstructor

    rec = Reconstructor(build_plan(geo, pcfg), cfg=rcfg, device="cpu")
    vols = []
    for i, sino in enumerate(sinos):
        tmp = tmp_path_factory.mktemp(f"ref{i}")
        store = SlabStore.from_array(
            str(tmp / "sino"), sino, slab=Y_SLAB
        )
        res = reconstruct_streaming(
            rec, store, str(tmp / "vol"), iters=ITERS, y_slab=Y_SLAB
        )
        vols.append(res.volume.to_array())
    return vols


def _spec(geo, sino, pcfg, rcfg, **kw):
    kw.setdefault("iters", ITERS)
    kw.setdefault("y_slab", Y_SLAB)
    return JobSpec(geo=geo, sino=sino, pcfg=pcfg, rcfg=rcfg, **kw)


# --------------------------------------------------------------------- #
# the warm path (tentpole acceptance)
# --------------------------------------------------------------------- #
def test_warm_job_skips_cold_path_and_is_faster(
    geo, pcfg, rcfg, sinos, tmp_path
):
    """The reference's cold path includes the solver's compile; the
    port's has none, and at n=32 its build (about 0.05 s) is below a slab
    solve's spread on a shared CPU.  A ``slow`` fault at ``serve/build``
    on every build (1 s) stands in for the cold path's cost: a warm job
    that built again would pay it too."""
    srv = _server(workdir=str(tmp_path))
    plan = FaultPlan(seed=0).add("serve/build", "slow", attempts=None,
                                 delay_s=1.0)
    with inject.activate(plan) as handle:
        cold = srv.submit(_spec(geo, sinos[0], pcfg, rcfg))
        assert srv.drain() == 1 and cold.status == "done"
        assert srv.cache.stats()["builds"] == 1
        assert cold.telemetry.plan_cold

        warm = srv.submit(_spec(geo, sinos[1], pcfg, rcfg, tenant="b"))
        assert warm.plan_key == cold.plan_key
        assert srv.drain() == 1 and warm.status == "done"
    assert handle.fired == [("serve/build", None, 0, "slow")]
    st = srv.cache.stats()
    # ZERO new partition/winseg builds: the cache counters are the proof
    assert st["builds"] == 1 and st["misses"] == 1 and st["hits"] == 1
    assert not warm.telemetry.plan_cold
    # and the warm job reaches its first slab strictly sooner
    assert (
        warm.telemetry.first_slab_s
        < cold.telemetry.first_slab_s
    )


def test_concurrent_jobs_bit_exact_vs_streaming(
    geo, pcfg, rcfg, sinos, reference, tmp_path
):
    events = []
    srv = _server(
        workdir=str(tmp_path),
        on_preview=lambda job, pv: events.append(
            (job.id, job.status, pv.j0, pv.j1)
        ),
    )
    jobs = [
        srv.submit(_spec(geo, s, pcfg, rcfg, tenant=f"t{i}"))
        for i, s in enumerate(sinos)
    ]
    assert srv.drain() == 3
    # one batch, one cold build, everything coalesced
    assert len(srv.batches) == 1
    assert srv.batches[0]["jobs"] == [j.id for j in jobs]
    assert srv.cache.stats()["builds"] == 1
    for job, ref in zip(jobs, reference):
        assert job.status == "done"
        np.testing.assert_array_equal(job.volume.to_array(), ref)
        assert job.resnorms.shape == (ITERS, Y)
    # previews streamed round-robin while every job was still running
    assert all(status == "running" for _, status, _, _ in events)
    first_three = [jid for jid, _, _, _ in events[:3]]
    assert sorted(first_three) == [j.id for j in jobs]
    # telemetry split covers the work
    for job in jobs:
        t = job.telemetry
        assert t.n_slabs == Y // Y_SLAB
        assert t.solve_s > 0 and t.total_s > 0


def test_jobs_visible_and_volumes_on_disk(geo, pcfg, rcfg, sinos,
                                          tmp_path):
    srv = _server(workdir=str(tmp_path))
    job = srv.submit(_spec(geo, sinos[0], pcfg, rcfg))
    srv.drain()
    assert srv.job(job.id) is job
    assert job.volume.complete()
    for pv in job.previews:
        assert os.path.exists(pv.path)  # previews ARE the shards
    st = srv.stats()
    assert st["completed"] == 1 and st["queued"] == 0


# --------------------------------------------------------------------- #
# admission control
# --------------------------------------------------------------------- #
def test_admission_rejects_impossible_jobs(geo, pcfg, rcfg, sinos,
                                           tmp_path):
    srv = _server(2**20, workdir=str(tmp_path))  # 1 MiB: hopeless
    job = srv.submit(_spec(geo, sinos[0], pcfg, rcfg, y_slab=None))
    assert job.status == "rejected" and job.terminal
    assert "mem_budget" in job.error
    assert srv.stats()["rejected"] == 1
    assert srv.cache.stats()["builds"] == 0  # pricing never builds


def test_admission_rejects_bad_specs(geo, pcfg, rcfg, sinos, tmp_path):
    srv = _server(workdir=str(tmp_path))
    wrong_rows = np.zeros((7, Y), np.float32)
    j = srv.submit(_spec(geo, wrong_rows, pcfg, rcfg))
    assert j.status == "rejected" and "rays" in j.error
    odd = srv.submit(
        _spec(geo, sinos[0][:, :5], pcfg, rcfg, y_slab=None)
    )
    assert odd.status == "rejected" and "granule" in odd.error
    ragged = srv.submit(_spec(geo, sinos[0], pcfg, rcfg, y_slab=3))
    assert ragged.status == "rejected" and "multiple" in ragged.error
    assert srv.drain() == 0


def test_admission_bounds_the_backlog(geo, pcfg, rcfg, sinos, tmp_path):
    srv = _server(workdir=str(tmp_path), max_queue=2)
    a = srv.submit(_spec(geo, sinos[0], pcfg, rcfg))
    b = srv.submit(_spec(geo, sinos[1], pcfg, rcfg))
    c = srv.submit(_spec(geo, sinos[2], pcfg, rcfg))
    assert a.status == "queued" and b.status == "queued"
    assert c.status == "rejected" and "queue full" in c.error
    # the queued work still runs
    assert srv.drain() == 2


def test_admission_fits_shares_the_operator():
    cost = JobCost(
        fixed_bytes=100, per_slice_bytes=2, y_slab=10, n_slices=40
    )
    adm = AdmissionController.__new__(AdmissionController)
    adm.mem_budget = 150
    assert cost.working_bytes == 20 and cost.slab_bytes == 120
    assert cost.n_slabs == 4
    assert adm.fits([cost, cost])  # 100 + 2*20 = 140 <= 150
    assert not adm.fits([cost, cost, cost])  # 160 > 150
    assert adm.fits([])


# --------------------------------------------------------------------- #
# batching policy (pure units)
# --------------------------------------------------------------------- #
def _fake_job(jid, key="k", tenant="a", priority=0, jobs=(JobSpec, Job)):
    spec_cls, job_cls = jobs
    spec = spec_cls(
        geo=None, sino=np.zeros((1, 2), np.float32),
        tenant=tenant, priority=priority,
    )
    return job_cls(jid, spec, key)


def test_fair_order_priority_then_least_served_then_fifo():
    jobs = [
        _fake_job(0, tenant="greedy"),
        _fake_job(1, tenant="greedy"),
        _fake_job(2, tenant="new"),
        _fake_job(3, tenant="vip", priority=5),
    ]
    served = {"greedy": 100.0, "new": 0.0}
    order = [j.id for j in fair_order(jobs, served)]
    # priority first; then the under-served tenant; FIFO within a tenant
    assert order == [3, 2, 0, 1]


def test_form_batch_coalesces_same_key_under_budget():
    jobs = [
        _fake_job(0, key="k1"),
        _fake_job(1, key="k2"),
        _fake_job(2, key="k1"),
        _fake_job(3, key="k1"),
    ]
    costs = {
        j.id: JobCost(
            fixed_bytes=100, per_slice_bytes=1, y_slab=20, n_slices=20
        )
        for j in jobs
    }
    adm = AdmissionController.__new__(AdmissionController)
    adm.mem_budget = 150  # 100 fixed + two 20-byte working sets
    batch = form_batch(jobs, costs, adm, max_batch=4)
    # k2 never joins a k1 batch; the third k1 job does not fit
    assert [j.id for j in batch] == [0, 2]
    batch2 = form_batch(jobs, costs, adm, max_batch=1)
    assert [j.id for j in batch2] == [0]


def test_priority_orders_real_batches(geo, pcfg, rcfg, sinos, tmp_path):
    srv = _server(workdir=str(tmp_path), max_batch=2)
    lo = [
        srv.submit(_spec(geo, sinos[i], pcfg, rcfg)) for i in range(2)
    ]
    hi = srv.submit(
        _spec(geo, sinos[2], pcfg, rcfg, tenant="vip", priority=9)
    )
    assert srv.drain() == 3
    # the priority job leads the first batch despite submitting last
    assert srv.batches[0]["jobs"][0] == hi.id
    assert {j.id for j in lo} == set(
        srv.batches[0]["jobs"][1:] + srv.batches[1]["jobs"]
    )


# --------------------------------------------------------------------- #
# plan cache (pure units)
# --------------------------------------------------------------------- #
def test_plan_cache_lru_evicts_by_bytes():
    cache = PlanCache(capacity_bytes=100)
    e1, hit = cache.get_or_build("a", lambda: (1, 1, 60))
    assert not hit and cache.bytes == 60
    cache.get_or_build("b", lambda: (2, 2, 60))  # evicts a (LRU)
    assert "a" not in cache and "b" in cache
    assert cache.stats()["evictions"] == 1
    # the evicted entry let go of its plan and solver
    assert e1.plan is None and e1.rec is None
    # rebuilding a counts a fresh miss + build
    cache.get_or_build("a", lambda: (1, 1, 60))
    assert cache.stats()["builds"] == 3 and cache.hits == 0
    _, hit = cache.get_or_build("a", lambda: (1, 1, 60))
    assert hit and cache.hits == 1 and cache.hit_rate == 0.25


def test_plan_cache_pin_blocks_eviction():
    cache = PlanCache(capacity_bytes=100)
    cache.get_or_build("a", lambda: (1, 1, 60))
    cache.pin("a")
    cache.get_or_build("b", lambda: (2, 2, 60))  # over budget, a pinned
    assert "a" in cache and "b" in cache  # deferred, not dropped
    cache.unpin("a")  # deferred eviction lands now ("a" is LRU)
    assert "a" not in cache and "b" in cache
    assert cache.peek("zzz") is None
    # peek counts nothing
    before = cache.stats()
    cache.peek("b")
    assert cache.stats() == before


def test_plan_cache_single_entry_never_evicts_its_own_key():
    cache = PlanCache(capacity_bytes=10)  # smaller than any entry
    entry, _ = cache.get_or_build("a", lambda: (1, 1, 60))
    assert "a" in cache  # degrade to rebuild-every-time, not refusal
    cache.get_or_build("b", lambda: (2, 2, 60))
    assert "b" in cache and "a" not in cache


# --------------------------------------------------------------------- #
# failure containment + background mode
# --------------------------------------------------------------------- #
def test_failed_job_does_not_sink_its_batch(geo, pcfg, rcfg, sinos,
                                            tmp_path):
    # a sinogram store missing its second shard: the first slab solves,
    # the second fetch raises -> that job fails, its batch mate finishes
    holey = SlabStore.create(
        str(tmp_path / "holey"), geo.n_rays, Y, Y_SLAB
    )
    holey.write(0, sinos[0][:, :Y_SLAB])
    srv = _server(workdir=str(tmp_path / "srv"))
    bad = srv.submit(_spec(geo, holey, pcfg, rcfg))
    good = srv.submit(_spec(geo, sinos[1], pcfg, rcfg, tenant="b"))
    assert srv.drain() == 2
    assert bad.status == "failed" and "slab load failed" in bad.error
    assert len(bad.previews) == 1  # the slab that did land is published
    assert good.status == "done" and good.volume.complete()
    assert srv.stats()["failed"] == 1 and srv.stats()["completed"] == 1


def test_background_server_drains_submits(geo, pcfg, rcfg, sinos,
                                          tmp_path):
    srv = _server(workdir=str(tmp_path))
    srv.start()
    with pytest.raises(RuntimeError, match="already started"):
        srv.start()
    try:
        jobs = [
            srv.submit(_spec(geo, s, pcfg, rcfg)) for s in sinos[:2]
        ]
        for j in jobs:
            assert j.wait(timeout=300)
            assert j.status == "done"
    finally:
        srv.stop()
    assert srv.stats()["completed"] == 2
    srv.stop()  # idempotent
    assert threading.active_count() >= 1  # no leaked scheduler thread


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


def test_failed_serve_job_reports_terminal_telemetry(
    geo, pcfg, rcfg, sinos, tmp_path, fresh_obs
):
    tracer, m = fresh_obs
    # a sinogram store missing its second shard: slab 1 solves, slab 2's
    # fetch raises inside the stream/load span
    holey = SlabStore.create(str(tmp_path / "holey"), geo.n_rays, 8, 4)
    holey.write(0, sinos[0][:, :4])
    srv = _server(workdir=str(tmp_path / "srv"))
    bad = srv.submit(JobSpec(geo=geo, sino=holey, pcfg=pcfg, rcfg=rcfg,
                             iters=3, y_slab=4))
    srv.drain()
    assert bad.status == "failed"
    t = bad.telemetry
    # a failed job still reports terminal timing and what killed it, plus
    # the split up to the failure point
    assert t.total_s > 0
    assert t.error_type == "FileNotFoundError"
    assert t.n_slabs == 1 and t.solve_s > 0
    # the failing span recorded the exception type
    failed_loads = [
        e for e in tracer.spans("stream/load")
        if "exception" in e["attrs"]
    ]
    assert [e["attrs"]["exception"] for e in failed_loads] == [
        "FileNotFoundError"
    ]
    # slabs that DID run sit on the tenant lane
    assert tracer.spans("serve/slab")[0]["lane"] == "tenant:default"
    assert m.get("serve_jobs_total", status="failed") == 1.0
    assert m.get("plan_cache_misses_total") == 1.0
    # the server's scrape endpoint renders the same registry
    text = srv.metrics_text()
    assert 'serve_jobs_total{status="failed"} 1' in text
    assert "serve_queue_depth 0" in text


def test_server_runs_on_the_card_by_default(monkeypatch, tmp_path):
    """``device=None`` means ``cuda``: without a card the server raises,
    as ``Reconstructor`` does, and never moves to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReconServer(BUDGET, workdir=str(tmp_path))
    assert _server(workdir=str(tmp_path)).device == torch.device("cpu")


# --------------------------------------------------------------------- #
# side by side with the JAX package
# --------------------------------------------------------------------- #
def test_batching_decisions_match_reference():
    """A seeded queue of many tenants, priorities and keys: the port's
    fair order, batches and slab interleave are the reference's."""
    rng = np.random.default_rng(7)
    n = 40
    tenants = rng.choice(["a", "b", "c", "d"], size=n)
    prios = rng.integers(0, 3, size=n)
    keys = rng.choice(["k1", "k2", "k3"], size=n)
    fixed = {"k1": 100, "k2": 60, "k3": 150}
    ys = rng.integers(1, 6, size=n) * 4
    served = {"a": 12.0, "c": 3.0, "d": 40.0}

    def queue(spec_cls, job_cls):
        return [_fake_job(i, key=str(keys[i]), tenant=str(tenants[i]),
                          priority=int(prios[i]), jobs=(spec_cls, job_cls))
                for i in range(n)]

    ours, theirs = queue(JobSpec, Job), queue(JJobSpec, JJob)
    o_order, t_order = fair_order(ours, served), jfair_order(theirs, served)
    assert [j.id for j in o_order] == [j.id for j in t_order]
    costs = {i: JobCost(fixed_bytes=fixed[str(keys[i])], per_slice_bytes=3,
                        y_slab=int(ys[i]), n_slices=int(ys[i]) * 2)
             for i in range(n)}
    for budget in (150, 260, 400):
        for max_batch in (1, 3, 8):
            adm = AdmissionController.__new__(AdmissionController)
            adm.mem_budget = budget
            jadm = JAdmission.__new__(JAdmission)
            jadm.mem_budget = budget
            rest_o, rest_t = list(o_order), list(t_order)
            while rest_o:  # drain the queue batch by batch
                bo = form_batch(rest_o, costs, adm, max_batch)
                bt = jform_batch(rest_t, costs, jadm, max_batch)
                assert [j.id for j in bo] == [j.id for j in bt]
                rest_o = [j for j in rest_o if j not in bo]
                rest_t = [j for j in rest_t if j not in bt]
    slabs = [[(j0, j0 + int(y)) for j0 in range(0, 3 * int(y), int(y))]
             [: int(rng.integers(1, 4))] for y in ys[:7]]
    assert interleave_slabs(slabs) == jinterleave(slabs)


@pytest.mark.parametrize("precision,y_slab", [
    ("single", None), ("mixed", None), ("q8", None), ("mixed", 16),
])
def test_admission_price_is_the_reference_plus_port_extras(
        precision, y_slab, monkeypatch):
    """Priced on the same estimate: the operator and per-slice terms are
    the reference's plus ``port_extras``; with those set to zero the whole
    ``JobCost`` is the reference's, fair-share slab included."""
    from repro.core.geometry import XCTGeometry as JGeo
    from repro_torch.stream import scheduler

    geo, jgeo = XCTGeometry(n=64, n_angles=96), JGeo(n=64, n_angles=96)
    budget = 24 << 20

    def price(extras):
        adm = AdmissionController(
            budget, Topology.from_sizes([("model", 1, "ici")]),
            fair_share=2)
        if not extras:
            monkeypatch.setattr(scheduler, "port_extras",
                                lambda plan, pol: (0, 0))
        return adm.price(geo, PartitionConfig(), ReconConfig(
            precision=precision, fuse=4), n_slices=64, y_slab=y_slab)

    theirs = JAdmission(
        budget, JTopo.from_sizes([("model", 1, "ici")]), fair_share=2,
    ).price(jgeo, JPcfg(), JCfg(precision=precision, fuse=4), n_slices=64,
            y_slab=y_slab)
    ours = price(extras=True)
    ex_fixed, ex_slice = port_extras(
        estimate_plan(geo, PartitionConfig()), get_policy(precision))
    assert ex_fixed > 0 and ex_slice > 0
    assert ours.fixed_bytes == theirs.fixed_bytes + ex_fixed
    assert ours.per_slice_bytes == theirs.per_slice_bytes + ex_slice
    assert ours.n_slices == theirs.n_slices
    if y_slab is not None:
        assert ours.y_slab == theirs.y_slab == y_slab
    else:  # the fair share of what the port's terms leave
        share = (budget - ours.fixed_bytes) // 2
        assert ours.y_slab == max(4, min(
            64, share // ours.per_slice_bytes // 4 * 4))
    bare = price(extras=False)
    assert (bare.fixed_bytes, bare.per_slice_bytes, bare.y_slab,
            bare.n_slices) == (theirs.fixed_bytes, theirs.per_slice_bytes,
                               theirs.y_slab, theirs.n_slices)


def test_served_volume_matches_jax_server_and_port_streaming(
    small_system, geo, pcfg, rcfg, sinos, reference, tmp_path
):
    """Two jobs through each package's server: the port's volumes equal
    its own streamed volumes bit for bit and the JAX server's to the
    ``single`` tolerance (the CG's row sums reduce in another order than
    XLA's, so not bit for bit)."""
    jgeo = small_system[0]
    jpcfg = JPcfg(n_data=1, tile=4, rows_per_block=16, nnz_per_stage=16)
    jrcfg = JCfg(precision="single", comm_mode="rs", fuse=2)
    jsrv = JServer(BUDGET, workdir=str(tmp_path / "jax"))
    srv = _server(workdir=str(tmp_path / "port"))
    theirs = [jsrv.submit(JJobSpec(geo=jgeo, sino=s, pcfg=jpcfg, rcfg=jrcfg,
                                   iters=ITERS, y_slab=Y_SLAB))
              for s in sinos[:2]]
    ours = [srv.submit(_spec(geo, s, pcfg, rcfg)) for s in sinos[:2]]
    assert jsrv.drain() == 2 and srv.drain() == 2
    # one batch, one cold build, in both (the keys differ: the packages'
    # ReconConfig fields differ, and plan_key hashes them)
    assert [(b["jobs"], b["cold"]) for b in srv.batches] == [
        (b["jobs"], b["cold"]) for b in jsrv.batches] == [([0, 1], True)]
    for o, t, ref in zip(ours, theirs, reference):
        x, jx = o.volume.to_array(), t.volume.to_array()
        np.testing.assert_array_equal(x, ref)
        np.testing.assert_allclose(x, jx, rtol=TOL,
                                   atol=TOL * np.abs(jx).max())
        np.testing.assert_allclose(o.resnorms, t.resnorms, rtol=TOL,
                                   atol=TOL * np.abs(t.resnorms).max())
        assert (o.y_slab, o.telemetry.n_slabs) == (
            t.y_slab, t.telemetry.n_slabs)


@pytest.mark.parametrize("name", [
    "repro_torch.serve.admission", "repro_torch.serve.batching",
])
def test_module_doctests(name):
    result = doctest.testmod(importlib.import_module(name))
    assert result.attempted > 0 and result.failed == 0
