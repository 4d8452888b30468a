"""repro_torch.obs.drift and the modeled exchange traffic on the CPU.

The counterparts of the drift cases of ``test_obs.py`` (the injected
model, the nested-span dedup, the argument check, a live
``Reconstructor``'s phases, a traced streaming drain with its
``recon/exchange`` instants and counters) on the port, then side by side
with the JAX package: the same spans give the same rendered report, and
under the reference's hardware rates (the port prices with the H100's,
``launch.hardware.HW``) and the same per-copy overhead a reconstructor
on the same plan gives the same modeled phases, the same
``recon/exchange`` instant and the same counters.
"""
import doctest
import json

import numpy as np
import pytest
import torch

from repro.core.recon import ReconConfig as JCfg
from repro.core.recon import Reconstructor as JRec
from repro.launch.hlo_analysis import HW as JHW
from repro.obs import drift as jdrift
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch.core import geometry as tgeo
from repro_torch.core import partition as tpart
from repro_torch.core.recon import ReconConfig, Reconstructor
from repro_torch.launch import hardware as thardware
from repro_torch.obs import drift, export, metrics, trace
from repro_torch.stream import (
    SlabStore,
    reconstruct_streaming,
    simulate_to_store,
)


def fake_clock(*vals):
    return iter([float(v) for v in vals]).__next__


def counting_clock():
    it = iter(range(10_000))
    return lambda: float(next(it))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
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


@pytest.fixture()
def reference_rates(monkeypatch):
    """The port priced with the reference's rates."""
    rates = thardware.Hardware(
        peak_flops=JHW.peak_flops, hbm_bw=JHW.hbm_bw, ici_bw=JHW.ici_bw,
        dci_bw=JHW.dci_bw,
    )
    monkeypatch.setattr(thardware, "HW", rates)
    return rates


@pytest.fixture()
def fresh_tracer():
    """Swap in an enabled tracer + fresh metrics; restore after."""
    old_t = trace.set_tracer(trace.Tracer(enabled=True))
    old_m = metrics.set_metrics(metrics.Metrics())
    try:
        yield trace.get_tracer(), metrics.get_metrics()
    finally:
        trace.set_tracer(old_t)
        metrics.set_metrics(old_m)


def _rec(plan, precision="single", comm_mode="rs", **kw):
    return Reconstructor(plan, cfg=ReconConfig(
        precision=precision, comm_mode=comm_mode, fuse=2, **kw),
        device="cpu")


# --------------------------------------------------------------------- #
# the port's drift report
# --------------------------------------------------------------------- #
def test_drift_report_pins_on_injected_model():
    t = trace.Tracer(enabled=True, clock=fake_clock(0.0, 2.0, 2.0, 2.5))
    with t.span("stream/solve"):
        pass
    with t.span("stream/load"):
        pass
    rep = drift.drift_report(
        t,
        modeled={"solve": 1.0, "hbm": 0.5, "dma_issue": 0.3,
                 "exchange_ici": 0.2, "exchange_dci": 0.0},
        threshold=0.5,
    )
    assert [r.phase for r in rep.rows] == list(drift.PHASES)
    solve = rep.row("solve")
    assert (solve.measured_s, solve.modeled_s, solve.ratio,
            solve.source, solve.flagged) == (2.0, 1.0, 2.0, "span", True)
    # sub-phases: attributed share of the measured solve, never flagged
    hbm = rep.row("hbm")
    assert hbm.measured_s == pytest.approx(1.0)
    assert hbm.share == pytest.approx(0.5)
    assert hbm.source == "attributed" and not hbm.flagged
    assert rep.row("exchange_dci").ratio is None  # modeled 0: no ratio
    assert rep.row("load").measured_s == 0.5
    assert rep.row("load").modeled_s is None
    assert [r.phase for r in rep.flagged] == ["solve"]
    # a measured solve inside the band does not flag
    t2 = trace.Tracer(enabled=True, clock=fake_clock(0.0, 1.2))
    with t2.span("stream/solve"):
        pass
    rep2 = drift.drift_report(t2, modeled={"solve": 1.0}, threshold=0.5)
    assert rep2.flagged == []
    # render + json round out the report object
    assert "DRIFT" in rep.render()
    parsed = json.loads(rep.to_json())
    assert parsed["rows"][0]["phase"] == "solve"


def test_drift_dedups_nested_same_phase_spans():
    t = trace.Tracer(enabled=True, clock=counting_clock())
    with t.span("stream/solve"):        # 0 .. 3
        with t.span("recon/solve"):     # 1 .. 2: same phase, nested
            pass
    measured = drift.measured_phases(t)
    assert measured == {"solve": 3.0}  # NOT 3 + 1
    # the same inner span at top level DOES count
    t2 = trace.Tracer(enabled=True, clock=fake_clock(0.0, 1.0))
    with t2.span("recon/solve"):
        pass
    assert drift.measured_phases(t2) == {"solve": 1.0}


def test_drift_requires_model_or_reconstructor():
    t = trace.Tracer(enabled=True)
    with pytest.raises(ValueError, match="modeled= or all of"):
        drift.drift_report(t)


def test_modeled_phases_prices_real_reconstructor(port_plan):
    rec = _rec(port_plan)
    phases, meta = drift.modeled_phases(rec, iters=4, n_slices=8)
    # the same decomposition the autotuner's modeled tier sums
    assert phases["solve"] == pytest.approx(
        phases["hbm"] + phases["dma_issue"]
        + phases["exchange_ici"] + phases["exchange_dci"]
    )
    assert phases["hbm"] > 0 and phases["dma_issue"] > 0
    assert meta["overhead_source"] == "default"
    assert meta["per_copy_overhead_s"] > 0
    # iters scale linearly in applications: (iters+1)
    p2, _ = drift.modeled_phases(rec, iters=9, n_slices=8)
    assert p2["solve"] == pytest.approx(phases["solve"] * 2.0)
    # a calibrated overhead changes only the issue term + provenance
    p3, m3 = drift.modeled_phases(
        rec, iters=4, n_slices=8,
        per_copy_overhead_s=2 * meta["per_copy_overhead_s"],
    )
    assert p3["dma_issue"] == pytest.approx(2 * phases["dma_issue"])
    assert p3["hbm"] == phases["hbm"]
    assert m3["overhead_source"] == "measured"
    with pytest.raises(ValueError, match="granule"):
        drift.modeled_phases(rec, iters=4, n_slices=7)


def test_streaming_trace_agrees_with_result_fields(
    small_system, port_plan, tmp_path, fresh_tracer
):
    tracer, m = fresh_tracer
    geo, a, _ = small_system
    rec = _rec(port_plan)
    store = SlabStore.create(str(tmp_path / "sino"), geo.n_rays, 8, 2)
    simulate_to_store(a, geo.n, store, noise=0.01, seed=5)
    res = reconstruct_streaming(
        rec, store, str(tmp_path / "vol"), iters=3, y_slab=4,
    )
    assert len(res.solved) == 2
    # per-slab span sums agree with the result fields to <1% -- by
    # construction they are the SAME span durations
    for name, field in (
        ("stream/solve", res.solve_s),
        ("stream/load", res.load_s),
        ("stream/stage", res.upload_s),
        ("stream/slab", res.slab_s),
    ):
        assert tracer.total_s(name) == pytest.approx(
            sum(field), rel=0.01
        ), name
    # exchange instants + counters rode along
    ex = [e for e in tracer.events if e["name"] == "recon/exchange"]
    assert len(ex) == 2 and all(
        e["attrs"]["ici_bytes"] > 0 for e in ex
    )
    assert m.get("stream_slabs_total") == 2.0
    assert m.get("comm_bytes_total", link="ici") == pytest.approx(
        sum(e["attrs"]["ici_bytes"] for e in ex)
    )
    assert m.get("dma_issues_total", op="spmm") > 0
    # the whole trace exports schema-valid
    export.validate_chrome_trace(export.chrome_trace(tracer))
    # and the drift report covers the acceptance phases from a live rec
    rep = drift.drift_report(tracer, rec=rec, iters=3, n_slices=8)
    assert rep.row("solve").source == "span"
    assert rep.row("dma_issue").source == "attributed"
    assert rep.row("exchange_ici").source == "attributed"


def test_exchange_instant_only_while_tracing(port_plan, phantom32):
    """With tracing off the solve emits no instant and bumps no counter."""
    _, y = phantom32
    old_m = metrics.set_metrics(metrics.Metrics())
    try:
        _rec(port_plan).reconstruct(y, iters=2)
        assert metrics.get_metrics().snapshot() == \
            metrics.Metrics().snapshot()
    finally:
        metrics.set_metrics(old_m)


# --------------------------------------------------------------------- #
# side by side with the JAX package
# --------------------------------------------------------------------- #
def _same_spans(module, clock_vals):
    """One span tree, recorded by ``module``'s tracer under a fake clock:
    a streamed slab (solve with a nested recon/solve, a retried load, a
    stage, an upload) and a served slab."""
    t = module.Tracer(enabled=True, clock=fake_clock(*clock_vals))
    with t.span("stream/solve", slab=0):
        with t.span("recon/solve", iters=4):
            pass
    with t.span("stream/load", retry=1):
        pass
    with t.span("stream/load", retry=0):
        pass
    with t.span("stream/stage"):
        pass
    with t.span("serve/solve", lane="tenant:a"):
        pass
    with t.span("recon/stage"):
        pass
    return t


CLOCK = (0.0, 0.5, 1.2, 1.5, 1.5, 1.7, 2.0, 2.1, 2.1, 2.4, 3.0, 4.25,
         4.25, 4.3)


@pytest.mark.parametrize("threshold", [0.5, 0.1, 3.0])
@pytest.mark.parametrize("modeled", [
    {"solve": 1.0, "hbm": 0.5, "dma_issue": 0.3, "exchange_ici": 0.2,
     "exchange_dci": 0.0},
    {"solve": 2.75},
    {"solve": 0.02, "hbm": 0.015, "dma_issue": 0.005, "load": 0.01},
])
def test_drift_render_matches_reference(modeled, threshold):
    ours = drift.drift_report(_same_spans(trace, CLOCK), modeled=modeled,
                              threshold=threshold)
    theirs = jdrift.drift_report(_same_spans(jtrace, CLOCK),
                                 modeled=modeled, threshold=threshold)
    assert ours.render() == theirs.render()
    assert ours.to_json() == theirs.to_json()
    assert drift.measured_phases(_same_spans(trace, CLOCK)) == \
        jdrift.measured_phases(_same_spans(jtrace, CLOCK))


@pytest.mark.parametrize("cfg", [
    dict(precision="single", comm_mode="rs"),
    dict(precision="mixed", comm_mode="hier"),
    dict(precision="q8", comm_mode="direct", dma="per_row"),
])
def test_modeled_phases_and_report_match_reference(
        cfg, small_system, port_plan, reference_rates):
    """The same plan bound by both packages: under the same rates and
    overhead the modeled phases, and the report rendered from the port's
    spans, are the reference's."""
    _, _, plan = small_system
    rec = _rec(port_plan, **cfg)
    jrec = JRec(plan, cfg=JCfg(fuse=2, **cfg))
    for kw in (dict(per_copy_overhead_s=1e-7), dict(per_copy_overhead_s=3e-9)):
        ours = drift.modeled_phases(rec, iters=4, n_slices=8, **kw)
        theirs = jdrift.modeled_phases(jrec, iters=4, n_slices=8, **kw)
        assert ours == theirs
    spans = _same_spans(trace, CLOCK)
    assert drift.drift_report(
        spans, rec=rec, iters=4, n_slices=8, per_copy_overhead_s=1e-7,
    ).render() == jdrift.drift_report(
        spans.events, rec=jrec, iters=4, n_slices=8,
        per_copy_overhead_s=1e-7,
    ).render()


@pytest.mark.parametrize("cfg", [
    dict(precision="single", comm_mode="rs"),
    dict(precision="mixed", comm_mode="hier", dma="per_row"),
])
def test_exchange_instant_and_counters_match_reference(
        cfg, small_system, port_plan, phantom32):
    """A traced solve in each package: the same ``recon/exchange``
    instant (its modeled bytes) and the same counters."""
    _, _, plan = small_system
    _, y = phantom32

    def traced(module_trace, module_metrics, rec):
        old_t = module_trace.set_tracer(module_trace.Tracer(enabled=True))
        old_m = module_metrics.set_metrics(module_metrics.Metrics())
        try:
            rec.reconstruct(y, iters=2)
            ex = [e for e in module_trace.get_tracer().events
                  if e["name"] == "recon/exchange"]
            return ex, module_metrics.get_metrics()
        finally:
            module_trace.set_tracer(old_t)
            module_metrics.set_metrics(old_m)

    ours, m = traced(trace, metrics, _rec(port_plan, **cfg))
    theirs, jm = traced(jtrace, jmetrics, JRec(plan, cfg=JCfg(fuse=2, **cfg)))
    assert len(ours) == len(theirs) == 1
    assert ours[0]["attrs"] == theirs[0]["attrs"]
    for name, labels in (("comm_bytes_total", {"link": "ici"}),
                         ("comm_bytes_total", {"link": "dci"}),
                         ("dma_issues_total", {"op": "spmm"})):
        assert m.get(name, **labels) == jm.get(name, **labels)
    assert np.isfinite(ours[0]["attrs"]["ici_bytes"])


def test_drift_doctest():
    result = doctest.testmod(drift)
    assert result.attempted > 0 and result.failed == 0
