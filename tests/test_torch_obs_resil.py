"""The port's ``obs`` and ``resil`` against the reference's, on the CPU.

The same calls on both sides give the same ``Tracer`` events under a fake
clock, the same Chrome trace documents, the same Prometheus text, the
same fault-firing decisions, retry delays and circuit states; the port's
``Reconstructor`` emits the reference's spans and consults its fault
site; ``--trace`` writes a trace that passes the schema.
"""
import json

import numpy as np
import pytest
import torch

from repro.core.recon import ReconConfig as JaxConfig
from repro.core.recon import Reconstructor as JaxReconstructor
from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.resil import circuit as jcircuit
from repro.resil import errors as jerrors
from repro.resil import inject as jinject
from repro.resil import retry as jretry
from repro_torch import obs as tobs
from repro_torch import resil as tresil
from repro_torch.core import geometry as tgeo
from repro_torch.core import partition as tpart
from repro_torch.core.recon import ReconConfig, Reconstructor
from repro_torch.obs import export as texport
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.resil import circuit as tcircuit
from repro_torch.resil import errors as terrors
from repro_torch.resil import inject as tinject
from repro_torch.resil import retry as tretry

SIDES = {
    "reference": dict(trace=jtrace, export=jexport, metrics=jmetrics,
                      inject=jinject, retry=jretry, circuit=jcircuit,
                      errors=jerrors),
    "port": dict(trace=ttrace, export=texport, metrics=tmetrics,
                 inject=tinject, retry=tretry, circuit=tcircuit,
                 errors=terrors),
}


def _fake_clock():
    return iter(np.arange(0.0, 50.0, 0.25).tolist()).__next__


def _script(trace):
    """One tracer session: nesting, lanes, instants, an exception."""
    t = trace.Tracer(enabled=True, clock=_fake_clock())
    with t.span("stream/slab", slab=0):
        with t.span("recon/stage", slices=4):
            pass
        t.instant("recon/exchange", ici_bytes=1.5, dci_bytes=0)
        with t.span("recon/solve", iters=3, slices=4) as sp:
            pass
    with t.span("serve/job", lane="tenant:a"):
        pass
    try:
        with t.span("recon/solve", iters=1):
            raise FloatingPointError("boom")
    except FloatingPointError:
        pass
    off = trace.Tracer(enabled=False, clock=_fake_clock())
    with off.span("quiet") as q:
        pass
    return t, sp, q


def _events(t):
    return [{k: v for k, v in e.items() if k != "thread_id"}
            for e in t.events]


def test_tracer_events_match_reference():
    jt, jsp, jq = _script(jtrace)
    tt, tsp, tq = _script(ttrace)
    assert _events(tt) == _events(jt)
    assert (tsp.duration_s, tq.duration_s) == (jsp.duration_s, jq.duration_s)
    assert tt.total_s("recon/solve") == jt.total_s("recon/solve")
    assert [e["name"] for e in tt.spans("recon/solve")] == ["recon/solve"] * 2
    assert tt.spans()[-1]["attrs"]["exception"] == "FloatingPointError"


def test_chrome_trace_documents_match_reference(tmp_path):
    jt, _, _ = _script(jtrace)
    tt, _, _ = _script(ttrace)
    jdoc, tdoc = jexport.chrome_trace(jt), texport.chrome_trace(tt)
    assert json.dumps(tdoc, sort_keys=True) == json.dumps(jdoc, sort_keys=True)
    for doc in (jdoc, tdoc):
        texport.validate_chrome_trace(doc)
        jexport.validate_chrome_trace(doc)
    tschema, jschema = texport.load_schema(), jexport.load_schema()
    tschema.pop("$comment"), jschema.pop("$comment")
    assert tschema == jschema
    path = texport.write_chrome_trace(str(tmp_path / "t.json"), tt)
    assert json.load(open(path)) == json.loads(json.dumps(tdoc))
    bad = {"traceEvents": [{"ph": "X", "pid": 1, "tid": 1, "name": "x"}],
           "displayTimeUnit": "ms"}
    for mod in (texport, jexport):
        with pytest.raises(mod.SchemaError, match="ts/dur"):
            mod.validate_chrome_trace(bad)


def _metrics_script(metrics):
    m = metrics.Metrics()
    m.inc("jobs_total", 2, status="done")
    m.inc("jobs_total", status="failed")
    m.inc("comm_bytes_total", 1.25e6, link="ici")
    m.set_gauge("queue_depth", 3)
    m.set_gauge("queue_depth", 0.5, tenant="b")
    for v in (0.5, 0.05, 20.0):
        m.observe("solve_seconds", v, buckets=(0.1, 1.0))
    m.observe("stage_seconds", 0.002)
    return m


def test_prometheus_text_and_snapshot_match_reference():
    jm, tm = _metrics_script(jmetrics), _metrics_script(tmetrics)
    assert tm.render_prometheus() == jm.render_prometheus()
    assert tm.snapshot() == jm.snapshot()
    assert tm.get("jobs_total", status="done") == 2.0
    for m in (jm, tm):
        with pytest.raises(ValueError, match="cannot decrease"):
            m.inc("jobs_total", -1)


def test_hash01_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        parts = (int(rng.integers(0, 1 << 30)), "stream/load",
                 int(rng.integers(0, 100)), int(rng.integers(0, 5)))
        assert tinject.hash01(*parts) == jinject.hash01(*parts)


def _fault_script(side):
    """A plan of every kind, consulted in one order; returns what fired,
    what raised and the mutated arrays."""
    inject, errors = side["inject"], side["errors"]
    plan = (inject.FaultPlan(seed=7)
            .add("store/read", "corrupt", key=3, flip_bytes=3)
            .add("stream/load", "io_error", attempts=(0, 2))
            .add("recon/solve", "nonfinite", attempts=None,
                 when={"precision": "q8"})
            .add("serve/build", "error")
            .add("stream/after_slab", "preempt", key=1)
            .add("stream/stage", "slow", delay_s=0.0))
    arr = np.arange(24, dtype=np.float32).reshape(4, 6)
    log = []
    with inject.activate(plan) as handle:
        for site, key, ctx in [
            ("store/read", 3, None), ("store/read", 4, None),
            ("stream/load", 0, None), ("stream/load", 0, None),
            ("stream/load", 0, None), ("recon/solve", 5, {"precision": "q8"}),
            ("recon/solve", 5, {"precision": "single"}),
            ("serve/build", None, None), ("serve/build", None, None),
            ("stream/after_slab", 1, None), ("stream/stage", 2, None),
        ]:
            try:
                out = inject.mutate(site, arr, key=key, ctx=ctx)
                log.append((site, key, "ok", np.asarray(out).tobytes()))
            except (errors.InjectedIOError, errors.InjectedError,
                    errors.InjectedPreemption) as e:
                log.append((site, key, type(e).__name__, str(e)))
        with inject.scope(9):  # a keyless site takes the scope's key
            with pytest.raises(errors.InjectedIOError, match="key=9"):
                inject.fire("stream/load")
        fired = list(handle.fired)
    assert not inject.active()
    return fired, log


def test_fault_plan_decisions_match_reference():
    jfired, jlog = _fault_script(SIDES["reference"])
    tfired, tlog = _fault_script(SIDES["port"])
    assert tfired == jfired and tlog == jlog
    kinds = {f[3] for f in tfired}
    assert kinds == {"corrupt", "io_error", "nonfinite", "error", "preempt",
                     "slow"}
    with pytest.raises(ValueError, match="unknown fault kind"):
        tinject.FaultPlan().add("x", "bogus")
    with tinject.activate(tinject.FaultPlan()):
        with pytest.raises(RuntimeError, match="already active"):
            with tinject.activate(tinject.FaultPlan()):
                pass


@pytest.mark.parametrize("policy", [
    dict(max_attempts=4, base_delay_s=0.1, backoff=2.0, jitter=0.0, seed=7),
    dict(max_attempts=5, base_delay_s=0.05, backoff=3.0, jitter=0.5, seed=1),
    dict(max_attempts=2, jitter=0.25, seed=3),
], ids=["no-jitter", "jitter", "two-attempts"])
def test_retry_policy_matches_reference(policy):
    """Delays, attempt budgets and ``call_with_retry``'s sleeps and
    outcome are the reference's for the same policy and failures."""
    def drive(side):
        retry, errors = side["retry"], side["errors"]
        p = retry.RetryPolicy(**policy)
        delays = [p.delay_s("stream/load", k, a)
                  for k in (0, 3, "x") for a in (1, 2, 3, 4)]
        budgets = [p.attempts_for(errors.CorruptShardError("c")),
                   p.attempts_for(OSError("o"))]
        sleeps, calls = [], []

        def flaky(attempt):
            calls.append(attempt)
            if attempt < 2:
                raise OSError(f"transient {attempt}")
            return attempt

        try:
            got = retry.call_with_retry(flaky, policy=p, site="s", key=1,
                                        sleep=sleeps.append)
        except OSError as e:
            got = str(e)
        with pytest.raises(ValueError):
            retry.call_with_retry(lambda a: int("x"), policy=p, site="s",
                                  sleep=sleeps.append)
        return delays, budgets, sleeps, calls, got

    assert drive(SIDES["port"]) == drive(SIDES["reference"])


def test_circuit_breaker_states_match_reference():
    def drive(circuit):
        now = {"t": 0.0}
        cb = circuit.CircuitBreaker(threshold=2, cooldown_s=30.0,
                                    clock=lambda: now["t"])
        states = []
        for t, action in [(0, "fail"), (1, "fail"), (2, None), (31, None),
                          (32, "fail"), (40, None), (63, "ok"), (64, None),
                          (65, "fail")]:
            now["t"] = float(t)
            if action == "fail":
                cb.record_failure("k")
            elif action == "ok":
                cb.record_success("k")
            states.append((cb.state("k"), cb.allow("k"), cb.state("other")))
        return states

    assert drive(tcircuit) == drive(jcircuit)


def test_error_types_match_reference():
    for name in jerrors.__all__:
        t, j = getattr(terrors, name), getattr(jerrors, name)
        assert [b.__name__ for b in t.__mro__] == [
            b.__name__ for b in j.__mro__]
    assert sorted(tresil.__all__) == sorted(
        __import__("repro.resil", fromlist=["x"]).__all__)
    jobs = __import__("repro.obs", fromlist=["x"]).__all__
    assert sorted(tobs.__all__) == sorted(jobs)


def test_span_fence_returns_its_value_and_skips_the_cpu():
    sp = ttrace.Tracer().span("x")
    t = torch.ones(3)
    value = {"a": [t, (t, 1)], "b": np.zeros(2)}
    assert sp.fence(value) is value and sp.fence(t) is t


@pytest.fixture(scope="module")
def port_plan(small_system):
    geo, _, plan = small_system
    return tpart.plan_from_arrays(
        tpart.plan_to_arrays(plan),
        tgeo.XCTGeometry(geo.n, geo.n_angles),
        tpart.PartitionConfig(tile=4, rows_per_block=16, nnz_per_stage=16),
    )


# the port's spans of one reconstruct call, in order
STAGING_SPANS = ["recon/stage", "recon/x0", "recon/solve", "recon/unpack",
                 "recon/download"]


def _solve_spans(trace, rec, y):
    old = trace.get_tracer()
    tracer = trace.enable(clock=_fake_clock())
    try:
        rec.reconstruct(y, iters=2)
    finally:
        trace.set_tracer(old)
    return [(e["name"], e["attrs"], e["depth"], e["parent"])
            for e in tracer.spans()]


def test_reconstructor_spans_match_reference(small_system, phantom32,
                                             port_plan):
    """``recon/stage`` and ``recon/solve`` with the reference's attributes
    and nesting, on the same plan and sinogram, and around them the
    port's spans of the staging layer, every one at depth 0."""
    _, _, plan = small_system
    _, y = phantom32
    rec = Reconstructor(port_plan, ReconConfig(comm_mode="rs", fuse=2),
                        device="cpu")
    jrec = JaxReconstructor(plan, cfg=JaxConfig(comm_mode="rs", fuse=2))
    got = _solve_spans(ttrace, rec, y)
    ref = _solve_spans(jtrace, jrec, y)
    assert [g for g in got if g[0] in {r[0] for r in ref}] == ref
    assert [g[0] for g in got] == STAGING_SPANS
    assert got[2][1] == {"iters": 2, "slices": 4}
    assert all(g[2:] == (0, None) for g in got)
    assert [g[1] for g in got if g[0] != "recon/solve"] == [{"slices": 4}] * 4


@pytest.mark.parametrize("precision,fires", [("q8", True), ("single", False)])
def test_reconstructor_consults_the_solve_fault_site(phantom32, port_plan,
                                                     precision, fires):
    """A ``nonfinite`` fault at ``recon/solve`` matching the solve's
    precision poisons one element and raises the typed error; one for
    another precision leaves the solve alone."""
    _, y = phantom32
    rec = Reconstructor(port_plan, ReconConfig(precision=precision,
                                               comm_mode="rs", fuse=2),
                        device="cpu")
    plan = tinject.FaultPlan(seed=3).add(
        "recon/solve", "nonfinite", attempts=None, when={"precision": "q8"})
    with tinject.activate(plan) as handle, tinject.scope(11):
        if fires:
            with pytest.raises(terrors.NonFiniteSolveError, match="1 non"):
                rec.reconstruct(y, iters=2)
        else:
            x, _ = rec.reconstruct(y, iters=2)
            assert np.isfinite(x).all()
    assert handle.fired == ([("recon/solve", 11, 0, "nonfinite")]
                            if fires else [])


@pytest.mark.parametrize("p_data", [1, 4])
def test_cli_trace_on_cpu(tmp_path, capsys, p_data):
    """``--trace OUT.json`` writes a trace that passes the schema, with
    the solve's spans, and leaves the process tracer as it found it."""
    from repro_torch.launch import recon as cli

    before = ttrace.get_tracer()
    out = tmp_path / "trace.json"
    cli.main(["--n", "32", "--angles", "48", "--slices", "4", "--iters", "3",
              "--fuse", "2", "--p-data", str(p_data), "--device", "cpu",
              "--trace", str(out)])
    assert ttrace.get_tracer() is before
    text = capsys.readouterr().out
    assert f"trace written to {out}" in text and "drift report" in text
    doc = texport.validate_chrome_trace(json.load(open(out)))
    jexport.validate_chrome_trace(doc)
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    assert names == STAGING_SPANS
    assert not [e for e in doc["traceEvents"]
                if e["name"].startswith("solve/")]
    solve = [e for e in doc["traceEvents"] if e["name"] == "recon/solve"][0]
    assert solve["args"] == {"iters": 3, "slices": 4} and solve["dur"] > 0


def _annotations(prof, tmp_path):
    """``(name, ts, dur)`` of the ``user_annotation`` events of a
    profile, in the order they start."""
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    return sorted((e["ts"], e["name"], e["dur"])
                  for e in json.load(open(path))["traceEvents"]
                  if e.get("cat") == "user_annotation")


def _phase_counts(iters, n_mini, narrow):
    """The ``solve/*`` ranges of one group's CGNR solve: ``iters + 1``
    applications of each operator, each ``n_mini`` kernel phases,
    ``n_mini`` reduce phases and the join, renormalized before and
    after under a narrow policy; ``1 + 3 * iters`` dots; the updates
    before, in and after the loop."""
    apps = 2 * (iters + 1)
    return {"solve/spmm": apps * n_mini, "solve/reduce": apps * (n_mini + 1),
            "solve/scale": 2 * apps if narrow else 0,
            "solve/dot": 1 + 3 * iters, "solve/update": 2 * iters + 4}


@pytest.mark.parametrize("precision,fuse,overlap", [
    ("mixed", 2, True), ("single", 4, True), ("mixed", 1, False)])
def test_profiled_reconstruct_names_its_spans_and_phases(
        phantom32, port_plan, tmp_path, precision, fuse, overlap):
    """Under ``torch.profiler`` (the tracer off) each ``recon/*`` span of
    a call is one ``user_annotation``, and each ``solve/*`` range one per
    phase the solve runs, inside ``recon/solve``."""
    from torch.profiler import ProfilerActivity, profile

    _, y = phantom32
    rec = Reconstructor(port_plan, ReconConfig(
        precision=precision, comm_mode="rs", fuse=fuse, overlap=overlap),
        device="cpu")
    assert not ttrace.get_tracer().enabled
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec.reconstruct(y, iters=3)
    got = _annotations(prof, tmp_path)
    names = [n for _, n, _ in got]
    assert [n for n in names if n.startswith("recon/")] == STAGING_SPANS
    counts = {n: names.count(n) for n in set(names) if n.startswith("solve/")}
    want = _phase_counts(3, y.shape[1] // fuse, precision == "mixed")
    assert counts == {n: c for n, c in want.items() if c}
    ((t0, _, dur),) = [(t, n, d) for t, n, d in got if n == "recon/solve"]
    assert all(t0 <= t and t + d <= t0 + dur
               for t, n, d in got if n.startswith("solve/"))


def test_ranges_cost_nothing_with_the_profiler_off(
        phantom32, port_plan, monkeypatch):
    """With the profiler off ``range`` gives one shared object, and
    neither it nor a span nor a whole call opens a profiler range."""
    import torch.autograd.profiler as tprof

    def refuse(name, *args, **kwargs):
        raise AssertionError(f"record_function({name!r}) with the "
                             "profiler off")

    monkeypatch.setattr(tprof, "record_function", refuse)
    first = ttrace.range("solve/spmm")
    assert first is ttrace.range("solve/dot") is tobs.range("solve/update")
    with first:
        pass
    with ttrace.Tracer(enabled=True).span("recon/x0", slices=4):
        pass
    _, y = phantom32
    rec = Reconstructor(port_plan, ReconConfig(precision="mixed",
                                               comm_mode="rs", fuse=2),
                        device="cpu")
    x, _ = rec.reconstruct(y, iters=2)
    assert np.isfinite(x).all()


@pytest.mark.parametrize("fault", [False, True])
def test_tracer_holds_the_staging_spans_and_no_phase(
        phantom32, port_plan, fault):
    """With tracer and profiler both on, the tracer records the five
    spans of a call in order at depth 0, and no ``solve/*`` range; a call
    that raises (a non-finite volume) closes them all, its error in the
    last one's attrs."""
    from torch.profiler import ProfilerActivity, profile

    _, y = phantom32
    rec = Reconstructor(port_plan, ReconConfig(precision="q8",
                                               comm_mode="rs", fuse=2),
                        device="cpu")
    plan = tinject.FaultPlan(seed=3).add("recon/solve", "nonfinite",
                                         attempts=None)
    old = ttrace.get_tracer()
    tracer = ttrace.enable(clock=_fake_clock())
    try:
        with profile(activities=[ProfilerActivity.CPU]), \
                tinject.activate(plan if fault else tinject.FaultPlan()):
            if fault:
                with pytest.raises(terrors.NonFiniteSolveError):
                    rec.reconstruct(y, iters=2)
            else:
                rec.reconstruct(y, iters=2)
    finally:
        ttrace.set_tracer(old)
    spans = tracer.spans()
    assert [e["name"] for e in spans] == STAGING_SPANS
    assert [(e["depth"], e["parent"]) for e in spans] == [(0, None)] * 5
    assert not [e for e in tracer.events if e["name"].startswith("solve/")]
    assert [e["attrs"].get("exception") for e in spans] == \
        [None] * 4 + (["NonFiniteSolveError"] if fault else [None])


def test_span_that_raises_closes_its_profiler_range(tmp_path):
    """An exception through a span closes its profiler range where the
    span ends, and the span keeps the error's name."""
    from torch.profiler import ProfilerActivity, profile, record_function

    t = ttrace.Tracer(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            with t.span("recon/unpack", slices=4):
                torch.ones(3).add_(1)
                raise ValueError("boom")
        with record_function("after"):
            torch.ones(3).mul_(2)
    (unpack, after) = _annotations(prof, tmp_path)
    assert (unpack[1], after[1]) == ("recon/unpack", "after")
    assert unpack[0] + unpack[2] <= after[0]
    assert t.spans()[0]["attrs"] == {"slices": 4, "exception": "ValueError"}
