"""``ranges.py`` and the readers of the program's spans and ranges: a
hand-built profiler trace with known launches, ranges and overlaps, a
tracer with a fake clock, and a traced run of the throwaway cell."""
import json
import types

import pytest

from conftest import CELL, ROOT, make_tiny_root
from xctbench import devtrace, harness, ranges

SPANS = ("stage", "x0", "download", "unpack")


def _x(cat, name, ts, dur, tid=1, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=1, tid=tid,
                args=args)


# host thread 1: recon/solve holds a kernel phase, a reduce phase and an
# update with a dot inside; recon/download after it.  Each launch's
# correlation names its device operation.
EVENTS = [
    _x("user_annotation", devtrace.MARKER, 0, 1000),
    _x("user_annotation", "recon/solve", 10, 880),
    _x("user_annotation", "solve/spmm", 20, 40),        # 20-60
    _x("user_annotation", "solve/reduce", 60, 40),      # 60-100
    _x("user_annotation", "solve/update", 100, 40),     # 100-140
    _x("user_annotation", "solve/dot", 110, 20),        # 110-130
    _x("user_annotation", "recon/download", 900, 50),
    _x("user_annotation", "not-a-phase", 130, 10),      # 130-140
    _x("cuda_runtime", "cudaLaunchKernel", 25, 2, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 70, 2, correlation=2),
    _x("cuda_runtime", "cudaLaunchKernel", 75, 2, correlation=3),
    _x("cuda_runtime", "cudaLaunchKernel", 115, 2, correlation=4),
    _x("cuda_runtime", "cudaLaunchKernel", 135, 2, correlation=5),
    _x("cuda_runtime", "cudaMemcpyAsync", 905, 2, correlation=6),
    _x("cuda_runtime", "cudaLaunchKernel", 50, 2, tid=2, correlation=7),
    _x("kernel", "xct_spmm_sorted_f16_f32", 200, 300, stream=7,
       correlation=1),                                   # 200-500
    _x("kernel", "indexFuncLargeIndex", 300, 100, stream=13,
       correlation=2),                                   # hidden
    _x("kernel", "elementwise_kernel", 550, 50, stream=13,
       correlation=3),                                   # not hidden
    _x("kernel", "reduce_kernel", 600, 20, stream=7, correlation=4),
    _x("kernel", "vectorized_elementwise", 620, 30, stream=7,
       correlation=5),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 700, 100, stream=7,
       correlation=6),
    _x("kernel", "other_thread_kernel", 800, 10, stream=7, correlation=7),
    _x("gpu_memset", "Memset (Device)", 810, 5, stream=7, correlation=99),
    _x("kernel", "after_the_stretch", 1500, 10, stream=7, correlation=1),
]
OWNERS = {
    "xct_spmm_sorted_f16_f32": "solve/spmm",
    "indexFuncLargeIndex": "solve/reduce",
    "elementwise_kernel": "solve/reduce",
    "reduce_kernel": "solve/dot",
    "vectorized_elementwise": "solve/update",
    "Memcpy DtoH (Device -> Pageable)": "recon/download",
    "other_thread_kernel": None,   # its thread opened no range
    "Memset (Device)": None,       # its launch is not in the trace
}


def _write(path, events):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def _run(tmp_path, events=EVENTS, profile=True, calls=3):
    """A run record as the readers see it: 2 profiled solves of 32-slice
    slabs at ``fuse`` 16 and 30 iterations, its trace where the harness
    writes it."""
    cell = types.SimpleNamespace(
        name="cell", bench_dir=tmp_path / "xctbench",
        config={"fuse": 16, "iters": 30}, traffic={"slab_slices": 32})
    _write(tmp_path / "build" / "xctbench" / "trace" / "cell.json", events)
    return types.SimpleNamespace(
        cell=cell, calls=[object()] * calls,
        profile={"solves": 2} if profile else None)


def _reader(name):
    return harness._reader(ROOT / "xctbench", name)


def test_each_operation_belongs_to_the_innermost_range(tmp_path):
    got = ranges.ops(_write(tmp_path / "t.json", EVENTS))
    assert {o.name: o.owner for o in got} == OWNERS
    assert [o.name for o in got if o.spmm] == ["xct_spmm_sorted_f16_f32"]
    assert sorted(o.name for o in got if not o.glue) == [
        "Memcpy DtoH (Device -> Pageable)", "xct_spmm_sorted_f16_f32"]


def test_parsed_once_until_the_file_changes(tmp_path):
    path = _write(tmp_path / "t.json", EVENTS)
    first = ranges.ops(path)
    assert ranges.ops(path) is first
    _write(path, EVENTS[:-1])
    again = ranges.ops(path)
    assert again is not first and again == first  # the op cut lay outside


def test_no_marker_no_operations(tmp_path):
    assert ranges.ops(_write(tmp_path / "t.json", EVENTS[1:])) is None


def test_phase_readers(tmp_path):
    run = _run(tmp_path)
    per = 2 * (32 // 16) * 30  # solves x minibatches x iterations
    # reduce: 100 + 50 us; dot + update: 20 + 30 us
    assert _reader("reduce_ms_per_iter").read(run) == pytest.approx(
        0.150 / per)
    assert _reader("cg_ms_per_iter").read(run) == pytest.approx(0.050 / per)
    # the reduce phase's union 300-400 and 550-600 against the SpMM's
    # 200-500: 100 of 150 us
    assert _reader("reduce_hidden_share").read(run) == pytest.approx(
        100 * 100 / 150)


def test_phase_readers_find_nothing_without_ranges(tmp_path):
    """A program that opens no ``solve/*`` range (and a run that did not
    profile) reads nothing, and raises nothing."""
    bare = [e for e in EVENTS if not e["name"].startswith("solve/")]
    for run in (_run(tmp_path / "bare", bare),
                _run(tmp_path / "unprofiled", profile=False)):
        for name in ("reduce_ms_per_iter", "cg_ms_per_iter",
                     "reduce_hidden_share"):
            assert _reader(name).read(run) is None, name


def test_summary_splits_the_glue(tmp_path):
    got = ranges.summary(_write(tmp_path / "t.json", EVENTS))
    glue = 100 + 50 + 20 + 30 + 10 + 5  # us: all but SpMM and DtoH
    assert got["glue_s"] == pytest.approx(glue / 1e6)
    assert got["glue_in_solve_ranges"] == pytest.approx(200 / glue)
    assert got["glue_in_any_range"] == pytest.approx(200 / glue)
    assert [k for k, _ in got["glue_outside_solve_ranges"]] == [
        "None: other_thread_kernel", "None: Memset (Device)"]
    assert got["streams_by_range_s"]["solve/reduce"] == {
        "13": pytest.approx(150 / 1e6)}
    assert got["reduce_hidden_share"] == pytest.approx(100 * 100 / 150)


@pytest.fixture
def fake_tracer():
    from repro_torch.obs import trace

    clock = iter(x * 0.5 for x in range(1000)).__next__
    old = trace.set_tracer(trace.Tracer(enabled=True, clock=clock))
    try:
        yield trace.get_tracer()
    finally:
        trace.set_tracer(old)


def test_span_readers(tmp_path, fake_tracer):
    """Each reader's mean span over the window's calls; a count that is
    not the calls' reads nothing."""
    for _ in range(3):
        for k, name in enumerate(SPANS):
            with fake_tracer.span(f"recon/{name}"):
                for _ in range(k):  # recon/<k-th> lasts k + 1 ticks
                    fake_tracer._clock()
    fake_tracer.enabled = False
    run = _run(tmp_path, calls=3)
    for k, name in enumerate(SPANS):
        assert _reader(f"{name}_ms_per_solve").read(run) == \
            pytest.approx(1e3 * 0.5 * (k + 1))
        assert _reader(f"{name}_ms_per_solve").read(
            _run(tmp_path, calls=2)) is None


def test_traced_run_reports_the_staging_spans(tmp_path):
    """A traced run of the throwaway cell on the CPU with the staging
    metrics listed for it: each reads, and together they lie within the
    host time outside the solve."""
    root = make_tiny_root(tmp_path)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    names = [f"{n}_ms_per_solve" for n in SPANS] + ["host_ms_per_solve.batch"]
    for m in manifest["per_layer"]:
        if m["name"] in names:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    out = harness.run_cell(root, CELL, 2**31 + 5, 0.3, True, device="cpu")
    assert out["correct"]
    got = {n: out["metrics"][n]["value"] for n in names}
    assert all(v > 0 for v in got.values())
    assert sum(got[f"{n}_ms_per_solve"] for n in SPANS) <= \
        got["host_ms_per_solve.batch"]
