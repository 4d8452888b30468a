"""The check's readings and the trace's arithmetic, on data made by hand."""
import json

import numpy as np
import pytest
import torch

from xctbench import check, devtrace
from xctbench.reference.cgnr import cgnr, operator
from xctbench.reference.geometry import XCTGeometry, build_system_matrix

ITERS = 12


@pytest.fixture(scope="module")
def problem():
    a = build_system_matrix(XCTGeometry(n=12, n_angles=10))
    ops = operator(a, "cpu")
    rng = np.random.default_rng(3)
    x = rng.random((a.shape[1], 8))
    y = np.asarray(a @ x, np.float32)
    pool = [np.ascontiguousarray(y[:, :4]), np.ascontiguousarray(y[:, 4:])]
    return ops, pool


def _answers(ops, pool, iters=ITERS, stop=None):
    """The reference's own answers, float32, one per slab; ``stop``: the
    solve stops there and pads its residuals."""
    out = []
    for k, y in enumerate(pool):
        x, res = cgnr(*ops, torch.from_numpy(y).double(), stop or iters)
        res = torch.cat([res] + [res[-1:]] * (iters - (stop or iters)))
        out.append((k, x.float().numpy(), res.float().numpy(), None))
    return out


def test_reference_answers_read_near_zero(problem):
    ops, pool = problem
    got = check.judge(_answers(*problem), pool, ops, ITERS)
    assert got["attempted"] == got["distinct"] == 2 and got["failed"] == 0
    for name in ("res_head_gap", "fit_gap", "vol_gap"):
        assert got[name] < 1e-5, name
    assert abs(got["res_end_excess"]) < 1e-5
    assert abs(got["res_end_bias"]) < 1e-5
    assert len(got["res_gap_by_iter"]) == ITERS


def test_repeated_answers_are_judged_once(problem):
    ops, pool = problem
    answers = _answers(*problem)
    repeated = answers + answers + [answers[0]]
    got = check.judge(repeated, pool, ops, ITERS)
    assert got["attempted"] == 5 and got["distinct"] == 2
    changed = (0, answers[0][1] * 1.5, answers[0][2], None)
    got = check.judge(repeated + [changed], pool, ops, ITERS)
    assert got["distinct"] == 3 and got["fit_gap"] > 0.1


def test_early_stop_reads_at_the_end(problem):
    ops, pool = problem
    got = check.judge(_answers(*problem, stop=check.HEAD + 1), pool, ops,
                      ITERS)
    assert got["res_head_gap"] < 1e-5  # the head is the reference's
    assert got["res_end_excess"] > 0.1 and got["res_end_bias"] > 0.1


def test_no_whole_answer(problem):
    ops, pool = problem
    got = check.judge([(0, None, None, "RuntimeError: lost")], pool, ops,
                      ITERS)
    assert got["failed"] == 1 and got["distinct"] == 0
    correct, numbers = check.verdict(got, {"res_head_gap": 1e-3})
    assert not correct and numbers["res_head_gap"]["value"] is None
    correct, numbers = check.verdict(
        dict(got, failed=0, res_head_gap=float("inf")), {"res_head_gap": 1})
    assert not correct and json.dumps(numbers, allow_nan=False)


def _trace(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        dict(ph="X", cat=cat, name=name, ts=ts, dur=dur)
        for cat, name, ts, dur in events]}))
    return path


def test_trace_counts_copies_apart_and_overlap_once(tmp_path):
    path = _trace(tmp_path, [
        ("user_annotation", devtrace.MARKER, 0, 1000),
        ("kernel", "xct_spmm_sorted_f16_f32", 100, 300),   # 100-400
        ("kernel", "elementwise_kernel", 300, 200),         # 300-500
        ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 600, 50),
        ("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 650, 50),
        ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 800, 100),
        ("cpu_op", "aten::index_add_", 500, 100),
    ])
    got = devtrace.read_trace(path)
    assert got["window_s"] == pytest.approx(1000e-6)
    # union: 100-500, 600-700, 800-900
    assert got["busy_s"] == pytest.approx(600e-6)
    assert got["spmm_s"] == pytest.approx(300e-6)
    assert got["copy_s"] == pytest.approx(150e-6)
    assert got["other_s"] == pytest.approx(250e-6)
    # idle: 0-100, 500-600, 700-800, 900-1000
    assert [round(s * 1e6) for _, s in got["idle_gaps"]] == [100] * 4
    assert "aten::index_add_" in [name for name, _ in got["idle_gaps"]]


def test_trace_without_a_solve(tmp_path):
    path = _trace(tmp_path, [("kernel", "xct_spmm", 0, 10)])
    assert devtrace.read_trace(path) is None
