"""Whole runs of a throwaway cell on the CPU (the harness's look for a
card skipped): sound, under its control, and with the timed path
broken underneath; and the command without a card."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import CELL, ROOT, TINY_LIMITS
from xctbench import cache, faults, harness
from xctbench.traffic import slabs

SEED = 2**31 + 77  # more than 32 signed bits hold


def _run(root, **kw):
    kw.setdefault("trace", False)
    return harness.run_cell(root, CELL, SEED, 0.3, device="cpu", **kw)


def test_throwaway_cell_runs_and_is_correct(tiny_root):
    out = _run(tiny_root)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"slices_per_s", "setup_s"}
    assert list(out)[-1] == "check"
    assert set(out["check"]) == set(TINY_LIMITS)
    assert out["device"]["platform"] == "cpu"


def test_throwaway_cell_traced(tiny_root):
    out = _run(tiny_root, trace=True)
    assert out["correct"]
    # no device here: the readers of the device trace find nothing
    assert set(out["metrics"]) == {"bind_s", "calls_answered"}
    assert out["metrics"]["calls_answered"]["unit"] == "calls"


def test_same_seed_same_inputs(tiny_root):
    cell = harness.load_cell(tiny_root, CELL)
    a = cache.load_matrix(cell.config, tiny_root / "build" / "xctbench")
    one = slabs.make_pool(a, cell.config, cell.traffic, SEED, "cpu")
    two = slabs.make_pool(a, cell.config, cell.traffic, SEED, "cpu")
    other = slabs.make_pool(a, cell.config, cell.traffic, SEED + 1, "cpu")
    assert all(np.array_equal(p, q) for p, q in zip(one, two))
    assert not np.array_equal(one[0], other[0])
    assert [p.shape for p in one] == [p.shape for p in other]


def test_control_fails(tiny_root):
    out = _run(tiny_root, precision="q8")
    assert not out["correct"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_caught(tiny_root, fault):
    with faults.planted(fault):
        out = _run(tiny_root)
    assert not out["correct"], out["check"]
    json.dumps(out, allow_nan=False)


def test_fault_is_taken_out_again():
    from repro_torch.core import recon

    before = recon.cgnr, recon.Reconstructor.reconstruct
    with faults.planted("steepest_descent"):
        assert recon.cgnr is not before[0]
    with faults.planted("half_batch"):
        assert recon.Reconstructor.reconstruct is not before[1]
    assert (recon.cgnr, recon.Reconstructor.reconstruct) == before


def test_forbidden_modules_are_named(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax", "repro"]


def test_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    proc = subprocess.run(
        [sys.executable, "xctbench/run.py", "--workload",
         "shale-mixed.slab128", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.gpu
def test_throwaway_cell_on_the_card(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = harness.run_cell(tiny_root, CELL, SEED, 0.5, True)
    assert out["correct"], out["check"]
    dev = out["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    assert {"spmm_roofline", "idle_share", "glue_ms_per_iter"} <= set(
        out["metrics"])
    assert 0 < out["metrics"]["spmm_roofline"]["value"] <= 100
    json.dumps(out)
