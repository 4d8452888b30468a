"""The set-up's cache: keyed by what shapes a plan, built once."""
import json
import shutil

import numpy as np

from conftest import ROOT
from xctbench import cache

CONFIG = json.loads(
    (ROOT / "xctbench/configs/xct-shale-p64-mixed.json").read_text())
TINY = dict(CONFIG, n=16, angles=12)


def _program_copy(tmp_path):
    dst = tmp_path / "repro_torch"
    for rel in cache.PLANNING_SOURCES:
        (dst / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ROOT / "src/repro_torch" / rel, dst / rel)
    return dst


def test_plan_key_follows_planning_sources(tmp_path):
    program = _program_copy(tmp_path)
    key = cache.plan_key(CONFIG, program)
    assert key == cache.plan_key(CONFIG, ROOT / "src/repro_torch")
    for rel in cache.PLANNING_SOURCES:
        f = program / rel
        before = f.read_bytes()
        f.write_bytes(before + b"\n")
        assert cache.plan_key(CONFIG, program) != key, rel
        f.write_bytes(before)
    assert cache.plan_key(CONFIG, program) == key


def test_plan_key_follows_geometry_and_partition():
    program = ROOT / "src/repro_torch"
    key = cache.plan_key(CONFIG, program)
    assert cache.plan_key(dict(CONFIG, n=256), program) != key
    assert cache.plan_key(dict(CONFIG, angles=192), program) != key
    part = dict(CONFIG["partition"], nnz_per_stage=16)
    assert cache.plan_key(dict(CONFIG, partition=part), program) != key
    # the policy does not shape the plan: both configurations share it
    assert cache.plan_key(dict(CONFIG, precision="single"), program) == key


def test_plan_and_matrix_built_once(tmp_path):
    program = ROOT / "src/repro_torch"
    got = cache.setup_inputs(TINY, tmp_path, program)
    assert got["plan_built"]
    again = cache.setup_inputs(TINY, tmp_path, program)
    assert not again["plan_built"]
    from repro_torch.core.partition import plan_to_arrays

    first, second = plan_to_arrays(got["plan"]), plan_to_arrays(
        again["plan"])
    assert first.keys() == second.keys()
    assert all(np.array_equal(first[k], second[k]) for k in first)
    assert (got["matrix"] != again["matrix"]).nnz == 0
    assert not list(tmp_path.glob("*.partial"))


def test_store_gives_back_every_array_bit_for_bit(tmp_path, monkeypatch):
    monkeypatch.setattr(cache, "PIECE", 1000)  # many pieces an array
    rng = np.random.default_rng(5)
    arrays = {"proj.vals": rng.random((3, 700), dtype=np.float32),
              "proj.inds": rng.integers(0, 500, (4, 999)).astype(np.int16),
              "back.winmap": np.arange(2500, dtype=np.int32).reshape(50, 50),
              "scalar": np.array(7, np.int64),
              "empty": np.zeros((0, 3), np.float64)}
    cache.save_arrays(arrays, tmp_path / "entry")
    got = cache.load_arrays(tmp_path / "entry")
    assert got.keys() == arrays.keys()
    for name, arr in arrays.items():
        assert got[name].dtype == arr.dtype and got[name].shape == arr.shape
        assert np.array_equal(got[name], arr), name
    written = sum(f.stat().st_size for f in (tmp_path / "entry").iterdir())
    assert written < sum(a.nbytes for a in arrays.values())
