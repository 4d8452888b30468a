"""Fixtures of the benchmark's tests: a throwaway checkout holding one
tiny cell, made from new files only."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY = "tiny-mixed"
CELL = "tiny-mixed.slab8"
# limits of the tiny configuration, from CPU readings at n=32, 24 angles
# (12 seeds; control and faults 3 each): mixed reads res_head_gap 7.9e-5
# to 3.8e-4, fit_gap 1.8e-3 to 4.5e-3, res_end_excess 0.125 to 0.203 and
# res_end_bias 0.106 to 0.134; its control q8 res_head_gap 1.2e-3 to
# 3.3e-3; stopped_after_20 res_end_excess 0.50 to 0.56 and res_end_bias
# 0.47 to 0.48
TINY_LIMITS = {"res_head_gap": 8e-4, "fit_gap": 0.02,
               "res_end_excess": 0.35, "res_end_bias": 0.3}
# a per-layer metric a later change might add: the window's call count
EXTRA_METRIC = '''"""Calls answered in the window."""
UNIT = "calls"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "staging"
MOVES = "slices_per_s"


def read(run):
    return len(run.calls)
'''


def make_tiny_root(path: Path) -> Path:
    """A checkout with the real manifest and files plus one tiny cell,
    its configuration, its traffic and one more metric, all new files;
    the program is the repository's (``src`` links to it)."""
    bench = path / "xctbench"
    for sub in ("configs", "workloads", "traffic", "metrics"):
        shutil.copytree(ROOT / "xctbench" / sub, bench / sub)
    (path / "src").symlink_to(ROOT / "src")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads(
        (bench / "configs" / "xct-shale-p64-mixed.json").read_text())
    config.update(name=TINY, n=32, angles=24, slices=64, fuse=4, iters=30,
                  limits=TINY_LIMITS)
    (bench / "configs" / f"{TINY}.json").write_text(json.dumps(config))
    traffic = {"loop": "closed", "callers": 1, "slab_slices": 8, "pool": 2,
               "noise": 0.01, "warmup_solves": 1, "trace_solves": 2}
    (bench / "traffic" / "slab8.json").write_text(json.dumps(traffic))
    cell = {"name": CELL, "config": TINY, "traffic": "slab8", "chips": 1,
            "why": "a throwaway cell of the tests"}
    (bench / "workloads" / f"{CELL}.json").write_text(json.dumps(cell))
    (bench / "metrics" / "calls_answered.py").write_text(EXTRA_METRIC)
    manifest["configs"].append({"name": TINY, "source": "tests",
                                "file": f"xctbench/configs/{TINY}.json",
                                "reduced": ["n", "angles"], "why": "tests"})
    manifest["workloads"].append(cell)
    manifest["per_layer"].append(
        {"name": "calls_answered", "unit": "calls", "better": "higher",
         "source": "host_clock", "layer": "staging", "moves": "slices_per_s",
         "workloads": [CELL]})
    (path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return path


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("checkout"))
