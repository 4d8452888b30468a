"""BENCHMARK.json against the benchmark's contract and its own files."""
import importlib.util
import json
import re

import pytest

from conftest import ROOT
from xctbench import check

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
BENCH = ROOT / "xctbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_top_level():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["xctbench"]
    assert MANIFEST["command"] == ["python3", "xctbench/run.py"]
    assert all(PATH.match(p) for p in MANIFEST["paths"])
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries(kind):
    entries = MANIFEST[kind]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and kind != "end_to_end":
                assert _line(e[key]), (e["name"], key)


def test_metric_names_unique_and_sources():
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e


def test_every_cell_reports_enough():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in METRICS:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    for cell in cells:
        def has(kind):
            return [m["name"] for m in MANIFEST[kind]
                    if cell in m.get("workloads", [cell])]
        e2e = has("end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2 and has("per_layer")
        for m in MANIFEST["per_layer"]:
            if cell in m.get("workloads", [cell]):
                assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("entry", MANIFEST["configs"],
                         ids=lambda e: e["name"])
def test_config_file_matches(entry):
    assert entry["file"].startswith("xctbench/configs/")
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["name"] == entry["name"]
    assert config["source"] == entry["source"] and _line(entry["source"])
    assert config["reduced"] == entry["reduced"]
    assert len(entry["reduced"]) <= 16
    assert all(NAME.match(k) for k in entry["reduced"])
    for key in config["reduced"]:
        assert config[key] != config["source_values"][key], key
    for key in ("n", "angles", "slices", "partition", "precision", "fuse",
                "iters", "control", "limits", "assumed", "deployment"):
        assert key in config, key
    assert config["limits"] and all(v is not None and v > 0
                                    for v in config["limits"].values())
    assert set(config["limits"]) <= set(check.NUMBERS)
    assert [c["file"] for c in MANIFEST["configs"]].count(entry["file"]) == 1
    assert any(w["config"] == entry["name"] for w in MANIFEST["workloads"])


@pytest.mark.parametrize("entry", MANIFEST["workloads"],
                         ids=lambda e: e["name"])
def test_workload_file_matches(entry):
    cell = json.loads(
        (BENCH / "workloads" / f"{entry['name']}.json").read_text())
    assert cell == entry
    assert entry["chips"] in (1, 4)
    assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
    traffic = json.loads(
        (BENCH / "traffic" / f"{entry['traffic']}.json").read_text())
    assert {"loop", "callers", "slab_slices", "pool", "noise",
            "warmup_solves", "trace_solves"} <= set(traffic)
    config = json.loads((BENCH / "configs" /
                         f"{entry['config']}.json").read_text())
    assert traffic["slab_slices"] % config["fuse"] == 0
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert pairs.count((entry["config"], entry["traffic"])) == 1


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


@pytest.mark.parametrize("entry", METRICS, ids=lambda e: e["name"])
def test_metric_file_matches(entry):
    mod = _metric(entry["name"])
    assert mod.UNIT == entry["unit"] and mod.BETTER == entry["better"]
    assert mod.SOURCE == entry["source"]
    assert mod.LAYER == entry.get("layer")
    assert mod.MOVES == entry.get("moves")
    assert callable(mod.read)


def test_files_named_from_names():
    for f in BENCH.rglob("*"):
        if "__pycache__" in f.parts:
            continue
        rel = f.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
