"""repro_torch.tune on the CPU: passports, the modeled autotuner, the
calibration and the consumers that resolve a passport.

The counterparts of every case of ``test_tune.py`` on the port, then
side by side with the JAX package on the same inputs: a passport saved
by either package loads in the other with the same bytes, the
fingerprints agree, and under the reference's hardware rates (the port
prices with the H100's, ``launch.hardware.HW``) the autotuner's trials
and passport equal the reference's.  For those the port's own device
terms of the slab model (``stream.scheduler.port_extras``) are set to
zero, since the reference's model does not have them.
"""
import dataclasses
import doctest
import importlib
import json

import pytest
import torch

from repro.core.geometry import XCTGeometry as JGeo
from repro.launch.hlo_analysis import HW as JHW
from repro.launch.xct_perf import sweep_topology as jax_topology
from repro.tune import passport as jpassport
from repro_torch.core.geometry import XCTGeometry
from repro_torch.kernels.traffic import PER_COPY_OVERHEAD_S
from repro_torch.launch import hardware as thardware
from repro_torch.launch.xct_perf import sweep_topology as port_topology
from repro_torch.tune import (
    PassportVersionError,
    TuningPassport,
    autotune,
    hardware_fingerprint,
    load_passport,
    passport_path,
    resolve_passport,
    save_passport,
)
from repro_torch.tune import passport as tpassport

# the packages export the function under the module's name
jautotune = importlib.import_module("repro.tune.autotune")
tautotune = importlib.import_module("repro_torch.tune.autotune")

HW = {"backend": "cpu", "device_kind": "cpu", "n_devices": 1}
GEO = XCTGeometry(n=32, n_angles=48)
# small but non-trivial sweep: every axis still exercised
SPACE = {
    "block": [(16, 16), (32, 32)],
    "slab_frac": [1.0, 0.5],
    "comm_mode": ["direct", "hier"],
}


def _tune(**kw):
    kw.setdefault("p_data", 1)
    kw.setdefault("mem_budget", 256 << 20)
    kw.setdefault("n_slices", 32)
    kw.setdefault("fuse", 4)
    kw.setdefault("space", SPACE)
    kw.setdefault("hardware", HW)
    return autotune(GEO, **kw)


def _passport(**over):
    kw = dict(
        fingerprint=hardware_fingerprint(HW), hardware=HW,
        knobs={"dma": "coalesced", "slot_order": "runs", "y_slab": 16},
    )
    kw.update(over)
    return TuningPassport(**kw)


@pytest.fixture()
def reference_rates(monkeypatch):
    """The port priced with the reference's rates and without its own
    slab-model terms: what the side-by-side cases compare."""
    from repro_torch.stream import scheduler

    rates = thardware.Hardware(
        peak_flops=JHW.peak_flops, hbm_bw=JHW.hbm_bw, ici_bw=JHW.ici_bw,
        dci_bw=JHW.dci_bw,
    )
    monkeypatch.setattr(tautotune, "HW", rates)
    monkeypatch.setattr(thardware, "HW", rates)
    monkeypatch.setattr(scheduler, "port_extras", lambda plan, pol: (0, 0))
    return rates


# --------------------------------------------------------------------- #
# persistence: determinism, round trip, versioning, corruption
# --------------------------------------------------------------------- #
def test_passport_bytes_deterministic_across_runs(tmp_path):
    """Two runs of the same sweep mint BYTE-identical passport files --
    no timestamps, no dict-order noise, no environment leakage."""
    p1, _ = _tune()
    p2, _ = _tune()
    assert p1 == p2
    d1, d2 = tmp_path / "a", tmp_path / "b"
    b1 = open(save_passport(p1, str(d1)), "rb").read()
    b2 = open(save_passport(p2, str(d2)), "rb").read()
    assert b1 == b2
    # canonical form: sorted keys, compact separators, one newline
    assert b1.endswith(b"\n") and b": " not in b1


def test_passport_roundtrip(tmp_path):
    p = _passport()
    path = save_passport(p, str(tmp_path))
    assert path == passport_path(str(tmp_path), p.fingerprint)
    assert load_passport(path) == p
    assert resolve_passport(str(tmp_path), p.fingerprint) == p


def test_future_schema_version_rejected(tmp_path):
    """A passport from a NEWER build raises on strict load and demotes
    to warn+None on resolve -- never silently misread."""
    p = _passport()
    path = save_passport(p, str(tmp_path))
    raw = json.loads(open(path).read())
    raw["schema_version"] = 99
    open(path, "w").write(json.dumps(raw))
    with pytest.raises(PassportVersionError, match="schema_version=99"):
        load_passport(path)
    with pytest.warns(UserWarning, match="unusable tuning passport"):
        assert resolve_passport(str(tmp_path), p.fingerprint) is None


def test_corrupt_passport_falls_back_with_warning(tmp_path):
    p = _passport()
    path = save_passport(p, str(tmp_path))
    open(path, "w").write("{definitely not json")
    with pytest.warns(UserWarning, match="unusable tuning passport"):
        assert resolve_passport(str(tmp_path), p.fingerprint) is None
    # missing file stays SILENT -- cold start is not an anomaly
    assert resolve_passport(str(tmp_path), "0" * 16) is None


def test_fingerprint_mismatch_inside_file_warns(tmp_path):
    p = _passport()
    path = save_passport(p, str(tmp_path))
    # file named for one machine, contents minted on another
    other = passport_path(str(tmp_path), "f" * 16)
    open(other, "wb").write(open(path, "rb").read())
    with pytest.warns(UserWarning, match="embedded fingerprint"):
        assert resolve_passport(str(tmp_path), "f" * 16) is None


def test_overhead_source_validated():
    for ok in ("default", "measured-interpret", "measured"):
        _passport(overhead_source=ok)
    with pytest.raises(ValueError, match="overhead_source"):
        _passport(overhead_source="guessed")


# --------------------------------------------------------------------- #
# the autotuner itself
# --------------------------------------------------------------------- #
def test_autotune_prefers_reordered_coalesced_and_beats_baseline():
    """The modeled argmin lands on the run-extension layout with
    coalesced copies (the issue-count winners) and the recorded objective
    beats the untuned first-seen baseline on the copy-issue term."""
    p, trials = _tune()
    assert p.knobs["slot_order"] == "runs"
    assert p.knobs["dma"] == "coalesced"
    base = p.objective["baseline"]
    assert p.objective["dma_issue_seconds"] < base["dma_issue_seconds"]
    assert p.objective["total_seconds"] <= base["total_seconds"]
    assert p.objective["dci_bytes"] <= base["dci_bytes"]
    feas = [t for t in trials if t["feasible"]]
    assert len(feas) > 1
    assert p.objective["total_seconds"] == min(
        t["total_seconds"] for t in feas
    )


def test_autotune_records_overhead_provenance():
    p, _ = _tune()
    assert p.overhead_source == "default"
    p2, _ = _tune(per_copy_overhead_s=3e-7,
                  overhead_source="measured-interpret")
    assert p2.per_copy_overhead_s == 3e-7
    assert p2.overhead_source == "measured-interpret"
    # a different overhead reprices the issue term
    assert p2.objective["dma_issue_seconds"] == pytest.approx(
        3e-7 / p.per_copy_overhead_s * p.objective["dma_issue_seconds"]
    )


def test_autotune_infeasible_budget_raises():
    with pytest.raises(ValueError, match="no feasible candidate"):
        _tune(mem_budget=1024)  # cannot hold even one granule


# --------------------------------------------------------------------- #
# consumer pins: recon / stream / serve resolve the SAME passport
# --------------------------------------------------------------------- #
def test_consumers_resolve_same_passport(tmp_path, monkeypatch):
    """ReconConfig.tuned, suggest_slab and AdmissionController must all
    act on the same passport for the same fingerprint -- one tuning
    result, one behavior, everywhere."""
    from repro_torch.core.partition import PartitionConfig, estimate_plan
    from repro_torch.core.recon import ReconConfig
    from repro_torch.dist import Topology
    from repro_torch.serve.admission import AdmissionController
    from repro_torch.stream.scheduler import suggest_slab

    p, _ = _tune(fuse=2)
    save_passport(p, str(tmp_path))
    # the consumers fingerprint the LIVE process; pin it to HW
    monkeypatch.setattr(tpassport, "describe_hardware", lambda: HW)

    rcfg = ReconConfig.tuned(tune_dir=str(tmp_path))
    assert rcfg.fuse == p.knobs["fuse"]
    assert rcfg.dma == p.knobs["dma"]
    assert rcfg.comm_mode == p.knobs["comm_mode"]
    # explicit override still wins over the passport
    assert ReconConfig.tuned(tune_dir=str(tmp_path), fuse=8).fuse == 8

    topo = Topology.from_sizes([("model", 1, "ici")])
    adm = AdmissionController(256 << 20, topo, tune_dir=str(tmp_path))
    assert adm.passport == p

    plan = estimate_plan(
        GEO,
        PartitionConfig(
            n_data=1,
            rows_per_block=p.knobs["rows_per_block"],
            nnz_per_stage=p.knobs["nnz_per_stage"],
            slot_order=p.knobs["slot_order"],
        ),
    )
    sp = suggest_slab(
        plan, rcfg, topo, 256 << 20, n_slices=64, passport=p
    )
    # tuned y_slab caps the streaming slab AND the admission pricing
    assert sp.y_slab <= p.knobs["y_slab"]
    cost = adm.price(GEO, PartitionConfig(n_data=1), rcfg, n_slices=64)
    assert cost.y_slab <= p.knobs["y_slab"]


def test_tuned_config_without_passport_is_stock(tmp_path):
    from repro_torch.core.recon import ReconConfig

    assert ReconConfig.tuned(tune_dir=str(tmp_path)) == ReconConfig()
    assert ReconConfig.tuned() == ReconConfig()


def test_calibrated_overhead_flows_into_passport():
    """The calibration micro-sweep's per-copy overhead rides into the
    passport with honest provenance: CPU runs time the plain version,
    tagged measured-interpret, and the shared traffic model warns that
    such timings must not rank dma modes."""
    from repro_torch.tune.calibrate import calibrate_per_copy_overhead

    with pytest.warns(RuntimeWarning, match="interpret"):
        cal = calibrate_per_copy_overhead(
            "cpu", buf=32, b=2, s=2, r=8, k=8, f=2, reps=1
        )
    assert cal["overhead_source"] == "measured-interpret"
    assert cal["per_copy_overhead_s"] >= 0.0
    assert cal["strided_issues"] > cal["contig_issues"]

    p, _ = _tune(
        per_copy_overhead_s=cal["per_copy_overhead_s"],
        overhead_source=cal["overhead_source"],
    )
    assert p.per_copy_overhead_s == cal["per_copy_overhead_s"]
    assert p.overhead_source == "measured-interpret"


def test_passport_asdict_json_stable():
    """dataclasses.asdict of a passport is JSON-serializable as-is --
    the save path cannot hit a TypeError mid-publish."""
    p, _ = _tune()
    json.dumps(dataclasses.asdict(p), sort_keys=True)


# --------------------------------------------------------------------- #
# side by side with the JAX package
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("hw", [
    HW,
    {"backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3",
     "n_devices": 1},
    {"backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3",
     "n_devices": 4},
])
def test_fingerprint_matches_reference(hw):
    assert hardware_fingerprint(hw) == jpassport.hardware_fingerprint(hw)
    assert passport_path("d", hardware_fingerprint(hw)) == \
        jpassport.passport_path("d", jpassport.hardware_fingerprint(hw))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_passport_crosses_the_packages_byte_for_byte(writer, tmp_path):
    """A passport saved by either package loads in the other, and saving
    it again there gives the same bytes."""
    kw = dict(
        fingerprint=hardware_fingerprint(HW), hardware=HW,
        knobs={"dma": "coalesced", "slot_order": "runs", "y_slab": 16,
               "rows_per_block": 32, "fuse": 4, "precision": "mixed"},
        workload={"n": 32, "n_angles": 48, "p_data": 1},
        objective={"total_seconds": 0.25, "dci_bytes": 0.0},
        per_copy_overhead_s=3.22e-11, overhead_source="measured",
    )
    mod_w, mod_r = ((tpassport, jpassport) if writer == "port"
                    else (jpassport, tpassport))
    path = mod_w.save_passport(mod_w.TuningPassport(**kw),
                               str(tmp_path / "w"))
    loaded = mod_r.load_passport(path)
    assert dataclasses.asdict(loaded) == kw | {"schema_version": 1}
    again = mod_r.save_passport(loaded, str(tmp_path / "r"))
    assert open(again, "rb").read() == open(path, "rb").read()
    assert mod_r.resolve_passport(str(tmp_path / "w"),
                                  kw["fingerprint"]) == loaded


def test_describe_hardware_reads_torch_cuda(monkeypatch):
    """The fingerprint describes the card through ``torch.cuda``; without
    one it describes the CPU."""
    assert tpassport.describe_hardware() == {
        "backend": "cpu", "device_kind": "cpu", "n_devices": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    hw = tpassport.describe_hardware()
    assert hw == {"backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3",
                  "n_devices": 1}
    assert tpassport.hardware_fingerprint() == \
        jpassport.hardware_fingerprint(hw)


@pytest.mark.parametrize("knobs", [
    {"block": (32, 32), "tile": 8, "slot_order": "runs", "dma": "coalesced",
     "comm_mode": "hier", "precision": "mixed", "wire": "native",
     "slab_frac": 1.0},
    {"block": (16, 16), "tile": 8, "slot_order": "first_seen",
     "dma": "per_row", "comm_mode": "sparse", "precision": "q8",
     "wire": "native", "slab_frac": 0.5},
    {"block": (32, 32), "tile": 8, "slot_order": "runs", "dma": "coalesced",
     "comm_mode": "hier-sparse", "precision": "mixed", "wire": "q8",
     "slab_frac": 0.25},
])
@pytest.mark.parametrize("p_data", [1, 16])
def test_modeled_objective_matches_reference(knobs, p_data,
                                             reference_rates):
    """One candidate priced by both packages under the same rates and
    overhead: every term equal."""
    kw = dict(p_data=p_data, mem_budget=256 << 20, fuse=4, n_slices=32,
              per_copy_overhead_s=1e-7)
    ours = tautotune.modeled_objective(
        GEO, knobs, topology=port_topology(p_data), **kw)
    theirs = jautotune.modeled_objective(
        JGeo(n=32, n_angles=48), knobs,
        topology=jax_topology(p_data), **kw)
    assert ours == theirs


def test_autotune_trials_and_passport_match_reference(reference_rates,
                                                       tmp_path):
    """The whole sweep under the reference's rates: the same trials in the
    same order, the same winner, and a passport of the same bytes."""
    kw = dict(p_data=1, mem_budget=256 << 20, n_slices=32, fuse=4,
              space=SPACE, hardware=HW, per_copy_overhead_s=1e-7)
    ours, t_ours = autotune(GEO, **kw)
    theirs, t_theirs = jautotune.autotune(JGeo(n=32, n_angles=48), **kw)
    assert t_ours == t_theirs
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    a = save_passport(ours, str(tmp_path / "port"))
    b = jpassport.save_passport(theirs, str(tmp_path / "jax"))
    assert open(a, "rb").read() == open(b, "rb").read()


def test_h100_rates_reprice_the_same_work():
    """Under the H100's rates the tuner prices the same bytes and issues
    as under the reference's: each term scales by the ratio of the
    rates, and only the per-copy overhead scales the issue term."""
    knobs = {"block": (32, 32), "tile": 8, "slot_order": "runs",
             "dma": "coalesced", "comm_mode": "hier", "precision": "mixed",
             "wire": "native", "slab_frac": 1.0}
    kw = dict(p_data=16, mem_budget=256 << 20, fuse=4, n_slices=32)
    ours = tautotune.modeled_objective(
        GEO, knobs, topology=port_topology(16),
        per_copy_overhead_s=PER_COPY_OVERHEAD_S, **kw)
    theirs = jautotune.modeled_objective(
        JGeo(n=32, n_angles=48), knobs, topology=jax_topology(16),
        per_copy_overhead_s=1e-7, **kw)
    assert ours["hbm_seconds"] == pytest.approx(
        theirs["hbm_seconds"] * JHW.hbm_bw / thardware.HW.hbm_bw)
    assert ours["ici_seconds"] == pytest.approx(
        theirs["ici_seconds"] * JHW.ici_bw / thardware.HW.ici_bw)
    assert ours["dma_issue_seconds"] == pytest.approx(
        theirs["dma_issue_seconds"] * PER_COPY_OVERHEAD_S / 1e-7)
    assert (ours["ici_bytes"], ours["dci_bytes"]) == (
        theirs["ici_bytes"], theirs["dci_bytes"])


def test_suggest_slab_passport_cap_matches_reference(reference_rates):
    """The passport's ``y_slab`` caps the port's slab as it caps the
    reference's, on the same plan and budget."""
    from repro.core.partition import PartitionConfig as JPcfg
    from repro.core.partition import estimate_plan as jestimate
    from repro.core.recon import ReconConfig as JCfg
    from repro.dist import Topology as JTopo
    from repro.stream.scheduler import suggest_slab as jsuggest
    from repro_torch.core.partition import PartitionConfig, estimate_plan
    from repro_torch.core.recon import ReconConfig
    from repro_torch.dist import Topology
    from repro_torch.stream.scheduler import suggest_slab

    plan = estimate_plan(GEO, PartitionConfig())
    jplan = jestimate(JGeo(n=32, n_angles=48), JPcfg())
    for cap in (None, 3, 8, 12, 1000):
        knobs = {} if cap is None else {"y_slab": cap}
        ours = suggest_slab(
            plan, ReconConfig(fuse=4), Topology.from_sizes(
                [("model", 1, "ici")]), 64 << 20, n_slices=64,
            passport=_passport(knobs=knobs))
        theirs = jsuggest(
            jplan, JCfg(fuse=4), JTopo.from_sizes([("model", 1, "ici")]),
            64 << 20, n_slices=64,
            passport=jpassport.TuningPassport(
                fingerprint="0" * 16, hardware=HW, knobs=knobs))
        assert ours.y_slab == theirs.y_slab


def test_tuned_config_matches_reference(tmp_path, monkeypatch):
    from repro.core.recon import ReconConfig as JCfg
    from repro_torch.core.recon import ReconConfig

    knobs = {"precision": "q8", "comm_mode": "hier-sparse", "wire": "q8",
             "fuse": 8, "dma": "per_row", "rows_per_block": 64}
    p = _passport(knobs=knobs)
    save_passport(p, str(tmp_path))
    monkeypatch.setattr(tpassport, "describe_hardware", lambda: HW)
    monkeypatch.setattr(jpassport, "describe_hardware", lambda: HW)
    for over in ({}, {"fuse": 2}, {"precision": "single", "wire": "native",
                                    "comm_mode": "rs"}):
        ours = ReconConfig.tuned(tune_dir=str(tmp_path), **over)
        theirs = JCfg.tuned(tune_dir=str(tmp_path), **over)
        for f in ("precision", "comm_mode", "wire", "fuse", "dma"):
            assert getattr(ours, f) == getattr(theirs, f), f


def test_interpret_timed_warns_as_the_reference_does():
    from repro.kernels.traffic import spmm_traffic as jtraffic
    from repro_torch.kernels.traffic import spmm_traffic as ttraffic

    with pytest.warns(RuntimeWarning, match="rank dma modes"):
        ours = ttraffic(2, 2, 8, 8, 32, 2, interpret_timed=True)
    with pytest.warns(RuntimeWarning, match="rank dma modes"):
        theirs = jtraffic(2, 2, 8, 8, 32, 2, interpret_timed=True)
    assert ours == theirs


@pytest.mark.parametrize("name", [
    "repro_torch.tune.passport", "repro_torch.launch.xct_perf",
    "repro_torch.launch.hardware",
])
def test_module_doctests(name):
    result = doctest.testmod(importlib.import_module(name))
    assert result.attempted > 0 and result.failed == 0
