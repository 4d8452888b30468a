"""One run of one cell: set up, warm up, measure, check, report.

Everything a cell is made of is found by name under the benchmark's
folder (``<root>/xctbench``), from ``<root>/BENCHMARK.json``:

* ``workloads/<cell>.json``: the configuration's and the traffic's
  names, the chips, why the cell exists;
* ``configs/<config>.json``: the geometry, the partition fields, the
  precision policy, ``fuse``, ``iters``, the cut from the source, the
  control and the limits of the check;
* ``traffic/<traffic>.json``: the mix's parameters (``traffic.slabs``);
* ``metrics/<metric>.py``: one reader per metric, ``read(run)`` over
  the :class:`Run` record, returning ``None`` where it finds nothing.

The measured program is ``repro_torch`` (``<root>/src``): the window
drives ``Reconstructor.reconstruct`` on host sinograms, one caller in a
closed loop.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from . import cache, check, devtrace
from .reference.cgnr import operator
from .traffic import slabs

__all__ = ["FORBIDDEN", "Cell", "Call", "Run", "load_cell", "run_cell",
           "forbidden_modules", "power_limit_w"]

BENCH = "xctbench"
# the JAX package and JAX itself, by whole top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    manifest: dict
    workload: dict
    config: dict
    traffic: dict
    bench_dir: Path

    def metrics(self, kind: str) -> list:
        """The manifest's ``end_to_end`` or ``per_layer`` entries that
        this cell reports."""
        return [m for m in self.manifest[kind]
                if self.name in m.get("workloads", [self.name])]


@dataclasses.dataclass
class Call:
    """One ``reconstruct`` call: host clock at its start and end."""

    t0: float
    t1: float
    slices: int
    slab: int
    x: np.ndarray | None = None
    res: np.ndarray | None = None
    error: str | None = None
    solve_s: float | None = None  # its fenced ``recon/solve`` span


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cell: Cell
    setup_s: float
    bind_s: float
    calls: list  # the window's, in order
    nnz: int  # of the benchmark's matrix
    n_rays: int
    n_vox: int
    kind: str  # the card's name
    precision: str
    profile: dict | None = None  # devtrace.read_trace + solves, launches

    def outside_solve_ms(self):
        """Milliseconds a window's call spends outside its fenced
        ``recon/solve`` span, averaged over the calls (``None`` without
        spans)."""
        outside = [(c.t1 - c.t0) - c.solve_s for c in self.calls
                   if c.solve_s is not None]
        return 1e3 * sum(outside) / len(outside) if outside else None


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str) -> Cell:
    root = Path(root)
    manifest = _read_json(root / "BENCHMARK.json")
    bench = root / BENCH
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = _read_json(bench / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: {key} {workload[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    (cfg_entry,) = [c for c in manifest["configs"]
                    if c["name"] == entry["config"]]
    config = _read_json(root / cfg_entry["file"])
    traffic = _read_json(bench / "traffic" / f"{entry['traffic']}.json")
    return Cell(name, manifest, workload, config, traffic, bench)


def _reader(bench: Path, metric: str):
    path = bench / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"{BENCH}_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(run: Run, entries: list) -> dict:
    out = {}
    for m in entries:
        mod = _reader(run.cell.bench_dir, m["name"])
        value = mod.read(run)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": mod.UNIT}
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or its package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w():
    """The card's power limit from ``nvidia-smi``, ``None`` where it
    cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _solve(rec, pool, i, iters) -> Call:
    k = i % len(pool)
    t0 = time.perf_counter()
    try:
        x, res = rec.reconstruct(pool[k], iters=iters)
        error = None
    except Exception as e:  # an answer that never came: judged failed
        x = res = None
        error = f"{type(e).__name__}: {e}"
    return Call(t0, time.perf_counter(), pool[k].shape[1], k, x, res, error)


def _profile(rec, pool, iters, n_solves, path, cuda) -> tuple:
    """``n_solves`` calls under ``torch.profiler``, the trace written to
    ``path``; returns ``(calls, summary)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import xct_spmm

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    launches = sum(xct_spmm.LAUNCHES.values())
    calls = []
    with profile(activities=acts) as prof:
        for i in range(n_solves):
            with record_function(devtrace.MARKER):
                calls.append(_solve(rec, pool, i, iters))
        if cuda:
            torch.cuda.synchronize()
    launches = sum(xct_spmm.LAUNCHES.values()) - launches
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    summary = devtrace.read_trace(path)
    if summary is not None:
        summary.update(solves=n_solves, launches=launches)
    return calls, summary


def run_cell(root, name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", precision: str | None = None,
             t_start: float | None = None, inputs: dict | None = None
             ) -> dict:
    """One run of cell ``name``; returns the result line's object (with
    its ``check`` key last).  ``precision`` replaces the configuration's
    policy (the control); ``t_start`` is the process's start on the
    host clock (default: now); ``inputs`` is ``cache.setup_inputs``'s
    result where the caller has it already."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from repro_torch.core.recon import ReconConfig, Reconstructor
    from repro_torch.obs import trace as obs_trace

    root = Path(root)
    cell = load_cell(root, name)
    cfg, tr = cell.config, cell.traffic
    precision = precision or cfg["precision"]
    iters = cfg["iters"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    program = root / "src" / "repro_torch"
    cache_dir = root / "build" / BENCH

    # set-up: plan and matrix (cached), the inputs on the device
    t0 = time.perf_counter()
    setup = {"imports_s": t0 - t_start}
    got = inputs or cache.setup_inputs(cfg, cache_dir, program)
    a = got["matrix"]
    t1 = time.perf_counter()
    pool = slabs.make_pool(a, cfg, tr, seed, dev)
    setup.update(plan_built=got["plan_built"], load_s=t1 - t0,
                 plan_s=got["plan_s"], matrix_s=got["matrix_s"],
                 inputs_s=time.perf_counter() - t1)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec = Reconstructor(got["plan"], cfg=ReconConfig(
        precision=precision, fuse=cfg["fuse"]), device=dev)
    if cuda:
        torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    del got
    tracer = obs_trace.enable() if trace else None
    warm = [_solve(rec, pool, i, iters) for i in range(tr["warmup_solves"])]
    for c in warm:
        if c.error is not None:
            raise RuntimeError(f"warm-up solve failed: {c.error}")
    if tracer is not None:
        tracer.reset()
    del warm
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    setup.update(bind_s=bind_s, warm_s=t_window - t0 - bind_s)

    # the window: one caller, closed loop, every call sent before the
    # deadline runs to its end
    calls = []
    while time.perf_counter() - t_window < seconds:
        calls.append(_solve(rec, pool, len(calls), iters))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if tracer is not None:
        spans = tracer.spans("recon/solve")
        if len(spans) == len(calls):
            for c, sp in zip(calls, spans):
                c.solve_s = sp["t1"] - sp["t0"]
        obs_trace.disable()

    profile, extra = None, []
    if trace:
        extra, profile = _profile(rec, pool, iters, tr["trace_solves"],
                                  cache_dir / "trace" / f"{name}.json", cuda)
    del rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the check, once the window has closed and the program is freed
    answers = [(c.slab, c.x, c.res, c.error) for c in calls + extra]
    t0 = time.perf_counter()
    judged = check.judge(answers, pool, operator(a, dev), iters)
    setup["check_s"] = time.perf_counter() - t0
    correct, numbers = check.verdict(judged, cfg["limits"])

    run = Run(cell=cell, setup_s=setup_s, bind_s=bind_s, calls=calls,
              nnz=int(a.nnz), n_rays=a.shape[0], n_vox=a.shape[1],
              kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
              precision=precision, profile=profile)
    metrics = read_metrics(
        run, cell.metrics("per_layer" if trace else "end_to_end"))
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": run.kind,
                   "count": cell.workload["chips"] if cuda else 1,
                   "memory_peak_bytes": int(peak),
                   "power_limit_w": power_limit_w() if cuda else None}
    out = {"correct": correct, "attempted": judged["attempted"],
           "failed": judged["failed"], "metrics": metrics,
           "device": device_info}
    if profile is not None:
        device_info.update(busy_s=profile["busy_s"],
                           window_s=profile["window_s"])
        out["breakdown"] = {"device_ops": profile["device_ops"],
                            "idle_gaps": profile["idle_gaps"]}
    walls = sorted(c.t1 - c.t0 for c in calls)
    out["window"] = {"calls": len(calls), "wall_min_s": walls[0],
                     "wall_median_s": walls[len(walls) // 2],
                     "wall_max_s": walls[-1]} if walls else {}
    out["setup"] = setup  # set-up's parts in seconds, and the check's
    out["readings"] = {  # every reading, for the record (JSON has no inf)
        k: v if not isinstance(v, float) or math.isfinite(v) else None
        for k, v in judged.items() if k not in ("attempted", "failed")}
    out["check"] = numbers
    return out
