"""The set-up's disk cache: the program's plan and the benchmark's matrix.

Both live under ``<checkout>/build/xctbench/`` at paths fixed by what
they hold, so only the first run of a checkout builds them:

* ``plan-<key>/``: the program's partition plan (its own system matrix,
  planned by its own ``build_plan``), one file per array of
  ``plan_to_arrays``.  The key hashes the geometry, the partition fields
  and the bytes of the program's planning sources, so a change to the
  planner never loads a stale plan.
* ``matrix-<key>/``: the benchmark's own system matrix (the frozen
  Siddon copy in ``reference/``) as CSR arrays, keyed by its geometry
  and source.

Each array is stored as zlib pieces (level 1) of at most ``PIECE`` raw
bytes, compressed and decompressed on a pool of threads: the window
tables and indices shrink 4 to 10 times, so the first run writes a
third of the raw bytes, and a warm load takes about as long as reading
them raw.  An entry is written under ``<name>.partial`` and renamed into
place, so a run that is cut leaves no half-written entry behind.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import scipy.sparse as sp

__all__ = ["PLANNING_SOURCES", "PIECE", "plan_key", "matrix_key",
           "save_arrays", "load_arrays", "load_plan", "load_matrix",
           "setup_inputs"]

# the program's files that shape a plan, relative to its package
PLANNING_SOURCES = ("core/geometry.py", "core/partition.py",
                    "core/hilbert.py", "kernels/ops.py")
_REFERENCE_GEOMETRY = Path(__file__).resolve().parent / "reference" / \
    "geometry.py"
PIECE = 1 << 24  # raw bytes per compressed piece
_SUFFIX = ".z"


def _digest(record: dict, files) -> str:
    h = hashlib.sha256(json.dumps(record, sort_keys=True).encode())
    for f in files:
        h.update(Path(f).read_bytes())
    return h.hexdigest()[:16]


def plan_key(config: dict, program_dir: Path) -> str:
    """Hash of the geometry, the partition fields and the planner's
    source bytes (``program_dir`` is the program's package)."""
    record = {"n": config["n"], "angles": config["angles"],
              "partition": config["partition"]}
    return _digest(record, [program_dir / f for f in PLANNING_SOURCES])


def matrix_key(config: dict) -> str:
    return _digest({"n": config["n"], "angles": config["angles"]},
                   [_REFERENCE_GEOMETRY])


def save_arrays(arrays: dict, path: Path, pool=None):
    """``{name: array}`` -> directory ``path``, one file per array: a
    JSON header line (dtype, shape, the raw bytes of a piece, the pieces'
    lengths), then the pieces."""
    if pool is None:
        with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
            return save_arrays(arrays, path, pool)
    path.mkdir(parents=True)
    for name, arr in arrays.items():
        raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
        pieces = list(pool.map(lambda i: zlib.compress(raw[i:i + PIECE], 1),
                               range(0, raw.size, PIECE)))
        header = {"dtype": arr.dtype.str, "shape": list(arr.shape),
                  "piece": PIECE, "pieces": [len(z) for z in pieces]}
        with open(path / f"{name}{_SUFFIX}", "wb") as f:
            f.write(json.dumps(header).encode() + b"\n")
            for z in pieces:
                f.write(z)


def load_arrays(path: Path, pool=None) -> dict:
    """The arrays :func:`save_arrays` wrote, bit for bit."""
    if pool is None:
        with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
            return load_arrays(path, pool)
    out, jobs = {}, []
    for f in sorted(path.glob(f"*{_SUFFIX}")):
        blob = memoryview(f.read_bytes())
        end = bytes(blob[:1 << 16]).index(b"\n")
        header = json.loads(bytes(blob[:end]))
        dtype = np.dtype(header["dtype"])
        flat = np.empty(int(np.prod(header["shape"], dtype=np.int64))
                        * dtype.itemsize, np.uint8)
        at, raw_at = end + 1, 0
        for size in header["pieces"]:
            n = min(header["piece"], flat.size - raw_at)
            jobs.append((flat[raw_at:raw_at + n], blob[at:at + size]))
            at, raw_at = at + size, raw_at + n
        out[f.name[:-len(_SUFFIX)]] = flat.view(dtype).reshape(
            header["shape"])

    def unpack(job):
        dst, z = job
        dst[:] = np.frombuffer(zlib.decompress(z), np.uint8)

    list(pool.map(unpack, jobs))
    return out


def _store(arrays: dict, final: Path, pool):
    """Write ``arrays`` under ``final``'s ``.partial`` name and rename it
    into place (where another run got there first, drop this one)."""
    partial = final.with_name(final.name + ".partial")
    shutil.rmtree(partial, ignore_errors=True)
    save_arrays(arrays, partial, pool)
    if final.exists():
        shutil.rmtree(partial)
    else:
        partial.rename(final)


def _build_plan(config: dict):
    from repro_torch.core.geometry import XCTGeometry, build_system_matrix
    from repro_torch.core.partition import PartitionConfig, build_plan

    geo = XCTGeometry(n=config["n"], n_angles=config["angles"])
    a = build_system_matrix(geo)
    return build_plan(geo, PartitionConfig(**config["partition"]), a=a)


def load_plan(config: dict, cache_dir: Path, program_dir: Path,
              pool=None):
    """``(plan, built)``: the cached plan, built and stored first when
    missing."""
    from repro_torch.core.geometry import XCTGeometry
    from repro_torch.core.partition import (
        PartitionConfig,
        plan_from_arrays,
        plan_to_arrays,
    )

    final = cache_dir / f"plan-{plan_key(config, program_dir)}"
    if final.is_dir():
        geo = XCTGeometry(n=config["n"], n_angles=config["angles"])
        return plan_from_arrays(load_arrays(final, pool), geo,
                                PartitionConfig(**config["partition"])), False
    plan = _build_plan(config)
    _store(plan_to_arrays(plan), final, pool)
    return plan, True


def load_matrix(config: dict, cache_dir: Path, pool=None) -> sp.csr_matrix:
    """The benchmark's own ``A`` (rays x voxels, float32 CSR)."""
    from .reference.geometry import XCTGeometry, build_system_matrix

    final = cache_dir / f"matrix-{matrix_key(config)}"
    if final.is_dir():
        z = load_arrays(final, pool)
        return sp.csr_matrix((z["data"], z["indices"], z["indptr"]),
                             shape=tuple(z["shape"]))
    a = build_system_matrix(XCTGeometry(n=config["n"],
                                        n_angles=config["angles"]))
    _store({"data": a.data, "indices": a.indices.astype(np.int32),
            "indptr": a.indptr.astype(np.int64),
            "shape": np.array(a.shape)}, final, pool)
    return a


def setup_inputs(config: dict, cache_dir: Path, program_dir: Path) -> dict:
    """Plan and matrix side by side (the matrix on a thread; NumPy and
    zlib hold the interpreter lock little), their pieces on one pool.
    Returns ``{plan, matrix, plan_built, plan_s, matrix_s}``, the seconds
    each took."""
    out: dict = {}
    errors: list = []
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:

        def matrix():
            t0 = time.perf_counter()
            try:
                out["matrix"] = load_matrix(config, cache_dir, pool)
            except BaseException as e:  # re-raised on the caller's thread
                errors.append(e)
            out["matrix_s"] = time.perf_counter() - t0

        th = threading.Thread(target=matrix, name="xctbench-matrix")
        th.start()
        try:
            t0 = time.perf_counter()
            out["plan"], out["plan_built"] = load_plan(
                config, cache_dir, program_dir, pool)
            out["plan_s"] = time.perf_counter() - t0
        finally:
            th.join()
    if errors:
        raise errors[0]
    return out
