"""Chunked, manifest-backed on-disk stores for sinograms and volumes (the
port's copy of the reference's ``stream/store.py``; the on-disk format
is the same, so a store written by either package opens in the other).

The paper's datasets (9K x 11K x 11K mouse brain) are terabytes; neither
the sinogram ``[n_rays, Y]`` nor the volume ``[n_vox, Y]`` fits in host
RAM.  A :class:`SlabStore` keeps such a 2D array on disk as *slab-aligned
shards* along the slice axis (the paper's natural streaming unit,
Sec. III-E: slices are independent least-squares problems sharing ``A``):

  <dir>/manifest.json          rows, n_slices, slab, dtype  (written once)
  <dir>/slab_000000_000016.npy  slices [0, 16)
  <dir>/slab_000016_000032.npy  slices [16, 32)
  ...

Writes are slab-granular, *atomic* and *durable* (tmp + fsync +
``os.replace`` + directory fsync, the same publish discipline as
``ckpt.checkpoint``): a crash mid-write never leaves a torn shard and a
crash right after the rename cannot publish one either -- the data hits
the platter before the name does.  Each write also records the shard's
crc32 in the manifest (under ``"checksums"``, keyed ``"<j0>_<j1>"``);
``read`` verifies a shard the first time it touches it and raises a
typed :class:`~repro_torch.resil.errors.CorruptShardError` on mismatch, which
the retry layer treats as retryable-once-then-quarantine.  Verification
is cached per ``(path, mtime)`` so steady-state reads stay memmap-fast;
the cache is bypassed while a fault plan is active (injected corruption
must never be masked by it).  Reads are range-granular -- ``read(j0,
j1)`` assembles any slice range from the covering shards via memmap, so
a scheduler is free to drain the store in slabs larger than the
writer's (e.g. the simulator writes fine-grained slabs, the solver
reads budget-sized ones).

``simulate_to_store`` is the streaming test-fixture writer: it generates
phantom slices and forward-projects them slab-by-slab
(``data.phantom.phantom_slices(start=, stop=)`` +
``simulate_measurements(first_slice=)``), so building a ``Y``-slice
sinogram never materializes more than one slab of ``[n_rays, slab]`` on
the host -- and the result is bit-identical to the one-shot simulation
for any slab size.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import threading
import zlib

import numpy as np

from ..resil import inject
from ..resil.errors import CorruptShardError

__all__ = ["SlabStore", "simulate_to_store"]

_SHARD_RE = re.compile(r"^slab_(\d{6})_(\d{6})\.npy$")

# the manifest's identity keys; create() re-open compares only these
# (the "checksums" map grows with every write)
_STATIC_KEYS = ("rows", "n_slices", "slab", "dtype")


def _crc(arr) -> int:
    """crc32 of an array's raw bytes (the integrity unit is the shard's
    array data, not the .npy file, so header changes never alarm)."""
    a = np.ascontiguousarray(arr)
    return zlib.crc32(a.view(np.uint8).reshape(-1)) & 0xFFFFFFFF


def _fsync_dir(directory: str) -> None:
    """Durably record a rename in its directory (best-effort on
    platforms that cannot fsync a directory fd)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform-dependent
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - platform-dependent
        pass
    finally:
        os.close(fd)


def _write_json(path: str, obj: dict) -> None:
    """Durable atomic JSON publish (fsync + replace + dir fsync)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


class SlabStore:
    """A ``[rows, n_slices]`` array stored as slab shards along axis 1."""

    def __init__(self, directory: str, manifest: dict):
        self.directory = directory
        self.rows = int(manifest["rows"])
        self.n_slices = int(manifest["n_slices"])
        self.slab = int(manifest["slab"])
        self.dtype = np.dtype(manifest["dtype"])
        self._checksums = dict(manifest.get("checksums", {}))
        self._verified: dict = {}  # shard path -> mtime at verification
        self._lock = threading.Lock()  # manifest read-modify-write

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    @classmethod
    def create(
        cls,
        directory: str,
        rows: int,
        n_slices: int,
        slab: int,
        dtype=np.float32,
    ) -> "SlabStore":
        """Create (or re-open, if the manifest matches) a store."""
        if slab <= 0 or n_slices <= 0 or rows <= 0:
            raise ValueError((rows, n_slices, slab))
        manifest = {
            "rows": int(rows),
            "n_slices": int(n_slices),
            "slab": int(slab),
            "dtype": np.dtype(dtype).name,
        }
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "manifest.json")
        if os.path.exists(path):
            with open(path) as f:
                existing = json.load(f)
            if {k: existing.get(k) for k in _STATIC_KEYS} != manifest:
                raise ValueError(
                    f"store at {directory} already exists with a "
                    f"different manifest: {existing} vs {manifest}"
                )
            # keep the recorded checksums when re-opening (resume path)
            manifest = existing
        else:
            _write_json(path, manifest)
        return cls(directory, manifest)

    @classmethod
    def open(cls, directory: str) -> "SlabStore":
        with open(os.path.join(directory, "manifest.json")) as f:
            return cls(directory, json.load(f))

    # ------------------------------------------------------------------ #
    # slab geometry
    # ------------------------------------------------------------------ #
    def slabs(self) -> list[tuple[int, int]]:
        """All ``(j0, j1)`` write-granularity slab ranges, in order."""
        return [
            (j0, min(j0 + self.slab, self.n_slices))
            for j0 in range(0, self.n_slices, self.slab)
        ]

    def _shard_path(self, j0: int, j1: int) -> str:
        return os.path.join(
            self.directory, f"slab_{j0:06d}_{j1:06d}.npy"
        )

    def written_slabs(self) -> list[tuple[int, int]]:
        """Slab ranges whose shards exist on disk (completion record)."""
        out = []
        for name in os.listdir(self.directory):
            m = _SHARD_RE.match(name)
            if m:
                out.append((int(m.group(1)), int(m.group(2))))
        return sorted(out)

    def complete(self) -> bool:
        return self.written_slabs() == self.slabs()

    # ------------------------------------------------------------------ #
    # I/O
    # ------------------------------------------------------------------ #
    def write(self, j0: int, arr) -> str:
        """Durably + atomically write the slab starting at slice ``j0``.

        ``arr`` must be exactly one write-granularity slab (``[rows,
        j1 - j0]`` with ``j0`` slab-aligned); re-writing a slab replaces
        it atomically.  The shard's crc32 lands in the manifest *before*
        the rename publishes the shard, and both the shard bytes and the
        rename are fsynced -- a crash at any point leaves either the old
        state or the new shard with a matching recorded checksum, never
        a torn shard the resume manifest believes is done.
        """
        arr = np.asarray(arr)
        if j0 % self.slab or not 0 <= j0 < self.n_slices:
            raise ValueError(
                f"slab start {j0} not aligned to slab={self.slab}"
            )
        j1 = min(j0 + self.slab, self.n_slices)
        if arr.shape != (self.rows, j1 - j0):
            raise ValueError(
                f"slab [{j0},{j1}) wants shape {(self.rows, j1 - j0)}, "
                f"got {arr.shape}"
            )
        stored = arr.astype(self.dtype, copy=False)
        final = self._shard_path(j0, j1)
        fd, tmp = tempfile.mkstemp(
            dir=self.directory, suffix=".npy.tmp"
        )
        try:
            with os.fdopen(fd, "wb") as f:
                np.save(f, stored)
                f.flush()
                os.fsync(f.fileno())
            self._record_checksum(j0, j1, _crc(stored))
            os.replace(tmp, final)  # atomic publish
            _fsync_dir(self.directory)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self._verified[final] = os.path.getmtime(final)
        return final

    def _record_checksum(self, j0: int, j1: int, crc: int) -> None:
        path = os.path.join(self.directory, "manifest.json")
        with self._lock:
            with open(path) as f:
                manifest = json.load(f)
            manifest.setdefault("checksums", {})[f"{j0}_{j1}"] = int(crc)
            manifest["checksum_algo"] = "crc32"
            _write_json(path, manifest)
            self._checksums[f"{j0}_{j1}"] = int(crc)

    def _load_shard(self, s0: int, s1: int, path: str) -> np.ndarray:
        """One shard, integrity-checked on first touch.

        Verification reads the shard once and caches ``(path, mtime)``;
        later reads memmap straight through.  While a fault plan is
        active the cache is bypassed and the ``store/read`` injection
        site is consulted (key = shard start slice), so injected
        io_error / corrupt / slow faults land here -- exactly where the
        real ones would.
        """
        recorded = self._checksums.get(f"{s0}_{s1}")
        injecting = inject.active()
        mtime = os.path.getmtime(path)
        if not injecting and (
            recorded is None or self._verified.get(path) == mtime
        ):
            # legacy shard (no recorded crc) or already verified
            return np.load(path, mmap_mode="r")
        shard = np.load(path, mmap_mode="r")
        if injecting:
            shard = inject.mutate("store/read", np.asarray(shard), key=s0)
        if recorded is not None:
            got = _crc(shard)
            if got != recorded:
                raise CorruptShardError(
                    f"shard [{s0},{s1}) of {self.directory} is corrupt: "
                    f"crc {got:#010x} != recorded {recorded:#010x}"
                )
            if not injecting:
                self._verified[path] = mtime
        return shard

    def read(self, j0: int, j1: int) -> np.ndarray:
        """Assemble slices ``[j0, j1)`` from the covering shards.

        Raises :class:`~repro_torch.resil.errors.CorruptShardError` when a
        shard's bytes do not match its recorded crc (see
        :meth:`_load_shard`).
        """
        if not 0 <= j0 < j1 <= self.n_slices:
            raise ValueError((j0, j1, self.n_slices))
        out = np.empty((self.rows, j1 - j0), self.dtype)
        j = j0
        while j < j1:
            s0 = (j // self.slab) * self.slab
            s1 = min(s0 + self.slab, self.n_slices)
            path = self._shard_path(s0, s1)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"slab [{s0},{s1}) of {self.directory} not written"
                )
            shard = self._load_shard(s0, s1, path)
            hi = min(j1, s1)
            out[:, j - j0 : hi - j0] = shard[:, j - s0 : hi - s0]
            j = hi
        return out

    # ------------------------------------------------------------------ #
    # convenience (tests / small arrays)
    # ------------------------------------------------------------------ #
    @classmethod
    def from_array(
        cls, directory: str, arr, slab: int
    ) -> "SlabStore":
        arr = np.asarray(arr)
        store = cls.create(
            directory, arr.shape[0], arr.shape[1], slab, arr.dtype
        )
        for j0, j1 in store.slabs():
            store.write(j0, arr[:, j0:j1])
        return store

    def to_array(self) -> np.ndarray:
        return self.read(0, self.n_slices)


def simulate_to_store(
    a_csr,
    n: int,
    store: SlabStore,
    *,
    noise: float = 0.0,
    seed: int = 0,
) -> SlabStore:
    """Fill ``store`` with simulated measurements, slab by slab.

    Each slab generates its phantom slices and forward-projects them
    independently (chunk-invariant: ``phantom_slices`` slab ranges and
    ``simulate_measurements`` per-slice noise streams depend only on the
    global slice index), so the host working set is one slab, never the
    full ``[n_rays, Y]``.
    """
    from ..data.phantom import phantom_slices, simulate_measurements

    for j0, j1 in store.slabs():
        x = phantom_slices(
            n, store.n_slices, seed=seed, start=j0, stop=j1
        )
        y = simulate_measurements(
            a_csr, x, noise=noise, seed=seed, first_slice=j0
        )
        store.write(j0, y)
    return store
