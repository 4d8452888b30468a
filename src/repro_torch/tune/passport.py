"""Tuning passports: versioned, per-hardware persisted autotune results
(the port's copy of the reference's ``tune/passport.py``; a passport file
is the same bytes in either package, so one saved by either loads in the
other).

A passport is one JSON file per hardware fingerprint holding the knob
settings the autotuner picked and the modeled objective that picked
them.  The rules:

* **Canonical bytes.**  ``save_passport`` serializes with sorted keys,
  fixed separators and a trailing newline, and carries no timestamps or
  environment noise -- two runs of the same sweep on the same hardware
  produce *byte-identical* files (pinned by ``tests/test_torch_tune.py``).
  Writes go through the same tmp + ``os.replace`` atomic-publish idiom
  as ``stream.store.SlabStore`` manifests: readers never observe a
  half-written passport.
* **Versioned.**  ``schema_version`` gates forward compatibility: a
  passport written by a *newer* schema raises
  :class:`PassportVersionError` on load instead of being silently
  misread.  :func:`resolve_passport` (the consumer entry point used by
  ``ReconConfig.tuned``, ``launch.recon --tune-dir``,
  ``stream.scheduler.suggest_slab`` and ``serve.admission``) demotes
  *any* unusable file -- future version, corrupt JSON, wrong shape --
  to a ``UserWarning`` plus ``None``, so a bad passport can never take
  down a job that would have run fine untuned.
* **Keyed by hardware.**  The filename embeds
  :func:`hardware_fingerprint`: sha256 over the canonical hardware
  description (backend, device kind, device count -- from ``torch.cuda``
  here), truncated to 16 hex chars.  A passport tuned on one machine is
  invisible on another.

Doctest -- round trip, determinism, and the corrupt-file demotion:

>>> import tempfile, warnings
>>> hw = {"backend": "cpu", "device_kind": "cpu", "n_devices": 1}
>>> fp = hardware_fingerprint(hw)
>>> len(fp)
16
>>> p = TuningPassport(fingerprint=fp, hardware=hw,
...                    knobs={"dma": "coalesced", "slot_order": "runs"})
>>> d = tempfile.mkdtemp()
>>> path = save_passport(p, d)
>>> first = open(path, "rb").read()
>>> save_passport(p, d) == path and open(path, "rb").read() == first
True
>>> resolve_passport(d, fp).knobs["slot_order"]
'runs'
>>> _ = open(path, "w").write("{not json")
>>> with warnings.catch_warnings(record=True) as w:
...     warnings.simplefilter("always")
...     resolve_passport(d, fp) is None and len(w) == 1
True
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings

import torch

from ..kernels.traffic import PER_COPY_OVERHEAD_S

__all__ = [
    "SCHEMA_VERSION",
    "PassportVersionError",
    "TuningPassport",
    "describe_hardware",
    "hardware_fingerprint",
    "passport_path",
    "save_passport",
    "load_passport",
    "resolve_passport",
]

SCHEMA_VERSION = 1

# per_copy_overhead_s provenance ladder (see tune.calibrate.
# calibrate_per_copy_overhead): "default" = the traffic-model constant,
# "measured-interpret" = micro-sweep timed off the card (the plain
# PyTorch version: a smoke of the calibration plumbing, NOT a copy-issue
# number), "measured" = micro-sweep timed on the card.
OVERHEAD_SOURCES = ("default", "measured-interpret", "measured")


class PassportVersionError(RuntimeError):
    """Passport written by a newer schema than this build understands."""


@dataclasses.dataclass(frozen=True)
class TuningPassport:
    """One hardware's tuned configuration (see module docstring).

    ``knobs`` is what consumers apply (partition + runtime settings:
    ``rows_per_block``, ``nnz_per_stage``, ``tile``, ``slot_order``,
    ``dma``, ``comm_mode``, ``fuse``, ``y_slab``); ``objective`` records
    the modeled seconds/bytes that made them win, next to the same
    numbers for the untuned default so the margin is auditable.
    """

    fingerprint: str
    hardware: dict
    knobs: dict
    schema_version: int = SCHEMA_VERSION
    workload: dict = dataclasses.field(default_factory=dict)
    objective: dict = dataclasses.field(default_factory=dict)
    per_copy_overhead_s: float = PER_COPY_OVERHEAD_S
    overhead_source: str = "default"

    def __post_init__(self):
        if self.overhead_source not in OVERHEAD_SOURCES:
            raise ValueError(
                f"overhead_source {self.overhead_source!r}; one of "
                f"{OVERHEAD_SOURCES}"
            )


def describe_hardware() -> dict:
    """Canonical description of the machine the process can see.

    Backend + device kind + count is what changes the cost-model inputs
    (and so the argmin); library versions and hostnames deliberately do
    NOT enter the fingerprint -- a pip upgrade should not orphan a
    passport.  Read from ``torch.cuda``: the name of card 0 and the
    count of cards; a process without a card describes the CPU.
    """
    if not torch.cuda.is_available():
        return {"backend": "cpu", "device_kind": "cpu", "n_devices": 0}
    return {
        "backend": "cuda",
        "device_kind": torch.cuda.get_device_name(0),
        "n_devices": torch.cuda.device_count(),
    }


def _canonical(obj) -> bytes:
    return (
        json.dumps(obj, sort_keys=True, separators=(",", ":")) + "\n"
    ).encode()


def hardware_fingerprint(hardware: dict | None = None) -> str:
    """sha256 over the canonical hardware description, 16 hex chars."""
    if hardware is None:
        hardware = describe_hardware()
    return hashlib.sha256(_canonical(hardware)).hexdigest()[:16]


def passport_path(tune_dir: str, fingerprint: str) -> str:
    return os.path.join(tune_dir, f"passport-{fingerprint}.json")


def save_passport(passport: TuningPassport, tune_dir: str) -> str:
    """Atomically publish ``passport`` under ``tune_dir``; returns path.

    Canonical serialization (sorted keys, fixed separators, trailing
    newline, no timestamps) => byte-determinism across runs.
    """
    os.makedirs(tune_dir, exist_ok=True)
    path = passport_path(tune_dir, passport.fingerprint)
    payload = _canonical(dataclasses.asdict(passport))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)  # atomic publish, as SlabStore manifests
    return path


def load_passport(path: str) -> TuningPassport:
    """Parse one passport file; strict (raises) -- see resolve_passport.

    Raises :class:`PassportVersionError` when the file's
    ``schema_version`` is newer than this build's, ``ValueError`` /
    ``KeyError`` / ``json.JSONDecodeError`` on malformed content.
    """
    with open(path, "rb") as f:
        raw = json.loads(f.read().decode())
    if not isinstance(raw, dict):
        raise ValueError(f"passport {path}: expected a JSON object")
    ver = raw.get("schema_version")
    if not isinstance(ver, int):
        raise ValueError(f"passport {path}: missing schema_version")
    if ver > SCHEMA_VERSION:
        raise PassportVersionError(
            f"passport {path} has schema_version={ver}, newer than this "
            f"build's {SCHEMA_VERSION}; refusing to guess at its fields"
        )
    fields = {f.name for f in dataclasses.fields(TuningPassport)}
    return TuningPassport(**{k: v for k, v in raw.items() if k in fields})


def resolve_passport(
    tune_dir: str | None,
    fingerprint: str | None = None,
) -> TuningPassport | None:
    """Consumer entry point: best-effort passport lookup, never raises.

    Missing dir/file -> ``None`` silently (untuned is the normal cold
    state); unusable file (corrupt, future schema, wrong fingerprint
    inside) -> ``UserWarning`` + ``None`` so jobs degrade to defaults
    instead of dying on a bad cache.
    """
    if tune_dir is None:
        return None
    if fingerprint is None:
        fingerprint = hardware_fingerprint()
    path = passport_path(tune_dir, fingerprint)
    if not os.path.exists(path):
        return None
    try:
        p = load_passport(path)
    except Exception as e:  # noqa: BLE001 -- demote, see docstring
        warnings.warn(
            f"ignoring unusable tuning passport {path}: "
            f"{type(e).__name__}: {e}",
            UserWarning,
            stacklevel=2,
        )
        return None
    if p.fingerprint != fingerprint:
        warnings.warn(
            f"ignoring tuning passport {path}: embedded fingerprint "
            f"{p.fingerprint!r} != expected {fingerprint!r}",
            UserWarning,
            stacklevel=2,
        )
        return None
    return p
