"""Config autotuning: sweep the modeled design space, persist a passport
(the port's copy of the reference's ``repro.tune``).

``repro_torch.tune`` closes the loop between the shared cost models
(``kernels.traffic``, ``launch.xct_perf.comm_volume``,
``stream.scheduler.suggest_slab``) and the runtime configs that consume
them.  :func:`autotune.autotune` sweeps block shape x slab budget x comm
mode x dma mode x slot order through those models, priced with the
H100's rates (``launch.hardware.HW``) -- the *modeled* tier needs no
card at all -- and persists the argmin as a versioned, per-hardware
**tuning passport** (:mod:`~repro_torch.tune.passport`) that
``core.recon.ReconConfig.tuned``, ``launch.recon --tune-dir``,
``stream.scheduler.suggest_slab(passport=...)`` and
``serve.admission.AdmissionController(tune_dir=...)`` all resolve by
hardware fingerprint.  :func:`calibrate.calibrate_per_copy_overhead`
measures the copy issue overhead the models price, on the card.
"""
from .autotune import DEFAULT_SPACE, autotune, modeled_objective
from .calibrate import calibrate_per_copy_overhead
from .passport import (
    SCHEMA_VERSION,
    PassportVersionError,
    TuningPassport,
    describe_hardware,
    hardware_fingerprint,
    load_passport,
    passport_path,
    resolve_passport,
    save_passport,
)

__all__ = [
    "DEFAULT_SPACE",
    "autotune",
    "modeled_objective",
    "calibrate_per_copy_overhead",
    "SCHEMA_VERSION",
    "PassportVersionError",
    "TuningPassport",
    "describe_hardware",
    "hardware_fingerprint",
    "load_passport",
    "passport_path",
    "resolve_passport",
    "save_passport",
]
