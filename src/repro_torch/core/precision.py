"""Mixed-precision policies + adaptive normalization (paper Sec. III-C).

The paper stores and communicates in half precision and computes in single
precision, guarding fp16's narrow range with *adaptive normalization*: the
(de)normalization factor follows the max-norm of the evolving iterate so
casts neither overflow nor underflow.

The float rungs of the reference's ladder, in torch dtypes.  ``double``
is true float64 here (the reference's ``jnp.float64`` computes in float32
unless ``jax_enable_x64`` is set).  The scale factors follow the
reference's arithmetic: the exponent is ``round(log2(target / max|x|))``
in float32 with half-to-even rounding (``torch.round``, like
``jnp.round``), and ``2**e`` is built from its bits, exactly.  They are
bit-equal to the reference's except where ``log2`` lies within a float32
ulp of a half-integer and the two frameworks' ``log`` round differently
(ROADMAP.md queue 3).
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "Precision",
    "POLICIES",
    "ALIASES",
    "get_policy",
    "adaptive_scale",
    "adaptive_scale_cols",
    "qcast",
]


@dataclasses.dataclass(frozen=True)
class Precision:
    """A storage/compute/communication dtype triple.

    Attributes:
      storage: dtype of resident vectors and of the staged input windows
        (the paper's 2-byte packing when half/mixed).
      compute: FMA/accumulation dtype inside kernels.
      comm: wire dtype for partial-data reductions.
      adaptive: apply max-norm power-of-two rescaling around narrow casts.
    """

    name: str
    storage: torch.dtype
    compute: torch.dtype
    comm: torch.dtype
    adaptive: bool = False

    @property
    def storage_bytes(self) -> int:
        return self.storage.itemsize

    @property
    def comm_bytes(self) -> int:
        return self.comm.itemsize

    @property
    def vals_dtype(self) -> torch.dtype:
        """Operator value dtype (the vector storage dtype on float rungs)."""
        return self.storage

    @property
    def vals_bytes(self) -> int:
        return self.vals_dtype.itemsize


POLICIES = {
    "double": Precision(
        "double", torch.float64, torch.float64, torch.float64
    ),
    "single": Precision(
        "single", torch.float32, torch.float32, torch.float32
    ),
    "half": Precision("half", torch.float16, torch.float16, torch.float16),
    "mixed": Precision(
        "mixed", torch.float16, torch.float32, torch.float16, adaptive=True
    ),
    "bf16": Precision(
        "bf16", torch.bfloat16, torch.bfloat16, torch.bfloat16
    ),
    "mixed_bf16": Precision(
        "mixed_bf16", torch.bfloat16, torch.float32, torch.bfloat16,
        adaptive=True,
    ),
}

# the quantized-operator rungs of the reference, not ported yet
_NOT_PORTED = ("q8", "fp8")

# Spelling conveniences: the dtype names people type first.
ALIASES = {
    "f32": "single",
    "f64": "double",
    "f16": "half",
    "int8": "q8",
}


def get_policy(name: str) -> Precision:
    key = ALIASES.get(name, name)
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"precision {key!r} (quantized operator values) is not ported "
            "yet: ROADMAP.md queue 2, the quantized kernel"
        )
    try:
        return POLICIES[key]
    except KeyError:
        raise KeyError(
            f"unknown precision {name!r}; one of {sorted(POLICIES)} "
            f"(aliases: {', '.join(f'{a}->{b}' for a, b in sorted(ALIASES.items()))})"
        ) from None


_INV_LN2 = 1.4426950408889634  # rounds to float32 1.44269502


def _pow2(exp):
    """``2.0**exp`` in float32, built from the exponent bits (exact for
    ``exp`` in [-126, 127]; callers clip to [-100, 100])."""
    return ((exp.to(torch.int32) + 127) << 23).view(torch.float32)


def _norm_exponent(m, target: float):
    """``clip(round(log2(target / max(m, tiny))), -100, 100)`` in float32.

    log2 is taken as ``log(v) * float32(1/ln 2)``, the formula
    ``jnp.log2`` lowers to, rather than ``torch.log2``: the two round
    differently right at half-integers (ROADMAP.md queue 3).
    """
    m = torch.clamp_min(m, torch.finfo(torch.float32).tiny)
    exp = torch.round(torch.log(target / m) * _INV_LN2)
    return torch.clamp(exp, -100.0, 100.0)


def adaptive_scale(x, target: float = 256.0):
    """Power-of-two factor steering ``max|x|`` to ``target`` (Sec. III-C1).

    Power-of-two so the scaling itself is lossless in any binary float
    format.  Returns the float32 scalar ``s`` such that ``x * s`` is
    cast-safe; apply ``1/s`` after the round trip.
    """
    m = torch.max(torch.abs(x.to(torch.float32)))
    return _pow2(_norm_exponent(m, target))


def adaptive_scale_cols(x, target: float = 1.0):
    """Per-column (per-slice) power-of-two normalization factors.

    The paper's III-C1 applied to the evolving CG vectors: each fused
    slice gets its own factor (slices are independent problems with
    independent dynamic ranges).  Returns ``s`` with shape ``[F]``.
    """
    m = torch.amax(torch.abs(x.to(torch.float32)), dim=0)
    return _pow2(_norm_exponent(m, target))


def qcast(x, dtype, *, adaptive: bool = False, target: float = 256.0):
    """Cast with optional adaptive normalization.

    Returns ``(x_cast, inv_scale)``; multiply by ``inv_scale`` after the
    matching upcast.  For wide targets (f32/f64) this is a plain cast.
    """
    if dtype.itemsize >= 4 or not adaptive:
        return x.to(dtype), torch.ones((), dtype=torch.float32,
                                       device=x.device)
    s = adaptive_scale(x, target=target)
    return (x.to(torch.float32) * s).to(dtype), 1.0 / s
