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

The quantized-operator rungs ``q8`` and ``fp8`` pack the operator
*values* into int8 or fp8-e4m3 with one power-of-two exponent per
(row-block, stage) (:func:`quantize_block_vals`); vectors and the wire
stay at the ``mixed`` policy's f16 and compute at f32.

Over several ranks, a list of per-rank tensors takes the place of the
reference's ``axis_name``: the scale functions and :func:`qcast` give
every rank the one factor of the group's max-norm (the reference's
``pmax``), bit for bit.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..placement import copy_kind

__all__ = [
    "Precision",
    "POLICIES",
    "ALIASES",
    "get_policy",
    "adaptive_scale",
    "adaptive_scale_cols",
    "qcast",
    "quantize_block_vals",
    "dequantize_block_vals",
]


@dataclasses.dataclass(frozen=True)
class Precision:
    """A storage/compute/communication dtype triple (plus operator vals).

    Attributes:
      storage: dtype of resident vectors and of the staged input windows
        (the paper's 2-byte packing when half/mixed).
      compute: FMA/accumulation dtype inside kernels.
      comm: wire dtype for partial-data reductions.
      adaptive: apply max-norm power-of-two rescaling around narrow casts.
      vals: dtype of the packed operator values when it differs from
        ``storage`` (int8 / fp8-e4m3 with per-block scales, the quantized
        rungs); ``None`` means "same as storage".
    """

    name: str
    storage: torch.dtype
    compute: torch.dtype
    comm: torch.dtype
    adaptive: bool = False
    vals: torch.dtype | None = None

    @property
    def storage_bytes(self) -> int:
        return self.storage.itemsize

    @property
    def comm_bytes(self) -> int:
        return self.comm.itemsize

    @property
    def vals_dtype(self) -> torch.dtype:
        """Operator value dtype (defaults to the vector storage dtype)."""
        return self.storage if self.vals is None else self.vals

    @property
    def vals_bytes(self) -> int:
        return self.vals_dtype.itemsize

    @property
    def quantized(self) -> bool:
        """True when operator vals carry per-block scales (1-byte tier)."""
        return self.vals is not None


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
    # quantized operator tier: int8 / fp8-e4m3 vals with per-block
    # power-of-two scales, dequantized inline in the kernel
    "q8": Precision(
        "q8", torch.float16, torch.float32, torch.float16, adaptive=True,
        vals=torch.int8,
    ),
    "fp8": Precision(
        "fp8", torch.float16, torch.float32, torch.float16, adaptive=True,
        vals=torch.float8_e4m3fn,
    ),
}

# Spelling conveniences: the dtype names people type first.
ALIASES = {
    "f32": "single",
    "f64": "double",
    "f16": "half",
    "int8": "q8",
}


def get_policy(name: str) -> Precision:
    key = ALIASES.get(name, name)
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


def _log2_ratio(target: float, m):
    """``log2(target / max(m, tiny))`` in float32, as the reference rounds it.

    The quotient is a correctly rounded division: PyTorch's ``target / m``
    multiplies by the reciprocal of ``m`` and rounds twice, which moves
    the quotient off an exact power of two when ``m`` is one ulp above
    ``target * 2**k``.  log2 is then ``log(v) * float32(1/ln 2)``, the
    formula ``jnp.log2`` lowers to, rather than ``torch.log2``: the two
    round differently right at half-integers (ROADMAP.md queue 3).
    """
    m = torch.clamp_min(m, torch.finfo(torch.float32).tiny)
    return torch.log(torch.div(torch.full_like(m, target), m)) * _INV_LN2


def _norm_exponent(m, target: float):
    """``clip(round(log2(target / max(m, tiny))), -100, 100)`` in float32."""
    return torch.clamp(torch.round(_log2_ratio(target, m)), -100.0, 100.0)


def _listed(x):
    """``(tensors, many)``: a list or tuple of per-rank tensors stands for
    the reference's ``axis_name``, the group of ranks that must share one
    factor; one tensor is a group of one."""
    many = isinstance(x, (list, tuple))
    return (list(x) if many else [x]), many


@copy_kind("pmax")
def _group_factor(xs, local_max, target: float) -> list:
    """The one power-of-two factor of the group's max-norm, on each rank's
    device.  The ranks' maxima reduce as the reference's ``pmax`` does;
    max is exact, so the factor is the reference's bit for bit."""
    m = local_max(xs[0])
    for t in xs[1:]:
        m = torch.maximum(m, local_max(t).to(m.device))
    s = _pow2(_norm_exponent(m, target))
    return [s.to(t.device) for t in xs]


def adaptive_scale(x, target: float = 256.0):
    """Power-of-two factor steering ``max|x|`` to ``target`` (Sec. III-C1).

    Power-of-two so the scaling itself is lossless in any binary float
    format.  Returns the float32 scalar ``s`` such that ``x * s`` is
    cast-safe; apply ``1/s`` after the round trip.  Given a list of
    per-rank tensors (the reference's ``axis_name``), the max-norm is the
    group's, and every rank gets the *same* factor, on its own device.
    """
    xs, many = _listed(x)
    s = _group_factor(
        xs, lambda t: torch.max(torch.abs(t.to(torch.float32))), target
    )
    return s if many else s[0]


def adaptive_scale_cols(x, target: float = 1.0):
    """Per-column (per-slice) power-of-two normalization factors.

    The paper's III-C1 applied to the evolving CG vectors: each fused
    slice gets its own factor (slices are independent problems with
    independent dynamic ranges).  Returns ``s`` with shape ``[F]``; for a
    list of per-rank row chunks, the group's factors on each rank's
    device, as :func:`adaptive_scale`.
    """
    xs, many = _listed(x)
    s = _group_factor(
        xs, lambda t: torch.amax(torch.abs(t.to(torch.float32)), dim=0),
        target,
    )
    return s if many else s[0]


def qcast(x, dtype, *, adaptive: bool = False, target: float = 256.0):
    """Cast with optional adaptive normalization.

    Returns ``(x_cast, inv_scale)``; multiply by ``inv_scale`` after the
    matching upcast.  For wide targets (f32/f64) this is a plain cast.
    For a list of per-rank tensors both are lists, every rank cast with
    the group's one factor (:func:`adaptive_scale`).
    """
    xs, many = _listed(x)
    if dtype.itemsize >= 4 or not adaptive:
        casts = [t.to(dtype) for t in xs]
        invs = [torch.ones((), dtype=torch.float32, device=t.device)
                for t in xs]
    else:
        s = adaptive_scale(xs, target=target)
        casts = [(t.to(torch.float32) * si).to(dtype)
                 for t, si in zip(xs, s)]
        invs = [1.0 / si for si in s]
    return (casts, invs) if many else (casts[0], invs[0])


def _quant_target(dtype) -> float:
    """Max-|value| the quantized grid should land on: int8's symmetric
    127, or fp8-e4m3's 240 (max finite 448, with headroom)."""
    return 240.0 if dtype.is_floating_point else 127.0


def quantize_block_vals(vals, dtype):
    """Pack operator values into ``dtype`` with per-block scales.

    One power-of-two scale per block (every leading index of ``vals
    [..., R, K]``) steers the block's max |value| onto the narrow grid.
    The exponent is ``floor`` of ``log2(target / max|v|)``, so the scaled
    maximum lands at or below the grid edge and nothing clips.

    Returns ``(q, exp)``: the packed ``[..., R, K]`` values and the int32
    ``[...]`` dequantization exponents, ``vals ~= q * 2.0**exp``.
    """
    lead = vals.shape[:-2]
    flat = vals.to(torch.float32).reshape(max(1, math.prod(lead)), -1)
    m = torch.amax(torch.abs(flat), dim=1)
    sexp = torch.clamp(
        torch.floor(_log2_ratio(_quant_target(dtype), m)), -100.0, 100.0
    )
    q = flat * _pow2(sexp)[:, None]
    if not dtype.is_floating_point:
        q = torch.clamp(torch.round(q), -127.0, 127.0)
    q = q.to(dtype).reshape(vals.shape)
    return q, (-sexp).to(torch.int32).reshape(lead)


def dequantize_block_vals(q, exp, dtype=torch.float32):
    """Widen per-block quantized values: ``q * 2.0**exp`` in f32."""
    scale = _pow2(exp.to(torch.int32))
    return (q.to(torch.float32) * scale[..., None, None]).to(dtype)
