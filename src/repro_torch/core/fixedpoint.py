"""Variable-width fixed-point data types — paper §III-A.

The port's own copy of `repro.core.fixedpoint`: the type,
`alpha_for_range`, and the bit-accurate array ops on torch tensors.

A fixed-point type is a tuple (alpha, beta): `alpha` integral bits, `beta`
fractional bits (total width alpha+beta).  Signed types use two's complement,
so the representable ranges are

    unsigned: [0, 2^alpha - 2^-beta]
    signed:   [-2^(alpha-1), 2^(alpha-1) - 2^-beta]

Values are stored as the scaled integer ``round(x * 2^beta)`` in the
smallest containing container (`repro_torch.core.policy`), with
saturation instead of wrap-around.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import xla_f32


@dataclasses.dataclass(frozen=True)
class FixedPointType:
    """(alpha, beta) fixed-point format — paper's `typ` parameter."""

    alpha: int            # integral bits (includes sign bit when signed)
    beta: int             # fractional bits
    signed: bool = True

    def __post_init__(self):
        if self.alpha < 0 or self.beta < 0:
            raise ValueError(f"negative field width: {self}")
        if self.alpha + self.beta == 0:
            raise ValueError("zero-width fixed-point type")

    # -- derived quantities ------------------------------------------------
    @property
    def width(self) -> int:
        return self.alpha + self.beta

    @property
    def resolution(self) -> float:
        """Smallest representable increment, 2^-beta."""
        return 2.0 ** (-self.beta)

    @property
    def min_value(self) -> float:
        return -(2.0 ** (self.alpha - 1)) if self.signed else 0.0

    @property
    def max_value(self) -> float:
        if self.signed:
            return 2.0 ** (self.alpha - 1) - self.resolution
        return 2.0 ** self.alpha - self.resolution

    # scaled-integer bounds (value * 2^beta)
    @property
    def int_min(self) -> int:
        return -(1 << (self.width - 1)) if self.signed else 0

    @property
    def int_max(self) -> int:
        return (1 << (self.width - 1)) - 1 if self.signed else (1 << self.width) - 1

    def __str__(self) -> str:  # e.g. s13.4 / u8.0
        return f"{'s' if self.signed else 'u'}{self.alpha}.{self.beta}"

    # -- classmethods -------------------------------------------------------
    @staticmethod
    def for_range(lo: float, hi: float, beta: int = 0) -> "FixedPointType":
        """Smallest type whose range covers [lo, hi] — paper's alpha formula."""
        alpha = alpha_for_range(lo, hi)
        return FixedPointType(alpha=alpha, beta=beta, signed=lo < 0)


def alpha_for_range(lo: float, hi: float) -> int:
    """Number of integral bits for range [lo, hi] — paper §IV-B, eq. for alpha.

        alpha = max(ceil(log2(ceil|lo|)), ceil(log2(floor|hi| + 1))) + 1   if lo < 0
        alpha = ceil(log2(floor(hi) + 1))                                  otherwise
    """
    if math.isinf(lo) or math.isinf(hi):
        return 64  # sentinel: analysis blew up (division by interval containing 0)
    if lo > hi:
        raise ValueError(f"empty range [{lo}, {hi}]")

    def _clog2(v: float) -> int:
        if v <= 1:
            return 0
        return int(math.ceil(math.log2(v)))

    if lo < 0:
        a_neg = _clog2(math.ceil(abs(lo)))
        a_pos = _clog2(math.floor(abs(hi)) + 1) if hi > 0 else 0
        return max(a_neg, a_pos) + 1
    return max(_clog2(math.floor(hi) + 1), 1)


# ---------------------------------------------------------------------------
# Bit-accurate fixed-point emulation ops, on torch tensors.
#
# Representation: "qvalue" = the scaled integer round(x * 2^beta), carried in
# int64.  All ops saturate.
# ---------------------------------------------------------------------------

def quantize(x: torch.Tensor, t: FixedPointType) -> torch.Tensor:
    """float -> int64 qvalue: round-half-even in f64, then saturation.

    `x` is taken to f64 first, whatever its dtype: the reference rounds
    in x's own dtype, which for an f32 `x` at JAX's default x32 can
    round a tie the other way (ROADMAP, the reference's standing
    failures); here the product ``x * 2^beta`` is always the f64 one."""
    q = torch.round(x.to(torch.float64) * (2.0 ** t.beta))
    q = torch.clamp(q, float(t.int_min), float(t.int_max))
    return q.to(torch.int64)


def dequantize(q: torch.Tensor, t: FixedPointType) -> torch.Tensor:
    """qvalue -> float: f64 for int64 qvalues, f32 for narrower ones."""
    dt = torch.float64 if q.dtype == torch.int64 else torch.float32
    return q.to(dt) * (2.0 ** -t.beta)


def fix_round(x: torch.Tensor, t: FixedPointType) -> torch.Tensor:
    """Round a float tensor onto the (alpha, beta) grid with saturation,
    in x's dtype: quantize then dequantize, without leaving floats."""
    step = 2.0 ** t.beta
    q = torch.round(x * step)
    q = torch.clamp(q, float(t.int_min), float(t.int_max))
    return q / step


def fix_round_f32(x: torch.Tensor, t: FixedPointType) -> torch.Tensor:
    """`fix_round` of an f32 tensor under XLA's f32 rules
    (`core.xla_f32`), as the reference's `fix_round` runs on its f32
    walk: the step and the clip bounds are f32 (``float(t.int_max)``
    rounds above 2^24), the product and the quotient are flushed, and
    the clip is XLA's max then min."""
    dev = x.device
    step = xla_f32.const(2.0 ** t.beta, dev).t
    q = torch.round(xla_f32.ftz(xla_f32.ftz(x) * step))
    q = xla_f32.minimum(
        xla_f32.maximum(q, xla_f32.const(float(t.int_min), dev).t),
        xla_f32.const(float(t.int_max), dev).t)
    return xla_f32.ftz(q / step)


def saturating_add(qa: torch.Tensor, qb: torch.Tensor,
                   t: FixedPointType) -> torch.Tensor:
    return torch.clamp(qa + qb, t.int_min, t.int_max)


def saturating_sub(qa: torch.Tensor, qb: torch.Tensor,
                   t: FixedPointType) -> torch.Tensor:
    return torch.clamp(qa - qb, t.int_min, t.int_max)


def saturating_mul(qa: torch.Tensor, qb: torch.Tensor, ta: FixedPointType,
                   tb: FixedPointType, tout: FixedPointType) -> torch.Tensor:
    """(a * 2^ba) * (b * 2^bb) = ab * 2^(ba+bb); rescaled to tout.beta
    with round-half-UP on the dropped bits (the cheap FPGA rounding, as
    the reference's)."""
    prod = qa * qb                       # exact in int64
    shift = ta.beta + tb.beta - tout.beta
    if shift > 0:
        prod = (prod + (1 << (shift - 1))) >> shift
    elif shift < 0:
        prod = prod << (-shift)
    return torch.clamp(prod, tout.int_min, tout.int_max)


def apply_fixed(x: torch.Tensor, t: Optional[FixedPointType]
                ) -> torch.Tensor:
    """Snap to the type's grid; None keeps the float (the float design)."""
    if t is None:
        return x
    return fix_round(x, t)


def quant_error_bound(t: FixedPointType) -> float:
    """Max rounding error introduced by one snap: half a resolution step."""
    return 0.5 * t.resolution


def storage_bits(t: Optional[FixedPointType]) -> int:
    """Bits per stored element (float reference = 32)."""
    return 32 if t is None else t.width


def np_quantize(x: np.ndarray, t: FixedPointType) -> np.ndarray:
    """NumPy twin of `quantize` for oracles in tests."""
    q = np.rint(x * (2.0 ** t.beta))
    return np.clip(q, t.int_min, t.int_max).astype(np.int64)
