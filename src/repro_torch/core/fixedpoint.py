"""Variable-width fixed-point data types — paper §III-A.

The port's own copy of `FixedPointType` and `alpha_for_range` from
`repro.core.fixedpoint`; the array ops there (quantize, saturating
arithmetic) are not ported yet.

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
