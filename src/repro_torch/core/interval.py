"""Interval-arithmetic abstract domain — paper §III-C and Algorithm 1.

The port's own copy of `repro.core.interval` (the port imports nothing from
`repro`); tests/test_torch_*.py hold the two copies equal.

An `Interval` [lo, hi] over-approximates the set of values a (homogeneous)
pixel signal can take at a pipeline stage.  Transfer functions follow
Algorithm 1 exactly, including the dedicated `power` rule the compiler uses
when it recognizes x*x as x**2 (paper §IV-B: x in [-2,2] ⇒ x*x = [-4,4] but
x**2 = [0,4]).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence, Union

Number = Union[int, float]


def _is_ndarray(x) -> bool:
    # late import keeps core.interval dependency-free of numpy at import time
    return type(x).__module__ == "numpy" and type(x).__name__ == "ndarray"


@dataclasses.dataclass(frozen=True)
class Interval:
    lo: float
    hi: float

    def __post_init__(self):
        if not (self.lo <= self.hi or (math.isnan(self.lo) or math.isnan(self.hi))):
            raise ValueError(f"malformed interval [{self.lo}, {self.hi}]")

    # -- constructors --------------------------------------------------------
    @staticmethod
    def point(v: Number) -> "Interval":
        return Interval(float(v), float(v))

    @staticmethod
    def top() -> "Interval":
        return Interval(-math.inf, math.inf)

    @staticmethod
    def of(v) -> "Interval":
        if isinstance(v, Interval):
            return v
        return Interval.point(v)

    # -- lattice ---------------------------------------------------------------
    def join(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))

    def contains(self, v: Number) -> bool:
        return self.lo - 1e-12 <= v <= self.hi + 1e-12

    def encloses(self, other: "Interval") -> bool:
        return self.lo - 1e-12 <= other.lo and other.hi <= self.hi + 1e-12

    @property
    def width(self) -> float:
        return self.hi - self.lo

    # -- arithmetic (Algorithm 1 switch) ---------------------------------------
    # NB: ndarray operands return NotImplemented so numpy object arrays
    # dispatch elementwise (the §IV-C per-pixel executor relies on this).
    def __add__(self, other) -> "Interval":
        if _is_ndarray(other):
            return NotImplemented
        o = Interval.of(other)
        return Interval(self.lo + o.lo, self.hi + o.hi)

    __radd__ = __add__

    def __neg__(self) -> "Interval":
        return Interval(-self.hi, -self.lo)

    def __sub__(self, other) -> "Interval":
        if _is_ndarray(other):
            return NotImplemented
        o = Interval.of(other)
        return Interval(self.lo - o.hi, self.hi - o.lo)

    def __rsub__(self, other) -> "Interval":
        if _is_ndarray(other):
            return NotImplemented
        return Interval.of(other) - self

    def __mul__(self, other) -> "Interval":
        if _is_ndarray(other):
            return NotImplemented
        o = Interval.of(other)

        def m(a: float, b: float) -> float:
            # standard interval convention: 0 * inf = 0 (avoids NaN bounds)
            if a == 0.0 or b == 0.0:
                return 0.0
            return a * b

        cands = (m(self.lo, o.lo), m(self.lo, o.hi),
                 m(self.hi, o.lo), m(self.hi, o.hi))
        return Interval(min(cands), max(cands))

    __rmul__ = __mul__

    def __truediv__(self, other) -> "Interval":
        if _is_ndarray(other):
            return NotImplemented
        o = Interval.of(other)
        if o.lo <= 0.0 <= o.hi:
            # divisor interval contains zero -> [-inf, +inf]   (Algorithm 1, case /)
            return Interval.top()
        return self * Interval(1.0 / o.hi, 1.0 / o.lo)

    def __rtruediv__(self, other) -> "Interval":
        if _is_ndarray(other):
            return NotImplemented
        return Interval.of(other) / self

    def __pow__(self, n: int) -> "Interval":
        """Exponentiation rule from paper §IV-B (n a compile-time constant)."""
        if not isinstance(n, int) or n < 0:
            raise ValueError("interval power requires a non-negative int exponent")
        if n == 0:
            return Interval.point(1.0)
        if n % 2 == 1:
            return Interval(self.lo ** n, self.hi ** n)
        # even power
        if self.lo >= 0:
            return Interval(self.lo ** n, self.hi ** n)
        if self.hi < 0:
            return Interval(self.hi ** n, self.lo ** n)
        return Interval(0.0, max(self.lo ** n, self.hi ** n))

    # -- domain-specific transfer functions -------------------------------------
    def abs(self) -> "Interval":
        if self.lo >= 0:
            return self
        if self.hi <= 0:
            return -self
        return Interval(0.0, max(-self.lo, self.hi))

    def min_(self, other) -> "Interval":
        o = Interval.of(other)
        return Interval(min(self.lo, o.lo), min(self.hi, o.hi))

    def max_(self, other) -> "Interval":
        o = Interval.of(other)
        return Interval(max(self.lo, o.lo), max(self.hi, o.hi))

    def sqrt(self) -> "Interval":
        lo = max(self.lo, 0.0)
        return Interval(math.sqrt(lo), math.sqrt(max(self.hi, 0.0)))

    def select(self, then_v: "Interval", else_v: "Interval") -> "Interval":
        """Select(cond, a, b): result may be either branch — join."""
        return then_v.join(else_v)

    def __repr__(self) -> str:
        return f"[{self.lo:g}, {self.hi:g}]"


def stencil_range(inp: Interval, weights: Sequence[Sequence[float]],
                  scale: float = 1.0) -> Interval:
    """Combined range of `scale * sum_k w_k * x_k` with all x_k in `inp`.

    This is the paper's homogeneity trick (§IV-B): every tap of the stencil
    reads a pixel of the *same* stage, hence the same interval; the stencil
    expands into the expression  scale * (w_0*x_0 + w_1*x_1 + ...) and interval
    arithmetic treats the taps as independent (no cancellation), exactly as
    the paper's Table II numbers do (e.g. Sobel on [0,255] -> [-85, 85] after
    the 1/12 scale).
    """
    acc = Interval.point(0.0)
    for row in weights:
        for w in row:
            acc = acc + inp * float(w)
    return acc * scale


def dot_range(inps: Iterable[Interval], weights: Iterable[float]) -> Interval:
    acc = Interval.point(0.0)
    for iv, w in zip(inps, weights):
        acc = acc + iv * float(w)
    return acc
