"""Affine-arithmetic abstract domain — paper §III-C (Stolfi & Figueiredo style).

A signal is represented as  x = x0 + sum_i xi * eps_i,  eps_i in [-1, 1].
Correlations between signals are captured by *shared* noise symbols, so
x - x == 0 exactly (where interval arithmetic over-approximates to [-w, w]).

Non-affine ops (mul, div, powers) introduce one fresh noise symbol carrying
the linearization error, per the standard Chebyshev/trivial-range
approximations.  This is the drop-in second domain for the paper's pluggable
framework (§IV-C, the YalAA `typ` switch) — see `core.absval`.

The port's own copy of `repro.core.affine`, with its own noise-symbol
counter: symbol ids are process-global and only their identity matters
(two forms share a symbol or do not), never their values.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Union

from repro_torch.core.interval import Interval

Number = Union[int, float]


def _is_ndarray(x) -> bool:
    return type(x).__module__ == "numpy" and type(x).__name__ == "ndarray"


_fresh_counter = itertools.count()


def _fresh() -> int:
    return next(_fresh_counter)


class AffineForm:
    """x0 + sum_i xi*eps_i with eps_i in [-1,1]."""

    __slots__ = ("x0", "terms")

    def __init__(self, x0: float, terms: Dict[int, float] | None = None):
        self.x0 = float(x0)
        self.terms = dict(terms or {})

    # -- constructors ---------------------------------------------------------
    @staticmethod
    def from_interval(lo: float, hi: float) -> "AffineForm":
        if math.isinf(lo) or math.isinf(hi):
            # top element: unbounded radius around 0
            return AffineForm(0.0, {_fresh(): math.inf})
        mid = 0.5 * (lo + hi)
        rad = 0.5 * (hi - lo)
        if rad == 0.0:
            return AffineForm(mid)
        return AffineForm(mid, {_fresh(): rad})

    @staticmethod
    def point(v: Number) -> "AffineForm":
        return AffineForm(float(v))

    @staticmethod
    def of(v) -> "AffineForm":
        if isinstance(v, AffineForm):
            return v
        return AffineForm.point(v)

    # -- range extraction -------------------------------------------------------
    @property
    def radius(self) -> float:
        return sum(abs(c) for c in self.terms.values())

    def to_interval(self) -> Interval:
        r = self.radius
        return Interval(self.x0 - r, self.x0 + r)

    # -- affine ops (exact) -------------------------------------------------------
    # ndarray operands -> NotImplemented so numpy object arrays dispatch
    # elementwise (per-pixel §IV-C executor).
    def __add__(self, other) -> "AffineForm":
        if _is_ndarray(other):
            return NotImplemented
        o = AffineForm.of(other)
        terms = dict(self.terms)
        for k, v in o.terms.items():
            terms[k] = terms.get(k, 0.0) + v
        return AffineForm(self.x0 + o.x0, {k: v for k, v in terms.items() if v != 0.0})

    __radd__ = __add__

    def __neg__(self) -> "AffineForm":
        return AffineForm(-self.x0, {k: -v for k, v in self.terms.items()})

    def __sub__(self, other) -> "AffineForm":
        if _is_ndarray(other):
            return NotImplemented
        return self + (-AffineForm.of(other))

    def __rsub__(self, other) -> "AffineForm":
        if _is_ndarray(other):
            return NotImplemented
        return AffineForm.of(other) + (-self)

    def scale(self, c: float) -> "AffineForm":
        return AffineForm(self.x0 * c, {k: v * c for k, v in self.terms.items()})

    # -- non-affine ops (fresh noise symbol for the approximation error) ---------
    def __mul__(self, other) -> "AffineForm":
        if _is_ndarray(other):
            return NotImplemented
        o = AffineForm.of(other)
        if not o.terms:       # scalar
            return self.scale(o.x0)
        if not self.terms:
            return o.scale(self.x0)
        # (x0 + X)(y0 + Y) = x0*y0 + x0*Y + y0*X + X*Y ;  |X*Y| <= rad(X)*rad(Y)
        out = AffineForm(self.x0 * o.x0)
        out = out + o.scale(self.x0) + AffineForm(-self.x0 * o.x0)  # x0*y0 + x0*Y
        tmp = self.scale(o.x0)
        out = out + AffineForm(tmp.x0 - self.x0 * o.x0, tmp.terms)  # + y0*X
        err = self.radius * o.radius
        if err > 0.0:
            out.terms[_fresh()] = err
        return out

    __rmul__ = __mul__

    def __truediv__(self, other) -> "AffineForm":
        if _is_ndarray(other):
            return NotImplemented
        o = AffineForm.of(other)
        iv = o.to_interval()
        if iv.lo <= 0.0 <= iv.hi:
            return AffineForm.from_interval(-math.inf, math.inf)
        return self * o.reciprocal()

    def __rtruediv__(self, other) -> "AffineForm":
        if _is_ndarray(other):
            return NotImplemented
        return AffineForm.of(other) / self

    def reciprocal(self) -> "AffineForm":
        """1/x via min-range linear approximation on [lo, hi] (x bounded away from 0)."""
        iv = self.to_interval()
        a, b = iv.lo, iv.hi
        if a <= 0.0 <= b:
            return AffineForm.from_interval(-math.inf, math.inf)
        if not self.terms:
            return AffineForm(1.0 / self.x0)
        # min-range approx: slope p = -1/b^2 (for a>0), intercepts at endpoints
        if a > 0:
            p = -1.0 / (b * b)
            ya = 1.0 / a - p * a
            yb = 1.0 / b - p * b
        else:  # b < 0
            p = -1.0 / (a * a)
            ya = 1.0 / a - p * a
            yb = 1.0 / b - p * b
        q = 0.5 * (ya + yb)
        delta = 0.5 * abs(ya - yb)
        out = self.scale(p)
        out.x0 += q
        out.terms[_fresh()] = delta
        return out

    def __pow__(self, n: int) -> "AffineForm":
        if not isinstance(n, int) or n < 0:
            raise ValueError("affine power requires non-negative int exponent")
        if n == 0:
            return AffineForm(1.0)
        if n == 1:
            return AffineForm(self.x0, dict(self.terms))
        if n == 2:
            return self._square()
        return self._square() ** (n // 2) * (self if n % 2 else AffineForm(1.0))

    def _square(self) -> "AffineForm":
        """x^2 with the tight parabola bound: keeps result non-negative-aware."""
        if not self.terms:
            return AffineForm(self.x0 * self.x0)
        r = self.radius
        x0 = self.x0
        # x^2 = x0^2 + 2*x0*X + X^2 ;  X^2 in [0, r^2] -> center r^2/2, rad r^2/2
        out = self.scale(2.0 * x0)
        out.x0 = x0 * x0 + 0.5 * r * r
        out.terms[_fresh()] = 0.5 * r * r
        return out

    # -- domain transfer functions mirroring Interval ------------------------------
    def abs(self) -> "AffineForm":
        iv = self.to_interval()
        if iv.lo >= 0:
            return self
        if iv.hi <= 0:
            return -self
        a = iv.abs()
        return AffineForm.from_interval(a.lo, a.hi)

    def min_(self, other) -> "AffineForm":
        o = AffineForm.of(other)
        iv = self.to_interval().min_(o.to_interval())
        return AffineForm.from_interval(iv.lo, iv.hi)

    def max_(self, other) -> "AffineForm":
        o = AffineForm.of(other)
        iv = self.to_interval().max_(o.to_interval())
        return AffineForm.from_interval(iv.lo, iv.hi)

    def sqrt(self) -> "AffineForm":
        iv = self.to_interval().sqrt()
        return AffineForm.from_interval(iv.lo, iv.hi)

    def join(self, other: "AffineForm") -> "AffineForm":
        """Lattice join (interval hull) — correlations across an undecided
        Select branch pair are not representable, so noise symbols reset."""
        iv = self.to_interval().join(AffineForm.of(other).to_interval())
        return AffineForm.from_interval(iv.lo, iv.hi)

    def select(self, then_v: "AffineForm", else_v: "AffineForm") -> "AffineForm":
        return then_v.join(else_v)

    def __repr__(self) -> str:
        return f"AA({self.x0:g} ± {self.radius:g}, {len(self.terms)} syms)"
