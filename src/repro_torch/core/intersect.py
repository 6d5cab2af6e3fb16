"""Intersection (reduced-product) domain: interval ∩ affine.

The paper observes (§VI) that affine arithmetic gave no better ranges than
interval arithmetic on its benchmarks.  The reason is visible in the USM
analysis: affine's multiplication introduces a rad*rad linearization term
that can *widen* results past interval arithmetic, even while its
cancellation handling is tighter on linear subexpressions.

Both domains are sound, so their **intersection** is sound and at least as
tight as either — the classic reduced product.  This domain runs both in
lockstep and intersects ranges at every step, giving the best static bound
the framework can produce without profiling.  Registered as "intersect" in
the pluggable-domain registry (paper §IV-C: adding a domain = one class).

The port's own copy of `repro.core.intersect`.
"""
from __future__ import annotations

from repro_torch.core.absval import register_domain
from repro_torch.core.affine import AffineForm
from repro_torch.core.interval import Interval


def _meet(a: Interval, b: Interval) -> Interval:
    """Sound intersection (both are over-approximations of the truth)."""
    lo = max(a.lo, b.lo)
    hi = min(a.hi, b.hi)
    if lo > hi:        # numerical round-off between the two domains
        return a if a.width <= b.width else b
    return Interval(lo, hi)


class IAValue:
    """Paired (interval, affine) value evaluated in lockstep."""

    __slots__ = ("iv", "af")

    def __init__(self, iv: Interval, af: AffineForm):
        self.iv = iv
        self.af = af

    @staticmethod
    def of(v) -> "IAValue":
        if isinstance(v, IAValue):
            return v
        return IAValue(Interval.point(float(v)), AffineForm.point(float(v)))

    def range(self) -> Interval:
        return _meet(self.iv, self.af.to_interval())

    def _wrap(self, iv: Interval, af: AffineForm) -> "IAValue":
        # reduce: clamp the interval component by the affine hull and keep
        # the affine form intact (its correlations are its value)
        return IAValue(_meet(iv, af.to_interval()), af)

    # -- arithmetic -----------------------------------------------------------
    def __add__(self, o):
        o = IAValue.of(o)
        return self._wrap(self.iv + o.iv, self.af + o.af)

    __radd__ = __add__

    def __sub__(self, o):
        o = IAValue.of(o)
        return self._wrap(self.iv - o.iv, self.af - o.af)

    def __rsub__(self, o):
        return IAValue.of(o) - self

    def __mul__(self, o):
        o = IAValue.of(o)
        return self._wrap(self.iv * o.iv, self.af * o.af)

    __rmul__ = __mul__

    def __truediv__(self, o):
        o = IAValue.of(o)
        return self._wrap(self.iv / o.iv, self.af / o.af)

    def __rtruediv__(self, o):
        return IAValue.of(o) / self

    def __pow__(self, n: int):
        return self._wrap(self.iv ** n, self.af ** n)

    def __neg__(self):
        return self._wrap(-self.iv, -self.af)

    # -- transfer functions -------------------------------------------------------
    def abs(self):
        return self._wrap(self.iv.abs(), self.af.abs())

    def sqrt(self):
        return self._wrap(self.iv.sqrt(), self.af.sqrt())

    def min_(self, o):
        o = IAValue.of(o)
        return self._wrap(self.iv.min_(o.iv), self.af.min_(o.af))

    def max_(self, o):
        o = IAValue.of(o)
        return self._wrap(self.iv.max_(o.iv), self.af.max_(o.af))

    def join(self, other) -> "IAValue":
        o = IAValue.of(other)
        return self._wrap(self.iv.join(o.iv), self.af.join(o.af))

    def select(self, t, e):
        return IAValue.of(t).join(e)

    def __repr__(self):
        return f"IA({self.range()!r})"


class IntersectDomain:
    name = "intersect"

    def const(self, v: float) -> IAValue:
        return IAValue.of(v)

    def fresh_signal(self, rng: Interval) -> IAValue:
        return IAValue(rng, AffineForm.from_interval(rng.lo, rng.hi))

    def to_interval(self, v: IAValue) -> Interval:
        return v.range()


register_domain("intersect", IntersectDomain)
