"""Pluggable abstract-value framework — paper §IV-C.

The paper's generated HLS C++ is polymorphic in a single type parameter
`typ`; switching it between `float`, `ap_fixed`, an interval type, or
YalAA's affine type re-purposes the same program as a simulator or an
analyzer.  Here the same role is played by a *domain adapter*: the
expression evaluator is written once against this protocol, and any
analysis (interval, affine, or future domains) plugs in via the registry.

The port's own copy of `repro.core.absval`.  The SMT domains are not
ported yet, so the lazy map names ``"intersect"`` only.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Protocol

from repro_torch.core.affine import AffineForm
from repro_torch.core.interval import Interval


class Domain(Protocol):
    """What an abstract domain must provide to the shared evaluator."""

    name: str

    def const(self, v: float) -> Any: ...
    def fresh_signal(self, rng: Interval) -> Any:
        """Abstract value for one homogeneous signal with known range.

        Called once per Ref *occurrence* during combined per-stage analysis:
        interval returns the range itself; affine mints a fresh noise symbol
        (stencil taps read distinct pixels, hence independent signals).
        """
        ...
    def to_interval(self, v: Any) -> Interval: ...


class IntervalDomain:
    name = "interval"

    def const(self, v: float) -> Interval:
        return Interval.point(v)

    def fresh_signal(self, rng: Interval) -> Interval:
        return rng

    def to_interval(self, v: Interval) -> Interval:
        return v


class AffineDomain:
    name = "affine"

    def const(self, v: float) -> AffineForm:
        return AffineForm.point(v)

    def fresh_signal(self, rng: Interval) -> AffineForm:
        return AffineForm.from_interval(rng.lo, rng.hi)

    def to_interval(self, v: AffineForm) -> Interval:
        return v.to_interval()


_REGISTRY: Dict[str, Callable[[], Domain]] = {
    "interval": IntervalDomain,
    "affine": AffineDomain,
}

# Domains living in modules that register themselves on import; resolved on
# first use so core stays import-light and cycle-free.
_LAZY_MODULES: Dict[str, str] = {
    "intersect": "repro_torch.core.intersect",
}


def register_domain(name: str, factory: Callable[[], Domain]) -> None:
    _REGISTRY[name] = factory


def get_domain(name: str) -> Domain:
    if name not in _REGISTRY and name in _LAZY_MODULES:
        import importlib
        importlib.import_module(_LAZY_MODULES[name])
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(
            f"unknown analysis domain {name!r}; registered: "
            f"{sorted(set(_REGISTRY) | set(_LAZY_MODULES))}") from None
