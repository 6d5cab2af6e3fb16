"""Hierarchical span tracer and typed counters (port of `repro.obs.tracer`).

Standard library only.  The analysis driver, the design search, the
executors and the SMT engine emit into it, so "where did a plan's time
go?" has an answer per pass, per stage and per island.

  * **spans** — `with span("analysis.pass", column=...) as sp:` records
    a monotonic `[t0, t1)` interval with nested parent ids (a span stack
    per thread); `sp.set(k=v)` attaches attributes mid-flight.
  * **events** — `event(name, **attrs)` is an instant marker attached
    to the current span (`rt.range` telemetry records are events).
  * **counters / gauges** — `CounterGroup` is a dict subclass with a
    lock, `add()` and `reset()`: `analysis.driver.MEMO_STATS` /
    `DISK_CACHE_STATS`, `dsl.exec.EXEC_CACHE_STATS` and
    `smt.solver.STATS` are such groups, so `STATS["hits"]`-style reads
    keep working; every group registers itself (`all_counters()`).
    `gauge(name, value)` samples a numeric time series.

Tracing is off by default and free when off: `span`, `event` and
`gauge` check one global and return a shared no-op object.  Turn it on
with `enable()` (off again with `disable()`) or for a scope with `with
tracing() as tr:`; `runtime_ranges=True` also asks the executors for
per-stage range telemetry (`obs.runtime`).  `obs.exporters` writes a
tracer as JSONL or as a Chrome trace.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "CounterGroup", "Span", "Tracer", "active_tracer", "all_counters",
    "disable", "enable", "event", "gauge", "is_enabled",
    "runtime_ranges_enabled", "span", "tracing",
]

_COUNTER_REGISTRY: Dict[str, "CounterGroup"] = {}
_REGISTRY_LOCK = threading.Lock()


class CounterGroup(dict):
    """A named group of counters: a locked, resettable dict.

    Subclassing `dict` keeps readers byte-compatible (`STATS["hits"]`,
    `dict(STATS)`); `add()` mutates under a lock, `reset()` restores
    the declared initial values, and the group registers itself so the
    exporters can snapshot every counter in the process
    (`all_counters()`).
    """

    def __init__(self, name: str, **initial):
        super().__init__(**initial)
        self.name = name
        self._initial = dict(initial)
        self._lock = threading.Lock()
        with _REGISTRY_LOCK:
            _COUNTER_REGISTRY[name] = self

    def add(self, key: str, n=1):
        """Locked increment; returns the new value."""
        with self._lock:
            v = self.get(key, 0) + n
            super().__setitem__(key, v)
            return v

    def set(self, key: str, value):
        """Locked gauge-style assignment."""
        with self._lock:
            super().__setitem__(key, value)

    def reset(self) -> None:
        """Restore the declared initial values (drop any extra keys)."""
        with self._lock:
            super().clear()
            super().update(self._initial)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self)


def all_counters() -> Dict[str, Dict[str, Any]]:
    """{group name: {counter: value}} over every registered group."""
    with _REGISTRY_LOCK:
        groups = list(_COUNTER_REGISTRY.values())
    return {g.name: g.snapshot() for g in groups}


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------
class Span:
    """One finished (or in-flight) span.  Context-manager protocol; use
    through `Tracer.span` / the module-level `span` helper."""

    __slots__ = ("tracer", "name", "attrs", "span_id", "parent_id",
                 "t0", "t1", "thread_id")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = -1
        self.parent_id: Optional[int] = None
        self.t0 = 0.0
        self.t1 = 0.0
        self.thread_id = 0

    def set(self, **attrs) -> "Span":
        """Attach/overwrite attributes (any time before export)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        tr = self.tracer
        self.span_id = next(tr._ids)
        self.thread_id = threading.get_ident()
        stack = tr._stack()
        self.parent_id = stack[-1].span_id if stack else None
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.t1 = time.perf_counter()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:                 # tolerate mis-nested exits
            stack.remove(self)
        self.tracer._record_span(self)
        return False


class _NullSpan:
    """Shared no-op stand-in when tracing is disabled (zero allocation)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def set(self, **attrs):
        return self


_NULL = _NullSpan()


class Tracer:
    """Thread-safe collector of spans, instant events and gauge samples.

    `runtime_ranges=True` opts the executors into per-stage observed-range
    / saturation / alpha-headroom telemetry (`obs.runtime`); plain
    tracing never touches pixel data.
    """

    def __init__(self, runtime_ranges: bool = False):
        self.runtime_ranges = runtime_ranges
        self.t0 = time.perf_counter()
        self.wall_t0 = time.time()
        self._ids = itertools.count(1)     # .__next__ is atomic under the GIL
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._events: List[dict] = []
        self._tls = threading.local()

    # -- collection ---------------------------------------------------------
    def _stack(self) -> List[Span]:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def _record_span(self, sp: Span) -> None:
        with self._lock:
            self._spans.append(sp)

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def current_span(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def event(self, name: str, **attrs) -> None:
        parent = self.current_span()
        rec = {"kind": "event", "name": name,
               "ts": time.perf_counter(),
               "parent": parent.span_id if parent else None,
               "thread": threading.get_ident(), "attrs": attrs}
        with self._lock:
            self._events.append(rec)

    def gauge(self, name: str, value, **attrs) -> None:
        rec = {"kind": "gauge", "name": name,
               "ts": time.perf_counter(), "value": value,
               "thread": threading.get_ident(), "attrs": attrs}
        with self._lock:
            self._events.append(rec)

    # -- queries (exporters and tests) ---------------------------------------
    def spans(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        return sorted(out, key=lambda s: (s.t0, s.span_id))

    def events(self, name: Optional[str] = None) -> List[dict]:
        with self._lock:
            out = list(self._events)
        if name is not None:
            out = [e for e in out if e["name"] == name]
        return sorted(out, key=lambda e: e["ts"])

    def us(self, t: float) -> float:
        """Monotonic seconds -> microseconds since this tracer's origin."""
        return (t - self.t0) * 1e6


# ---------------------------------------------------------------------------
# module-level active tracer (the instrumentation surface)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Tracer] = None


def enable(runtime_ranges: bool = False) -> Tracer:
    """Install (and return) a fresh process-wide tracer."""
    global _ACTIVE
    _ACTIVE = Tracer(runtime_ranges=runtime_ranges)
    return _ACTIVE


def disable() -> Optional[Tracer]:
    """Remove the active tracer; returns it (for export)."""
    global _ACTIVE
    t, _ACTIVE = _ACTIVE, None
    return t


def active_tracer() -> Optional[Tracer]:
    return _ACTIVE


def is_enabled() -> bool:
    return _ACTIVE is not None


def runtime_ranges_enabled() -> bool:
    t = _ACTIVE
    return t is not None and t.runtime_ranges


class tracing:
    """`with tracing() as tr:` — scoped enable/restore (tests, harnesses)."""

    def __init__(self, runtime_ranges: bool = False):
        self.runtime_ranges = runtime_ranges
        self._prev: Optional[Tracer] = None

    def __enter__(self) -> Tracer:
        global _ACTIVE
        self._prev = _ACTIVE
        _ACTIVE = Tracer(runtime_ranges=self.runtime_ranges)
        return _ACTIVE

    def __exit__(self, *a):
        global _ACTIVE
        _ACTIVE = self._prev
        return False


def span(name: str, **attrs):
    """Span on the active tracer, or a shared no-op when tracing is off.

    The disabled path is one global load + `is None` test — cheap enough
    for per-stage instrumentation on production hot loops.
    """
    t = _ACTIVE
    if t is None:
        return _NULL
    return t.span(name, **attrs)


def event(name: str, **attrs) -> None:
    t = _ACTIVE
    if t is not None:
        t.event(name, **attrs)


def gauge(name: str, value, **attrs) -> None:
    t = _ACTIVE
    if t is not None:
        t.gauge(name, value, **attrs)
