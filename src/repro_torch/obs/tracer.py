"""Hierarchical span tracer and typed counters (port of `repro.obs.tracer`).

Standard library only.  `analysis.driver.run_plan` emits into it, so "where
did a plan's time go?" has an answer per pass.

  * **spans** — `with span("analysis.pass", column=...) as sp:` records
    a monotonic `[t0, t1)` interval with nested parent ids (a span stack
    per thread); `sp.set(k=v)` attaches attributes mid-flight.
  * **events** — `event(name, **attrs)` is an instant marker attached
    to the current span.
  * **counters** — `CounterGroup` is a dict subclass with a lock,
    `add()` and `reset()`: `analysis.driver.MEMO_STATS` /
    `DISK_CACHE_STATS` and `dsl.exec.EXEC_CACHE_STATS` are such groups,
    so `STATS["hits"]`-style reads keep working.

Tracing is off by default and free when off: `span` and `event` check
one global and return a shared no-op object.  `with tracing() as tr:`
turns it on for a scope.  The exporters, the per-stage runtime
telemetry and the report of `repro.obs` are not ported yet.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["CounterGroup", "Span", "Tracer", "event", "span", "tracing"]


class CounterGroup(dict):
    """A named group of counters: a locked, resettable dict.

    Subclassing `dict` keeps readers byte-compatible (`STATS["hits"]`,
    `dict(STATS)`); `add()` mutates under a lock and `reset()` restores
    the declared initial values.
    """

    def __init__(self, name: str, **initial):
        super().__init__(**initial)
        self.name = name
        self._initial = dict(initial)
        self._lock = threading.Lock()

    def add(self, key: str, n=1):
        """Locked increment; returns the new value."""
        with self._lock:
            v = self.get(key, 0) + n
            super().__setitem__(key, v)
            return v

    def reset(self) -> None:
        """Restore the declared initial values (drop any extra keys)."""
        with self._lock:
            super().clear()
            super().update(self._initial)


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
    """Thread-safe collector of spans and instant events."""

    def __init__(self):
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

    # -- queries -------------------------------------------------------------
    def spans(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        return sorted(out, key=lambda s: (s.t0, s.span_id))

    def events(self) -> List[dict]:
        with self._lock:
            out = list(self._events)
        return sorted(out, key=lambda e: e["ts"])


# ---------------------------------------------------------------------------
# module-level active tracer (the instrumentation surface)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Tracer] = None


class tracing:
    """`with tracing() as tr:` — scoped enable/restore (tests, harnesses)."""

    def __init__(self):
        self._prev: Optional[Tracer] = None

    def __enter__(self) -> Tracer:
        global _ACTIVE
        self._prev = _ACTIVE
        _ACTIVE = Tracer()
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
