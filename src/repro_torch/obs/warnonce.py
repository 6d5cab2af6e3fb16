"""Process-once warning dedupe (port of `repro.obs.warnonce`).

A notice that an entry point can raise on every call (the plan disk
cache skipping a process-local pass) routes through `warn_once`, which
emits each distinct message text once per process, thread-safe.

Tests that expect a specific warning call `reset_warn_once()` first:
the registry lives for the whole process, and test workers run many
tests in one process.
"""
from __future__ import annotations

import threading
import warnings

__all__ = ["warn_once", "reset_warn_once"]

_WARNED: set = set()
_LOCK = threading.Lock()


def warn_once(msg: str) -> bool:
    """Emit `msg` as a `RuntimeWarning` the first time it is seen; no-op
    after.

    Returns True when the warning was emitted (first sighting).
    """
    with _LOCK:
        if msg in _WARNED:
            return False
        _WARNED.add(msg)
    warnings.warn(msg, RuntimeWarning, stacklevel=3)
    return True


def reset_warn_once() -> None:
    """Forget every deduped message (test isolation hook)."""
    with _LOCK:
        _WARNED.clear()
