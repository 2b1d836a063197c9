"""The lock seam of the schedule reconciler.

The subsystems that threads cross (telemetry, the serving sentinels, the
load shedder) make their locks through :func:`make_lock`, naming each one
with its canonical key (``"resilience/sentinel.py:QuarantineLog._lock"``)
as the reference does. With ``TPTPU_LOCK_TRACE`` unset (the default) it
returns the raw ``threading`` primitive: no wrapper and no cost. The
traced lock, the dynamic lock-order graph and its reconciliation against
the static analyzer are not ported yet (``ROADMAP.md`` A14), so asking
for them raises instead of handing back an untraced lock.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable

__all__ = ["make_lock", "trace_enabled"]

TRACE_ENV = "TPTPU_LOCK_TRACE"


def trace_enabled() -> bool:
    """True when ``TPTPU_LOCK_TRACE`` asks for instrumented locks (read at
    lock creation time, as the reference reads it)."""
    return os.environ.get(TRACE_ENV, "0").strip().lower() not in (
        "", "0", "false", "off",
    )


def make_lock(name: str, factory: Callable[[], Any] = threading.Lock):
    """``factory()``, the raw primitive. ``name`` is the lock's canonical
    key; it is kept for the traced lock of a later slice."""
    if trace_enabled():
        raise NotImplementedError(
            f"{TRACE_ENV} asks for a traced lock ({name}); TracedLock is not "
            "ported yet (ROADMAP.md A14)"
        )
    return factory()
