"""Structured JSONL event log — the ops-facing record of rare, important
state changes.

Every :func:`emit` produces one JSON-able record with a process-unique,
strictly monotonic ``seq`` (assigned under the log lock, so the JSONL
ordering is the ordering even when emitters race across threads), the
injectable-monotonic timestamp, a wall-clock timestamp for correlation
with external logs, and the emitter's fields.

Wired event kinds:

* ``breaker_transition`` — resilience/sentinel.py circuit breakers
* ``drift_alert`` / ``drift_cleared`` — resilience/sentinel.py drift
  sentinel (one ``drift_alert`` per episode; the paired
  ``drift_cleared`` fires when that feature's window returns under
  threshold, so "still drifting" and "recovered on its own" are
  distinguishable downstream)
* ``fused_fallback`` — local/scoring.py, a fused batch that went staged
* ``deadline_exceeded`` — serving/deadline.py checkpoints
* ``load_shed`` — serving/shedding.py tier transitions

The log is a bounded in-memory deque (``TPTPU_EVENT_BUFFER``, default
4096) exportable as JSONL (:func:`to_jsonl` / :func:`write`); set
``TPTPU_EVENT_LOG=/path/file.jsonl`` to also append each record to disk
as it is emitted.

In-process consumers can :func:`subscribe` a callback; subscribers are
invoked AFTER the log lock is released (an event subscriber may take
its own leaf lock, but no lock-graph edge ever leaves the events lock).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any

from . import spans as _spans
from .spans import _env_int

__all__ = [
    "emit",
    "recent",
    "count",
    "to_jsonl",
    "write",
    "subscribe",
    "unsubscribe",
    "reset_for_tests",
]

_LOCK = threading.Lock()
_BUFFER: deque = deque(maxlen=_env_int("TPTPU_EVENT_BUFFER", 4096))
_STATE: dict[str, int] = {"seq": 0}
# registered under _LOCK, SNAPSHOT under _LOCK, but always INVOKED after
# the lock is released — a subscriber that takes its own lock therefore
# never creates an edge out of the events lock
_SUBSCRIBERS: list = []


def emit(kind: str, **fields: Any) -> dict[str, Any]:
    """Append one event; returns the record (with its assigned seq).

    Honors the telemetry disable switch: when ``spans.enabled()`` is
    False the record is built and returned (seq 0) but neither buffered
    nor appended to ``TPTPU_EVENT_LOG``."""
    rec: dict[str, Any] = {
        "seq": 0,
        "ts": round(_spans.clock(), 6),
        "unix": round(time.time(), 3),
        "kind": kind,
    }
    rec.update(fields)
    if not _spans.enabled():
        return rec
    path = os.environ.get("TPTPU_EVENT_LOG")
    with _LOCK:
        _STATE["seq"] += 1
        rec["seq"] = _STATE["seq"]
        _BUFFER.append(rec)
        if path:
            # inside the lock so on-disk ordering matches seq ordering;
            # events are rare (failovers, breaker trips), so the open
            # cost is irrelevant
            try:
                with open(path, "a", encoding="utf-8") as f:
                    f.write(json.dumps(rec, default=str) + "\n")
            except OSError:
                pass  # a full disk must not take scoring down
        subs = list(_SUBSCRIBERS)
    for fn in subs:
        try:
            fn(rec)
        except Exception:
            pass  # a broken subscriber must not take the emitter down
    return rec


def subscribe(fn) -> None:
    """Register ``fn(record)`` to be called for every emitted event.

    Callbacks run on the emitting thread, after the log lock is
    released, in registration order; exceptions are swallowed. Keep
    subscribers cheap — record-and-return, decide later."""
    with _LOCK:
        if fn not in _SUBSCRIBERS:
            _SUBSCRIBERS.append(fn)


def unsubscribe(fn) -> None:
    with _LOCK:
        try:
            _SUBSCRIBERS.remove(fn)
        except ValueError:
            pass


def recent(n: int | None = None) -> list[dict[str, Any]]:
    with _LOCK:
        out = list(_BUFFER)
    return out if n is None else out[-n:]


def count() -> int:
    """Total events emitted this process (monotonic, survives buffer
    eviction)."""
    return _STATE["seq"]


def to_jsonl() -> str:
    return "\n".join(json.dumps(r, default=str) for r in recent())


def write(path: str) -> int:
    """Dump the buffered events as JSONL; returns the record count."""
    recs = recent()
    with open(path, "w", encoding="utf-8") as f:
        for r in recs:
            f.write(json.dumps(r, default=str) + "\n")
    return len(recs)


def reset_for_tests() -> None:
    with _LOCK:
        _BUFFER.clear()
        _STATE["seq"] = 0
        _SUBSCRIBERS.clear()
