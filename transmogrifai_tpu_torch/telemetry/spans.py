"""Structured trace spans — low-overhead, thread-safe, Perfetto-ready.

``span("train/layer", index=3)`` is a context manager that times a region
and records it three ways:

* a **Chrome trace event** in a bounded in-process buffer (complete
  ``"ph": "X"`` events; Perfetto nests same-thread spans by time
  containment, so the exported JSON shows layer → fit/transform,
  fold → candidate, batch → stage hierarchies with no parent bookkeeping
  in the hot path);
* an **exponential-bucket duration histogram** per span name in the
  metrics registry (``tptpu_span_seconds{span="..."}``) — true
  p50/p95/p99 per stage family;
* for root ``serve/*`` spans, a compact trace in the bounded **serving
  ring buffer** (:func:`recent_serve_traces`).

The clock is injectable (:func:`set_clock`) so the telemetry suite runs on
fake time — the same seam convention the resilience components use.
Disabling (:func:`set_enabled` or ``TPTPU_TELEMETRY=0``) makes
``span`` a near-no-op.

The serving hot path records through :func:`record_serve_batch` (one call
per scored batch with pre-aggregated per-family seconds) instead of one
span per stage, so single-row scoring pays a handful of clock reads, not
dozens of span objects; per-stage detail spans engage above
``TPTPU_TRACE_STAGE_ROWS`` rows (default 16).
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable

from . import metrics as _metrics

__all__ = [
    "span",
    "record_span",
    "record_serve_batch",
    "clock",
    "set_clock",
    "get_clock",
    "enabled",
    "set_enabled",
    "stage_detail",
    "set_detail_suppressed",
    "snapshot_events",
    "recent_serve_traces",
    "configure_buffers",
    "reset_for_tests",
]


def _env_int(name: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(name, str(default))))
    except ValueError:
        return default


_LOCK = threading.Lock()
_TLS = threading.local()

#: injectable monotonic clock (rebindable plain name — no lock needed)
_CLOCK: Callable[[], float] = time.monotonic

#: mutable module state crossed by worker/warmup threads — every write
#: below holds ``_LOCK``
_STATE: dict[str, Any] = {
    "enabled": os.environ.get("TPTPU_TELEMETRY", "1") != "0",
    # raised by the serving load shedder (tier >= 1): per-stage detail
    # spans are the cheapest thing to drop under overload
    "detail_suppressed": False,
}
_EVENTS: deque = deque(maxlen=_env_int("TPTPU_TRACE_BUFFER", 65536))
_SERVE_RING: deque = deque(maxlen=_env_int("TPTPU_SERVE_TRACE_RING", 64))
_TIDS: dict[int, int] = {}

#: per-batch row floor below which scoring skips per-stage detail spans
_DETAIL_MIN_ROWS = _env_int("TPTPU_TRACE_STAGE_ROWS", 16)

_CHILD_CAP = 256  # children kept per span in the serving-ring trace tree


def clock() -> float:
    return _CLOCK()


def set_clock(fn: Callable[[], float] | None = None) -> None:
    """Swap the monotonic clock (None restores ``time.monotonic``)."""
    global _CLOCK
    _CLOCK = fn if fn is not None else time.monotonic


def get_clock() -> Callable[[], float]:
    """The currently installed clock callable (for save/restore swaps)."""
    return _CLOCK


def enabled() -> bool:
    return _STATE["enabled"]


def set_enabled(on: bool) -> None:
    with _LOCK:
        _STATE["enabled"] = bool(on)


def stage_detail(rows: int) -> bool:
    """True when scoring should emit per-stage detail spans for a batch of
    ``rows`` (large enough that span cost is noise, and the load shedder
    has not suppressed detail)."""
    return (
        _STATE["enabled"]
        and not _STATE["detail_suppressed"]
        and rows >= _DETAIL_MIN_ROWS
    )


def set_detail_suppressed(on: bool) -> None:
    """Shed/restore per-stage detail spans (serving shed tier 1 — the
    first, cheapest degradation under overload). A stale read in a scoring
    thread mid-transition costs one extra/missing detail span, never
    correctness, so the read side stays lock-free."""
    with _LOCK:
        _STATE["detail_suppressed"] = bool(on)


def _tid() -> int:
    t = threading.get_ident()
    got = _TIDS.get(t)
    if got is None:
        with _LOCK:
            got = _TIDS.setdefault(t, len(_TIDS) + 1)
    return got


def _observe(name: str, dur: float) -> None:
    reg = _metrics.REGISTRY
    reg.histogram("tptpu_span_seconds", labels={"span": name}).observe(dur)
    reg.counter("tptpu_spans_recorded_total").inc()


def _record(
    name: str,
    start: float,
    dur: float,
    attrs: dict | None,
    parent: "span | None",
    children: list | None,
    root_trace: bool,
) -> None:
    rec: dict[str, Any] = {
        "name": name, "ts": start, "dur": dur, "tid": _tid(),
    }
    if attrs:
        rec["args"] = dict(attrs)
    with _LOCK:
        _EVENTS.append(rec)
    _observe(name, dur)
    if parent is not None:
        kids = parent.children
        if kids is None:
            kids = parent.children = []
        if len(kids) < _CHILD_CAP:
            child: dict[str, Any] = {
                "name": name, "durMs": round(dur * 1e3, 3),
            }
            if children:
                child["children"] = children
            kids.append(child)
    elif root_trace and name.startswith("serve/"):
        trace = {
            "name": name,
            "durMs": round(dur * 1e3, 3),
            "attrs": dict(attrs) if attrs else {},
            "children": children or [],
        }
        with _LOCK:
            _SERVE_RING.append(trace)


class span:
    """``with span("cv/fold", fold=2): ...`` — times the block and records
    it (see module docstring). Near-free when telemetry is disabled."""

    __slots__ = ("name", "attrs", "children", "_t0")

    def __init__(self, name: str, **attrs: Any):
        self.name = name
        self.attrs = attrs
        self.children: list | None = None
        self._t0 = -1.0

    def __enter__(self) -> "span":
        if not _STATE["enabled"]:
            return self
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        stack.append(self)
        self._t0 = _CLOCK()
        return self

    def __exit__(self, *exc) -> bool:
        if self._t0 < 0.0:  # entered disabled
            return False
        dur = _CLOCK() - self._t0
        stack = getattr(_TLS, "stack", None)
        parent = None
        if stack and stack[-1] is self:
            stack.pop()
            parent = stack[-1] if stack else None
        _record(
            self.name, self._t0, dur, self.attrs, parent, self.children,
            root_trace=parent is None,
        )
        return False


def record_span(name: str, start: float, dur: float, **attrs: Any) -> None:
    """Record an already-measured interval (the scoring loop aggregates
    per-stage timings with raw clock reads, then emits spans in bulk).
    Chrome nesting still works — Perfetto nests by time containment."""
    if not _STATE["enabled"]:
        return
    _record(name, start, dur, attrs, None, None, root_trace=False)


def record_serve_batch(
    entry: str, rows: int, started: float, stage_seconds: dict[str, float]
) -> None:
    """One scored batch: total + per-stage-family latency histograms
    (``tptpu_serve_seconds{stage=...}``), a ``serve/batch`` trace span,
    throughput counters, and a compact trace in the serving ring."""
    if not _STATE["enabled"]:
        return
    total = _CLOCK() - started
    reg = _metrics.REGISTRY
    reg.histogram("tptpu_serve_seconds", labels={"stage": "total"}).observe(
        total
    )
    for fam, secs in stage_seconds.items():
        reg.histogram("tptpu_serve_seconds", labels={"stage": fam}).observe(
            secs
        )
    reg.counter("tptpu_serve_batches_total").inc()
    reg.counter("tptpu_serve_rows_total").inc(rows)
    rec = {
        "name": "serve/batch", "ts": started, "dur": total, "tid": _tid(),
        "args": {"rows": rows, "entry": entry},
    }
    trace = {
        "name": "serve/batch",
        "entry": entry,
        "rows": rows,
        "durMs": round(total * 1e3, 3),
        "stagesMs": {
            fam: round(secs * 1e3, 3) for fam, secs in stage_seconds.items()
        },
    }
    with _LOCK:
        _EVENTS.append(rec)
        _SERVE_RING.append(trace)


# ------------------------------------------------------------------ readers
def snapshot_events() -> list[dict]:
    """Copy of the buffered span records (seconds-domain ts/dur)."""
    with _LOCK:
        return list(_EVENTS)


def recent_serve_traces() -> list[dict]:
    """The bounded ring of recent serving traces, oldest first."""
    with _LOCK:
        return list(_SERVE_RING)


def configure_buffers(
    trace_buffer: int | None = None, serve_ring: int | None = None
) -> None:
    """Re-bound the in-process buffers (tests; production uses the
    ``TPTPU_TRACE_BUFFER`` / ``TPTPU_SERVE_TRACE_RING`` env knobs).
    Existing contents are kept up to the new bound."""
    global _EVENTS, _SERVE_RING
    with _LOCK:
        if trace_buffer is not None:
            _EVENTS = deque(_EVENTS, maxlen=max(1, trace_buffer))
        if serve_ring is not None:
            _SERVE_RING = deque(_SERVE_RING, maxlen=max(1, serve_ring))


def buffer_bounds() -> tuple[int, int]:
    return (_EVENTS.maxlen or 0, _SERVE_RING.maxlen or 0)


def reset_for_tests() -> None:
    """Clear buffers and the tid map; leaves enabled-state and clock."""
    with _LOCK:
        _EVENTS.clear()
        _SERVE_RING.clear()
        _TIDS.clear()
