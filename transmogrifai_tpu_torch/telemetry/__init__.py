"""Telemetry plane of the port: the serving slice's part of it.

* :mod:`telemetry.spans` — trace spans, the serving-latency histograms
  (``record_serve_batch``) and the ring of recent serving traces, on an
  injectable clock.
* :mod:`telemetry.metrics` — counters, gauges, exponential-bucket
  histograms and the registry of ledger sources. The registry belongs to
  this package's process state: a process that imports both packages has
  two registries, and neither reaches the other.
* :mod:`telemetry.events` — the structured event log (breaker
  transitions, drift alerts, fused fallbacks).
* :mod:`telemetry.runlog` — the host<->device transfer ledger only; the
  run recorder, its reports and the regression sentinel are
  ``ROADMAP.md`` A12, as is ``export`` (Prometheus and Chrome traces).
"""
from __future__ import annotations

from . import events  # noqa: F401
from . import runlog  # noqa: F401
from .metrics import (  # noqa: F401
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    LedgerCore,
    MetricsRegistry,
    exponential_buckets,
    snapshot_lock,
)
from .spans import (  # noqa: F401
    clock,
    enabled,
    record_serve_batch,
    record_span,
    recent_serve_traces,
    reset_for_tests,
    set_clock,
    set_enabled,
    span,
)

emit = events.emit
