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
* :mod:`telemetry.export` — ``render_prometheus()``, the text exposition
  of the registry and every ledger source (the scoring closures', the
  serving services' and fleets'), and the serve-latency snapshots.
* :mod:`telemetry.runlog` — the host<->device transfer ledger and the
  cross-run ``diff_runs`` / ``RegressionSentinel`` verdicts (the model
  registry's canary gate). The run recorder and its reports are
  ``ROADMAP.md`` A12, as are the Chrome trace export, the phase breakdown
  and the summary line.
"""
from __future__ import annotations

from . import events  # noqa: F401
from . import runlog  # noqa: F401
from .export import (  # noqa: F401
    metrics_snapshot,
    render_prometheus,
    serve_latency_summary,
    serving_snapshot,
)
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
