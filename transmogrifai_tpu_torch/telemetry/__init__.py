"""Telemetry plane of the port.

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
  serving services' and fleets', the run ledger's and the retrain
  loop's), the serve-latency snapshots, ``export_chrome_trace()``,
  ``phase_breakdown()`` and ``summary_line()``.
* :mod:`telemetry.runlog` — the run recorder every ``train()`` installs,
  its RUN reports and their files, the host<->device transfer ledger and
  the cross-run ``diff_runs`` / ``RegressionSentinel`` verdicts (the
  model registry's canary gate). The compile plane's blocks of a report
  wait for ``ROADMAP.md`` A14.
"""
from __future__ import annotations

from . import events  # noqa: F401
from . import runlog  # noqa: F401
from .export import (  # noqa: F401
    export_chrome_trace,
    metrics_snapshot,
    phase_breakdown,
    render_prometheus,
    serve_latency_summary,
    serving_snapshot,
    summary_line,
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
