"""Export surfaces: the Prometheus text exposition and the serving
snapshots.

``render_prometheus()`` walks the registry's own metrics (span/serve
latency histograms, throughput counters) plus every registered ledger
source (featurizeStats, the transfer census, the attribution ledger, the
live scoring closures' health counters, the live serving services and
fleets) and renders the standard text exposition — scrapeable as-is by a
Prometheus agent.

``export_chrome_trace()`` writes the buffered spans as a Chrome
trace-event document (Perfetto, chrome://tracing); ``phase_breakdown()``
attributes the leaf spans' seconds to the bench phases (ingest,
featurize, compile, fit, eval, explain); ``summary_line()`` is the one
telemetry line of ``summary_pretty()``.

``serve_latency_summary()`` / ``serving_snapshot()`` summarize the
serve-latency histograms; ``metrics_snapshot()`` is the JSON view of the
registry and its sources, the run ledger (``run``) and the retrain loop's
(``retrain``) among them.

Not ported yet: the compile plane's ``compile`` source (``ROADMAP.md``
A14) and the ``resilience`` source of distributed resilience (A13b) are
absent from the exposition.
"""
from __future__ import annotations

import json
import re
from typing import Any

from . import events as _events
from . import metrics as _metrics
from . import spans as _spans

__all__ = [
    "render_prometheus",
    "export_chrome_trace",
    "phase_breakdown",
    "serve_latency_summary",
    "serving_snapshot",
    "metrics_snapshot",
    "summary_line",
]


def _ensure_default_sources() -> None:
    """Importing the ledger modules registers them as sources — lazily, so
    a fresh CLI process exposes the full catalogue (at zero) without this
    module importing them at package-import time."""
    from ..featurize import stats as _fstats  # noqa: F401
    from ..insights import ledger as _attr  # noqa: F401
    from ..local import scoring as _scoring  # noqa: F401
    from ..resilience import retrain as _retrain  # noqa: F401
    from . import runlog as _runlog  # noqa: F401


_SNAKE_RE = re.compile(r"(?<=[a-z0-9])([A-Z])")


def _snake(key: str) -> str:
    return _SNAKE_RE.sub(r"_\1", key).lower()


def _escape(v: Any) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", " ")


def _labels_str(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _fmt(v: float) -> str:
    if isinstance(v, int):
        return str(v)
    return format(v, ".10g")


def _render_source(src: str, mapping: dict, lines: list[str]) -> None:
    """Flatten one ledger snapshot: numeric leaves become gauges named
    ``tptpu_{src}_{snake(key)}``; ``{name: num}`` maps become labeled
    samples; ``{name: {field: num}}`` maps one labeled sample per numeric
    field. Lists / strings / None are skipped (not counters)."""
    for key in sorted(mapping):
        val = mapping[key]
        base = f"tptpu_{src}_{_snake(key)}"
        if _num(val):
            lines.append(f"# TYPE {base} gauge")
            lines.append(f"{base} {_fmt(val)}")
        elif isinstance(val, dict):
            samples: list[str] = []
            for name in sorted(val):
                inner = val[name]
                lbl = _labels_str({"name": name})
                if _num(inner):
                    samples.append(f"{base}{lbl} {_fmt(inner)}")
                elif isinstance(inner, dict):
                    for field in sorted(inner):
                        v2 = inner[field]
                        if _num(v2):
                            samples.append(
                                f"{base}_{_snake(field)}{lbl} {_fmt(v2)}"
                            )
            if samples:
                lines.append(f"# TYPE {base} gauge")
                lines.extend(samples)


def render_prometheus(
    registry: _metrics.MetricsRegistry | None = None,
    default_sources: bool = True,
) -> str:
    """Prometheus text exposition of the whole telemetry plane (see
    module docstring). Deterministically ordered, trailing newline."""
    if registry is None:
        registry = _metrics.REGISTRY
        if default_sources:
            _ensure_default_sources()
    lines: list[str] = []
    with registry.lock:
        snap_counters = dict(registry._counters)
        snap_gauges = dict(registry._gauges)
        histograms = list(registry._histograms.values())
    # sources MUST run after the lock releases: the lock is re-entrant, so
    # calling source_snapshots() inside the block silently runs the source
    # callables with the registry lock held — an ABBA deadlock against any
    # thread holding its subsystem lock while touching a gauge/counter
    # (e.g. ScoringService.submit -> queue gauge vs. the service source ->
    # ScoringService.stats).
    sources = registry.source_snapshots()
    for name in sorted(snap_counters):
        c = snap_counters[name]
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {_fmt(c.value)}")
    for name in sorted(snap_gauges):
        g = snap_gauges[name]
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_fmt(g.value)}")
    by_name: dict[str, list] = {}
    for h in histograms:
        by_name.setdefault(h.name, []).append(h)
    for name in sorted(by_name):
        lines.append(f"# TYPE {name} histogram")
        for h in sorted(
            by_name[name], key=lambda h: tuple(sorted(h.labels.items()))
        ):
            cum, count, total = h.bucket_counts()
            for bound, c in zip(h.bounds, cum):
                lbl = _labels_str({**h.labels, "le": format(bound, ".6g")})
                lines.append(f"{name}_bucket{lbl} {c}")
            lbl = _labels_str({**h.labels, "le": "+Inf"})
            lines.append(f"{name}_bucket{lbl} {cum[-1]}")
            plain = _labels_str(h.labels)
            lines.append(f"{name}_sum{plain} {_fmt(float(total))}")
            lines.append(f"{name}_count{plain} {count}")
    for src in sorted(sources):
        _render_source(src, sources[src], lines)
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------- chrome trace
def export_chrome_trace(path: str | None = None) -> dict[str, Any]:
    """The buffered spans as a Chrome trace-event document; written to
    ``path`` when given. Open in Perfetto (ui.perfetto.dev) or
    chrome://tracing."""
    events = []
    for rec in _spans.snapshot_events():
        ev: dict[str, Any] = {
            "name": rec["name"],
            "cat": rec["name"].split("/", 1)[0],
            "ph": "X",
            "pid": 1,
            "tid": rec["tid"],
            "ts": round(rec["ts"] * 1e6, 3),
            "dur": round(rec["dur"] * 1e6, 3),
        }
        if rec.get("args"):
            ev["args"] = rec["args"]
        events.append(ev)
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, default=str)
    return doc


# ------------------------------------------------------------ phase breakdown
#: leaf span name (prefix) -> bench phase; nested parents (train/layer,
#: cv/fold, selector sweeps) are deliberately absent so time is counted once
_PHASE_PREFIXES = (
    ("train/ingest", "ingest"),
    ("train/transform", "featurize"),
    ("compile/", "compile"),
    ("train/fit", "fit"),
    ("train/eval", "eval"),
    # the explainability plane: train-time baseline sweeps + serve-time
    # explain=k sweeps both attribute to one "explain" phase
    ("train/attribution", "explain"),
    ("serve/explain", "explain"),
)


def phase_breakdown() -> dict[str, float]:
    """Span-derived seconds per bench phase (see module docstring)."""
    out = {phase: 0.0 for _, phase in _PHASE_PREFIXES}
    for rec in _spans.snapshot_events():
        name = rec["name"]
        for prefix, phase in _PHASE_PREFIXES:
            if name.startswith(prefix):
                out[phase] += rec["dur"]
                break
    return {phase: round(secs, 3) for phase, secs in out.items()}


# ------------------------------------------------------------------ summaries
def serve_latency_summary() -> dict[str, dict[str, Any]]:
    """Per-stage-family serving latency: count + p50/p95/p99 milliseconds
    from the ``tptpu_serve_seconds`` histograms."""
    out: dict[str, dict[str, Any]] = {}
    for h in _metrics.REGISTRY.histograms_named("tptpu_serve_seconds"):
        snap = h.snapshot()
        out[h.labels.get("stage", "total")] = {
            "count": snap["count"],
            "p50Ms": None if snap["p50"] is None else round(snap["p50"] * 1e3, 3),
            "p95Ms": None if snap["p95"] is None else round(snap["p95"] * 1e3, 3),
            "p99Ms": None if snap["p99"] is None else round(snap["p99"] * 1e3, 3),
        }
    return out


def serving_snapshot() -> dict[str, Any]:
    """The ``score_fn.metadata()["telemetry"]`` payload."""
    reg = _metrics.REGISTRY
    return {
        "serveLatencyMs": serve_latency_summary(),
        "spansRecorded": reg.counter("tptpu_spans_recorded_total").value,
        "serveBatches": reg.counter("tptpu_serve_batches_total").value,
        "serveRows": reg.counter("tptpu_serve_rows_total").value,
        "eventsEmitted": _events.count(),
        "recentTraces": len(_spans.recent_serve_traces()),
    }


def metrics_snapshot() -> dict[str, Any]:
    """JSON snapshot of the registry + sources (the CLI ``--json`` view)."""
    _ensure_default_sources()
    return _metrics.REGISTRY.snapshot_all()


def summary_line() -> str | None:
    """One consolidated line for ``summary_pretty()`` — None when the
    process recorded nothing."""
    reg = _metrics.REGISTRY
    spans_n = reg.counter("tptpu_spans_recorded_total").value
    events_n = _events.count()
    if not spans_n and not events_n:
        return None
    names = len(reg.histograms_named("tptpu_span_seconds"))
    line = (
        f"Telemetry: {spans_n} span(s) across {names} name(s), "
        f"{events_n} event(s)"
    )
    total = serve_latency_summary().get("total")
    if total and total["count"]:
        line += (
            f"; serve p50/p95/p99 {total['p50Ms']}/{total['p95Ms']}/"
            f"{total['p99Ms']} ms over {total['count']} batch(es)"
        )
    return line
