"""Attribution drift — model-BEHAVIOR drift detection over LOCO sweeps, the port of the JAX
package's ``insights/drift.py``.

The input ``DriftSentinel`` watches the INPUT distribution (per-raw-feature
fill rate + value histograms vs the training profiles). That misses a
whole failure class: the inputs can look exactly like training while the
model's *reasons* shift — a feature group that used to dominate the
prediction goes quiet (upstream pipeline silently zeroing a slice, a
vocabulary rotating out from under a hashed text plane), or a group that
was noise at fit time starts carrying the score. Attribution drift
catches that by comparing the distribution of per-group LOCO
contributions at serve time against a baseline captured at train time:

* :func:`compute_attribution_profile` — run once by ``Workflow.train()``
  over a bounded sample of training rows: per column group, a
  ``StreamingHistogram`` of signed contributions + mean |contribution|;
  persisted in the model manifest as ``attributionProfiles`` next to
  ``servingProfiles``;
* :class:`AttributionDriftMonitor` — the serving-side comparator (same
  chunked-sliding-window + Jensen-Shannon machinery as the input-drift
  sentinel, fed by every ``explain=k`` sweep): per group, the JS
  divergence of serve-time contributions vs the baseline histogram, with
  ``ok`` / ``warn`` / ``alert`` statuses. Fresh alerts emit an
  ``attribution_drift`` event, bump
  ``tptpu_attribution_drift_alerts_total``, and count on the attribution
  ledger.

Torn or corrupt baseline groups disable monitoring for that group only —
a damaged artifact must degrade observability, never scoring.
"""
from __future__ import annotations

import logging
from typing import Any

import numpy as np

from ..analysis import schedule as _schedule
from ..resilience.sentinel import (
    DriftConfig,
    _Window,
    histogram_js_divergence,
)
from ..telemetry import events as _tevents
from ..telemetry import metrics as _tm
from ..utils.streaming_histogram import StreamingHistogram, histogram_from_values
from . import ledger as _ledger
from .loco import column_groups, explain_batch

log = logging.getLogger(__name__)

__all__ = [
    "AttributionDriftMonitor",
    "compute_attribution_profile",
]


def compute_attribution_profile(
    model,
    x: np.ndarray,
    meta,
    max_rows: int = 256,
    max_bins: int = 64,
) -> dict[str, Any]:
    """Baseline per-group contribution profile from training rows.

    Runs ONE batched LOCO sweep over an evenly-spaced sample of at most
    ``max_rows`` rows (bounded cost: the profile must stay well under the
    2% train-overhead guard) and sketches each group's signed
    contribution distribution. JSON-able; rides the model manifest."""
    x = np.asarray(x, dtype=np.float32)
    total = n = x.shape[0]
    if n == 0 or x.ndim != 2 or x.shape[1] == 0:
        return {"rows": 0, "groups": {}}
    if n > max_rows:
        # deterministic evenly-spaced sample — no RNG in the train path
        idx = np.linspace(0, n - 1, max_rows).astype(np.int64)
        x = x[idx]
        n = max_rows
    from ..telemetry import spans as _tspans

    groups = column_groups(meta, x.shape[1])
    t0 = _tspans.clock()
    diffs, info = explain_batch(model, x, groups)
    _ledger.stats().record_explain(
        n, _tspans.clock() - t0, lanes=info["lanes"],
        deduped=info["deduped"], padded=info["padded"],
    )
    out_groups: dict[str, Any] = {}
    for g, (name, _) in enumerate(groups):
        col = diffs[:, g]
        out_groups[name] = {
            "count": int(n),
            "meanAbs": round(float(np.abs(col).mean()), 8),
            "histogram": histogram_from_values(col, max_bins=max_bins).to_json(),
        }
    _ledger.stats().count_profile()
    return {"rows": int(n), "sampledFrom": int(total), "groups": out_groups}


class AttributionDriftMonitor:
    """Serve-time comparator over the attribution window (one instance
    per scoring closure; thread-safe like the input-drift sentinel:
    per-group window locks, a report lock for alert bookkeeping)."""

    def __init__(
        self,
        profile: dict[str, Any] | None,
        config: DriftConfig | None = None,
    ):
        self.config = config or DriftConfig()
        self.baselines: dict[str, StreamingHistogram] = {}
        self.torn: list[str] = []
        self.rows_observed = 0
        self.alerts_total = 0
        self._alerting: set[str] = set()
        for name, prof in ((profile or {}).get("groups") or {}).items():
            try:
                self.baselines[name] = StreamingHistogram.from_json(
                    prof["histogram"]
                )
            except Exception as e:
                log.warning(
                    "attribution drift: baseline for group '%s' is torn or "
                    "corrupt (%s); monitoring disabled for it", name, e,
                )
                self.torn.append(name)
        self._windows = {
            name: _Window(self.config) for name in self.baselines
        }
        # per-group lock FAMILY: one node in the lock-order graphs
        self._window_locks = {
            name: _schedule.make_lock(
                "insights/drift.py:AttributionDriftMonitor._window_locks[]"
            )
            for name in self.baselines
        }
        self._report_lock = _schedule.make_lock(
            "insights/drift.py:AttributionDriftMonitor._report_lock"
        )

    @property
    def enabled(self) -> bool:
        return bool(self.baselines)

    def observe(self, names: list[str], diffs: np.ndarray) -> None:
        """Feed one sweep's ``[N, G]`` contribution matrix into the
        per-group sliding windows (one vectorized bulk merge per group)."""
        if not self.baselines or diffs.size == 0:
            return
        n = diffs.shape[0]
        with self._report_lock:
            self.rows_observed += n
        for g, name in enumerate(names):
            w = self._windows.get(name)
            if w is None:
                continue  # group unseen at train time: no baseline
            vals = np.asarray(diffs[:, g], dtype=np.float64)
            with self._window_locks[name]:
                w.observe_bulk(vals, n, 0)

    def report(self) -> dict[str, Any]:
        """Per-group serve-vs-train contribution JS divergence with
        ``ok``/``warn``/``alert`` statuses; fresh alerts emit the
        ``attribution_drift`` event and count everywhere they should."""
        groups: dict[str, Any] = {}
        alerts: list[str] = []
        for name, baseline in self.baselines.items():
            w = self._windows[name]
            with self._window_locks[name]:
                rows = w.rows
                hist = w.histogram()
            if rows < self.config.min_rows:
                groups[name] = {"status": "insufficient", "rows": rows}
                continue
            js = histogram_js_divergence(
                baseline, hist, self.config.compare_bins
            )
            status = "ok"
            if js > self.config.js_warn:
                status = "warn"
            if js > self.config.js_threshold:
                status = "alert"
            groups[name] = {
                "status": status,
                "rows": rows,
                "jsDivergence": round(js, 6),
            }
            if status == "alert":
                alerts.append(name)
                with self._report_lock:
                    fresh = name not in self._alerting
                    if fresh:
                        self._alerting.add(name)
                        self.alerts_total += 1
                if fresh:
                    _ledger.stats().count_drift_alert()
                    _tm.REGISTRY.counter(
                        "tptpu_attribution_drift_alerts_total"
                    ).inc()
                    _tevents.emit(
                        "attribution_drift", group=name,
                        jsDivergence=round(js, 4),
                    )
                    log.warning(
                        "attribution drift: group '%s' contribution "
                        "distribution drifted (js=%.3f) — the model's "
                        "reasons changed, check upstream features", name, js,
                    )
            else:
                with self._report_lock:
                    self._alerting.discard(name)
        with self._report_lock:
            return {
                "enabled": self.enabled,
                "rowsObserved": self.rows_observed,
                "tornGroups": list(self.torn),
                "alerts": alerts,
                "attributionDriftAlertsTotal": self.alerts_total,
                "groups": groups,
            }
