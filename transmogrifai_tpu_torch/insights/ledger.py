"""``attributionStats`` — the explainability plane's process-wide ledger.

The third stage-family ledger beside compileStats and ``featurize.stats``
(featurizeStats): one thread-safe counter object records every
record-insights event — rows explained with their wall-clock (so the
snapshot reports explain rows/s against plain scoring throughput),
perturbation-lane dispatches with their dedup/pad bookkeeping, the
vector-metadata fallbacks that anonymize column groups, and the
degradation counters (explain work shed under load, explain skipped on a
spent deadline budget, attribution-drift alerts).

Per feature group it accumulates the streaming attribution statistics
the drift monitor reads: mean |contribution|, the sign mix (how often
the group pushed the score up vs down), and top-k hit counts (how often
the group made a row's returned top-k).

In the port the explain lanes are not ported yet (``ROADMAP.md`` A10), so
nothing records an explain sweep or raises a drift alert: every counter
stays 0 unless a caller bumps it. The model registry's canary gate reads
``attributionDriftAlerts`` (``serving/registry.py``).

Counters are cumulative per process; consumers wanting a per-phase view
take ``snapshot()`` before and ``delta(before)`` after. The counter dict,
lock, and delta arithmetic come from :class:`telemetry.metrics.LedgerCore`
— the same shared re-entrant lock under the other ledgers, so a
``telemetry.snapshot_lock()`` read is consistent across all. The ledger
registers itself as the ``attribution`` source of
``telemetry.render_prometheus()``.
"""
from __future__ import annotations

import numpy as np

from ..telemetry import metrics as _tm

_COUNTER_KEYS = (
    "rowsExplained",         # rows that received LOCO attributions
    "explainBatches",        # explain sweeps executed (one per scored batch)
    "laneDispatches",        # perturbation-lane model dispatches (post-dedup,
                             # incl. bucket-pad lanes)
    "lanesDeduped",          # lanes skipped because the group slice was
                             # already all-zero for the whole batch (diff==0
                             # without a model call)
    "lanesPadded",           # inert lanes added by shape-bucket padding
    "metaFallbacks",         # vector metadata absent/mismatched: LOCO fell
                             # back to anonymous per-column groups (TPX007)
    "explainShedRows",       # rows whose explain work was shed by the load
                             # shedder (tier 1, the first casualty)
    "explainDeadlineSkips",  # explain sweeps skipped because the request's
                             # remaining budget could not cover the explain
                             # family's p95
    "explainErrors",         # sweeps that errored mid-flight (contained:
                             # scores kept, attributions degraded to None)
    "attributionDriftAlerts",  # fresh attribution-drift alerts (model-
                             # behavior drift, not input drift)
    "profilesCaptured",      # train-time baseline attribution profiles
    "explainBudgetSkips",    # fused-graph explain sweeps skipped because
                             # lanes x rows x width exceeded the lane
                             # budget for a single dispatch (scores kept)
)


class AttributionStats(_tm.LedgerCore):
    """Thread-safe counters; explain wall-clock seconds and per-group
    streaming statistics ride along."""

    def __init__(self) -> None:
        super().__init__(_COUNTER_KEYS)
        self._explain_s = 0.0
        #: group name -> [rows, sum|c|, positive, negative, topKHits]
        self._groups: dict[str, list[float]] = {}

    # ------------------------------------------------------------ recording
    def record_explain(
        self,
        rows: int,
        seconds: float,
        lanes: int,
        deduped: int = 0,
        padded: int = 0,
    ) -> None:
        """One explain sweep: ``rows`` rows × ``lanes`` dispatched lanes
        in ``seconds`` (``deduped`` lanes skipped, ``padded`` inert)."""
        with self._lock:
            self._counts["rowsExplained"] += rows
            self._counts["explainBatches"] += 1
            self._counts["laneDispatches"] += lanes
            self._counts["lanesDeduped"] += deduped
            self._counts["lanesPadded"] += padded
            self._explain_s += seconds

    def record_groups(
        self,
        names: list[str],
        diffs: np.ndarray,
        topk_counts: np.ndarray | None = None,
    ) -> None:
        """Streaming per-group statistics from one sweep's ``[N, G]``
        contribution matrix (``topk_counts[g]`` = rows where group ``g``
        made the returned top-k)."""
        if diffs.size == 0:
            return
        n = diffs.shape[0]
        sum_abs = np.abs(diffs).sum(axis=0)
        pos = (diffs > 0).sum(axis=0)
        neg = (diffs < 0).sum(axis=0)
        with self._lock:
            for g, name in enumerate(names):
                cell = self._groups.setdefault(name, [0.0] * 5)
                cell[0] += n
                cell[1] += float(sum_abs[g])
                cell[2] += int(pos[g])
                cell[3] += int(neg[g])
                if topk_counts is not None:
                    cell[4] += int(topk_counts[g])

    def count_meta_fallback(self) -> None:
        self.bump("metaFallbacks")

    def count_shed(self, rows: int) -> None:
        self.bump("explainShedRows", rows)

    def count_deadline_skip(self) -> None:
        self.bump("explainDeadlineSkips")

    def count_budget_skip(self) -> None:
        self.bump("explainBudgetSkips")

    def count_error(self) -> None:
        self.bump("explainErrors")

    def count_drift_alert(self) -> None:
        self.bump("attributionDriftAlerts")

    def count_profile(self) -> None:
        self.bump("profilesCaptured")

    # ------------------------------------------------------------ reporting
    def snapshot(self) -> dict:
        """JSON-able view. ``explainRowsPerSec`` is rows over sweep
        seconds; ``groups`` reports the streaming per-group statistics
        (mean |contribution|, sign mix, top-k hit counts)."""
        with self._lock:
            out: dict = dict(self._counts)
            out["explainSeconds"] = round(self._explain_s, 4)
            groups = {
                name: _group_cell(cell)
                for name, cell in sorted(self._groups.items())
            }
        out["explainRowsPerSec"] = (
            round(out["rowsExplained"] / out["explainSeconds"])
            if out["explainSeconds"] > 0 else None
        )
        out["groups"] = groups
        return out

    def reset(self) -> None:
        with self._lock:
            self._reset_counts()
            self._explain_s = 0.0
            self._groups = {}


def _group_cell(cell: list[float]) -> dict:
    rows = int(cell[0])
    signed = cell[2] + cell[3]
    return {
        "rows": rows,
        "meanAbsContribution": (
            round(cell[1] / rows, 6) if rows else None
        ),
        "positive": int(cell[2]),
        "negative": int(cell[3]),
        "positiveFraction": _tm.ratio(cell[2], signed),
        "topKHits": int(cell[4]),
    }


_STATS = AttributionStats()
_tm.REGISTRY.register_source("attribution", _STATS.snapshot)


def stats() -> AttributionStats:
    return _STATS


def snapshot() -> dict:
    return _STATS.snapshot()


def delta(before: dict) -> dict:
    """Per-phase view: current snapshot minus an earlier ``snapshot()``
    (rates recomputed from the deltas, not differenced)."""
    now = _STATS.snapshot()
    out: dict = _tm.counter_delta(now, before, _COUNTER_KEYS)
    out["explainSeconds"] = _tm.float_delta(
        now, before, "explainSeconds", ndigits=4
    )
    out["explainRowsPerSec"] = (
        round(out["rowsExplained"] / out["explainSeconds"])
        if out["explainSeconds"] > 0 else None
    )
    before_groups = before.get("groups", {})
    groups = {}
    for name, cell in now["groups"].items():
        prev = before_groups.get(name, {})
        rows = cell["rows"] - prev.get("rows", 0)
        if rows:
            groups[name] = {
                "rows": rows,
                "topKHits": cell["topKHits"] - prev.get("topKHits", 0),
            }
    out["groups"] = groups
    return out
