"""Score-time graceful degradation: NaN/Inf guards with per-stage fallback.

A serving path must not crash (or silently emit NaN) because one stage's
arithmetic went non-finite on a weird row. ``ScoreGuard`` inspects each
stage's output column in ``local/scoring.py``: rows holding NaN/Inf are
either replaced with a deterministic default (prediction 0 with uniform
probabilities; 0.0 on numeric/vector planes) or escalated, per stage. Every
degraded row is counted in ``counts`` and surfaced in the score function's
metadata so operators see degradation instead of discovering it in
downstream metrics.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
from collections import Counter
from typing import Any

import numpy as np

log = logging.getLogger(__name__)

#: fallback modes
MODE_DEFAULT = "default"   # replace bad rows with a default value, count them
MODE_RAISE = "raise"       # escalate: non-finite output is an error
MODE_OFF = "off"           # pass through untouched


class ScoreGuardError(ValueError):
    """A guarded stage produced non-finite output under mode='raise'."""


class ScoreGuard:
    """Configurable NaN/Inf containment for the scoring plan.

    ``fallback`` is the default mode; ``per_stage`` overrides it for
    individual stages keyed by uid, class name, operation name, or output
    column name. ``scope`` limits where the default applies: ``"results"``
    (the default) guards only result-feature outputs — intermediate columns
    flow through untouched so local scoring stays numerically identical to
    batch ``WorkflowModel.score`` — while ``"all"`` guards every stage.
    A per-stage override always applies regardless of scope."""

    def __init__(
        self,
        fallback: str = MODE_DEFAULT,
        per_stage: dict[str, str] | None = None,
        scope: str = "results",
    ):
        if fallback not in (MODE_DEFAULT, MODE_RAISE, MODE_OFF):
            raise ValueError(f"unknown fallback mode {fallback!r}")
        if scope not in ("results", "all"):
            raise ValueError(f"unknown scope {scope!r}")
        self.fallback = fallback
        self.per_stage = dict(per_stage or {})
        self.scope = scope
        self._lock = threading.Lock()
        #: stage output name -> number of degraded rows (mutated under the
        #: instance lock — concurrent service workers share one guard)
        self.counts: Counter[str] = Counter()

    def mode_for(self, stage: Any, is_result: bool = True) -> str:
        for key in (
            stage.uid, type(stage).__name__,
            getattr(stage, "operation_name", None), stage.output_name,
        ):
            if key is not None and key in self.per_stage:
                return self.per_stage[key]
        if self.scope == "results" and not is_result:
            return MODE_OFF
        return self.fallback

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "fallback": self.fallback,
                "guardedRows": int(sum(self.counts.values())),
                "byStage": dict(self.counts),
            }

    def apply(
        self,
        stage: Any,
        column: Any,
        is_result: bool = True,
        num_rows: int | None = None,
        count: bool = True,
    ) -> Any:
        """Return ``column`` (possibly sanitized); raises under 'raise'.
        ``num_rows`` bounds the rows that COUNT: scoring pads batches to
        power-of-two buckets by replicating row 0, and those replicas must
        not inflate the degradation counters or error messages (the whole
        column is still sanitized — padding is sliced off by the caller).
        ``count=False`` sanitizes without counting or logging — the
        per-row isolation re-runs re-execute stages whose degradation the
        primary run already counted."""
        mode = self.mode_for(stage, is_result=is_result)
        if mode == MODE_OFF:
            return column
        sanitized, bad = _sanitize(column)
        if bad is None or not bad.any():
            return column
        limit = len(bad) if num_rows is None else min(num_rows, len(bad))
        n_bad = int(bad[:limit].sum())
        if n_bad == 0:
            return sanitized  # only padded replicas were bad
        if mode == MODE_RAISE:
            raise ScoreGuardError(
                f"stage {type(stage).__name__}({stage.uid}) produced "
                f"non-finite values in {n_bad} row(s) of "
                f"'{stage.output_name}'"
            )
        if count:
            with self._lock:
                self.counts[stage.output_name] += n_bad
            log.warning(
                "score guard: %d non-finite row(s) in '%s' replaced with "
                "defaults", n_bad, stage.output_name,
            )
        return sanitized


def _sanitize(column: Any) -> tuple[Any, Any]:
    """(sanitized column, per-row bad mask — None when the column has no
    float plane to check: text, maps, sparse vectors)."""
    from ..types.columns import NumericColumn, PredictionColumn, VectorColumn

    if isinstance(column, NumericColumn):
        if not np.issubdtype(column.values.dtype, np.floating):
            return column, None
        bad = ~np.isfinite(column.values) & np.asarray(column.mask, bool)
        if not bad.any():
            return column, bad
        vals = np.where(bad, 0.0, column.values)
        return dataclasses.replace(column, values=vals), bad
    if isinstance(column, VectorColumn):
        if column.is_sparse:
            return column, None
        vals = np.asarray(column.values)
        bad = ~np.isfinite(vals).all(axis=tuple(range(1, vals.ndim)))
        if not bad.any():
            return column, bad
        vals = np.where(np.isfinite(vals), vals, 0.0)
        return dataclasses.replace(column, values=vals), bad
    if isinstance(column, PredictionColumn):
        pred = np.asarray(column.prediction, dtype=np.float64)
        bad = ~np.isfinite(pred)
        prob = column.probability
        raw = column.raw
        if prob is not None:
            bad |= ~np.isfinite(np.asarray(prob)).all(axis=1)
        if raw is not None:
            bad |= ~np.isfinite(np.asarray(raw)).all(axis=1)
        if not bad.any():
            return column, bad
        # default prediction: class/value 0, uniform probabilities, zero raw
        pred = np.where(bad, 0.0, pred)
        if prob is not None:
            prob = np.array(prob, dtype=np.float64, copy=True)
            prob[bad, :] = 1.0 / prob.shape[1]
        if raw is not None:
            raw = np.array(raw, dtype=np.float64, copy=True)
            raw[bad, :] = 0.0
        return (
            dataclasses.replace(
                column, prediction=pred, probability=prob, raw=raw
            ),
            bad,
        )
    return column, None
