"""Date/DateTime vectorizer: circular encodings + days-since-reference.

Reference: dsl/RichDateFeature.scala:108-120 — vectorize = per-period unit
circle (DateToUnitCircleTransformer.scala, sin/cos pairs for HourOfDay,
DayOfWeek, DayOfMonth, DayOfYear) combined with DateList SinceLast pivot
(days from the value to the reference date) + null indicator. Date values are
epoch milliseconds (joda convention).

Missing dates encode as (0, 0) on the unit circle (the reference maps empty
to the zero vector) and 0 days-since with the null indicator set. Host numpy,
the same operations as ``transmogrifai_tpu/ops/dates.py``, so the blocks are
equal bit for bit.
"""
from __future__ import annotations

import datetime as _dt
from typing import Sequence

import numpy as np

from ..stages.metadata import NULL_STRING, ColumnMeta
from ..types.columns import Column, NumericColumn
from .base import VectorizerTransformer
from .defaults import DEFAULTS

_MS_PER_DAY = 86_400_000.0

#: period size = the joda TimePeriodVal max (DateToUnitCircleTransformer
#: .scala getPeriodWithSize); True = 1-based (min == 1 → shift so the
#: first period has angle 0)
_PERIOD_SIZE: dict[str, tuple[float, bool]] = {
    "HourOfDay": (24.0, False),
    "DayOfWeek": (7.0, True),
    "DayOfMonth": (31.0, True),
    "DayOfYear": (366.0, True),
    "MonthOfYear": (12.0, True),
    "WeekOfMonth": (6.0, True),
    "WeekOfYear": (53.0, True),
}


def _period_values(ms: np.ndarray, period: str) -> np.ndarray:
    """Extract the integer time-period component from epoch-ms values
    (shared calendar conventions live in ops/time_period.period_value)."""
    from .time_period import period_value

    if period == "HourOfDay":
        return (ms // 3_600_000) % 24
    if period == "DayOfWeek":
        days = ms // 86_400_000
        return ((days + 3) % 7) + 1  # epoch day 0 = Thursday; joda Mon=1
    return np.array(
        [period_value(int(m), period) for m in ms], dtype=np.float64
    )


def unit_circle(ms: np.ndarray, mask: np.ndarray, period: str) -> np.ndarray:
    """[N, 2] (cos, sin) encoding; missing → (0, 0).

    DateToUnitCircle.convertToRandians semantics
    (DateToUnitCircleTransformer.scala:109-120): 1-based periods shift by
    one so the first period always has angle 0, and the components are
    ordered (cos, sin) — the x_/y_ column pair."""
    size, one_based = _PERIOD_SIZE[period]
    vals = _period_values(ms.astype(np.int64), period).astype(np.float64)
    if one_based:
        vals = vals - 1.0
    radians = 2.0 * np.pi * vals / size
    out = np.stack([np.cos(radians), np.sin(radians)], axis=1)
    out[~mask] = 0.0
    return out


class DateToUnitCircleTransformer(VectorizerTransformer):
    """Date/DateTime → OPVector [cos, sin] (the x_/y_ pair) for ONE time
    period (DateToUnitCircleTransformer.scala; dsl
    ``date.to_unit_circle()``, RichDateFeature / RichMapFeature
    toUnitCircle). All 7 reference TimePeriods are accepted."""

    def __init__(self, time_period: str = "HourOfDay", uid: str | None = None):
        super().__init__("toUnitCircle", uid=uid)
        if time_period not in _PERIOD_SIZE:
            raise ValueError(
                f"time_period must be one of {sorted(_PERIOD_SIZE)}"
            )
        self.time_period = time_period

    def get_params(self):
        return {"time_period": self.time_period}

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        blocks, metas = [], []
        for col, feat in zip(cols, self.input_features):
            assert isinstance(col, NumericColumn)
            blocks.append(unit_circle(col.values, col.mask, self.time_period))
            metas.append([
                ColumnMeta(
                    (feat.name,), feat.ftype.__name__,
                    # x_HourOfDay / y_HourOfDay — DateToUnitCircle
                    # .metadataValues order, same as DateVectorizer's
                    descriptor_value=f"{comp}_{self.time_period}",
                )
                for comp in ("x", "y")
            ])
        return blocks, metas


class DateVectorizer(VectorizerTransformer):
    """Sequence transformer for Date/DateTime features."""

    def __init__(
        self,
        reference_date_ms: int | None = None,
        circular_reps: Sequence[str] = DEFAULTS.CircularDateRepresentations,
        track_nulls: bool = True,
        uid: str | None = None,
    ):
        super().__init__("vecDate", uid=uid)
        if reference_date_ms is None:
            # Fixed at stage construction (TransmogrifierDefaults.ReferenceDate
            # = DateTimeUtils.now()).
            reference_date_ms = int(
                _dt.datetime.now(tz=_dt.timezone.utc).timestamp() * 1000
            )
        self.reference_date_ms = reference_date_ms
        self.circular_reps = tuple(circular_reps)
        self.track_nulls = track_nulls

    def get_params(self):
        return {
            "reference_date_ms": self.reference_date_ms,
            "circular_reps": list(self.circular_reps),
            "track_nulls": self.track_nulls,
        }

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        blocks, metas = [], []
        for col, feat in zip(cols, self.input_features):
            assert isinstance(col, NumericColumn)
            parts = []
            metas_f: list[ColumnMeta] = []
            for period in self.circular_reps:
                parts.append(unit_circle(col.values, col.mask, period))
                for comp in ("x", "y"):
                    metas_f.append(
                        ColumnMeta(
                            (feat.name,),
                            feat.ftype.__name__,
                            descriptor_value=f"{comp}_{period}",
                        )
                    )
            # SinceLast: days from value to reference date (DateListPivot)
            days = (self.reference_date_ms - col.values.astype(np.float64)) / _MS_PER_DAY
            days = np.where(col.mask, days, 0.0)
            parts.append(days[:, None])
            metas_f.append(
                ColumnMeta(
                    (feat.name,), feat.ftype.__name__, descriptor_value="SinceLast"
                )
            )
            if self.track_nulls:
                parts.append((~col.mask).astype(np.float64)[:, None])
                metas_f.append(
                    ColumnMeta(
                        (feat.name,),
                        feat.ftype.__name__,
                        grouping=feat.name,
                        indicator_value=NULL_STRING,
                    )
                )
            blocks.append(np.concatenate(parts, axis=1))
            metas.append(metas_f)
        return blocks, metas
