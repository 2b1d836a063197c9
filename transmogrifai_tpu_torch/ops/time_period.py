"""Time-period extraction transformers.

Reference: core/.../stages/impl/feature/{TimePeriodTransformer,
TimePeriodListTransformer, TimePeriodMapTransformer}.scala — extract one
calendar period (DayOfMonth/DayOfWeek/DayOfYear/HourOfDay/MonthOfYear/
WeekOfMonth/WeekOfYear) from Date values as Integral, through the
featurize plane's vectorized ``featurize.kernels.calendar_periods``.
"""
from __future__ import annotations

import datetime as _dt

import numpy as np

from ..featurize.kernels import calendar_periods
from ..stages.base import Transformer
from ..types import Date, DateList, Integral, IntegralMap, OPMap
from ..types.columns import (
    Column,
    ListColumn,
    MapColumn,
    NumericColumn,
)

TIME_PERIODS = (
    "DayOfMonth", "DayOfWeek", "DayOfYear", "HourOfDay",
    "MonthOfYear", "WeekOfMonth", "WeekOfYear",
)


def period_value(ms: int, period: str) -> int:
    """One calendar period component from epoch millis (UTC, joda
    conventions: Monday=1, months 1-12, WeekOfMonth 1-based)."""
    if period == "HourOfDay":
        return int((ms // 3_600_000) % 24)
    if period == "DayOfWeek":
        return int(((ms // 86_400_000 + 3) % 7) + 1)  # epoch day 0 = Thursday
    d = _dt.datetime.fromtimestamp(ms / 1000.0, tz=_dt.timezone.utc)
    if period == "DayOfMonth":
        return d.day
    if period == "DayOfYear":
        return d.timetuple().tm_yday
    if period == "MonthOfYear":
        return d.month
    if period == "WeekOfMonth":
        return (d.day - 1) // 7 + 1
    if period == "WeekOfYear":
        return d.isocalendar()[1]
    raise ValueError(f"Unknown time period {period}")


class TimePeriodTransformer(Transformer):
    """Date → Integral period (TimePeriodTransformer.scala)."""

    input_types = (Date,)
    output_type = Integral

    def __init__(self, period: str, uid: str | None = None):
        super().__init__(f"timePeriod{period}", uid=uid)
        if period not in TIME_PERIODS:
            raise ValueError(f"Unknown time period {period}")
        self.period = period

    def get_params(self):
        return {"period": self.period}

    def transform_columns(self, *cols: Column, num_rows: int) -> NumericColumn:
        col = cols[0]
        assert isinstance(col, NumericColumn)
        vals = calendar_periods(
            col.values.astype(np.int64, copy=False), self.period
        )
        vals[~col.mask] = 0
        return NumericColumn(Integral, vals, col.mask.copy())


class TimePeriodListTransformer(Transformer):
    """DateList → DateList of period values (TimePeriodListTransformer.scala)."""

    input_types = (DateList,)
    output_type = DateList

    def __init__(self, period: str, uid: str | None = None):
        super().__init__(f"timePeriodList{period}", uid=uid)
        if period not in TIME_PERIODS:
            raise ValueError(f"Unknown time period {period}")
        self.period = period

    def get_params(self):
        return {"period": self.period}

    def transform_columns(self, *cols: Column, num_rows: int) -> ListColumn:
        from itertools import chain

        col = cols[0]
        assert isinstance(col, ListColumn)
        rows = col.values
        counts = np.fromiter(map(len, rows), np.int64, len(rows))
        offsets = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        flat = np.fromiter(
            chain.from_iterable(rows), np.int64, int(offsets[-1])
        )
        periods = calendar_periods(flat, self.period)
        out = [
            periods[offsets[r]:offsets[r + 1]].tolist()
            for r in range(len(rows))
        ]
        return ListColumn(DateList, out)


class TimePeriodMapTransformer(Transformer):
    """DateMap → IntegralMap of period values (TimePeriodMapTransformer.scala)."""

    input_types = (OPMap,)
    output_type = IntegralMap

    def __init__(self, period: str, uid: str | None = None):
        super().__init__(f"timePeriodMap{period}", uid=uid)
        if period not in TIME_PERIODS:
            raise ValueError(f"Unknown time period {period}")
        self.period = period

    def get_params(self):
        return {"period": self.period}

    def transform_columns(self, *cols: Column, num_rows: int) -> MapColumn:
        from itertools import chain

        col = cols[0]
        assert isinstance(col, MapColumn)
        maps = col.values
        counts = np.fromiter(map(len, maps), np.int64, len(maps))
        offsets = np.zeros(len(maps) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        keys = list(chain.from_iterable(maps))
        flat = np.fromiter(
            (v for m in maps for v in m.values()), np.int64, int(offsets[-1])
        )
        periods = calendar_periods(flat, self.period).tolist()
        out = [
            dict(zip(
                keys[offsets[r]:offsets[r + 1]],
                periods[offsets[r]:offsets[r + 1]],
            ))
            for r in range(len(maps))
        ]
        return MapColumn(IntegralMap, out)
