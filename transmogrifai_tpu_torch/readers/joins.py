"""Joined readers — typed joins of two readers' outputs on key columns.

Reference: readers/.../JoinedDataReader.scala:83-390 and JoinTypes.scala.
The reference joins the two generated DataFrames on `JoinKeys` (default both
sides' "key" column) with inner/left-outer/outer semantics, then optionally
re-aggregates. Columnar equivalent: hash-join the two Datasets; missing side
rows become all-missing columns (the reference's nulls).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np

from ..dataset import Dataset
from ..features.feature import Feature
from ..types.columns import empty_like
from .core import DataReader


class JoinType(enum.Enum):
    """JoinTypes.scala."""

    INNER = "inner"
    LEFT_OUTER = "leftOuter"
    OUTER = "outer"


@dataclasses.dataclass(frozen=True)
class JoinKeys:
    """JoinedDataReader.scala: key column names on each side (default the
    reader key column)."""

    left_key: str = "key"
    right_key: str = "key"
    result_key: str = "key"


@dataclasses.dataclass(frozen=True)
class TimeColumn:
    """Time column for post-join aggregation (JoinedDataReader.scala:54-60):
    ``keep`` controls whether it survives into the aggregated result."""

    name: str
    keep: bool = True


@dataclasses.dataclass(frozen=True)
class TimeBasedFilter:
    """Time-based filter for post-join conditional aggregation
    (JoinedDataReader.scala:66-75): per result row, the right (child) side's
    events merge only when their ``primary`` timestamp falls in the window
    anchored at that row's ``condition`` timestamp."""

    condition: TimeColumn
    primary: TimeColumn
    time_window_ms: int


class JoinedReader(DataReader):
    """Join the outputs of two readers (JoinedDataReader.scala:83).

    Each raw feature must be resolvable by exactly one side; the split is by
    feature name against each side's generated columns. The join is
    MANY-TO-MANY (Spark DataFrame.join semantics): every left row pairs with
    every matching right row.
    """

    def __init__(
        self,
        left: DataReader,
        right: DataReader,
        join_type: JoinType = JoinType.LEFT_OUTER,
        join_keys: JoinKeys = JoinKeys(),
        left_features: Sequence[Feature] = (),
        right_features: Sequence[Feature] = (),
    ):
        super().__init__(None)
        self.left = left
        self.right = right
        self.join_type = join_type
        self.join_keys = join_keys
        self.left_features = tuple(left_features)
        self.right_features = tuple(right_features)

    def inner_join(self, other: "DataReader", **kw) -> "JoinedReader":
        return JoinedReader(self, other, JoinType.INNER, **kw)

    def with_secondary_aggregation(
        self, time_filter: TimeBasedFilter
    ) -> "JoinedAggregateReader":
        """Aggregate after joining (JoinedDataReader.withSecondaryAggregation
        :228-236): group the joined rows by the result key; parent-side
        features keep one copy per key, child-side features monoid-merge
        under the time filter."""
        return JoinedAggregateReader(
            self.left, self.right, self.join_type, self.join_keys,
            self.left_features, self.right_features, time_filter,
        )

    def _split_features(self, raw_features: Sequence[Feature]):
        left_names = {f.name for f in self.left_features}
        right_names = {f.name for f in self.right_features}
        lf = [f for f in raw_features if f.name in left_names]
        rf = [f for f in raw_features if f.name in right_names]
        unclaimed = [
            f.name for f in raw_features
            if f.name not in left_names and f.name not in right_names
        ]
        if unclaimed:
            raise ValueError(
                f"Raw features {unclaimed} not declared on either join side"
            )
        return lf, rf

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        lf, rf = self._split_features(raw_features)
        lds = self.left.generate_dataset(lf)
        rds = self.right.generate_dataset(rf)
        return join_datasets(
            lds, rds, self.join_type, self.join_keys
        )


class JoinedAggregateReader(JoinedReader):
    """Join + group-by-key secondary aggregation
    (JoinedAggregateDataReader, JoinedDataReader.scala:240-305):

      * parent (left) features take the LAST joined value per key — the
        reference's DummyJoinedAggregator (convertTypesMerge = v2);
      * child (right) features monoid-merge only the rows whose primary
        timestamp passes the window test against that row's condition
        timestamp (JoinedConditionalAggregator.update:429-438 — predictors:
        cutoff-window < t < cutoff; responses: cutoff <= t < cutoff+window);
      * time columns with keep=False are dropped from the result.
    """

    def __init__(
        self, left, right, join_type, join_keys,
        left_features, right_features, time_filter: TimeBasedFilter,
    ):
        super().__init__(
            left, right, join_type, join_keys, left_features, right_features
        )
        self.time_filter = time_filter

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        lf, rf = self._split_features(raw_features)
        joined = super().generate_dataset(raw_features)
        # reference isCombinedJoin (JoinedDataReader.scala:103): only a join
        # producing the COMBINED key aggregates the left side conditionally;
        # any other key combination treats left as the parent table (one
        # copy per key — DummyJoinedAggregator)
        combined = self.join_keys.result_key == "combinedKey"
        return post_join_aggregate(
            joined, lf, rf, self.join_keys, self.time_filter,
            combined=combined,
        )


def post_join_aggregate(
    joined: Dataset,
    left_features: Sequence[Feature],
    right_features: Sequence[Feature],
    keys: JoinKeys,
    time_filter: TimeBasedFilter,
    combined: bool = False,
) -> Dataset:
    """Group the joined rows by the result key and aggregate each feature
    (JoinedAggregateDataReader.postJoinAggregate:275-305)."""
    from ..features.aggregators import aggregator_of
    from .aggregate import _column_for

    key_vals = joined[keys.result_key].to_list()
    n = len(key_vals)

    def ms_list(name: str) -> list[int]:
        if name not in joined:
            # zero-filling here would silently zero every windowed
            # aggregate; the filter's time columns MUST be raw features
            raise ValueError(
                f"TimeBasedFilter column '{name}' is not in the joined "
                "data — declare it among the join's raw features (keep="
                "False only drops it from the aggregated RESULT)"
            )
        return [
            0 if v is None else int(v) for v in joined[name].to_list()
        ]

    primary_ms = ms_list(time_filter.primary.name)
    condition_ms = ms_list(time_filter.condition.name)

    order: list[str] = []
    groups: dict[str, list[int]] = {}
    for i, k in enumerate(key_vals):
        if k not in groups:
            groups[k] = []
            order.append(k)
        groups[k].append(i)

    def in_window(i: int, is_response: bool) -> bool:
        ts, cutoff = primary_ms[i], condition_ms[i]
        w = time_filter.time_window_ms
        if is_response:
            return cutoff <= ts < cutoff + w
        return cutoff - w < ts < cutoff

    cols = {}
    from ..types.columns import column_from_values

    from .. import types as T

    cols[keys.result_key] = column_from_values(T.ID, order)
    time_drop = {
        t.name for t in (time_filter.condition, time_filter.primary)
        if not t.keep
    }
    right_names = {f.name for f in right_features}
    for f in list(left_features) + list(right_features):
        if f.name not in joined or f.name == keys.result_key:
            continue
        values = joined[f.name].to_list()
        conditional = f.name in right_names or combined
        out_vals = []
        for k in order:
            idxs = groups[k]
            if not conditional:
                out_vals.append(values[idxs[-1]])  # dummy: keep last copy
                continue
            agg = aggregator_of(f.ftype)
            acc = agg.zero
            for i in idxs:
                if values[i] is None or not in_window(i, f.is_response):
                    continue
                acc = agg.plus(acc, agg.prepare(values[i]))
            out_vals.append(agg.present(acc))
        if f.name not in time_drop:
            cols[f.name] = _column_for(f, out_vals)
    return Dataset.of(cols)


def join_datasets(
    left: Dataset,
    right: Dataset,
    join_type: JoinType = JoinType.LEFT_OUTER,
    keys: JoinKeys = JoinKeys(),
) -> Dataset:
    """Hash-join two columnar Datasets on their key columns — MANY-TO-MANY
    (Spark DataFrame.join semantics, JoinedDataReader.scala:168-175): every
    left row pairs with every matching right row; unmatched sides become
    all-missing columns per the join type."""
    lkeys = [_key_str(v) for v in left[keys.left_key].to_list()]
    rkeys = [_key_str(v) for v in right[keys.right_key].to_list()]
    rindex: dict[str, list[int]] = {}
    for i, k in enumerate(rkeys):
        rindex.setdefault(k, []).append(i)

    # left rows are addressed positionally so duplicate left keys each keep
    # their own data; the right side is looked up through its key index
    out_keys: list[str] = []
    li_list: list[int] = []
    ri_list: list[int] = []
    for i, k in enumerate(lkeys):
        matches = rindex.get(k)
        if not matches:
            if join_type is not JoinType.INNER:
                out_keys.append(k)
                li_list.append(i)
                ri_list.append(-1)
            continue
        for r in matches:
            out_keys.append(k)
            li_list.append(i)
            ri_list.append(r)
    if join_type is JoinType.OUTER:
        seen = set(lkeys)
        for i, k in enumerate(rkeys):
            if k not in seen:
                out_keys.append(k)
                li_list.append(-1)
                ri_list.append(i)
    li = np.array(li_list, dtype=np.int64)
    ri = np.array(ri_list, dtype=np.int64)

    cols = {}
    for name, col in left.columns.items():
        if name == keys.left_key:
            continue
        cols[name] = _gather(col, li, left.num_rows)
    for name, col in right.columns.items():
        if name == keys.right_key:
            continue
        if name in cols:
            raise ValueError(f"Join column collision: '{name}' on both sides")
        cols[name] = _gather(col, ri, right.num_rows)
    from ..types.columns import column_from_values

    from .. import types as T

    cols = {keys.result_key: column_from_values(T.ID, out_keys), **cols}
    return Dataset.of(cols)


def _key_str(v) -> str:
    return "" if v is None else str(v)


def _gather(col, idx: np.ndarray, n_src: int):
    """Take rows by index; -1 produces a missing row."""
    from ..types.columns import VectorColumn, column_from_values

    missing = idx < 0
    if not missing.any():
        return col.take(idx)
    if isinstance(col, VectorColumn):
        # rectangular: unmatched rows become zero vectors, metadata kept
        src = np.asarray(col.values)
        out = np.zeros((len(idx), src.shape[1]), dtype=src.dtype)
        valid = ~missing
        if valid.any() and n_src:
            out[valid] = src[idx[valid]]
        return VectorColumn(col.feature_type, out, col.metadata)
    if missing.all() or n_src == 0:
        return empty_like(col.feature_type, len(idx))
    # take valid rows then splice in missing rows
    safe = np.where(missing, 0, idx)
    taken = col.take(safe)
    vals = taken.to_list()
    evals = empty_like(col.feature_type, int(missing.sum())).to_list()
    j = 0
    for i, m in enumerate(missing):
        if m:
            vals[i] = evals[j]
            j += 1
    return column_from_values(col.feature_type, vals)
