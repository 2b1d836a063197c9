"""Aggregate / Conditional readers — event data → one row per entity.

Reference: readers/.../DataReader.scala:206-360 (AggregatedReader,
AggregateDataReader, ConditionalDataReader), aggregators/CutOffTime.scala,
readers/TimeStampToKeep.scala, DataReaders.scala:116-198.

Semantics (DataReader.scala:259-331, FeatureAggregator.scala:110-124):
  * records are grouped by ``key_fn``;
  * each raw feature's values are extracted per event, filtered by the
    cutoff window, and folded with the feature's monoid aggregator;
  * predictors aggregate events with ``ts <  cutoff`` (within
    ``predictor_window`` before it, when set);
  * responses aggregate events with ``ts >= cutoff`` (within
    ``response_window`` after it, when set);
  * Conditional readers derive the cutoff per key from the first/min/max/
    random event satisfying ``target_condition`` and can drop keys where
    the condition never fires.

Grouping runs host-side (the reference's groupBy shuffle); the folds are
commutative monoids so per-key results are event-order-invariant, matching
the Spark implementation's shard-independence.
"""
from __future__ import annotations

import dataclasses
import enum
import random
import time
from typing import Any, Callable, Iterable, Sequence

from ..dataset import Dataset
from ..features.aggregators import LastAggregator, aggregator_of
from ..features.feature import Feature, FeatureGeneratorStage
from ..types.columns import column_from_values
from .core import DataReader


class CutOffTimeType(enum.Enum):
    """CutOffTimeTypes.scala."""

    UNIX_EPOCH = "UnixEpoch"
    DAYS_AGO = "DaysAgo"
    WEEKS_AGO = "WeeksAgo"
    DDMMYYYY = "DDMMYYYY"
    NO_CUTOFF = "NoCutoff"


@dataclasses.dataclass(frozen=True)
class CutOffTime:
    """CutOffTime.scala:43 — a cutoff in epoch millis (None = no cutoff)."""

    ctype: CutOffTimeType
    time_ms: int | None

    @staticmethod
    def unix_epoch(since_epoch_ms: int) -> "CutOffTime":
        return CutOffTime(CutOffTimeType.UNIX_EPOCH, max(int(since_epoch_ms), 0))

    @staticmethod
    def days_ago(days: int, now_ms: int | None = None) -> "CutOffTime":
        now = _start_of_day(now_ms)
        return CutOffTime(CutOffTimeType.DAYS_AGO, now - days * 86_400_000)

    @staticmethod
    def weeks_ago(weeks: int, now_ms: int | None = None) -> "CutOffTime":
        now = _start_of_day(now_ms)
        return CutOffTime(CutOffTimeType.WEEKS_AGO, now - weeks * 7 * 86_400_000)

    @staticmethod
    def ddmmyyyy(s: str) -> "CutOffTime":
        ts = time.mktime(time.strptime(s, "%d%m%Y"))
        return CutOffTime(CutOffTimeType.DDMMYYYY, int(ts * 1000))

    @staticmethod
    def no_cutoff() -> "CutOffTime":
        return CutOffTime(CutOffTimeType.NO_CUTOFF, None)


def _start_of_day(now_ms: int | None) -> int:
    now = time.time() if now_ms is None else now_ms / 1000.0
    lt = time.localtime(now)
    return int(time.mktime((lt.tm_year, lt.tm_mon, lt.tm_mday, 0, 0, 0,
                            lt.tm_wday, lt.tm_yday, -1)) * 1000)


class TimeStampToKeep(enum.Enum):
    """TimeStampToKeep.scala — which target-event time becomes the cutoff."""

    MIN = "min"
    MAX = "max"
    RANDOM = "random"


def _in_window(
    ts: int,
    cutoff_ms: int | None,
    is_response: bool,
    window_ms: int | None,
) -> bool:
    """GenericFeatureAggregator.filterByDateWithCutoff
    (FeatureAggregator.scala:110-124)."""
    if cutoff_ms is None:
        return True
    if window_ms is None:
        return ts >= cutoff_ms if is_response else ts < cutoff_ms
    if is_response:
        return cutoff_ms <= ts <= cutoff_ms + window_ms
    return cutoff_ms - window_ms <= ts < cutoff_ms


def _aggregate_feature(
    feature: Feature,
    events: Sequence[tuple[int, Any]],  # (ts, record)
    cutoff_ms: int | None,
    is_response: bool,
    window_ms: int | None,
) -> Any:
    stage = feature.origin_stage
    assert isinstance(stage, FeatureGeneratorStage)
    agg = stage.aggregate_fn or aggregator_of(feature.ftype)
    if not hasattr(agg, "plus"):
        # plain callable (user aggregate_fn): fold the filtered values directly
        vals = [
            stage.extract_fn(r) if stage.extract_fn else r
            for ts, r in events
            if _in_window(ts, cutoff_ms, is_response, window_ms)
        ]
        return agg(vals)
    acc = agg.zero
    for ts, record in events:
        if not _in_window(ts, cutoff_ms, is_response, window_ms):
            continue
        value = stage.extract_fn(record) if stage.extract_fn else record
        if isinstance(agg, LastAggregator):
            prepared = agg.prepare_event(value, ts)
        else:
            prepared = agg.prepare(value)
        acc = agg.plus(acc, prepared)
    return agg.present(acc)


def _column_for(feature: Feature, vals: list) -> Any:
    """Build the output column; vector aggregates (CombineVector concatenates
    per-event vectors) are zero-padded to the longest row so the columnar
    [N, D] layout stays rectangular."""
    from ..types import Storage

    if feature.ftype.storage is Storage.VECTOR:
        import numpy as np

        rows = [np.asarray(v, dtype=np.float32).ravel() for v in vals]
        width = max((len(r) for r in rows), default=0)
        out = np.zeros((len(rows), width), dtype=np.float32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
        return column_from_values(feature.ftype, out)
    return column_from_values(feature.ftype, vals)


@dataclasses.dataclass
class AggregateParams:
    """AggregateParams (DataReader.scala:279)."""

    timestamp_fn: Callable[[Any], int] | None
    cutoff_time: CutOffTime
    response_window_ms: int | None = None
    predictor_window_ms: int | None = None


class AggregateReader(DataReader):
    """DataReaders.Aggregate.* (DataReaders.scala:116): group events by key,
    monoid-aggregate each raw feature around the cutoff."""

    def __init__(
        self,
        records: Iterable[Any],
        key_fn: Callable[[Any], str],
        aggregate_params: AggregateParams,
    ):
        super().__init__(key_fn)
        self._records = records
        self.params = aggregate_params

    def read_records(self) -> Iterable[Any]:
        return self._records

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        ts_fn = self.params.timestamp_fn
        groups: dict[str, list[tuple[int, Any]]] = {}
        for r in self._read_records_with_retry():
            groups.setdefault(self.key_fn(r), []).append(
                (ts_fn(r) if ts_fn else 0, r)
            )
        keys = sorted(groups)
        cutoff = self.params.cutoff_time.time_ms
        cols: dict[str, Any] = {
            _KEY_COLUMN: column_from_values(_key_type(), keys)
        }
        for f in raw_features:
            window = (
                self.params.response_window_ms
                if f.is_response
                else self.params.predictor_window_ms
            )
            vals = [
                _aggregate_feature(f, groups[k], cutoff, f.is_response, window)
                for k in keys
            ]
            cols[f.name] = _column_for(f, vals)
        return Dataset.of(cols)


@dataclasses.dataclass
class ConditionalParams:
    """ConditionalParams (DataReader.scala:351-358)."""

    timestamp_fn: Callable[[Any], int]
    target_condition: Callable[[Any], bool]
    response_window_ms: int | None = 7 * 86_400_000  # one week
    predictor_window_ms: int | None = 7 * 86_400_000
    timestamp_to_keep: TimeStampToKeep = TimeStampToKeep.RANDOM
    cutoff_time_fn: Callable[[str, Sequence[Any]], CutOffTime] | None = None
    drop_if_target_condition_not_met: bool = False
    seed: int | None = None  # the reference's Random is unseeded; we seed
    #: injectable "now" for the unmet-condition fallback cutoff
    #: (DataReader.scala:325 calls now()); pinning it makes streamed and
    #: materialized twins bit-comparable and keeps tests clock-free
    now_ms: int | None = None


class ConditionalReader(DataReader):
    """DataReaders.Conditional.* (DataReaders.scala:198): cutoff per key at
    the target event, predictors before / responses after
    (DataReader.scala:295-331)."""

    def __init__(
        self,
        records: Iterable[Any],
        key_fn: Callable[[Any], str],
        conditional_params: ConditionalParams,
    ):
        super().__init__(key_fn)
        self._records = records
        self.params = conditional_params

    def read_records(self) -> Iterable[Any]:
        return self._records

    def _cutoff_for(
        self, key: str, events: list[tuple[int, Any]], rng: random.Random
    ) -> int | None:
        p = self.params
        if p.cutoff_time_fn is not None:
            return p.cutoff_time_fn(key, [r for _, r in events]).time_ms
        target_times = [ts for ts, r in events if p.target_condition(r)]
        if not target_times:
            return None  # caller drops or uses now()
        if p.timestamp_to_keep is TimeStampToKeep.MIN:
            return min(target_times)
        if p.timestamp_to_keep is TimeStampToKeep.MAX:
            return max(target_times)
        return target_times[rng.randrange(len(target_times))]

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        p = self.params
        rng = random.Random(p.seed)
        groups: dict[str, list[tuple[int, Any]]] = {}
        for r in self._read_records_with_retry():
            groups.setdefault(self.key_fn(r), []).append((p.timestamp_fn(r), r))
        keys, cutoffs = [], []
        now_ms = (
            p.now_ms if p.now_ms is not None else int(time.time() * 1000)
        )
        for k in sorted(groups):
            cutoff = self._cutoff_for(k, groups[k], rng)
            if cutoff is None:
                if p.drop_if_target_condition_not_met:
                    continue
                cutoff = now_ms  # DataReader.scala:325: now() when unmet
            keys.append(k)
            cutoffs.append(cutoff)
        cols: dict[str, Any] = {
            _KEY_COLUMN: column_from_values(_key_type(), keys)
        }
        for f in raw_features:
            window = (
                p.response_window_ms if f.is_response else p.predictor_window_ms
            )
            vals = [
                _aggregate_feature(f, groups[k], c, f.is_response, window)
                for k, c in zip(keys, cutoffs)
            ]
            cols[f.name] = _column_for(f, vals)
        return Dataset.of(cols)


_KEY_COLUMN = "key"


def _key_type() -> type:
    from .. import types as T

    return T.ID


# ----------------------------------------------------- streamed event-time
class _FeatureFold:
    """Incremental per-feature event fold — ``_aggregate_feature`` turned
    into monoid state so the streamed readers never hold a key's event
    list. Monoid aggregators fold ``plus`` per event; a plain-callable
    ``aggregate_fn`` has no incremental form, so only its FILTERED
    extracted values buffer (bounded by in-window events, not the
    stream)."""

    def __init__(self, feature: Feature):
        stage = feature.origin_stage
        assert isinstance(stage, FeatureGeneratorStage)
        self.stage = stage
        self.agg = stage.aggregate_fn or aggregator_of(feature.ftype)
        self.monoid = hasattr(self.agg, "plus")

    def zero(self) -> Any:
        return self.agg.zero if self.monoid else []

    def fold(self, acc: Any, ts: int, record: Any) -> Any:
        value = (
            self.stage.extract_fn(record)
            if self.stage.extract_fn else record
        )
        if not self.monoid:
            acc.append(value)
            return acc
        if isinstance(self.agg, LastAggregator):
            prepared = self.agg.prepare_event(value, ts)
        else:
            prepared = self.agg.prepare(value)
        return self.agg.plus(acc, prepared)

    def present(self, acc: Any) -> Any:
        return self.agg.present(acc) if self.monoid else self.agg(acc)


class _StreamedEventReader(DataReader):
    """Shared chunk plumbing for the streamed event-time readers. The
    source is an iterable of record chunks OR a zero-arg callable
    producing one (a callable is REQUIRED wherever two passes are needed
    — a plain generator would be empty on the second)."""

    def __init__(
        self,
        chunks: Iterable[Sequence[Any]] | Callable[[], Iterable[Sequence[Any]]],
        key_fn: Callable[[Any], str],
    ):
        super().__init__(key_fn)
        self._chunks = chunks

    def _chunk_iter(self) -> Iterable[Sequence[Any]]:
        return self._chunks() if callable(self._chunks) else self._chunks

    def read_records(self) -> Iterable[Any]:
        for chunk in self._chunk_iter():
            yield from chunk


class StreamingAggregateReader(_StreamedEventReader):
    """Point-in-time-correct aggregate reader over a chunked event
    stream: one pass, per-entity monoid accumulators — memory is bounded
    by ENTITIES, never events. Semantically identical to
    :class:`AggregateReader` over the concatenated chunks
    (:func:`event_parity_oracle` pins column-exact equality): predictors fold
    events strictly before the cutoff, responses at/after it, each within
    its window — no future leakage regardless of how the stream is
    chunked."""

    def __init__(
        self,
        chunks: Iterable[Sequence[Any]] | Callable[[], Iterable[Sequence[Any]]],
        key_fn: Callable[[Any], str],
        aggregate_params: AggregateParams,
    ):
        super().__init__(chunks, key_fn)
        self.params = aggregate_params

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        p = self.params
        ts_fn = p.timestamp_fn
        cutoff = p.cutoff_time.time_ms
        folds = [_FeatureFold(f) for f in raw_features]
        windows = [
            p.response_window_ms if f.is_response else p.predictor_window_ms
            for f in raw_features
        ]
        state: dict[str, list[Any]] = {}
        for chunk in self._chunk_iter():
            for r in chunk:
                k = self.key_fn(r)
                ts = ts_fn(r) if ts_fn else 0
                accs = state.get(k)
                if accs is None:
                    accs = [fold.zero() for fold in folds]
                    state[k] = accs
                for i, f in enumerate(raw_features):
                    if _in_window(ts, cutoff, f.is_response, windows[i]):
                        accs[i] = folds[i].fold(accs[i], ts, r)
        keys = sorted(state)
        cols: dict[str, Any] = {
            _KEY_COLUMN: column_from_values(_key_type(), keys)
        }
        for i, f in enumerate(raw_features):
            vals = [folds[i].present(state[k][i]) for k in keys]
            cols[f.name] = _column_for(f, vals)
        return Dataset.of(cols)


class StreamingConditionalReader(_StreamedEventReader):
    """Per-entity cutoff-time semantics over a chunked event stream, in
    two streamed passes: pass 1 folds each key's target-event times
    (min/max incremental; RANDOM keeps the target times only), pass 2
    folds the windowed aggregates against the per-key cutoffs. Chunks
    must therefore come from a re-iterable source (sequence or callable)
    that replays the SAME records in the SAME order. Bit-identical to
    :class:`ConditionalReader` over the concatenated chunks given the
    same ``seed`` (pin ``now_ms`` when keys can miss the target
    condition). ``cutoff_time_fn`` needs a key's full event list and is
    not supported streamed."""

    def __init__(
        self,
        chunks: Iterable[Sequence[Any]] | Callable[[], Iterable[Sequence[Any]]],
        key_fn: Callable[[Any], str],
        conditional_params: ConditionalParams,
    ):
        super().__init__(chunks, key_fn)
        if conditional_params.cutoff_time_fn is not None:
            raise ValueError(
                "cutoff_time_fn requires each key's full event list and "
                "cannot stream; use ConditionalReader or precompute "
                "cutoffs"
            )
        self.params = conditional_params

    def _cutoffs(self) -> dict[str, int | None]:
        """Pass 1 → per-key cutoff. Consumes the rng over sorted keys
        exactly like ``ConditionalReader._cutoff_for`` so the streamed
        and materialized twins draw identical RANDOM cutoffs."""
        p = self.params
        keep = p.timestamp_to_keep
        # MIN/MAX fold to one int; RANDOM needs the times (arrival order,
        # matching the materialized group lists) for index selection
        times: dict[str, Any] = {}
        seen: set[str] = set()
        for chunk in self._chunk_iter():
            for r in chunk:
                k = self.key_fn(r)
                seen.add(k)
                if not p.target_condition(r):
                    continue
                ts = p.timestamp_fn(r)
                if keep is TimeStampToKeep.RANDOM:
                    times.setdefault(k, []).append(ts)
                elif keep is TimeStampToKeep.MIN:
                    times[k] = min(times.get(k, ts), ts)
                else:
                    times[k] = max(times.get(k, ts), ts)
        rng = random.Random(p.seed)
        out: dict[str, int | None] = {}
        for k in sorted(seen):
            t = times.get(k)
            if t is None:
                out[k] = None
            elif keep is TimeStampToKeep.RANDOM:
                out[k] = t[rng.randrange(len(t))]
            else:
                out[k] = t
        return out

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        p = self.params
        cutoffs = self._cutoffs()
        now_ms = (
            p.now_ms if p.now_ms is not None else int(time.time() * 1000)
        )
        keys = []
        for k in sorted(cutoffs):
            if cutoffs[k] is None:
                if p.drop_if_target_condition_not_met:
                    continue
                cutoffs[k] = now_ms  # DataReader.scala:325: now() when unmet
            keys.append(k)
        kept = set(keys)
        folds = [_FeatureFold(f) for f in raw_features]
        windows = [
            p.response_window_ms if f.is_response else p.predictor_window_ms
            for f in raw_features
        ]
        state: dict[str, list[Any]] = {
            k: [fold.zero() for fold in folds] for k in keys
        }
        for chunk in self._chunk_iter():
            for r in chunk:
                k = self.key_fn(r)
                if k not in kept:
                    continue
                ts = p.timestamp_fn(r)
                cutoff = cutoffs[k]
                accs = state[k]
                for i, f in enumerate(raw_features):
                    if _in_window(ts, cutoff, f.is_response, windows[i]):
                        accs[i] = folds[i].fold(accs[i], ts, r)
        cols: dict[str, Any] = {
            _KEY_COLUMN: column_from_values(_key_type(), keys)
        }
        for i, f in enumerate(raw_features):
            vals = [folds[i].present(state[k][i]) for k in keys]
            cols[f.name] = _column_for(f, vals)
        return Dataset.of(cols)


def event_parity_oracle(streamed: Dataset, materialized: Dataset) -> dict:
    """Column-exact comparison of a streamed event-time frame against its
    materialized twin — the acceptance oracle for the streamed readers.
    Returns ``{"identical": bool,
    "mismatches": [...]}`` naming every differing column (or a shape/
    schema difference) instead of a bare boolean, so a parity break is
    diagnosable from the report."""
    mismatches: list[str] = []
    a, b = streamed.columns, materialized.columns
    if sorted(a) != sorted(b):
        mismatches.append(
            f"columns differ: {sorted(a)} vs {sorted(b)}"
        )
        return {"identical": False, "mismatches": mismatches}
    for name in sorted(a):
        va, vb = a[name].to_list(), b[name].to_list()
        if len(va) != len(vb):
            mismatches.append(
                f"{name}: {len(va)} rows vs {len(vb)}"
            )
        elif va != vb:
            bad = next(
                i for i, (x, y) in enumerate(zip(va, vb)) if x != y
            )
            mismatches.append(
                f"{name}: row {bad}: {va[bad]!r} != {vb[bad]!r}"
            )
    return {"identical": not mismatches, "mismatches": mismatches}
