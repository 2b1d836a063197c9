"""List-family vectorizers: TextList, DateList/DateTimeList, Geolocation.

Reference:
  * RichListFeature.vectorize on TextList — hashing TF over the list's terms
    (numTerms = DefaultNumOfFeatures = 512, binary frequency off, minDocFreq 0;
    core/.../dsl/RichListFeature.scala) via OpHashingTF + optional IDF.
  * DateListVectorizer (core/.../stages/impl/feature/DateListVectorizer.scala)
    with DateListPivot modes SinceFirst / SinceLast / ModeDay / ModeMonth /
    ModeHour (Transmogrifier default: SinceLast).
  * GeolocationVectorizer (core/.../stages/impl/feature/GeolocationVectorizer.scala)
    — fill missing with the mean location, track nulls.

TextList terms are interned once (``featurize.interning.interned_of``):
each distinct term hashes once, the occurrences ride the code array
through the native bincount scatter (``featurize.kernels``).
"""
from __future__ import annotations

import datetime as _dt
from typing import Sequence

import numpy as np

from ..dataset import Dataset
from ..featurize import kernels as FK
from ..featurize.interning import interned_of
from ..stages.metadata import NULL_STRING, ColumnMeta
from ..types.columns import Column, ListColumn
from .base import VectorizerEstimator, VectorizerModel, VectorizerTransformer
from .defaults import DEFAULTS

_MS_PER_DAY = 86_400_000.0

#: DateListPivot enum parity (DateListVectorizer.scala)
SINCE_FIRST, SINCE_LAST = "SinceFirst", "SinceLast"
MODE_DAY, MODE_MONTH, MODE_HOUR = "ModeDay", "ModeMonth", "ModeHour"

_DAY_NAMES = (
    "Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday", "Sunday",
)
_MONTH_NAMES = (
    "January", "February", "March", "April", "May", "June", "July",
    "August", "September", "October", "November", "December",
)


def _term_buckets(tc, num_terms: int, seed: int) -> np.ndarray:
    """code -> murmur3 bucket of an interned TextList column's vocabulary;
    a term that is not a str hashes as ``str(term)``."""
    return FK.hash_vocab(
        [t if isinstance(t, str) else str(t) for t in tc.vocab],
        num_terms, seed=seed,
    )


class TextListModel(VectorizerModel):
    def __init__(self, idf: list | None, num_terms: int, binary_freq: bool,
                 seed: int, track_nulls: bool, **kw):
        super().__init__("vecTextList", **kw)
        self.idf = idf  # per-feature [num_terms] weights or None
        self.num_terms = num_terms
        self.binary_freq = binary_freq
        self.seed = seed
        self.track_nulls = track_nulls

    def get_params(self):
        return {
            "idf": self.idf,
            "num_terms": self.num_terms,
            "binary_freq": self.binary_freq,
            "seed": self.seed,
            "track_nulls": self.track_nulls,
        }

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        blocks, metas = [], []
        for fi, (col, feat) in enumerate(zip(cols, self.input_features)):
            width = self.num_terms + (1 if self.track_nulls else 0)
            tc = interned_of(col)
            out = FK.term_count_block(
                tc, _term_buckets(tc, self.num_terms, self.seed), width,
                binary=self.binary_freq,
            )
            if self.track_nulls:
                out[tc.row_counts() == 0, self.num_terms] = 1.0
            if self.idf is not None:
                out[:, : self.num_terms] *= np.asarray(self.idf[fi])[None, :]
            blocks.append(out)
            metas_f = [
                ColumnMeta((feat.name,), feat.ftype.__name__,
                           descriptor_value=f"hash_{j}")
                for j in range(self.num_terms)
            ]
            if self.track_nulls:
                metas_f.append(
                    ColumnMeta((feat.name,), feat.ftype.__name__,
                               grouping=feat.name, indicator_value=NULL_STRING)
                )
            metas.append(metas_f)
        return blocks, metas


class TextListVectorizer(VectorizerEstimator):
    """Hashing TF (+ IDF when min_doc_freq > 0) over TextList terms."""

    def __init__(
        self,
        num_terms: int = DEFAULTS.DefaultNumOfFeatures,
        binary_freq: bool = DEFAULTS.BinaryFreq,
        min_doc_freq: int = DEFAULTS.MinDocFrequency,
        seed: int = DEFAULTS.HashSeed,
        track_nulls: bool = DEFAULTS.TrackNulls,
        uid: str | None = None,
    ):
        super().__init__("vecTextList", uid=uid)
        self.num_terms = num_terms
        self.binary_freq = binary_freq
        self.min_doc_freq = min_doc_freq
        self.seed = seed
        self.track_nulls = track_nulls

    def get_params(self):
        return {
            "num_terms": self.num_terms,
            "binary_freq": self.binary_freq,
            "min_doc_freq": self.min_doc_freq,
            "seed": self.seed,
            "track_nulls": self.track_nulls,
        }

    def fit_model(self, dataset: Dataset) -> TextListModel:
        idf = None
        if self.min_doc_freq > 0:
            # Spark IDF semantics: log((m + 1) / (df + 1)); df < minDocFreq -> 0
            idf = []
            m = dataset.num_rows
            for name in self.input_names:
                tc = interned_of(dataset[name])
                buckets = _term_buckets(tc, self.num_terms, self.seed)
                # document frequency: one bincount over the distinct
                # (row, bucket) pairs
                df = FK.distinct_pair_bincount(
                    tc.row_index(), buckets[tc.codes], self.num_terms
                ).astype(np.int64)
                w = np.log((m + 1.0) / (df + 1.0))
                w[df < self.min_doc_freq] = 0.0
                idf.append(w.tolist())
        return TextListModel(
            idf, self.num_terms, self.binary_freq, self.seed, self.track_nulls
        )


def _list_mode(values: list[int]) -> int:
    """Most frequent value, ties to the smallest (deterministic)."""
    counts: dict[int, int] = {}
    for v in values:
        counts[v] = counts.get(v, 0) + 1
    return min(counts, key=lambda k: (-counts[k], k))


class DateListVectorizer(VectorizerTransformer):
    """DateList/DateTimeList pivot (DateListVectorizer.scala).

    SinceFirst/SinceLast: days between the earliest/latest date in the list
    and the reference date. Mode*: one-hot of the mode day-of-week / month /
    hour across the list's dates.
    """

    def __init__(
        self,
        pivot: str = SINCE_LAST,
        reference_date_ms: int | None = None,
        track_nulls: bool = DEFAULTS.TrackNulls,
        uid: str | None = None,
    ):
        super().__init__("vecDateList", uid=uid)
        if reference_date_ms is None:
            reference_date_ms = int(
                _dt.datetime.now(tz=_dt.timezone.utc).timestamp() * 1000
            )
        self.pivot = pivot
        self.reference_date_ms = reference_date_ms
        self.track_nulls = track_nulls

    def get_params(self):
        return {
            "pivot": self.pivot,
            "reference_date_ms": self.reference_date_ms,
            "track_nulls": self.track_nulls,
        }

    def _pivot_categories(self) -> tuple[str, ...]:
        if self.pivot == MODE_DAY:
            return _DAY_NAMES
        if self.pivot == MODE_MONTH:
            return _MONTH_NAMES
        if self.pivot == MODE_HOUR:
            return tuple(str(h) for h in range(24))
        return ()

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        blocks, metas = [], []
        for col, feat in zip(cols, self.input_features):
            assert isinstance(col, ListColumn)
            rows = col.to_list()
            metas_f: list[ColumnMeta] = []
            if self.pivot in (SINCE_FIRST, SINCE_LAST):
                out = np.zeros(
                    (num_rows, 1 + (1 if self.track_nulls else 0)), dtype=np.float32
                )
                for r, dates in enumerate(rows):
                    if not dates:
                        if self.track_nulls:
                            out[r, 1] = 1.0
                        continue
                    anchor = min(dates) if self.pivot == SINCE_FIRST else max(dates)
                    out[r, 0] = (self.reference_date_ms - float(anchor)) / _MS_PER_DAY
                metas_f.append(
                    ColumnMeta((feat.name,), feat.ftype.__name__,
                               descriptor_value=self.pivot)
                )
            else:
                cats = self._pivot_categories()
                out = np.zeros(
                    (num_rows, len(cats) + (1 if self.track_nulls else 0)),
                    dtype=np.float32,
                )
                for r, dates in enumerate(rows):
                    if not dates:
                        if self.track_nulls:
                            out[r, len(cats)] = 1.0
                        continue
                    comps = []
                    for msv in dates:
                        d = _dt.datetime.fromtimestamp(
                            msv / 1000.0, tz=_dt.timezone.utc
                        )
                        if self.pivot == MODE_DAY:
                            comps.append(d.weekday())
                        elif self.pivot == MODE_MONTH:
                            comps.append(d.month - 1)
                        else:
                            comps.append(d.hour)
                    out[r, _list_mode(comps)] = 1.0
                metas_f.extend(
                    ColumnMeta((feat.name,), feat.ftype.__name__,
                               grouping=feat.name, indicator_value=c)
                    for c in cats
                )
            if self.track_nulls:
                metas_f.append(
                    ColumnMeta((feat.name,), feat.ftype.__name__,
                               grouping=feat.name, indicator_value=NULL_STRING)
                )
            blocks.append(out)
            metas.append(metas_f)
        return blocks, metas


_GEO_COMPONENTS = ("lat", "lon", "accuracy")


def parse_geo(geo) -> tuple[float, float, float] | None:
    """One raw geolocation value -> (lat, lon, accuracy) or None for missing.
    Accuracy defaults to 0.0 (GeolocationAccuracy.Unknown) — the single
    shared parse so scalar and map geolocation features encode identically."""
    if not geo or len(geo) < 2:
        return None
    return (
        float(geo[0]),
        float(geo[1]),
        float(geo[2]) if len(geo) > 2 else 0.0,
    )


class GeolocationModel(VectorizerModel):
    def __init__(self, fills: list[list[float]], track_nulls: bool, **kw):
        super().__init__("vecGeo", **kw)
        self.fills = fills  # per-feature [lat, lon, acc] fill values
        self.track_nulls = track_nulls

    def get_params(self):
        return {"fills": self.fills, "track_nulls": self.track_nulls}

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        blocks, metas = [], []
        for fi, (col, feat) in enumerate(zip(cols, self.input_features)):
            fill = self.fills[fi]
            out = np.zeros(
                (num_rows, 3 + (1 if self.track_nulls else 0)), dtype=np.float32
            )
            for r, geo in enumerate(col.to_list()):
                parsed = parse_geo(geo)
                if parsed is not None:
                    out[r, :3] = parsed
                else:
                    out[r, :3] = fill
                    if self.track_nulls:
                        out[r, 3] = 1.0
            blocks.append(out)
            metas_f = [
                ColumnMeta((feat.name,), feat.ftype.__name__, descriptor_value=c)
                for c in _GEO_COMPONENTS
            ]
            if self.track_nulls:
                metas_f.append(
                    ColumnMeta((feat.name,), feat.ftype.__name__,
                               grouping=feat.name, indicator_value=NULL_STRING)
                )
            metas.append(metas_f)
        return blocks, metas


class GeolocationVectorizer(VectorizerEstimator):
    """Fill missing locations with the mean location (GeolocationVectorizer.scala)."""

    def __init__(
        self,
        fill_with_mean: bool = DEFAULTS.FillWithMean,
        fill_value: tuple[float, float, float] = (0.0, 0.0, 0.0),
        track_nulls: bool = DEFAULTS.TrackNulls,
        uid: str | None = None,
    ):
        super().__init__("vecGeo", uid=uid)
        self.fill_with_mean = fill_with_mean
        self.fill_value = tuple(fill_value)
        self.track_nulls = track_nulls

    def get_params(self):
        return {
            "fill_with_mean": self.fill_with_mean,
            "fill_value": list(self.fill_value),
            "track_nulls": self.track_nulls,
        }

    def fit_model(self, dataset: Dataset) -> GeolocationModel:
        fills = []
        for name in self.input_names:
            col = dataset[name]
            if self.fill_with_mean:
                acc = np.zeros(3, dtype=np.float64)
                cnt = 0
                for geo in col.to_list():
                    parsed = parse_geo(geo)
                    if parsed is not None:
                        acc += parsed
                        cnt += 1
                fills.append((acc / max(cnt, 1)).tolist())
            else:
                fills.append(list(self.fill_value))
        self.metadata["geoFills"] = fills
        return GeolocationModel(fills, self.track_nulls)


class TextListNullTransformer(VectorizerTransformer):
    """One empty-list indicator column per TextList input
    (TextListNullTransformer.scala: 1.0 when the list is empty/missing) —
    the null-tracking companion the reference pairs with hashed text
    lists."""

    def __init__(self, uid: str | None = None):
        super().__init__("textListNull", uid=uid)

    def get_params(self):
        return {}

    def blocks_for(self, cols, num_rows: int):
        blocks, metas = [], []
        for col, feat in zip(cols, self.input_features):
            values = col.to_list()
            out = np.zeros((num_rows, 1), dtype=np.float32)
            for r, v in enumerate(values):
                if not v:
                    out[r, 0] = 1.0
            blocks.append(out)
            metas.append([
                ColumnMeta((feat.name,), feat.ftype.__name__,
                           grouping=feat.name, indicator_value=NULL_STRING)
            ])
        return blocks, metas
