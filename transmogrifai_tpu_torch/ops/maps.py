"""Map-family vectorizers: per-key expansion with keys learned from data.

Reference: core/.../stages/impl/feature/OPMapVectorizer.scala (numeric maps:
per-key fill mean/mode/constant + null tracking), TextMapPivotVectorizer.scala
(per-key topK pivot for categorical maps, set-valued MultiPickListMap),
SmartTextMapVectorizer.scala (per-key pivot/hash/ignore decision),
GeolocationMapVectorizer.scala, DateMapVectorizer / DateMapToUnitCircleVectorizer,
and the PhoneMap default (Transmogrifier.scala:188-190).

Shared semantics: the key set of each map feature is learned at fit time
(sorted for determinism); keys are optionally cleaned (cleanKeys -> TextUtils
cleanString); transform expands each learned key into its own column block,
with per-key null indicators when track_nulls. Unseen keys at transform time
are ignored (the reference's behavior — the vector shape is fixed at fit).

Host numpy, as in ``transmogrifai_tpu/ops/maps.py``, on the featurize
plane: ``SmartTextMapVectorizer`` summarizes its keys on the featurize
pool, and ``SmartTextMapModel`` hashes through ``ops.text.hash_block`` (so
map values and text columns hash alike), a feature with a hashed key of 64
buckets or more assembling as a SparseMatrix from ``SPARSE_MIN_ROWS`` rows
on (``ops.text.hash_block_sparse``) outside a fused batch. ``DecisionTreeNumericMapBucketizer`` (the
per-key supervised binning) fits and encodes each key through
``ops/bucketizers.py``'s scalar helpers, as the reference does.
"""
from __future__ import annotations

import datetime as _dt
from collections import Counter
from functools import lru_cache
from typing import Sequence

import numpy as np

from ..dataset import Dataset
from ..stages.metadata import NULL_STRING, ColumnMeta
from ..featurize import engine as _engine
from ..featurize import parallel as _par
from ..types.columns import Column, MapColumn, SparseMatrix
from ..utils.text import clean_string, tokenize
from .base import VectorizerEstimator, VectorizerModel
from .categorical import pivot_block, pivot_metas, top_values
from .dates import unit_circle
from .lists import _GEO_COMPONENTS, parse_geo
from .defaults import DEFAULTS
from .phone import DEFAULT_REGION, is_valid_phone
from .text import (
    HASH,
    PIVOT,
    SPARSE_MIN_ROWS,
    batch_text_stats,
    decide_method,
    hash_block,
    hash_block_sparse,
)

_MS_PER_DAY = 86_400_000.0


@lru_cache(maxsize=65536)
def _clean_key_cached(k: str) -> str:
    # map keys repeat on every row — the clean_string regex runs once per
    # DISTINCT key per process instead of once per (row, key)
    return clean_string(k)


def _clean_key(k: str, clean_keys: bool) -> str:
    return _clean_key_cached(k) if clean_keys else k


def learn_keys(col: MapColumn, clean_keys: bool) -> list[str]:
    """Sorted distinct (cleaned) keys present in the column."""
    keys: set[str] = set()
    for m in col.values:
        for k in m:
            keys.add(_clean_key(k, clean_keys))
    return sorted(keys)


def map_rows(col: Column, clean_keys: bool) -> list[dict]:
    """Rows with cleaned keys (later duplicate keys win, as in the reference's
    map concatenation)."""
    out = []
    for m in col.to_list():
        out.append({_clean_key(k, clean_keys): v for k, v in (m or {}).items()})
    return out


def map_key_values(
    col: Column, clean_keys: bool, keys: list[str] | None = None
) -> dict[str, list]:
    """Per-key value columns in ONE pass over the rows — replaces the
    ``map_rows`` + per-key ``[m.get(k) for m in rows]`` pattern (which
    walked every row once per learned key). Later duplicate cleaned keys
    win, matching ``map_rows``. With ``keys`` given, unlearned keys are
    dropped; with ``keys=None`` the key set is DISCOVERED in the same
    pass (the fit path: ``learn_keys`` + extraction fused — rows before a
    key's first occurrence correctly read as missing)."""
    n = len(col)
    # one extraction pass per column per process phase: the fit walks the
    # rows, then the transform over the SAME column reuses its pass (the
    # cache lives on the column instance and dies with it)
    cached = getattr(col, "_extract_cache", None)
    if cached is not None and cached[0] == clean_keys:
        full = cached[1]
    else:
        full = {}
        cache = _clean_key_cached
        for r, m in enumerate(col.values):
            if m:
                for k, v in m.items():
                    if clean_keys:
                        k = cache(k)
                    lst = full.get(k)
                    if lst is None:
                        lst = full[k] = [None] * n
                    lst[r] = v
        try:
            col._extract_cache = (clean_keys, full)
        except Exception:  # pragma: no cover - exotic column type
            pass
    if keys is None:
        return full
    return {k: full.get(k) or [None] * n for k in keys}


class RealMapModel(VectorizerModel):
    """Fitted numeric-map vectorizer: per-key value + fill + null indicator."""

    def __init__(self, keys: list[list[str]], fills: list[list[float]],
                 clean_keys: bool, track_nulls: bool, **kw):
        super().__init__("vecRealMap", **kw)
        self.keys = keys
        self.fills = fills
        self.clean_keys = clean_keys
        self.track_nulls = track_nulls

    def get_params(self):
        return {
            "keys": self.keys,
            "fills": self.fills,
            "clean_keys": self.clean_keys,
            "track_nulls": self.track_nulls,
        }

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        blocks, metas = [], []
        for fi, (col, feat) in enumerate(zip(cols, self.input_features)):
            keys, fills = self.keys[fi], self.fills[fi]
            per_key = 2 if self.track_nulls else 1
            out = np.zeros((num_rows, len(keys) * per_key), dtype=np.float32)
            by_key = map_key_values(col, self.clean_keys, keys)
            for j, (k, fill) in enumerate(zip(keys, fills)):
                lst = by_key[k]
                present = np.fromiter(
                    (v is not None for v in lst), bool, num_rows
                )
                try:
                    vals = np.asarray(lst, dtype=np.float64)  # None -> nan
                except (TypeError, ValueError):
                    vals = np.asarray(
                        [np.nan if v is None else float(v) for v in lst],
                        dtype=np.float64,
                    )
                out[:, j * per_key] = np.where(present, vals, fill)
                if self.track_nulls:
                    out[:, j * per_key + 1] = ~present
            metas_f: list[ColumnMeta] = []
            for k in keys:
                metas_f.append(
                    ColumnMeta((feat.name,), feat.ftype.__name__, grouping=k)
                )
                if self.track_nulls:
                    metas_f.append(
                        ColumnMeta((feat.name,), feat.ftype.__name__,
                                   grouping=k, indicator_value=NULL_STRING)
                    )
            blocks.append(out)
            metas.append(metas_f)
        return blocks, metas


class RealMapVectorizer(VectorizerEstimator):
    """Numeric-map vectorizer (OPMapVectorizer.scala family).

    fill: "mean" (Real/Currency/Percent maps), "mode" (IntegralMap), or
    "constant" (BinaryMap / explicit fill_value).
    """

    def __init__(
        self,
        fill: str = "mean",
        fill_value: float = DEFAULTS.FillValue,
        clean_keys: bool = DEFAULTS.CleanKeys,
        track_nulls: bool = DEFAULTS.TrackNulls,
        uid: str | None = None,
    ):
        super().__init__("vecRealMap", uid=uid)
        assert fill in ("mean", "mode", "constant"), fill
        self.fill = fill
        self.fill_value = fill_value
        self.clean_keys = clean_keys
        self.track_nulls = track_nulls

    def get_params(self):
        return {
            "fill": self.fill,
            "fill_value": self.fill_value,
            "clean_keys": self.clean_keys,
            "track_nulls": self.track_nulls,
        }

    def fit_model(self, dataset: Dataset) -> RealMapModel:
        all_keys, all_fills = [], []
        for name in self.input_names:
            col = dataset[name]
            keys = learn_keys(col, self.clean_keys)
            rows = map_rows(col, self.clean_keys)
            fills = []
            for k in keys:
                vals = [float(m[k]) for m in rows if m.get(k) is not None]
                if self.fill == "constant" or not vals:
                    fills.append(float(self.fill_value))
                elif self.fill == "mean":
                    fills.append(float(np.mean(vals)))
                else:  # mode, ties to smallest (SequenceAggregators.ModeSeqMapLong)
                    c = Counter(vals)
                    fills.append(float(min(c, key=lambda v: (-c[v], v))))
            all_keys.append(keys)
            all_fills.append(fills)
        self.metadata["mapKeys"] = all_keys
        self.metadata["mapFills"] = all_fills
        return RealMapModel(all_keys, all_fills, self.clean_keys, self.track_nulls)


class DateMapModel(VectorizerModel):
    def __init__(self, keys: list[list[str]], reference_date_ms: int,
                 circular_reps: list[str], clean_keys: bool, track_nulls: bool,
                 **kw):
        super().__init__("vecDateMap", **kw)
        self.keys = keys
        self.reference_date_ms = reference_date_ms
        self.circular_reps = list(circular_reps)
        self.clean_keys = clean_keys
        self.track_nulls = track_nulls

    def get_params(self):
        return {
            "keys": self.keys,
            "reference_date_ms": self.reference_date_ms,
            "circular_reps": self.circular_reps,
            "clean_keys": self.clean_keys,
            "track_nulls": self.track_nulls,
        }

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        blocks, metas = [], []
        for fi, (col, feat) in enumerate(zip(cols, self.input_features)):
            keys = self.keys[fi]
            rows = map_rows(col, self.clean_keys)
            parts, metas_f = [], []
            for k in keys:
                vals = np.zeros(num_rows, dtype=np.int64)
                mask = np.zeros(num_rows, dtype=bool)
                for r, m in enumerate(rows):
                    v = m.get(k)
                    if v is not None:
                        vals[r] = int(v)
                        mask[r] = True
                for period in self.circular_reps:
                    parts.append(unit_circle(vals, mask, period))
                    for comp in ("x", "y"):
                        metas_f.append(
                            ColumnMeta((feat.name,), feat.ftype.__name__,
                                       grouping=k,
                                       descriptor_value=f"{comp}_{period}")
                        )
                days = (self.reference_date_ms - vals.astype(np.float64)) / _MS_PER_DAY
                days = np.where(mask, days, 0.0)
                parts.append(days[:, None])
                metas_f.append(
                    ColumnMeta((feat.name,), feat.ftype.__name__,
                               grouping=k, descriptor_value="SinceLast")
                )
                if self.track_nulls:
                    parts.append((~mask).astype(np.float64)[:, None])
                    metas_f.append(
                        ColumnMeta((feat.name,), feat.ftype.__name__,
                                   grouping=k, indicator_value=NULL_STRING)
                    )
            blocks.append(
                np.concatenate(parts, axis=1)
                if parts else np.zeros((num_rows, 0), dtype=np.float64)
            )
            metas.append(metas_f)
        return blocks, metas


class DateMapVectorizer(VectorizerEstimator):
    """Per-key circular date encodings + days-since-reference
    (DateMapToUnitCircleVectorizer + DateMapVectorizer)."""

    def __init__(
        self,
        reference_date_ms: int | None = None,
        circular_reps: Sequence[str] = DEFAULTS.CircularDateRepresentations,
        clean_keys: bool = DEFAULTS.CleanKeys,
        track_nulls: bool = DEFAULTS.TrackNulls,
        uid: str | None = None,
    ):
        super().__init__("vecDateMap", uid=uid)
        if reference_date_ms is None:
            reference_date_ms = int(
                _dt.datetime.now(tz=_dt.timezone.utc).timestamp() * 1000
            )
        self.reference_date_ms = reference_date_ms
        self.circular_reps = tuple(circular_reps)
        self.clean_keys = clean_keys
        self.track_nulls = track_nulls

    def get_params(self):
        return {
            "reference_date_ms": self.reference_date_ms,
            "circular_reps": list(self.circular_reps),
            "clean_keys": self.clean_keys,
            "track_nulls": self.track_nulls,
        }

    def fit_model(self, dataset: Dataset) -> DateMapModel:
        keys = [learn_keys(dataset[n], self.clean_keys) for n in self.input_names]
        self.metadata["mapKeys"] = keys
        return DateMapModel(
            keys, self.reference_date_ms, list(self.circular_reps),
            self.clean_keys, self.track_nulls,
        )


def _pivot_key_metas(name: str, parent_type: type, key: str, vocab: list[str],
                     track_nulls: bool) -> list[ColumnMeta]:
    return pivot_metas(name, parent_type, vocab, track_nulls, grouping=key)


class TextMapPivotModel(VectorizerModel):
    def __init__(self, keys: list[list[str]], vocabs: list[list[list[str]]],
                 clean_keys: bool, clean_text: bool, track_nulls: bool, **kw):
        super().__init__("pivotTextMap", **kw)
        self.keys = keys
        self.vocabs = vocabs  # per-feature, per-key vocab
        self.clean_keys = clean_keys
        self.clean_text = clean_text
        self.track_nulls = track_nulls

    def get_params(self):
        return {
            "keys": self.keys,
            "vocabs": self.vocabs,
            "clean_keys": self.clean_keys,
            "clean_text": self.clean_text,
            "track_nulls": self.track_nulls,
        }

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        blocks, metas = [], []
        for fi, (col, feat) in enumerate(zip(cols, self.input_features)):
            by_key = map_key_values(col, self.clean_keys, self.keys[fi])
            parts, metas_f = [], []
            for ki, k in enumerate(self.keys[fi]):
                vocab = self.vocabs[fi][ki]
                values = by_key[k]
                is_set = any(
                    isinstance(v, (set, frozenset, list, tuple)) for v in values
                )
                if is_set:
                    values = [
                        v if v is None or isinstance(v, (set, frozenset, list, tuple))
                        else (v,)
                        for v in values
                    ]
                parts.append(
                    pivot_block(values, vocab, self.track_nulls, self.clean_text,
                                is_set)
                )
                metas_f.extend(
                    _pivot_key_metas(feat.name, feat.ftype, k, vocab,
                                     self.track_nulls)
                )
            blocks.append(
                np.concatenate(parts, axis=1)
                if parts else np.zeros((num_rows, 0), dtype=np.float64)
            )
            metas.append(metas_f)
        return blocks, metas


class TextMapPivotVectorizer(VectorizerEstimator):
    """Per-key topK pivot for categorical maps (TextMapPivotVectorizer.scala);
    set-valued maps (MultiPickListMap) pivot each member."""

    def __init__(
        self,
        top_k: int = DEFAULTS.TopK,
        min_support: int = DEFAULTS.MinSupport,
        clean_text: bool = DEFAULTS.CleanText,
        clean_keys: bool = DEFAULTS.CleanKeys,
        track_nulls: bool = DEFAULTS.TrackNulls,
        uid: str | None = None,
    ):
        super().__init__("pivotTextMap", uid=uid)
        self.top_k = top_k
        self.min_support = min_support
        self.clean_text = clean_text
        self.clean_keys = clean_keys
        self.track_nulls = track_nulls

    def get_params(self):
        return {
            "top_k": self.top_k,
            "min_support": self.min_support,
            "clean_text": self.clean_text,
            "clean_keys": self.clean_keys,
            "track_nulls": self.track_nulls,
        }

    def fit_model(self, dataset: Dataset) -> TextMapPivotModel:
        all_keys, all_vocabs = [], []
        for name in self.input_names:
            col = dataset[name]
            keys = learn_keys(col, self.clean_keys)
            rows = map_rows(col, self.clean_keys)
            vocabs = []
            for k in keys:
                counts: Counter = Counter()
                for m in rows:
                    v = m.get(k)
                    if v is None:
                        continue
                    members = (
                        v if isinstance(v, (set, frozenset, list, tuple)) else (v,)
                    )
                    for mem in members:
                        mem2 = clean_string(str(mem)) if self.clean_text else str(mem)
                        counts[mem2] += 1
                vocabs.append(top_values(counts, self.top_k, self.min_support))
            all_keys.append(keys)
            all_vocabs.append(vocabs)
        self.metadata["mapKeys"] = all_keys
        self.metadata["mapVocabs"] = all_vocabs
        return TextMapPivotModel(
            all_keys, all_vocabs, self.clean_keys, self.clean_text,
            self.track_nulls,
        )


class SmartTextMapModel(VectorizerModel):
    def __init__(self, keys: list[list[str]], methods: list[list[str]],
                 vocabs: list[list[list[str]]], num_hashes: int,
                 clean_keys: bool, clean_text: bool, track_nulls: bool, **kw):
        super().__init__("smartTxtMap", **kw)
        self.keys = keys
        self.methods = methods
        self.vocabs = vocabs
        self.num_hashes = num_hashes
        self.clean_keys = clean_keys
        self.clean_text = clean_text
        self.track_nulls = track_nulls

    def get_params(self):
        return {
            "keys": self.keys,
            "methods": self.methods,
            "vocabs": self.vocabs,
            "num_hashes": self.num_hashes,
            "clean_keys": self.clean_keys,
            "clean_text": self.clean_text,
            "track_nulls": self.track_nulls,
        }

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        blocks, metas = [], []
        slot = 0
        nulls = 1 if self.track_nulls else 0
        for fi, (col, feat) in enumerate(zip(cols, self.input_features)):
            by_key = map_key_values(col, self.clean_keys, self.keys[fi])
            widths = []
            for ki, k in enumerate(self.keys[fi]):
                method = self.methods[fi][ki]
                if method == PIVOT:
                    widths.append(len(self.vocabs[fi][ki]) + 1 + nulls)
                elif method == HASH:
                    widths.append(self.num_hashes + nulls)
                else:
                    widths.append(nulls)
            if (
                HASH in self.methods[fi]
                and self.num_hashes >= 64
                and num_rows >= SPARSE_MIN_ROWS
                and not _engine.sink_active(self.uid)
            ):
                sparse = self._feature_sparse(fi, feat, by_key, widths,
                                              num_rows, slot)
                if sparse is not None:
                    blocks.append(sparse[0])
                    metas.append(sparse[1])
                    slot += len(self.keys[fi])
                    continue
            # one float32 buffer per map feature; hash keys scatter into it
            out = np.zeros((num_rows, sum(widths)), dtype=np.float32)
            metas_f: list[ColumnMeta] = []
            off = 0
            for ki, (k, width) in enumerate(zip(self.keys[fi], widths)):
                method = self.methods[fi][ki]
                values = [
                    None if v is None else str(v) for v in by_key[k]
                ]
                if method == PIVOT:
                    out[:, off:off + width] = pivot_block(
                        values, self.vocabs[fi][ki], self.track_nulls,
                        self.clean_text, False,
                    )
                elif method == HASH:
                    hash_block(values, feature_slot=slot, out=out,
                               col_offset=off, **self._hash_kw())
                elif self.track_nulls:  # IGNORE
                    for r, v in enumerate(values):
                        if v is None:
                            out[r, off] = 1.0
                metas_f.extend(self._key_metas(fi, ki, feat))
                slot += 1
                off += width
            blocks.append(out)
            metas.append(metas_f)
        return blocks, metas

    def _hash_kw(self) -> dict:
        return dict(
            num_features=self.num_hashes, shared=False,
            binary_freq=DEFAULTS.BinaryFreq,
            to_lowercase=DEFAULTS.ToLowercase,
            min_token_length=DEFAULTS.MinTokenLength,
            seed=DEFAULTS.HashSeed, track_nulls=self.track_nulls,
        )

    def _key_metas(self, fi: int, ki: int, feat) -> list[ColumnMeta]:
        k = self.keys[fi][ki]
        method = self.methods[fi][ki]
        if method == PIVOT:
            return _pivot_key_metas(feat.name, feat.ftype, k,
                                    self.vocabs[fi][ki], self.track_nulls)
        metas = []
        if method == HASH:
            metas = [
                ColumnMeta((feat.name,), feat.ftype.__name__,
                           grouping=k, descriptor_value=f"hash_{j}")
                for j in range(self.num_hashes)
            ]
        if self.track_nulls:
            metas.append(
                ColumnMeta((feat.name,), feat.ftype.__name__,
                           grouping=k, indicator_value=NULL_STRING)
            )
        return metas

    def _feature_sparse(self, fi, feat, by_key, widths, num_rows, slot):
        """One map feature's block as a SparseMatrix and its metas, or None
        when a hashed key has rows the native COO pass cannot take."""
        blocks, metas_f, used_widths = [], [], []
        for ki, (k, width) in enumerate(zip(self.keys[fi], widths)):
            method = self.methods[fi][ki]
            if width:
                values = [None if v is None else str(v) for v in by_key[k]]
                if method == PIVOT:
                    block = pivot_block(values, self.vocabs[fi][ki],
                                        self.track_nulls, self.clean_text,
                                        False)
                elif method == HASH:
                    block = hash_block_sparse(values, feature_slot=slot,
                                              **self._hash_kw())
                    if block is None:
                        return None
                else:  # IGNORE with track_nulls
                    nr = np.asarray(
                        [r for r, v in enumerate(values) if v is None],
                        dtype=np.int32,
                    )
                    block = SparseMatrix(nr, np.zeros(len(nr), np.int32),
                                         (num_rows, 1))
                blocks.append(block)
                used_widths.append(width)
                metas_f.extend(self._key_metas(fi, ki, feat))
            slot += 1
        return SparseMatrix.hstack(blocks, used_widths, num_rows), metas_f


class SmartTextMapVectorizer(VectorizerEstimator):
    """Per-(feature, key) pivot/hash/ignore decision
    (SmartTextMapVectorizer.scala)."""

    def __init__(
        self,
        max_cardinality: int = DEFAULTS.MaxCategoricalCardinality,
        top_k: int = DEFAULTS.TopK,
        min_support: int = DEFAULTS.MinSupport,
        coverage_pct: float = DEFAULTS.CoveragePct,
        min_length_std_dev: float = 0.0,
        num_hashes: int = DEFAULTS.DefaultNumOfFeatures,
        clean_text: bool = DEFAULTS.CleanText,
        clean_keys: bool = DEFAULTS.CleanKeys,
        track_nulls: bool = DEFAULTS.TrackNulls,
        uid: str | None = None,
    ):
        super().__init__("smartTxtMap", uid=uid)
        self.max_cardinality = max_cardinality
        self.top_k = top_k
        self.min_support = min_support
        self.coverage_pct = coverage_pct
        self.min_length_std_dev = min_length_std_dev
        self.num_hashes = num_hashes
        self.clean_text = clean_text
        self.clean_keys = clean_keys
        self.track_nulls = track_nulls

    def get_params(self):
        return {
            "max_cardinality": self.max_cardinality,
            "top_k": self.top_k,
            "min_support": self.min_support,
            "coverage_pct": self.coverage_pct,
            "min_length_std_dev": self.min_length_std_dev,
            "num_hashes": self.num_hashes,
            "clean_text": self.clean_text,
            "clean_keys": self.clean_keys,
            "track_nulls": self.track_nulls,
        }

    def fit_model(self, dataset: Dataset) -> SmartTextMapModel:
        all_keys, all_methods, all_vocabs, summaries = [], [], [], []
        for name in self.input_names:
            col = dataset[name]
            by_key = map_key_values(col, self.clean_keys)
            keys = sorted(by_key)
            methods, vocabs = [], []
            # the keys' statistics fan out across the pool (their native
            # passes release the interpreter lock)
            key_stats = _par.run_tasks([
                lambda k=k: batch_text_stats(
                    by_key[k], self.max_cardinality, self.clean_text)
                for k in keys
            ])
            for k, stats in zip(keys, key_stats):
                method = decide_method(
                    stats, self.max_cardinality, self.top_k, self.min_support,
                    self.coverage_pct, self.min_length_std_dev,
                )
                vocab = (
                    top_values(stats.value_counts, self.top_k, self.min_support)
                    if method == PIVOT else []
                )
                methods.append(method)
                vocabs.append(vocab)
                summaries.append({"feature": name, "key": k, "method": method,
                                  "cardinality": stats.cardinality})
            all_keys.append(keys)
            all_methods.append(methods)
            all_vocabs.append(vocabs)
        self.metadata["textMapStats"] = summaries
        return SmartTextMapModel(
            all_keys, all_methods, all_vocabs, self.num_hashes,
            self.clean_keys, self.clean_text, self.track_nulls,
        )


class GeolocationMapModel(VectorizerModel):
    def __init__(self, keys: list[list[str]], clean_keys: bool,
                 track_nulls: bool, **kw):
        super().__init__("vecGeoMap", **kw)
        self.keys = keys
        self.clean_keys = clean_keys
        self.track_nulls = track_nulls

    def get_params(self):
        return {
            "keys": self.keys,
            "clean_keys": self.clean_keys,
            "track_nulls": self.track_nulls,
        }

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        blocks, metas = [], []
        for fi, (col, feat) in enumerate(zip(cols, self.input_features)):
            keys = self.keys[fi]
            rows = map_rows(col, self.clean_keys)
            per_key = 3 + (1 if self.track_nulls else 0)
            out = np.zeros((num_rows, len(keys) * per_key), dtype=np.float64)
            for r, m in enumerate(rows):
                for j, k in enumerate(keys):
                    parsed = parse_geo(m.get(k))
                    base = j * per_key
                    if parsed is not None:
                        out[r, base:base + 3] = parsed
                    elif self.track_nulls:
                        out[r, base + 3] = 1.0
            metas_f: list[ColumnMeta] = []
            for k in keys:
                metas_f.extend(
                    ColumnMeta((feat.name,), feat.ftype.__name__, grouping=k,
                               descriptor_value=c)
                    for c in _GEO_COMPONENTS
                )
                if self.track_nulls:
                    metas_f.append(
                        ColumnMeta((feat.name,), feat.ftype.__name__,
                                   grouping=k, indicator_value=NULL_STRING)
                    )
            blocks.append(out)
            metas.append(metas_f)
        return blocks, metas


class GeolocationMapVectorizer(VectorizerEstimator):
    """Per-key (lat, lon, accuracy) expansion (GeolocationMapVectorizer.scala)."""

    def __init__(
        self,
        clean_keys: bool = DEFAULTS.CleanKeys,
        track_nulls: bool = DEFAULTS.TrackNulls,
        uid: str | None = None,
    ):
        super().__init__("vecGeoMap", uid=uid)
        self.clean_keys = clean_keys
        self.track_nulls = track_nulls

    def get_params(self):
        return {"clean_keys": self.clean_keys, "track_nulls": self.track_nulls}

    def fit_model(self, dataset: Dataset) -> GeolocationMapModel:
        keys = [learn_keys(dataset[n], self.clean_keys) for n in self.input_names]
        self.metadata["mapKeys"] = keys
        return GeolocationMapModel(keys, self.clean_keys, self.track_nulls)


class PhoneMapModel(VectorizerModel):
    def __init__(self, keys: list[list[str]], default_region: str,
                 clean_keys: bool, track_nulls: bool, **kw):
        super().__init__("vecPhoneMap", **kw)
        self.keys = keys
        self.default_region = default_region
        self.clean_keys = clean_keys
        self.track_nulls = track_nulls

    def get_params(self):
        return {
            "keys": self.keys,
            "default_region": self.default_region,
            "clean_keys": self.clean_keys,
            "track_nulls": self.track_nulls,
        }

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        blocks, metas = [], []
        for fi, (col, feat) in enumerate(zip(cols, self.input_features)):
            keys = self.keys[fi]
            rows = map_rows(col, self.clean_keys)
            per_key = 2 if self.track_nulls else 1
            out = np.zeros((num_rows, len(keys) * per_key), dtype=np.float64)
            for r, m in enumerate(rows):
                for j, k in enumerate(keys):
                    v = m.get(k)
                    valid = is_valid_phone(None if v is None else str(v),
                                           self.default_region)
                    if valid is None:
                        if self.track_nulls:
                            out[r, j * per_key + 1] = 1.0
                    elif valid:
                        out[r, j * per_key] = 1.0
            metas_f: list[ColumnMeta] = []
            for k in keys:
                metas_f.append(
                    ColumnMeta((feat.name,), feat.ftype.__name__, grouping=k,
                               descriptor_value="isValidPhone")
                )
                if self.track_nulls:
                    metas_f.append(
                        ColumnMeta((feat.name,), feat.ftype.__name__,
                                   grouping=k, indicator_value=NULL_STRING)
                    )
            blocks.append(out)
            metas.append(metas_f)
        return blocks, metas


class PhoneMapVectorizer(VectorizerEstimator):
    """Per-key phone validity (Transmogrifier PhoneMap default)."""

    def __init__(
        self,
        default_region: str = DEFAULT_REGION,
        clean_keys: bool = DEFAULTS.CleanKeys,
        track_nulls: bool = DEFAULTS.TrackNulls,
        uid: str | None = None,
    ):
        super().__init__("vecPhoneMap", uid=uid)
        self.default_region = default_region
        self.clean_keys = clean_keys
        self.track_nulls = track_nulls

    def get_params(self):
        return {
            "default_region": self.default_region,
            "clean_keys": self.clean_keys,
            "track_nulls": self.track_nulls,
        }

    def fit_model(self, dataset: Dataset) -> PhoneMapModel:
        keys = [learn_keys(dataset[n], self.clean_keys) for n in self.input_names]
        self.metadata["mapKeys"] = keys
        return PhoneMapModel(
            keys, self.default_region, self.clean_keys, self.track_nulls
        )


class TextMapNullModel(VectorizerModel):
    def __init__(self, keys: list[list[str]], clean_keys: bool, **kw):
        super().__init__("textMapNull", **kw)
        self.keys = keys
        self.clean_keys = clean_keys

    def get_params(self):
        return {"keys": self.keys, "clean_keys": self.clean_keys}

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        blocks, metas = [], []
        for fi, (col, feat) in enumerate(zip(cols, self.input_features)):
            keys = self.keys[fi]
            rows = map_rows(col, self.clean_keys)
            out = np.zeros((num_rows, len(keys)), dtype=np.float32)
            for r, m in enumerate(rows):
                for j, k in enumerate(keys):
                    if m.get(k) is None:
                        out[r, j] = 1.0
            blocks.append(out)
            metas.append([
                ColumnMeta((feat.name,), feat.ftype.__name__, grouping=k,
                           indicator_value=NULL_STRING)
                for k in keys
            ])
        return blocks, metas


class TextMapNullEstimator(VectorizerEstimator):
    """Per-key null indicators for text maps (TextMapNullEstimator.scala) —
    the null-tracking companion the reference pairs with hashed text maps."""

    def __init__(self, clean_keys: bool = DEFAULTS.CleanKeys,
                 uid: str | None = None):
        super().__init__("textMapNull", uid=uid)
        self.clean_keys = clean_keys

    def get_params(self):
        return {"clean_keys": self.clean_keys}

    def fit_model(self, dataset: Dataset) -> TextMapNullModel:
        keys = [
            learn_keys(dataset[n], self.clean_keys) for n in self.input_names
        ]
        self.metadata["mapKeys"] = keys
        return TextMapNullModel(keys, self.clean_keys)


class TextMapLenModel(VectorizerModel):
    def __init__(self, keys: list[list[str]], clean_keys: bool, **kw):
        super().__init__("textLenMap", **kw)
        self.keys = keys
        self.clean_keys = clean_keys

    def get_params(self):
        return {"keys": self.keys, "clean_keys": self.clean_keys}

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        blocks, metas = [], []
        for fi, (col, feat) in enumerate(zip(cols, self.input_features)):
            keys = self.keys[fi]
            rows = map_rows(col, self.clean_keys)
            out = np.zeros((num_rows, len(keys)), dtype=np.float32)
            for r, m in enumerate(rows):
                for j, k in enumerate(keys):
                    v = m.get(k)
                    if v is not None:
                        out[r, j] = float(
                            sum(len(t) for t in tokenize(str(v)))
                        )
            blocks.append(out)
            metas.append([
                ColumnMeta((feat.name,), feat.ftype.__name__, grouping=k,
                           descriptor_value="TextLen")
                for k in keys
            ])
        return blocks, metas


class TextMapLenEstimator(VectorizerEstimator):
    """Per-key summed token lengths for text maps
    (TextMapLenEstimator.scala / TextMapLenModel: tokenize each value,
    sum token character lengths; missing key → 0). Feeds the LOCO text
    aggregation the reference builds on text-length columns."""

    def __init__(self, clean_keys: bool = DEFAULTS.CleanKeys,
                 uid: str | None = None):
        super().__init__("textLenMap", uid=uid)
        self.clean_keys = clean_keys

    def get_params(self):
        return {"clean_keys": self.clean_keys}

    def fit_model(self, dataset: Dataset) -> TextMapLenModel:
        keys = [
            learn_keys(dataset[n], self.clean_keys) for n in self.input_names
        ]
        self.metadata["mapKeys"] = keys
        return TextMapLenModel(keys, self.clean_keys)


class DecisionTreeNumericMapBucketizerModel(VectorizerModel):
    """Fitted per-key supervised binning of numeric maps: input 0 is the
    label (supervision only), the rest are the maps."""

    def __init__(self, keys: list[list[str]], splits: list[list[list[float]]],
                 should_split: list[list[bool]], clean_keys: bool,
                 track_nulls: bool, track_invalid: bool, **kw):
        super().__init__("dtNumericMapBucketized", **kw)
        self.keys = keys
        self.splits = splits
        self.should_split = should_split
        self.clean_keys = clean_keys
        self.track_nulls = track_nulls
        self.track_invalid = track_invalid

    def get_params(self):
        return {
            "keys": self.keys,
            "splits": self.splits,
            "should_split": self.should_split,
            "clean_keys": self.clean_keys,
            "track_nulls": self.track_nulls,
            "track_invalid": self.track_invalid,
        }

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        # the per-key encoding, labels and invalid routing are the scalar
        # bucketizer's, so both variants agree
        import dataclasses

        from .bucketizers import _bucket_metas, _encode

        blocks, metas = [], []
        for fi, (col, feat) in enumerate(
            zip(cols[1:], self.input_features[1:])
        ):
            keys = self.keys[fi]
            rows = map_rows(col, self.clean_keys)
            parts, metas_f = [], []
            for ki, k in enumerate(keys):
                should = self.should_split[fi][ki]
                vals = np.full(num_rows, np.nan, dtype=np.float64)
                mask = np.zeros(num_rows, dtype=bool)
                for r, m in enumerate(rows):
                    v = m.get(k)
                    if v is not None:
                        vals[r] = float(v)
                        mask[r] = True
                if not should:
                    # no useful split: null indicator only (scalar parity)
                    if self.track_nulls:
                        parts.append((~mask).astype(np.float32)[:, None])
                        metas_f.append(
                            ColumnMeta((feat.name,), feat.ftype.__name__,
                                       grouping=k,
                                       indicator_value=NULL_STRING)
                        )
                    continue
                splits = np.asarray(self.splits[fi][ki], dtype=np.float64)
                parts.append(
                    _encode(vals, mask, splits, self.track_nulls,
                            self.track_invalid)
                )
                metas_f.extend(
                    dataclasses.replace(m_, grouping=k)
                    for m_ in _bucket_metas(
                        feat.name, feat.ftype.__name__, splits,
                        self.track_nulls, self.track_invalid,
                    )
                )
            blocks.append(
                np.concatenate(parts, axis=1)
                if parts else np.zeros((num_rows, 0), dtype=np.float32)
            )
            metas.append(metas_f)
        return blocks, metas


class DecisionTreeNumericMapBucketizer(VectorizerEstimator):
    """Supervised per-key binning of numeric maps
    (DecisionTreeNumericMapBucketizer.scala): each learned key's values fit
    a single-feature decision tree against the label — keys whose tree
    finds no informative split emit only their null indicator, exactly
    like the scalar DecisionTreeNumericBucketizer."""

    def __init__(
        self,
        max_depth: int = 5,
        min_info_gain: float = 1e-7,
        clean_keys: bool = DEFAULTS.CleanKeys,
        track_nulls: bool = DEFAULTS.TrackNulls,
        track_invalid: bool = True,
        uid: str | None = None,
    ):
        super().__init__("dtNumericMapBucketized", uid=uid)
        self.max_depth = max_depth
        self.min_info_gain = min_info_gain
        self.clean_keys = clean_keys
        self.track_nulls = track_nulls
        self.track_invalid = track_invalid

    def get_params(self):
        return {
            "max_depth": self.max_depth,
            "min_info_gain": self.min_info_gain,
            "clean_keys": self.clean_keys,
            "track_nulls": self.track_nulls,
            "track_invalid": self.track_invalid,
        }

    def fit_model(self, dataset: Dataset) -> DecisionTreeNumericMapBucketizerModel:
        from ..types.columns import NumericColumn
        from .bucketizers import _tree_splits

        label_name = self.input_names[0]
        label = dataset[label_name]
        assert isinstance(label, NumericColumn)
        all_keys, all_splits, all_should = [], [], []
        for name in self.input_names[1:]:
            col = dataset[name]
            keys = learn_keys(col, self.clean_keys)
            rows = map_rows(col, self.clean_keys)
            splits_f, should_f = [], []
            for k in keys:
                xs, ys = [], []
                for m, lv, lm in zip(rows, label.values, label.mask):
                    v = m.get(k)
                    if v is not None and lm and np.isfinite(float(v)):
                        xs.append(float(v))
                        ys.append(float(lv))
                inner = (
                    _tree_splits(
                        np.asarray(xs), np.asarray(ys),
                        max_depth=self.max_depth,
                        min_info_gain=self.min_info_gain,
                    )
                    if xs else np.zeros(0)
                )
                should = inner.size > 0
                splits = (
                    np.concatenate(([-np.inf], inner, [np.inf]))
                    if should else np.array([-np.inf, np.inf])
                )
                splits_f.append([float(s) for s in splits])
                should_f.append(bool(should))
            all_keys.append(keys)
            all_splits.append(splits_f)
            all_should.append(should_f)
        self.metadata["mapKeys"] = all_keys
        self.metadata["shouldSplit"] = all_should
        return DecisionTreeNumericMapBucketizerModel(
            all_keys, all_splits, all_should, self.clean_keys,
            self.track_nulls, self.track_invalid,
        )
