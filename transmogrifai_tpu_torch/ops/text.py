"""Text hashing + SmartText vectorizers.

SmartTextVectorizer (SmartTextVectorizer.scala:79-132) summarizes each text
field (TextStats: value counts with a cardinality cap, and the token-length
distribution), then decides per field, with transmogrify's defaults
max_cardinality=30, top_k=20, coverage_pct=0.90, min_length_std_dev=0:
  1. card > max_cardinality and card > top_k and coverage(topK) >= coverage_pct -> Pivot
  2. card <= max_cardinality -> Pivot
  3. token-length stddev < min_length_std_dev -> Ignore
  4. otherwise -> Hash (MurmurHash3 of the tokens into ``num_hashes`` buckets)

This is the reference's Python route (``transmogrifai_tpu/ops/text.py``),
the one it takes for a column its native library cannot take, with one
detail of the native route kept: a token of an ASCII row longer than 255
characters counts in the length histogram as 255. The hash plane is
assembled dense at every row count (the reference switches to a sparse COO
plane at ``SPARSE_MIN_ROWS`` rows; its densified values are the same).
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from functools import lru_cache
from itertools import islice
from typing import Sequence

import numpy as np

from ..stages.metadata import NULL_STRING, ColumnMeta
from ..types.columns import Column, TextColumn
from ..utils.text import clean_string, murmur3_32, tokenize
from .base import VectorizerEstimator, VectorizerModel
from .categorical import pivot_block, pivot_metas, top_values
from .defaults import DEFAULTS

PIVOT, HASH, IGNORE = "Pivot", "Hash", "Ignore"

#: the reference's native token-length histogram has this many bins; longer
#: tokens of ASCII rows land in the last one
_NATIVE_HIST_BINS = 256


@dataclasses.dataclass
class TextStats:
    """Monoid summary of one text field: value counts (cardinality-capped)
    and the token-length distribution."""

    value_counts: Counter
    length_counts: Counter
    cardinality_cap: int

    @staticmethod
    def empty(cap: int) -> "TextStats":
        return TextStats(Counter(), Counter(), cap)

    def add(self, cleaned: str, tokens: list[str]) -> None:
        # once the cardinality exceeds the cap, new keys are not added
        # (existing keys keep counting): the monoid stays bounded
        if cleaned in self.value_counts or len(self.value_counts) <= self.cardinality_cap:
            self.value_counts[cleaned] += 1
        for t in tokens:
            self.length_counts[len(t)] += 1

    @property
    def cardinality(self) -> int:
        return len(self.value_counts)

    def length_std(self) -> float:
        total = sum(self.length_counts.values())
        if total == 0:
            return 0.0
        mean = sum(k * c for k, c in self.length_counts.items()) / total
        var = sum(c * (k - mean) ** 2 for k, c in self.length_counts.items()) / total
        return float(np.sqrt(var))

    def coverage(self, top_k: int, min_support: int) -> float:
        total = sum(self.value_counts.values())
        if total == 0:
            return 0.0
        filtered = sorted(
            (c for c in self.value_counts.values() if c >= min_support), reverse=True
        )
        return sum(filtered[:top_k]) / total


def _partition_nulls(values) -> tuple[list, np.ndarray]:
    """(non-null texts, their int64 row indices); non-str values are
    coerced with ``str``."""
    arr = (
        values
        if isinstance(values, np.ndarray) and values.dtype == object
        else np.asarray(values, dtype=object)
    )
    present = np.fromiter((v is not None for v in arr), bool, len(arr))
    rows_idx = np.nonzero(present)[0].astype(np.int64)
    texts = [t if isinstance(t, str) else str(t) for t in arr[rows_idx].tolist()]
    return texts, rows_idx


def batch_text_stats(
    values: Sequence, cardinality_cap: int, clean_text: bool
) -> TextStats:
    """TextStats over a column of optional strings. The cap keeps the
    FIRST cap+1 distinct cleaned values in row order with their full
    counts, as the sequential capped insertion of ``TextStats.add``
    would."""
    stats = TextStats.empty(cardinality_cap)
    texts, _ = _partition_nulls(values)
    if not texts:
        return stats
    last = _NATIVE_HIST_BINS - 1
    cleaned = []
    for s in texts:
        cleaned.append(clean_string(s) if clean_text else s)
        ascii_row = s.isascii()
        for t in tokenize(s):
            n = len(t)
            stats.length_counts[min(n, last) if ascii_row else n] += 1
    full = Counter(cleaned)
    stats.value_counts.update(dict(islice(full.items(), cardinality_cap + 1)))
    return stats


def decide_method(
    stats: TextStats,
    max_cardinality: int,
    top_k: int,
    min_support: int,
    coverage_pct: float,
    min_length_std_dev: float,
) -> str:
    card = stats.cardinality
    if card > max_cardinality and card > top_k and stats.coverage(top_k, min_support) >= coverage_pct:
        return PIVOT
    if card <= max_cardinality:
        return PIVOT
    if stats.length_std() < min_length_std_dev:
        return IGNORE
    return HASH


def token_buckets(tokens: list[str], num_buckets: int, seed: int) -> np.ndarray:
    """int64 ``murmur3(token) % num_buckets`` per token, each distinct
    token hashed once."""
    bucket_of: dict[str, int] = {}
    cols = np.empty(len(tokens), dtype=np.int64)
    for i, t in enumerate(tokens):
        j = bucket_of.get(t)
        if j is None:
            j = bucket_of[t] = murmur3_32(t, seed) % num_buckets
        cols[i] = j
    return cols


def row_tokens(
    values: Sequence, prefix: str, to_lowercase: bool, min_token_length: int,
) -> tuple[list[str], np.ndarray]:
    """(tokens, their int64 rows) of a text column in row and token order,
    each token with ``prefix`` in front: the staged hash block's and the
    fused graph's text ingest's one tokenization."""
    texts, rows_idx = _partition_nulls(values)
    tokens: list[str] = []
    rows: list[int] = []
    for r, raw in zip(rows_idx.tolist(), texts):
        for t in tokenize(
            raw, to_lowercase=to_lowercase, min_token_length=min_token_length,
        ):
            tokens.append(prefix + t)
            rows.append(r)
    return tokens, np.asarray(rows, dtype=np.int64)


def murmur3_scatter(
    tokens: list[str],
    rows: np.ndarray,
    num_buckets: int,
    seed: int,
    binary: bool,
    out: np.ndarray,
    col_offset: int = 0,
) -> np.ndarray:
    """out[rows[i], col_offset + h(tokens[i]) % num_buckets] += 1 (set to 1
    when ``binary``)."""
    cols = token_buckets(tokens, num_buckets, seed) + col_offset
    if binary:
        out[rows, cols] = 1.0
    else:
        np.add.at(out, (rows, cols), 1.0)
    return out


def hash_block(
    values: Sequence,
    num_features: int,
    feature_slot: int,
    shared: bool,
    binary_freq: bool,
    to_lowercase: bool,
    min_token_length: int,
    seed: int,
    track_nulls: bool,
    out: np.ndarray | None = None,
    col_offset: int = 0,
) -> np.ndarray:
    """Feature-hash one text column into ``num_features`` buckets, plus the
    null-indicator column when ``track_nulls``. With a shared hash space
    every token carries the prefix ``<feature_slot>_``. With ``out`` /
    ``col_offset`` the block lands in the caller's float32 buffer."""
    n = len(values)
    if out is None:
        out = np.zeros((n, num_features + int(track_nulls)), dtype=np.float32)
        col_offset = 0
    if track_nulls:
        out[[v is None for v in values], col_offset + num_features] = 1.0
    tokens, rows = row_tokens(
        values, f"{feature_slot}_" if shared else "", to_lowercase,
        min_token_length,
    )
    if tokens:
        murmur3_scatter(
            tokens, rows, num_features, seed, binary_freq, out, col_offset,
        )
    return out


def hash_metas(
    name: str, parent_type: type, num_features: int, track_nulls: bool
) -> list[ColumnMeta]:
    """Metas of one hash block: ``hash_<j>`` descriptors (no grouping) and
    the null indicator."""
    return list(
        _hash_metas_cached(name, parent_type.__name__, num_features, track_nulls)
    )


@lru_cache(maxsize=1024)
def _hash_metas_cached(
    name: str, parent_type_name: str, num_features: int, track_nulls: bool
) -> tuple[ColumnMeta, ...]:
    metas = [
        ColumnMeta((name,), parent_type_name, grouping=None,
                   descriptor_value=f"hash_{j}")
        for j in range(num_features)
    ]
    if track_nulls:
        metas.append(
            ColumnMeta((name,), parent_type_name, grouping=name,
                       indicator_value=NULL_STRING)
        )
    return tuple(metas)


class SmartTextModel(VectorizerModel):
    def __init__(
        self,
        methods: list[str],
        vocabs: list[list[str]],
        num_hashes: int,
        clean_text: bool,
        track_nulls: bool,
        to_lowercase: bool = DEFAULTS.ToLowercase,
        min_token_length: int = DEFAULTS.MinTokenLength,
        binary_freq: bool = DEFAULTS.BinaryFreq,
        seed: int = DEFAULTS.HashSeed,
        **kw,
    ):
        super().__init__("smartTxt", **kw)
        self.methods = methods
        self.vocabs = vocabs
        self.num_hashes = num_hashes
        self.clean_text = clean_text
        self.track_nulls = track_nulls
        self.to_lowercase = to_lowercase
        self.min_token_length = min_token_length
        self.binary_freq = binary_freq
        self.seed = seed

    def get_params(self):
        return {
            "methods": self.methods,
            "vocabs": self.vocabs,
            "num_hashes": self.num_hashes,
            "clean_text": self.clean_text,
            "track_nulls": self.track_nulls,
            "to_lowercase": self.to_lowercase,
            "min_token_length": self.min_token_length,
            "binary_freq": self.binary_freq,
            "seed": self.seed,
        }

    def fused_member_spec(self):
        """The fused graph's member: an all-Pivot model rides the one-hot
        scatter; one with Hash slots the hashed-text scatter (which refuses
        a model that mixes Pivot and Hash slots)."""
        from ..compiler.fused import hashed_text_member, onehot_member

        if self.methods and all(m == PIVOT for m in self.methods):
            return onehot_member(
                self, self.vocabs, self.track_nulls, self.clean_text
            )
        return hashed_text_member(
            self, self.methods, self.num_hashes, self.track_nulls,
            self.binary_freq, self.to_lowercase, self.min_token_length,
            self.seed,
        )

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        """One float32 buffer for the whole stage: pivot blocks are copied
        in, hash blocks scatter straight into it."""
        nulls = int(self.track_nulls)
        widths = []
        for method, vocab in zip(self.methods, self.vocabs):
            if method == PIVOT:
                widths.append(len(vocab) + 1 + nulls)
            elif method == HASH:
                widths.append(self.num_hashes + nulls)
            else:
                widths.append(nulls)
        out = np.zeros((num_rows, sum(widths)), dtype=np.float32)
        metas_flat: list[ColumnMeta] = []
        off = 0
        for slot, (col, method, vocab, feat, width) in enumerate(
            zip(cols, self.methods, self.vocabs, self.input_features, widths)
        ):
            if not isinstance(col, TextColumn):
                raise TypeError(
                    f"SmartTextModel vectorizes text columns, got "
                    f"{type(col).__name__}"
                )
            values = col.values
            if method == PIVOT:
                out[:, off:off + width] = pivot_block(
                    values, vocab, self.track_nulls, self.clean_text
                )
                metas_flat.extend(
                    pivot_metas(feat.name, feat.ftype, vocab, self.track_nulls)
                )
            elif method == HASH:
                hash_block(
                    values, self.num_hashes, slot, shared=False,
                    binary_freq=self.binary_freq,
                    to_lowercase=self.to_lowercase,
                    min_token_length=self.min_token_length,
                    seed=self.seed, track_nulls=self.track_nulls,
                    out=out, col_offset=off,
                )
                metas_flat.extend(
                    hash_metas(feat.name, feat.ftype, self.num_hashes,
                               self.track_nulls)
                )
            elif self.track_nulls:  # IGNORE: null tracking only
                out[[v is None for v in values], off] = 1.0
                metas_flat.append(
                    ColumnMeta(
                        (feat.name,), feat.ftype.__name__,
                        grouping=feat.name, indicator_value=NULL_STRING,
                    )
                )
            off += width
        return [out], [metas_flat]


class SmartTextVectorizer(VectorizerEstimator):
    """Decides pivot vs hash vs ignore per text field, then vectorizes."""

    def __init__(
        self,
        max_cardinality: int = DEFAULTS.MaxCategoricalCardinality,
        top_k: int = DEFAULTS.TopK,
        min_support: int = DEFAULTS.MinSupport,
        coverage_pct: float = DEFAULTS.CoveragePct,
        min_length_std_dev: float = 0.0,
        num_hashes: int = DEFAULTS.DefaultNumOfFeatures,
        clean_text: bool = DEFAULTS.CleanText,
        track_nulls: bool = DEFAULTS.TrackNulls,
        uid: str | None = None,
    ):
        super().__init__("smartTxtVec", uid=uid)
        self.max_cardinality = max_cardinality
        self.top_k = top_k
        self.min_support = min_support
        self.coverage_pct = coverage_pct
        self.min_length_std_dev = min_length_std_dev
        self.num_hashes = num_hashes
        self.clean_text = clean_text
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
            "track_nulls": self.track_nulls,
        }

    def fit_model(self, dataset) -> SmartTextModel:
        methods, vocabs, summaries = [], [], []
        for name in self.input_names:
            col = dataset[name]
            if not isinstance(col, TextColumn):
                raise TypeError(f"{name} is not a text column")
            stats = batch_text_stats(
                col.values, self.max_cardinality, self.clean_text
            )
            method = decide_method(
                stats, self.max_cardinality, self.top_k, self.min_support,
                self.coverage_pct, self.min_length_std_dev,
            )
            methods.append(method)
            vocabs.append(
                top_values(stats.value_counts, self.top_k, self.min_support)
                if method == PIVOT else []
            )
            summaries.append({
                "feature": name,
                "method": method,
                "cardinality": stats.cardinality,
                "lengthStdDev": stats.length_std(),
            })
        self.metadata["textStats"] = summaries
        return SmartTextModel(
            methods, vocabs, self.num_hashes, self.clean_text,
            self.track_nulls,
        )
