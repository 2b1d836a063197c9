"""Text hashing + SmartText vectorizers.

SmartTextVectorizer (SmartTextVectorizer.scala:79-132) summarizes each text
field (TextStats: value counts with a cardinality cap, and the token-length
distribution), then decides per field, with transmogrify's defaults
max_cardinality=30, top_k=20, coverage_pct=0.90, min_length_std_dev=0:
  1. card > max_cardinality and card > top_k and coverage(topK) >= coverage_pct -> Pivot
  2. card <= max_cardinality -> Pivot
  3. token-length stddev < min_length_std_dev -> Ignore
  4. otherwise -> Hash (MurmurHash3 of the tokens into ``num_hashes`` buckets)

The host hot loops run in the native library (``native.py``): the fit's
clean, token-length histogram and capped value counts in one pass
(``text_stats_pass``), the hash plane's tokenize + hash + scatter in one
pass, dense (``tokenize_hash_scatter``) or, for a batch of at least
``SPARSE_MIN_ROWS`` rows with a hash block of 64 buckets or more, as COO
pairs (``tokenize_hash_coo``) that make the stage's block a SparseMatrix.
The C++ tokenizers are exact for ASCII only, so a column's non-ASCII rows
take the exact-Unicode Python tokenizer, as in the reference; with
``TPTPU_DISABLE_NATIVE`` every row does. The Python route keeps one detail
of the native pass: a token of an ASCII row longer than 255 characters
counts in the length histogram as 255.
"""
from __future__ import annotations

import dataclasses
import os
from collections import Counter
from functools import lru_cache
from itertools import islice
from typing import Sequence

import numpy as np

from .. import native
from ..featurize import engine as _engine

from ..stages.metadata import NULL_STRING, ColumnMeta
from ..types.columns import Column, SparseMatrix, TextColumn
from ..utils.text import clean_string, tokenize
from .base import VectorizerEstimator, VectorizerModel
from .categorical import pivot_block, pivot_metas, top_values
from .defaults import DEFAULTS

PIVOT, HASH, IGNORE = "Pivot", "Hash", "Ignore"

#: the native token-length histogram's bins; longer tokens of ASCII rows
#: land in the last one
_NATIVE_HIST_BINS = 256

#: batches below this row count assemble hash planes dense even at wide
#: bucket counts: serving-size batches pay more for the COO round trip
#: (and the predictor densifies regardless) than for the dense scatter
SPARSE_MIN_ROWS = int(os.environ.get("TPTPU_SPARSE_MIN_ROWS", "4096"))


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
    """(non-null texts, their int64 row indices), the None scan an
    elementwise object compare; non-str values are coerced with ``str``."""
    arr = (
        values
        if isinstance(values, np.ndarray) and values.dtype == object
        else np.asarray(values, dtype=object)
    )
    present = arr != None  # noqa: E711 — elementwise over objects
    if not isinstance(present, np.ndarray):
        present = np.fromiter((v is not None for v in arr), bool, len(arr))
    if present.all():
        rows_idx = np.arange(len(arr), dtype=np.int64)
        texts = arr.tolist()
    else:
        rows_idx = np.nonzero(present)[0].astype(np.int64)
        texts = arr[rows_idx].tolist()
    if texts and not all(isinstance(t, str) for t in texts):
        texts = [t if isinstance(t, str) else str(t) for t in texts]
    return texts, rows_idx


def _add_hist(stats: "TextStats", hist: np.ndarray) -> None:
    for length, count in enumerate(hist.tolist()):
        if count:
            stats.length_counts[length] += count


def batch_text_stats(
    values: Sequence, cardinality_cap: int, clean_text: bool
) -> TextStats:
    """TextStats over a column of optional strings. The cap keeps the
    FIRST cap+1 distinct cleaned values in row order with their full
    counts, as the sequential capped insertion of ``TextStats.add``
    would. An ASCII column takes one native pass; a column with non-ASCII
    rows takes the native clean pass over its ASCII rows (their lengths
    first in the histogram, ascending) and the Python route over the
    others, as the reference does."""
    stats = TextStats.empty(cardinality_cap)
    texts, _ = _partition_nulls(values)
    if not texts:
        return stats
    fused = native.text_stats_pass(texts, cardinality_cap, clean_text)
    if fused is not None:
        hist, uniques, counts = fused
        _add_hist(stats, hist)
        stats.value_counts.update(dict(zip(uniques, map(int, counts))))
        return stats
    ascii_pos = [i for i, s in enumerate(texts) if s.isascii()]
    slow_pos = [i for i, s in enumerate(texts) if not s.isascii()]
    cleaned: list = [None] * len(texts)
    res = native.clean_tokenstats([texts[i] for i in ascii_pos])
    if res is not None:
        native_cleaned, hist = res
        for i, c in zip(ascii_pos, native_cleaned):
            cleaned[i] = c if clean_text else texts[i]
    else:
        # the native routes disabled: the ASCII rows' plain version, its
        # histogram binned as the native pass bins it
        hist = np.zeros(_NATIVE_HIST_BINS, dtype=np.int64)
        last = _NATIVE_HIST_BINS - 1
        for i in ascii_pos:
            s = texts[i]
            cleaned[i] = clean_string(s) if clean_text else s
            for t in tokenize(s):
                hist[min(len(t), last)] += 1
    _add_hist(stats, hist)
    for i in slow_pos:
        s = texts[i]
        cleaned[i] = clean_string(s) if clean_text else s
        for t in tokenize(s):
            stats.length_counts[len(t)] += 1
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
    when ``binary``): ``native.murmur3_scatter`` into ``out``."""
    return native.murmur3_scatter(
        tokens, rows, out.shape[0], num_buckets, seed=seed, binary=binary,
        out=out, col_offset=col_offset,
    )


def _slow_tokens(slow_rows, prefix: str, to_lowercase: bool,
                 min_token_length: int) -> tuple[list[str], np.ndarray]:
    """(tokens, their int64 rows) of (row, text) pairs by the Python
    tokenizer, each token with ``prefix`` in front."""
    tokens: list[str] = []
    rows: list[int] = []
    for r, raw in slow_rows:
        for t in tokenize(raw, to_lowercase=to_lowercase,
                          min_token_length=min_token_length):
            tokens.append(prefix + t)
            rows.append(r)
    return tokens, np.asarray(rows, dtype=np.int64)


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
    ``col_offset`` the block lands in the caller's float32 buffer (the
    native scatter strides into it). Every non-null row goes through one
    native tokenize + hash + scatter pass; a column with non-ASCII rows
    sends its ASCII rows through that pass and the others through the
    Python tokenizer."""
    n = len(values)
    if out is None:
        out = np.zeros((n, num_features + int(track_nulls)), dtype=np.float32)
        col_offset = 0
    prefix = f"{feature_slot}_" if shared else ""
    texts, rows_idx = _partition_nulls(values)
    if track_nulls and len(rows_idx) < n:
        null_rows = np.ones(n, dtype=bool)
        null_rows[rows_idx] = False
        out[null_rows, col_offset + num_features] = 1.0
    kw = dict(seed=seed, binary=binary_freq, to_lowercase=to_lowercase,
              min_token_length=min_token_length, prefix=prefix,
              col_offset=col_offset)
    slow_rows: list[tuple[int, str]] = []
    if texts and not native.tokenize_hash_scatter(
        texts, rows_idx, num_features, out, **kw
    ):
        ascii_texts, ascii_rows = [], []
        for r, v in zip(rows_idx.tolist(), texts):
            if v.isascii():
                ascii_texts.append(v)
                ascii_rows.append(r)
            else:
                slow_rows.append((r, v))
        if ascii_texts and not native.tokenize_hash_scatter(
            ascii_texts, np.asarray(ascii_rows, dtype=np.int64),
            num_features, out, **kw,
        ):
            slow_rows = list(zip(ascii_rows, ascii_texts)) + slow_rows
    if slow_rows:
        tokens, rows = _slow_tokens(slow_rows, prefix, to_lowercase,
                                    min_token_length)
        if tokens:
            murmur3_scatter(tokens, rows, num_features, seed, binary_freq,
                            out, col_offset)
    return out


def hash_block_sparse(
    values: Sequence,
    num_features: int,
    feature_slot: int,
    shared: bool,
    binary_freq: bool,
    to_lowercase: bool,
    min_token_length: int,
    seed: int,
    track_nulls: bool,
) -> SparseMatrix | None:
    """The COO variant of :func:`hash_block`: the same nonzeros, ~50x fewer
    bytes than the dense block. None when the native COO pass cannot take
    the column (non-ASCII rows, or the native routes disabled): the caller
    assembles dense."""
    texts, rows_idx = _partition_nulls(values)
    if texts:
        coo = native.tokenize_hash_coo(
            texts, rows_idx, num_features, seed=seed, binary=binary_freq,
            to_lowercase=to_lowercase, min_token_length=min_token_length,
            prefix=f"{feature_slot}_" if shared else "",
        )
        if coo is None:
            return None
        rows, cols = coo
    else:
        rows = np.zeros(0, dtype=np.int32)
        cols = np.zeros(0, dtype=np.int32)
    width = num_features + int(track_nulls)
    if track_nulls and len(rows_idx) < len(values):
        null_rows = np.ones(len(values), dtype=bool)
        null_rows[rows_idx] = False
        nr = np.nonzero(null_rows)[0].astype(np.int32)
        rows = np.concatenate([rows, nr])
        cols = np.concatenate([cols, np.full(len(nr), num_features, np.int32)])
    return SparseMatrix(rows, cols, (len(values), width))


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

    def _slot_metas(self, feat, method: str, vocab: list[str]) -> list:
        if method == PIVOT:
            return pivot_metas(feat.name, feat.ftype, vocab, self.track_nulls)
        if method == HASH:
            return hash_metas(feat.name, feat.ftype, self.num_hashes,
                              self.track_nulls)
        if self.track_nulls:  # IGNORE: null tracking only
            return [ColumnMeta((feat.name,), feat.ftype.__name__,
                               grouping=feat.name, indicator_value=NULL_STRING)]
        return []

    def _hash_kw(self) -> dict:
        return dict(
            num_features=self.num_hashes, shared=False,
            binary_freq=self.binary_freq, to_lowercase=self.to_lowercase,
            min_token_length=self.min_token_length, seed=self.seed,
            track_nulls=self.track_nulls,
        )

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        """One block for the whole stage: a float32 buffer that pivot
        blocks are copied into and hash blocks scatter straight into, or,
        for a batch of at least ``SPARSE_MIN_ROWS`` rows with a hash block
        of 64 buckets or more, a SparseMatrix (when the native COO pass
        takes every hashed column and no fused batch holds a slot for the
        stage)."""
        for col in cols:
            if not isinstance(col, TextColumn):
                raise TypeError(
                    f"SmartTextModel vectorizes text columns, got "
                    f"{type(col).__name__}"
                )
        nulls = int(self.track_nulls)
        widths = []
        for method, vocab in zip(self.methods, self.vocabs):
            if method == PIVOT:
                widths.append(len(vocab) + 1 + nulls)
            elif method == HASH:
                widths.append(self.num_hashes + nulls)
            else:
                widths.append(nulls)
        if (
            HASH in self.methods
            and self.num_hashes >= 64
            and num_rows >= SPARSE_MIN_ROWS
            and not _engine.sink_active(self.uid)
        ):
            sparse = self._blocks_sparse(cols, num_rows, widths)
            if sparse is not None:
                return sparse
        out = np.zeros((num_rows, sum(widths)), dtype=np.float32)
        metas_flat: list[ColumnMeta] = []
        off = 0
        for slot, (col, method, vocab, feat, width) in enumerate(
            zip(cols, self.methods, self.vocabs, self.input_features, widths)
        ):
            values = col.values
            if method == PIVOT:
                out[:, off:off + width] = pivot_block(
                    values, vocab, self.track_nulls, self.clean_text
                )
            elif method == HASH:
                hash_block(values, feature_slot=slot, out=out, col_offset=off,
                           **self._hash_kw())
            elif self.track_nulls:
                out[[v is None for v in values], off] = 1.0
            metas_flat.extend(self._slot_metas(feat, method, vocab))
            off += width
        return [out], [metas_flat]

    def _blocks_sparse(self, cols, num_rows: int, widths: list[int]):
        """The stage's block as one SparseMatrix (pivot and null blocks
        ride along as COO), or None when a hashed column has rows the
        native COO pass cannot take."""
        blocks, metas_flat, used_widths = [], [], []
        for slot, (col, method, vocab, feat, width) in enumerate(
            zip(cols, self.methods, self.vocabs, self.input_features, widths)
        ):
            if width == 0:
                continue
            values = col.values
            if method == PIVOT:
                block = pivot_block(values, vocab, self.track_nulls,
                                    self.clean_text)
            elif method == HASH:
                block = hash_block_sparse(values, feature_slot=slot,
                                          **self._hash_kw())
                if block is None:
                    return None
            else:  # IGNORE: width > 0 means track_nulls
                nr = np.asarray(
                    [r for r, v in enumerate(values) if v is None],
                    dtype=np.int32,
                )
                block = SparseMatrix(nr, np.zeros(len(nr), np.int32),
                                     (num_rows, 1))
            blocks.append(block)
            used_widths.append(width)
            metas_flat.extend(self._slot_metas(feat, method, vocab))
        return (
            [SparseMatrix.hstack(blocks, used_widths, num_rows)], [metas_flat]
        )


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
        from ..featurize import parallel as _par

        cols = []
        for name in self.input_names:
            col = dataset[name]
            if not isinstance(col, TextColumn):
                raise TypeError(f"{name} is not a text column")
            cols.append(col)
        # the columns' statistics are independent and their native passes
        # release the interpreter lock: they fan out across the pool
        all_stats = _par.run_tasks([
            lambda c=c: batch_text_stats(
                c.values, self.max_cardinality, self.clean_text)
            for c in cols
        ])
        methods, vocabs, summaries = [], [], []
        for name, stats in zip(self.input_names, all_stats):
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
