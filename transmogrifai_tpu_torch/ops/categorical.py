"""One-hot pivot for categorical text and sets (OpOneHotVectorizer,
OpSetVectorizer): values are cleaned (TextUtils.cleanString) when
``clean_text`` is set; the vocabulary is the values counted at least
``min_support`` times, sorted by (-count, value), first ``top_k`` kept; the
block holds one column per vocabulary value, an OTHER column for any
present value outside the vocabulary, and a null-indicator column when
``track_nulls``. A text value sets its column to 1; a set (MultiPickList)
adds 1 per member, so its columns count members, and an empty set is
null."""
from __future__ import annotations

from collections import Counter
from functools import lru_cache
from typing import Sequence

import numpy as np

from ..featurize.interning import intern_values
from ..stages.metadata import NULL_STRING, OTHER_STRING, ColumnMeta
from ..types.columns import Column, SetColumn, TextColumn
from ..utils.text import clean_string
from .base import VectorizerEstimator, VectorizerModel


def top_values(counts: Counter, top_k: int, min_support: int) -> list[str]:
    """Pivot vocabulary: counts >= min_support, sorted by (-count, value),
    the first top_k kept."""
    filtered = [(v, c) for v, c in counts.items() if c >= min_support]
    filtered.sort(key=lambda vc: (-vc[1], vc[0]))
    return [v for v, _ in filtered[:top_k]]


def pivot_codes(values: Sequence, index: dict, clean_text: bool) -> np.ndarray:
    """Per-row pivot code: -1 null, -2 OTHER, >= 0 vocabulary column.
    Cleaning and lookup run once per distinct raw value: below 4096 rows
    by a memo dict (cheaper than the native round trip), above by
    whole-value interning (``featurize.interning.intern_values``, one
    native pass) and one gather."""
    n = len(values)
    if n < 4096:
        code_of: dict = {}
        codes = np.empty(n, dtype=np.int64)
        for r, raw in enumerate(values):
            j = code_of.get(raw)
            if j is None:
                v = _clean(raw, clean_text)
                j = code_of[raw] = -1 if v is None else index.get(v, -2)
            codes[r] = j
        return codes
    codes = np.full(n, -1, dtype=np.int64)
    present = np.fromiter((v is not None for v in values), bool, n)
    if not present.any():
        return codes
    texts = list(values) if present.all() else [v for v in values if v is not None]
    icodes, uniques, _ = intern_values(texts)
    uniq_col = np.empty(len(uniques), dtype=np.int64)
    for u, raw in enumerate(uniques):
        v = _clean(raw, clean_text)
        uniq_col[u] = -1 if v is None else index.get(v, -2)
    codes[present] = uniq_col[icodes]
    return codes


def _clean(v, clean_text: bool):
    if v is None:
        return None
    return clean_string(v) if clean_text else v


def pivot_block(
    values: Sequence, vocab: list[str], track_nulls: bool, clean_text: bool,
    is_set: bool = False,
) -> np.ndarray:
    """[N, len(vocab) + 1 (+1 if track_nulls)] pivot block; ``values`` are
    str | None per row, or iterables of str (sets) when ``is_set``."""
    n = len(values)
    other_col = len(vocab)
    out = np.zeros((n, other_col + 1 + int(track_nulls)), dtype=np.float32)
    index = {v: i for i, v in enumerate(vocab)}
    if is_set:
        return _set_block(values, index, track_nulls, clean_text, out)
    codes = pivot_codes(values, index, clean_text)
    hit = codes >= 0
    out[np.nonzero(hit)[0], codes[hit]] = 1.0
    out[codes == -2, other_col] = 1.0
    if track_nulls:
        out[codes == -1, other_col + 1] = 1.0
    return out


def _set_block(values: Sequence, index: dict, track_nulls: bool,
               clean_text: bool, out: np.ndarray) -> np.ndarray:
    """A set pivot's counts: each member adds 1 to its vocabulary column or
    to OTHER; an empty or missing set sets the null column."""
    other_col = len(index)
    for r, raw in enumerate(values):
        members = [
            None if m is None else clean_string(m) if clean_text else m
            for m in raw
        ] if raw else []
        if not members:
            if track_nulls:
                out[r, other_col + 1] = 1.0
            continue
        for m in members:
            out[r, index.get(m, other_col)] += 1.0
    return out


def pivot_metas(
    name: str, parent_type: type, vocab: list[str], track_nulls: bool,
    grouping: str | None = None,
) -> list[ColumnMeta]:
    """Metas for one pivot group: vocab columns + OTHER (+ null
    indicator). ``grouping`` defaults to the feature name; the map
    vectorizers pass the map key."""
    return list(_pivot_metas(name, parent_type.__name__, tuple(vocab),
                             track_nulls, grouping))


@lru_cache(maxsize=8192)
def _pivot_metas(
    name: str, parent_type_name: str, vocab: tuple[str, ...], track_nulls: bool,
    grouping: str | None,
) -> tuple[ColumnMeta, ...]:
    group = name if grouping is None else grouping
    metas = [
        ColumnMeta((name,), parent_type_name, grouping=group, indicator_value=v)
        for v in vocab + (OTHER_STRING,)
    ]
    if track_nulls:
        metas.append(
            ColumnMeta(
                (name,), parent_type_name, grouping=group,
                indicator_value=NULL_STRING,
            )
        )
    return tuple(metas)


class OneHotModel(VectorizerModel):
    def __init__(
        self, vocabs: list[list[str]], track_nulls: bool, clean_text: bool,
        **kw,
    ):
        super().__init__("pivot", **kw)
        self.vocabs = vocabs
        self.track_nulls = track_nulls
        self.clean_text = clean_text

    def get_params(self):
        return {
            "vocabs": self.vocabs,
            "track_nulls": self.track_nulls,
            "clean_text": self.clean_text,
        }

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        blocks, metas = [], []
        for col, vocab, feat in zip(cols, self.vocabs, self.input_features):
            if not isinstance(col, (TextColumn, SetColumn)):
                raise TypeError(
                    f"OneHotModel pivots text and set columns, got "
                    f"{type(col).__name__}"
                )
            blocks.append(pivot_block(
                col.values, vocab, self.track_nulls, self.clean_text,
                isinstance(col, SetColumn),
            ))
            metas.append(
                pivot_metas(feat.name, feat.ftype, vocab, self.track_nulls)
            )
        return blocks, metas

    def fused_member_spec(self):
        """The fused graph's member: codes resolved on the host, the
        one-hot scatter on the device. A set-valued pivot (member counts,
        not indicators) is refused."""
        from ..compiler.fused import Unfuseable, onehot_member
        from ..types import OPSet

        for feat in self.input_features:
            if issubclass(feat.ftype, OPSet):
                raise Unfuseable(
                    f"set-valued pivot '{feat.name}' emits member counts — "
                    "not expressible as a code scatter"
                )
        return onehot_member(
            self, self.vocabs, self.track_nulls, self.clean_text
        )


class OneHotVectorizer(VectorizerEstimator):
    """Sequence estimator pivoting categorical text and set features
    (defaults TopK=20, MinSupport=10)."""

    def __init__(
        self,
        top_k: int = 20,
        min_support: int = 10,
        clean_text: bool = True,
        track_nulls: bool = True,
        uid: str | None = None,
    ):
        super().__init__("pivotText", uid=uid)
        self.top_k = top_k
        self.min_support = min_support
        self.clean_text = clean_text
        self.track_nulls = track_nulls

    def get_params(self):
        return {
            "top_k": self.top_k,
            "min_support": self.min_support,
            "clean_text": self.clean_text,
            "track_nulls": self.track_nulls,
        }

    def fit_model(self, dataset) -> OneHotModel:
        vocabs = []
        for name in self.input_names:
            col = dataset[name]
            if isinstance(col, SetColumn):
                raw_values = (m for s in col.values for m in s if m is not None)
            elif isinstance(col, TextColumn):
                raw_values = (v for v in col.values if v is not None)
            else:
                raise TypeError(
                    f"OneHotVectorizer cannot pivot {type(col).__name__}")
            # value counts by interning: cleaning runs once per distinct
            # raw value (non-str members take the dict interner)
            counts: Counter = Counter()
            raw = list(raw_values)
            if raw:
                _, uniques, ucounts = intern_values(raw)
                for u, c in zip(uniques, ucounts.tolist()):
                    u2 = _clean(u, self.clean_text)
                    if u2 is not None:
                        counts[u2] += c
            vocabs.append(top_values(counts, self.top_k, self.min_support))
        self.metadata["vocabs"] = vocabs
        return OneHotModel(vocabs, self.track_nulls, self.clean_text)
