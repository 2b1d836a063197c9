"""Fitted one-hot pivot for categorical text: values are cleaned
(TextUtils.cleanString) when ``clean_text`` is set, and the block holds one
0/1 column per vocabulary value, an OTHER column for any present value
outside the vocabulary, and a null-indicator column when ``track_nulls``."""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np

from ..stages.metadata import NULL_STRING, OTHER_STRING, ColumnMeta
from ..types.columns import Column, TextColumn
from ..utils.text import clean_string
from .base import VectorizerModel


def pivot_codes(values: Sequence, index: dict, clean_text: bool) -> np.ndarray:
    """Per-row pivot code: -1 null, -2 OTHER, >= 0 vocabulary column.
    Cleaning and lookup run once per distinct raw value."""
    code_of: dict = {}
    codes = np.empty(len(values), dtype=np.int64)
    for r, raw in enumerate(values):
        j = code_of.get(raw)
        if j is None:
            v = None if raw is None else (clean_string(raw) if clean_text else raw)
            j = code_of[raw] = -1 if v is None else index.get(v, -2)
        codes[r] = j
    return codes


def pivot_block(
    values: Sequence, vocab: list[str], track_nulls: bool, clean_text: bool,
) -> np.ndarray:
    """[N, len(vocab) + 1 (+1 if track_nulls)] pivot block."""
    n = len(values)
    other_col = len(vocab)
    out = np.zeros((n, other_col + 1 + int(track_nulls)), dtype=np.float32)
    codes = pivot_codes(values, {v: i for i, v in enumerate(vocab)}, clean_text)
    hit = codes >= 0
    out[np.nonzero(hit)[0], codes[hit]] = 1.0
    out[codes == -2, other_col] = 1.0
    if track_nulls:
        out[codes == -1, other_col + 1] = 1.0
    return out


@lru_cache(maxsize=1024)
def _pivot_metas(
    name: str, parent_type_name: str, vocab: tuple[str, ...], track_nulls: bool,
) -> tuple[ColumnMeta, ...]:
    metas = [
        ColumnMeta((name,), parent_type_name, grouping=name, indicator_value=v)
        for v in vocab + (OTHER_STRING,)
    ]
    if track_nulls:
        metas.append(
            ColumnMeta(
                (name,), parent_type_name, grouping=name,
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

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        blocks, metas = [], []
        for col, vocab, feat in zip(cols, self.vocabs, self.input_features):
            if not isinstance(col, TextColumn):
                raise TypeError(
                    f"OneHotModel pivots text columns, got {type(col).__name__}"
                )
            blocks.append(
                pivot_block(col.values, vocab, self.track_nulls, self.clean_text)
            )
            metas.append(
                list(_pivot_metas(
                    feat.name, feat.ftype.__name__, tuple(vocab),
                    self.track_nulls,
                ))
            )
        return blocks, metas
