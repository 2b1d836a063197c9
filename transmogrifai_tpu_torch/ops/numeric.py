"""Fitted numeric vectorizers: imputed value + null indicator per nullable
feature (Real mean fill and Integral mode fill share one fitted model),
Binary constant fill, RealNN passthrough."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..stages.metadata import NULL_STRING, ColumnMeta
from ..types.columns import Column, NumericColumn
from .base import VectorizerModel, VectorizerTransformer


def _value_and_null_meta(
    name: str, parent_type: type, track_nulls: bool
) -> list[ColumnMeta]:
    metas = [ColumnMeta(parent_names=(name,), parent_type=parent_type.__name__)]
    if track_nulls:
        metas.append(
            ColumnMeta(
                parent_names=(name,),
                parent_type=parent_type.__name__,
                grouping=name,
                indicator_value=NULL_STRING,
            )
        )
    return metas


def _numeric(col: Column) -> NumericColumn:
    if not isinstance(col, NumericColumn):
        raise TypeError(f"expected a numeric column, got {type(col).__name__}")
    return col


def _impute_block(
    col: NumericColumn, fill: float, track_nulls: bool
) -> np.ndarray:
    vals = np.where(col.mask, col.values.astype(np.float64), fill)
    if track_nulls:
        return np.stack([vals, (~col.mask).astype(np.float64)], axis=1)
    return vals[:, None]


class NumericVectorizerModel(VectorizerModel):
    def __init__(
        self,
        fills: list[float],
        track_nulls: bool,
        value_ranges: list[list[float]] | None = None,
        **kw,
    ):
        super().__init__("vecNumeric", **kw)
        self.fills = fills
        self.track_nulls = track_nulls
        #: fit-time per-column [lo, hi]; carried for the saved format only
        self.value_ranges = value_ranges

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        blocks, metas = [], []
        for col, fill, feat in zip(cols, self.fills, self.input_features):
            blocks.append(_impute_block(_numeric(col), fill, self.track_nulls))
            metas.append(
                _value_and_null_meta(feat.name, feat.ftype, self.track_nulls)
            )
        return blocks, metas


class BinaryVectorizer(VectorizerTransformer):
    """Binary -> [0/1 value (missing filled with fill_value), null
    indicator]."""

    def __init__(self, fill_value: bool = False, track_nulls: bool = True, uid=None):
        super().__init__("vecBinary", uid=uid)
        self.fill_value = fill_value
        self.track_nulls = track_nulls

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        blocks, metas = [], []
        for col, feat in zip(cols, self.input_features):
            blocks.append(
                _impute_block(
                    _numeric(col), float(self.fill_value), self.track_nulls
                )
            )
            metas.append(
                _value_and_null_meta(feat.name, feat.ftype, self.track_nulls)
            )
        return blocks, metas


class RealNNVectorizer(VectorizerTransformer):
    """RealNN passthrough (no nulls possible)."""

    def __init__(self, uid=None):
        super().__init__("vecRealNN", uid=uid)

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        blocks, metas = [], []
        for col, feat in zip(cols, self.input_features):
            blocks.append(_numeric(col).values.astype(np.float64)[:, None])
            metas.append([ColumnMeta((feat.name,), feat.ftype.__name__)])
        return blocks, metas
