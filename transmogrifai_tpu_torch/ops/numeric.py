"""Numeric vectorizers: Real/Currency/Percent (mean imputation), Integral
(mode imputation), Binary (constant fill), RealNN (passthrough). Each
nullable feature contributes [imputed value, null indicator] columns; the
mean and mode estimators share one fitted model. The fill statistics are
computed on the host as the reference computes them (numpy's float64
pairwise sum for the mean; the smallest of the most frequent values for the
mode), because they go into the vector bit for bit."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..stages.metadata import NULL_STRING, ColumnMeta
from ..types.columns import Column, NumericColumn
from .base import VectorizerEstimator, VectorizerModel, VectorizerTransformer


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


def _fit_ranges(cols: list[NumericColumn]) -> list[list[float]]:
    """Per-column finite [lo, hi] of the present values (the fit-time
    scales of the reference's quantized serving plane); an all-null or
    all-non-finite column gives [0, 0]."""
    ranges = []
    for col in cols:
        present = np.asarray(col.values, dtype=np.float64)[col.mask]
        finite = present[np.isfinite(present)]
        if finite.size:
            ranges.append([float(finite.min()), float(finite.max())])
        else:
            ranges.append([0.0, 0.0])
    return ranges


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
        #: fit-time per-column [lo, hi]: the quantized plane's scales (None
        #: on models saved without them: a quantized build keeps their
        #: float32 member)
        self.value_ranges = value_ranges

    def get_arrays(self):
        return {"fills": np.asarray(self.fills, dtype=np.float64)}

    def get_params(self):
        return {
            "fills": list(map(float, self.fills)),
            "track_nulls": self.track_nulls,
            "value_ranges": self.value_ranges,
        }

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        blocks, metas = [], []
        for col, fill, feat in zip(cols, self.fills, self.input_features):
            blocks.append(_impute_block(_numeric(col), fill, self.track_nulls))
            metas.append(
                _value_and_null_meta(feat.name, feat.ftype, self.track_nulls)
            )
        return blocks, metas

    def fused_member_spec(self):
        """The fused graph's member: values and masks up, impute and
        null-track on the device; the fit ranges ride along for the
        quantized plane."""
        from ..compiler.fused import numeric_member

        return numeric_member(
            self, np.asarray(self.fills, dtype=np.float32),
            self.track_nulls, ranges=self.value_ranges,
        )


class RealVectorizer(VectorizerEstimator):
    """Mean-imputing vectorizer for Real/Currency/Percent (fillWithMean,
    trackNulls on by default)."""

    def __init__(
        self,
        fill_with_mean: bool = True,
        fill_value: float = 0.0,
        track_nulls: bool = True,
        uid: str | None = None,
    ):
        super().__init__("vecReal", uid=uid)
        self.fill_with_mean = fill_with_mean
        self.fill_value = fill_value
        self.track_nulls = track_nulls

    def get_params(self):
        return {"fill_with_mean": self.fill_with_mean,
                "fill_value": self.fill_value, "track_nulls": self.track_nulls}

    def fit_model(self, dataset) -> NumericVectorizerModel:
        cols = [_numeric(dataset[name]) for name in self.input_names]
        fills = []
        for col in cols:
            if self.fill_with_mean:
                cnt = int(col.mask.sum())
                fills.append(
                    float(col.values[col.mask].sum() / cnt) if cnt else 0.0
                )
            else:
                fills.append(float(self.fill_value))
        self.metadata["fills"] = fills
        return NumericVectorizerModel(
            fills, self.track_nulls, value_ranges=_fit_ranges(cols)
        )


class IntegralVectorizer(VectorizerEstimator):
    """Mode-imputing vectorizer for Integral (fillWithMode on by default);
    a tie goes to the smallest value."""

    def __init__(
        self,
        fill_with_mode: bool = True,
        fill_value: float = 0.0,
        track_nulls: bool = True,
        uid: str | None = None,
    ):
        super().__init__("vecIntegral", uid=uid)
        self.fill_with_mode = fill_with_mode
        self.fill_value = fill_value
        self.track_nulls = track_nulls

    def get_params(self):
        return {"fill_with_mode": self.fill_with_mode,
                "fill_value": self.fill_value, "track_nulls": self.track_nulls}

    def fit_model(self, dataset) -> NumericVectorizerModel:
        cols = [_numeric(dataset[name]) for name in self.input_names]
        fills = []
        for col in cols:
            present = col.values[col.mask]
            if self.fill_with_mode and len(present):
                vals, counts = np.unique(present, return_counts=True)
                fills.append(float(vals[np.argmax(counts)]))
            else:
                fills.append(float(self.fill_value))
        self.metadata["fills"] = fills
        return NumericVectorizerModel(
            fills, self.track_nulls, value_ranges=_fit_ranges(cols)
        )


class BinaryVectorizer(VectorizerTransformer):
    """Binary -> [0/1 value (missing filled with fill_value), null
    indicator]."""

    def __init__(self, fill_value: bool = False, track_nulls: bool = True, uid=None):
        super().__init__("vecBinary", uid=uid)
        self.fill_value = fill_value
        self.track_nulls = track_nulls

    def get_params(self):
        return {"fill_value": self.fill_value, "track_nulls": self.track_nulls}

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

    def fused_member_spec(self):
        from ..compiler.fused import numeric_member

        n = len(self.input_features)
        fills = np.full(n, float(self.fill_value), dtype=np.float32)
        # Binary values are {0, 1}: the quantized plane needs no fit pass
        return numeric_member(
            self, fills, self.track_nulls, ranges=[[0.0, 1.0]] * n
        )


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

    def fused_member_spec(self):
        from ..compiler.fused import passthrough_member

        return passthrough_member(self, len(self.input_features))
