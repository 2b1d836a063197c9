"""Bucketizers: fixed-split and decision-tree (supervised) binning.

Reference: core/.../stages/impl/feature/NumericBucketizer.scala (one-hot
bucket encoding with null and invalid tracking, left-inclusive splits,
default splits [-inf, 0, +inf]) and DecisionTreeNumericBucketizer.scala
(the splits of a single-feature decision tree over the label; maxDepth 5,
no useful split -> the null indicator alone).

Host numpy in float64, as in ``transmogrifai_tpu/ops/bucketizers.py``:
``_tree_splits`` keeps the reference's candidate order (midpoints of up to
32 quantiles), its strict ``>`` on the gini gain and its ``np.unique`` of
the splits, so the splits, the vectors and the metadata are equal.
``DropIndicesByTransformer`` takes a module-level predicate, pickled into
the saved model (``utils/serial.py``).
"""
from __future__ import annotations

import numpy as np

from ..stages.base import Estimator, Model, Transformer
from ..stages.metadata import NULL_STRING, ColumnMeta, VectorMetadata
from ..types import OPNumeric, OPVector, RealNN
from ..types.columns import Column, NumericColumn, VectorColumn
from ..utils.serial import decode_callable, encode_callable

OTHER_INVALID = "OTHER"


def _bucket_labels(splits: np.ndarray) -> list[str]:
    """NumericBucketizer.splitsToBucketLabels: 'lo-hi' left-inclusive."""
    return [
        f"{splits[i]}-{splits[i + 1]}" for i in range(len(splits) - 1)
    ]


def _encode(
    values: np.ndarray,
    mask: np.ndarray,
    splits: np.ndarray,
    track_nulls: bool,
    track_invalid: bool,
) -> np.ndarray:
    """One-hot bucket encoding (NumericBucketizer.scala:178): columns =
    buckets [+ invalid indicator] [+ null indicator]."""
    n = len(values)
    n_bins = len(splits) - 1
    width = n_bins + (1 if track_invalid else 0) + (1 if track_nulls else 0)
    out = np.zeros((n, width), dtype=np.float32)
    x = values.astype(np.float64)
    # left-inclusive: bucket i covers [splits[i], splits[i+1})
    idx = np.searchsorted(splits, x, side="right") - 1
    valid = mask & (idx >= 0) & (idx <= n_bins - 1)
    # values exactly at the top edge fall into the last bucket
    top = mask & (x == splits[-1])
    idx = np.where(top, n_bins - 1, idx)
    valid = valid | top
    rows = np.nonzero(valid)[0]
    out[rows, np.clip(idx[valid], 0, n_bins - 1)] = 1.0
    if track_invalid:
        out[mask & ~valid, n_bins] = 1.0
    if track_nulls:
        out[~mask, width - 1] = 1.0
    return out


def _bucket_metas(
    feature_name: str,
    ftype_name: str,
    splits: np.ndarray,
    track_nulls: bool,
    track_invalid: bool,
    labels: list[str] | None = None,
) -> list[ColumnMeta]:
    labels = labels or _bucket_labels(splits)
    metas = [
        ColumnMeta(
            parent_names=(feature_name,),
            parent_type=ftype_name,
            grouping=feature_name,
            indicator_value=lab,
            index=i,
        )
        for i, lab in enumerate(labels)
    ]
    if track_invalid:
        metas.append(
            ColumnMeta(
                parent_names=(feature_name,),
                parent_type=ftype_name,
                grouping=feature_name,
                indicator_value=OTHER_INVALID,
                index=len(metas),
            )
        )
    if track_nulls:
        metas.append(
            ColumnMeta(
                parent_names=(feature_name,),
                parent_type=ftype_name,
                grouping=feature_name,
                indicator_value=NULL_STRING,
                index=len(metas),
            )
        )
    return metas


class NumericBucketizer(Transformer):
    """Fixed-split one-hot bucketizer (NumericBucketizer.scala:54)."""

    input_types = (OPNumeric,)
    output_type = OPVector

    def __init__(
        self,
        splits=(-np.inf, 0.0, np.inf),
        track_nulls: bool = True,
        track_invalid: bool = False,
        bucket_labels: list[str] | None = None,
        uid: str | None = None,
    ):
        super().__init__("numericBucketized", uid=uid)
        self.splits = np.asarray(splits, dtype=np.float64)
        if len(self.splits) < 2 or not np.all(np.diff(self.splits) > 0):
            raise ValueError("splits must be strictly increasing, length >= 2")
        self.track_nulls = track_nulls
        self.track_invalid = track_invalid
        self.bucket_labels = bucket_labels

    def get_params(self):
        return {
            "splits": [float(s) for s in self.splits],
            "track_nulls": self.track_nulls,
            "track_invalid": self.track_invalid,
            "bucket_labels": self.bucket_labels,
        }

    def transform_columns(self, *cols: Column, num_rows: int) -> VectorColumn:
        col = cols[0]
        assert isinstance(col, NumericColumn)
        values = _encode(
            col.values, col.mask, self.splits, self.track_nulls, self.track_invalid
        )
        f = self.input_features[0]
        metas = _bucket_metas(
            f.name, f.ftype.__name__, self.splits,
            self.track_nulls, self.track_invalid, self.bucket_labels,
        )
        return VectorColumn(
            OPVector, values, VectorMetadata(self.output_name, tuple(metas))
        )


def _tree_splits(
    x: np.ndarray,
    y: np.ndarray,
    max_depth: int = 5,
    min_info_gain: float = 1e-7,
    min_instances: int = 1,
    max_bins: int = 32,
) -> np.ndarray:
    """Thresholds of a single-feature decision tree fit by gini impurity
    (DecisionTreeNumericBucketizer.scala defaults: maxDepth 5, gini,
    minInfoGain 0, maxBins 32). Candidate thresholds are quantile bins like
    Spark's; recursion is host-side (tiny — one feature)."""
    classes, yi = np.unique(y, return_inverse=True)
    k = len(classes)
    if k < 2 or len(x) < 2 * min_instances:
        return np.array([])
    # candidate thresholds: midpoints of up-to-max_bins quantiles
    qs = np.unique(np.quantile(x, np.linspace(0, 1, max_bins + 1)))
    cands = (qs[:-1] + qs[1:]) / 2.0
    out: list[float] = []

    def gini(counts: np.ndarray) -> float:
        n = counts.sum()
        if n == 0:
            return 0.0
        p = counts / n
        return 1.0 - float((p * p).sum())

    def split(lo_mask: np.ndarray, depth: int) -> None:
        if depth >= max_depth:
            return
        xs, ys = x[lo_mask], yi[lo_mask]
        n = len(xs)
        if n < 2 * min_instances:
            return
        total = np.bincount(ys, minlength=k).astype(np.float64)
        parent = gini(total)
        best_gain, best_t = 0.0, None
        for t in cands:
            left = xs <= t
            nl = int(left.sum())
            if nl < min_instances or n - nl < min_instances:
                continue
            cl = np.bincount(ys[left], minlength=k).astype(np.float64)
            cr = total - cl
            gain = parent - (nl / n) * gini(cl) - ((n - nl) / n) * gini(cr)
            if gain > best_gain:
                best_gain, best_t = gain, float(t)
        if best_t is None or best_gain <= min_info_gain:
            return
        out.append(best_t)
        split(lo_mask & (x <= best_t), depth + 1)
        split(lo_mask & (x > best_t), depth + 1)

    split(np.ones(len(x), dtype=bool), 0)
    return np.unique(np.asarray(out))


class DecisionTreeNumericBucketizer(Estimator):
    """Supervised binning: (RealNN label, numeric) → OPVector
    (DecisionTreeNumericBucketizer.scala:60). When the tree finds no useful
    split the output carries only the null-indicator column (if tracked)."""

    input_types = (RealNN, OPNumeric)
    output_type = OPVector
    label_inputs = (0,)  # supervised binning consumes the label by design

    def __init__(
        self,
        max_depth: int = 5,
        min_info_gain: float = 1e-7,
        track_nulls: bool = True,
        track_invalid: bool = True,
        uid: str | None = None,
    ):
        super().__init__("dtNumericBucketized", uid=uid)
        self.max_depth = max_depth
        self.min_info_gain = min_info_gain
        self.track_nulls = track_nulls
        self.track_invalid = track_invalid

    def get_params(self):
        return {
            "max_depth": self.max_depth,
            "min_info_gain": self.min_info_gain,
            "track_nulls": self.track_nulls,
            "track_invalid": self.track_invalid,
        }

    def fit_model(self, dataset) -> "DecisionTreeNumericBucketizerModel":
        label_name, feat_name = self.input_names
        label = dataset[label_name]
        col = dataset[feat_name]
        assert isinstance(label, NumericColumn) and isinstance(col, NumericColumn)
        both = label.mask & col.mask
        inner = _tree_splits(
            col.values[both].astype(np.float64),
            label.values[both].astype(np.float64),
            max_depth=self.max_depth,
            min_info_gain=self.min_info_gain,
        )
        should_split = inner.size > 0
        splits = (
            np.concatenate(([-np.inf], inner, [np.inf]))
            if should_split
            else np.array([-np.inf, np.inf])
        )
        self.metadata["shouldSplit"] = bool(should_split)
        self.metadata["splits"] = [float(s) for s in splits]
        return DecisionTreeNumericBucketizerModel(
            splits=splits,
            should_split=bool(should_split),
            track_nulls=self.track_nulls,
            track_invalid=bool(should_split) and self.track_invalid,
        )


class DecisionTreeNumericBucketizerModel(Model):
    output_type = OPVector
    label_inputs = (0,)  # wired (label, numeric) like its estimator

    def __init__(
        self,
        splits,
        should_split: bool,
        track_nulls: bool,
        track_invalid: bool,
        uid: str | None = None,
    ):
        super().__init__("dtNumericBucketized", uid=uid)
        self.splits = np.asarray(splits, dtype=np.float64)
        self.should_split = should_split
        self.track_nulls = track_nulls
        self.track_invalid = track_invalid

    def get_params(self):
        return {
            "should_split": self.should_split,
            "track_nulls": self.track_nulls,
            "track_invalid": self.track_invalid,
        }

    def get_arrays(self):
        return {"splits": self.splits}

    @classmethod
    def from_params(cls, params, arrays):
        return cls(
            arrays["splits"], params["should_split"],
            params["track_nulls"], params["track_invalid"],
        )

    def transform_columns(self, *cols: Column, num_rows: int) -> VectorColumn:
        col = cols[-1]
        assert isinstance(col, NumericColumn)
        f = self.input_features[-1]
        if not self.should_split:
            # no useful split: emit only the null indicator (if tracked)
            if self.track_nulls:
                values = (~col.mask).astype(np.float32)[:, None]
                metas = [
                    ColumnMeta(
                        parent_names=(f.name,),
                        parent_type=f.ftype.__name__,
                        grouping=f.name,
                        indicator_value=NULL_STRING,
                        index=0,
                    )
                ]
            else:
                values = np.zeros((num_rows, 0), dtype=np.float32)
                metas = []
            return VectorColumn(
                OPVector, values, VectorMetadata(self.output_name, tuple(metas))
            )
        values = _encode(
            col.values, col.mask, self.splits, self.track_nulls, self.track_invalid
        )
        metas = _bucket_metas(
            f.name, f.ftype.__name__, self.splits,
            self.track_nulls, self.track_invalid,
        )
        return VectorColumn(
            OPVector, values, VectorMetadata(self.output_name, tuple(metas))
        )


class DropIndicesByTransformer(Transformer):
    """Drop vector columns whose metadata matches a predicate
    (DropIndicesByTransformer.scala): e.g. drop all null-indicator columns."""

    input_types = (OPVector,)
    output_type = OPVector

    def __init__(self, match_fn, uid: str | None = None):
        super().__init__("dropIndicesBy", uid=uid)
        self.match_fn = decode_callable(match_fn)  # ColumnMeta -> bool (True = drop)

    def get_params(self):
        return {
            "match_fn": encode_callable(
                self.match_fn, type(self).__name__, "match_fn"
            )
        }

    def transform_columns(self, *cols: Column, num_rows: int) -> VectorColumn:
        col = cols[0]
        assert isinstance(col, VectorColumn)
        meta: VectorMetadata | None = col.metadata
        if meta is None:
            raise ValueError("DropIndicesByTransformer requires vector metadata")
        keep = [i for i, m in enumerate(meta.columns) if not self.match_fn(m)]
        values = np.asarray(col.values)[:, keep]
        new_cols = tuple(
            ColumnMeta(
                parent_names=m.parent_names,
                parent_type=m.parent_type,
                grouping=m.grouping,
                indicator_value=m.indicator_value,
                descriptor_value=m.descriptor_value,
                index=j,
            )
            for j, m in enumerate(meta.columns[i] for i in keep)
        )
        return VectorColumn(
            OPVector, values, VectorMetadata(self.output_name, new_cols)
        )
