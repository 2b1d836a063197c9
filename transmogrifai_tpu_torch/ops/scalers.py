"""Scaling stages: the standard scaler, mean imputation, the scaler /
descaler pair and the percentile calibrator.

Reference: core/.../stages/impl/feature/{OpScalarStandardScaler,
FillMissingWithMean, ScalerTransformer, DescalerTransformer,
PercentileCalibrator}.scala. The fits are one pass over the present values
(mean and sample standard deviation, or a quantile table) and the
transforms are elementwise, all in float64 numpy on the host as in
``transmogrifai_tpu/ops/scalers.py``, so the fitted state and the outputs
equal the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np

from ..stages.base import Estimator, Model, Transformer
from ..types import OPNumeric, Real, RealNN
from ..types.columns import Column, NumericColumn


class OpScalarStandardScaler(Estimator):
    """(x - mean) / std over a numeric column (OpScalarStandardScaler.scala;
    withMean and withStd on by default)."""

    input_types = (OPNumeric,)
    output_type = RealNN

    def __init__(
        self,
        with_mean: bool = True,
        with_std: bool = True,
        uid: str | None = None,
    ):
        super().__init__("stdScaled", uid=uid)
        self.with_mean = with_mean
        self.with_std = with_std

    def get_params(self):
        return {"with_mean": self.with_mean, "with_std": self.with_std}

    def fit_model(self, dataset) -> "OpScalarStandardScalerModel":
        col = dataset[self.input_names[0]]
        assert isinstance(col, NumericColumn)
        x = col.values[col.mask].astype(np.float64)
        mean = float(x.mean()) if x.size else 0.0
        # Spark's StandardScaler takes the sample (corrected) deviation
        std = float(x.std(ddof=1)) if x.size > 1 else 1.0
        if std == 0.0:
            std = 1.0
        self.metadata["mean"] = mean
        self.metadata["std"] = std
        return OpScalarStandardScalerModel(
            mean=mean if self.with_mean else 0.0,
            std=std if self.with_std else 1.0,
        )


class OpScalarStandardScalerModel(Model):
    output_type = RealNN

    def __init__(self, mean: float, std: float, uid: str | None = None):
        super().__init__("stdScaled", uid=uid)
        self.mean = float(mean)
        self.std = float(std)

    def get_params(self):
        return {"mean": self.mean, "std": self.std}

    @classmethod
    def from_params(cls, params, arrays):
        return cls(params["mean"], params["std"])

    def transform_columns(self, *cols: Column, num_rows: int) -> NumericColumn:
        col = cols[0]
        assert isinstance(col, NumericColumn)
        out = (col.values.astype(np.float64) - self.mean) / self.std
        return NumericColumn(RealNN, np.where(col.mask, out, 0.0), col.mask)


class FillMissingWithMean(Estimator):
    """Real -> RealNN with the missing values filled by the training mean
    (FillMissingWithMean.scala; ``default`` when every value is missing)."""

    input_types = (OPNumeric,)
    output_type = RealNN

    def __init__(self, default: float = 0.0, uid: str | None = None):
        super().__init__("fillWithMean", uid=uid)
        self.default = float(default)

    def get_params(self):
        return {"default": self.default}

    def fit_model(self, dataset) -> "FillMissingWithMeanModel":
        col = dataset[self.input_names[0]]
        assert isinstance(col, NumericColumn)
        x = col.values[col.mask].astype(np.float64)
        mean = float(x.mean()) if x.size else self.default
        self.metadata["mean"] = mean
        return FillMissingWithMeanModel(mean)


class FillMissingWithMeanModel(Model):
    output_type = RealNN

    def __init__(self, mean: float, uid: str | None = None):
        super().__init__("fillWithMean", uid=uid)
        self.mean = float(mean)

    def get_params(self):
        return {"mean": self.mean}

    @classmethod
    def from_params(cls, params, arrays):
        return cls(params["mean"])

    def transform_columns(self, *cols: Column, num_rows: int) -> NumericColumn:
        col = cols[0]
        assert isinstance(col, NumericColumn)
        out = np.where(col.mask, col.values.astype(np.float64), self.mean)
        return NumericColumn(RealNN, out, np.ones(num_rows, dtype=bool))


class ScalingType(enum.Enum):
    """ScalerTransformer.scala's scaling families."""

    LINEAR = "Linear"
    LOGARITHMIC = "Logarithmic"


@dataclasses.dataclass(frozen=True)
class LinearScalerArgs:
    slope: float = 1.0
    intercept: float = 0.0


class ScalerTransformer(Transformer):
    """A named, invertible scaling (ScalerTransformer.scala). The family and
    its args are kept in the stage's metadata; a ``DescalerTransformer``
    downstream inverts them."""

    input_types = (OPNumeric,)
    output_type = Real

    def __init__(
        self,
        scaling_type: ScalingType | str = ScalingType.LINEAR,
        args: LinearScalerArgs | dict | None = None,
        uid: str | None = None,
    ):
        super().__init__("scaled", uid=uid)
        # the saved forms are accepted, so a loaded model rebuilds it
        if isinstance(scaling_type, str):
            scaling_type = ScalingType(scaling_type)
        if isinstance(args, dict):
            args = LinearScalerArgs(**args)
        self.scaling_type = scaling_type
        self.args = args or LinearScalerArgs()
        self.metadata["scalingType"] = scaling_type.value
        self.metadata["scalingArgs"] = dataclasses.asdict(self.args)

    def get_params(self):
        return {
            "scaling_type": self.scaling_type.value,
            "args": dataclasses.asdict(self.args),
        }

    def transform_columns(self, *cols: Column, num_rows: int) -> NumericColumn:
        col = cols[0]
        assert isinstance(col, NumericColumn)
        x = col.values.astype(np.float64)
        if self.scaling_type is ScalingType.LINEAR:
            out = self.args.slope * x + self.args.intercept
            mask = col.mask
        else:
            with np.errstate(divide="ignore", invalid="ignore"):
                out = np.log(x)
            mask = col.mask & np.isfinite(out)
        return NumericColumn(Real, np.where(mask, out, 0.0), mask)

    def invert(self, values: np.ndarray) -> np.ndarray:
        if self.scaling_type is ScalingType.LINEAR:
            return (values - self.args.intercept) / self.args.slope
        return np.exp(values)


class DescalerTransformer(Transformer):
    """Inverts the scaling of a ``ScalerTransformer`` upstream
    (DescalerTransformer.scala): input 1 is the value to descale, input 2
    the scaled feature whose origin stage is the scaler. The scaler is
    found through that feature's ``origin_stage``, so a loaded model finds
    the loaded scaler."""

    input_types = (OPNumeric, OPNumeric)
    output_type = Real

    def __init__(self, uid: str | None = None):
        super().__init__("descaled", uid=uid)

    def _scaler(self) -> ScalerTransformer:
        origin = self.input_features[1].origin_stage
        if not isinstance(origin, ScalerTransformer):
            raise ValueError(
                "DescalerTransformer input2 must come from a ScalerTransformer"
            )
        return origin

    def transform_columns(self, *cols: Column, num_rows: int) -> NumericColumn:
        col = cols[0]
        assert isinstance(col, NumericColumn)
        out = self._scaler().invert(col.values.astype(np.float64))
        finite = np.isfinite(out)
        return NumericColumn(
            Real, np.where(col.mask & finite, out, 0.0), col.mask & finite
        )


class PercentileCalibrator(Estimator):
    """Maps scores onto percentile ranks 0 .. ``expected_num_buckets`` - 1
    (PercentileCalibrator.scala:48: quantile splits, then the bucket ids
    rescaled onto 0..99 by default)."""

    input_types = (RealNN,)
    output_type = RealNN

    def __init__(self, expected_num_buckets: int = 100, uid: str | None = None):
        super().__init__("percentCalibrated", uid=uid)
        self.expected_num_buckets = int(expected_num_buckets)

    def get_params(self):
        return {"expected_num_buckets": self.expected_num_buckets}

    def fit_model(self, dataset) -> "PercentileCalibratorModel":
        col = dataset[self.input_names[0]]
        assert isinstance(col, NumericColumn)
        x = col.values[col.mask].astype(np.float64)
        qs = np.linspace(0.0, 1.0, self.expected_num_buckets + 1)
        splits = np.unique(np.quantile(x, qs)) if x.size else np.array([0.0])
        n_bins = max(len(splits) - 1, 1)
        self.metadata["actualNumBuckets"] = int(n_bins)
        self.metadata["expectedNumBuckets"] = self.expected_num_buckets
        self.metadata["origSplits"] = [float(s) for s in splits]
        return PercentileCalibratorModel(splits, self.expected_num_buckets)


class PercentileCalibratorModel(Model):
    output_type = RealNN

    def __init__(self, splits, expected_num_buckets: int, uid: str | None = None):
        super().__init__("percentCalibrated", uid=uid)
        self.splits = np.asarray(splits, dtype=np.float64)
        self.expected_num_buckets = int(expected_num_buckets)

    def get_params(self):
        return {"expected_num_buckets": self.expected_num_buckets}

    def get_arrays(self):
        return {"splits": self.splits}

    @classmethod
    def from_params(cls, params, arrays):
        return cls(arrays["splits"], params["expected_num_buckets"])

    def transform_columns(self, *cols: Column, num_rows: int) -> NumericColumn:
        col = cols[0]
        assert isinstance(col, NumericColumn)
        x = col.values.astype(np.float64)
        n_bins = max(len(self.splits) - 1, 1)
        idx = np.clip(
            np.searchsorted(self.splits[1:-1], x, side="right"), 0, n_bins - 1
        )
        # bucket ids rescaled onto 0 .. expected - 1
        if n_bins > 1:
            out = idx * (self.expected_num_buckets - 1) / (n_bins - 1)
            out = np.floor(out)
        else:
            out = np.zeros_like(x)
        return NumericColumn(RealNN, out, np.ones(num_rows, dtype=bool))
