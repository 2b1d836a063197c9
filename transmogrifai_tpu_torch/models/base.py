"""Predictor stage bases: a fitted (label, features) -> Prediction model
whose transform emits the Prediction column (prediction + probability_* +
rawPrediction_*), and the estimator that fits one from dense arrays."""
from __future__ import annotations

import copy
from typing import Any

import numpy as np

from ..stages.base import Estimator, Model
from ..types import OPVector, Prediction, RealNN
from ..types.columns import Column, NumericColumn, PredictionColumn, VectorColumn
from ..utils import uid as uid_util


class PredictorModel(Model):
    output_type = Prediction

    def predict_arrays(
        self, x: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray | None, np.ndarray | None]:
        """(prediction [N], probability [N,C]|None, raw [N,C]|None)."""
        raise NotImplementedError

    def transform_columns(self, *cols: Column, num_rows: int) -> PredictionColumn:
        vec = cols[-1]
        if not isinstance(vec, VectorColumn):
            raise TypeError("predictor expects (label, features)")
        pred, prob, raw = self.predict_arrays(
            np.asarray(vec.values, dtype=np.float32)
        )
        return PredictionColumn(
            Prediction,
            np.asarray(pred, dtype=np.float64),
            None if prob is None else np.asarray(prob, dtype=np.float64),
            None if raw is None else np.asarray(raw, dtype=np.float64),
        )


class PredictorEstimator(Estimator):
    """Base for model-family estimators. Subclasses implement
    ``fit_arrays(x, y, row_mask) -> PredictorModel`` and expose their
    hyperparameters as attributes and through ``get_params``."""

    input_types = (RealNN, OPVector)
    output_type = Prediction

    def get_params(self) -> dict[str, Any]:
        return {}

    def extract_xy(self, dataset) -> tuple[np.ndarray, np.ndarray]:
        label_name, vec_name = self.input_names
        label = dataset[label_name]
        vec = dataset[vec_name]
        if not isinstance(label, NumericColumn) or not isinstance(vec, VectorColumn):
            raise TypeError(f"{self}: expected (numeric label, vector) columns")
        return (
            np.asarray(vec.values, dtype=np.float32),
            label.values.astype(np.float32),
        )

    def fit_model(self, dataset) -> PredictorModel:
        x, y = self.extract_xy(dataset)
        return self.fit_arrays(x, y, np.ones(len(y), dtype=np.float32))

    def fit_arrays(
        self, x: np.ndarray, y: np.ndarray, row_mask: np.ndarray
    ) -> PredictorModel:
        raise NotImplementedError

    def with_params(self, **params: Any) -> "PredictorEstimator":
        """A copy with hyperparameters overridden (grid expansion)."""
        c = copy.copy(self)
        c.uid = uid_util.make_uid(type(self))
        c.metadata = {}
        for k, v in params.items():
            if not hasattr(c, k):
                raise AttributeError(f"{type(self).__name__} has no param {k}")
            setattr(c, k, v)
        return c
