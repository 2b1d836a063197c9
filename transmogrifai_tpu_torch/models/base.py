"""Predictor model base: a fitted (label, features) -> Prediction stage whose
transform emits the Prediction column (prediction + probability_* +
rawPrediction_*)."""
from __future__ import annotations

import numpy as np

from ..stages.base import Model
from ..types import Prediction
from ..types.columns import Column, PredictionColumn, VectorColumn


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
