"""Prediction-map accessors.

Reference: core/.../dsl/RichMapFeature.scala:1118-1152: the Prediction
feature (a RealMap keyed prediction / probability_* / rawPrediction_*,
types/Maps.scala:339) exposes ``tupled()`` / ``apply`` extractors that give
the predicted value as RealNN and the probability and raw vectors as
OPVector features for downstream stages. Over the port's ``PredictionColumn``
(dense arrays), as ``transmogrifai_tpu/ops/prediction.py`` reads its own.
"""
from __future__ import annotations

import numpy as np

from ..stages.base import Transformer
from ..stages.metadata import ColumnMeta, VectorMetadata
from ..types import OPVector, Prediction, RealNN
from ..types.columns import (
    Column,
    NumericColumn,
    PredictionColumn,
    VectorColumn,
)

_FIELDS = ("prediction", "probability", "rawPrediction")


class PredictionFieldExtractor(Transformer):
    """Prediction → RealNN (``prediction``) or OPVector
    (``probability`` / ``rawPrediction``)."""

    input_types = (Prediction,)

    def __init__(self, field: str = "prediction", uid: str | None = None):
        if field not in _FIELDS:
            raise ValueError(f"field must be one of {_FIELDS}, got {field!r}")
        super().__init__(f"pred_{field}", uid=uid)
        self.field = field

    @property
    def output_type(self):  # type: ignore[override]
        return RealNN if self.field == "prediction" else OPVector

    def get_params(self):
        return {"field": self.field}

    def transform_columns(self, *cols: Column, num_rows: int) -> Column:
        col = cols[0]
        assert isinstance(col, PredictionColumn), type(col)
        if self.field == "prediction":
            vals = np.asarray(col.prediction, dtype=np.float64)
            return NumericColumn(RealNN, vals, np.ones(num_rows, dtype=bool))
        arr = col.probability if self.field == "probability" else col.raw
        if arr is None:  # regression predictions carry no class vectors
            arr = np.zeros((num_rows, 0), dtype=np.float64)
        arr = np.asarray(arr, dtype=np.float32)
        name = self.output_name
        f = self.input_features[0] if self.input_features else None
        metas = tuple(
            ColumnMeta(
                parent_names=(f.name,) if f is not None else (),
                parent_type=Prediction.__name__,
                grouping=self.field,
                descriptor_value=f"{self.field}_{j}",
                index=j,
            )
            for j in range(arr.shape[1])
        )
        return VectorColumn(OPVector, arr, VectorMetadata(name, metas))
