"""SelectedModel — the model selector's fitted winner: it delegates predict
to the best inner model and carries the selection summary."""
from __future__ import annotations

from typing import Any

import numpy as np

from ..models.base import PredictorModel


class SelectedModel(PredictorModel):
    def __init__(self, best_model: PredictorModel, summary: dict[str, Any], uid=None):
        super().__init__("modelSelector", uid=uid)
        self.best_model = best_model
        self.metadata["modelSelectorSummary"] = summary

    def to(self, device) -> "SelectedModel":
        self.best_model.to(device)
        return self

    def predict_arrays(self, x: np.ndarray):
        return self.best_model.predict_arrays(x)

    @classmethod
    def from_params(cls, params, arrays):
        from ..workflow.persistence import construct_stage

        inner_arrays = {
            k[len("best__"):]: v for k, v in arrays.items()
            if k.startswith("best__")
        }
        inner = construct_stage(
            params["best_model_class"], params["best_model_params"], inner_arrays
        )
        return cls(inner, params.get("summary", {}))
