"""Evaluator base.

Reference: core/.../evaluators/OpEvaluatorBase.scala — an evaluator consumes
(label, prediction) and produces a metrics record; a designated single metric
with ``is_larger_better`` drives model selection.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from ..types.columns import NumericColumn, PredictionColumn


EvalMetrics = Mapping[str, Any]


class Evaluator:
    #: name of the metric used for model selection
    default_metric: str = ""
    #: whether larger values of default_metric are better (isLargerBetter)
    is_larger_better: bool = True
    name: str = "evaluator"

    def evaluate_arrays(
        self,
        y: np.ndarray,
        pred: np.ndarray,
        prob: np.ndarray | None,
    ) -> dict[str, Any]:
        raise NotImplementedError

    def evaluate(self, label_col: NumericColumn, pred_col: PredictionColumn) -> dict[str, Any]:
        y = label_col.values.astype(np.float64)
        return self.evaluate_arrays(
            y,
            np.asarray(pred_col.prediction, dtype=np.float64),
            None if pred_col.probability is None else np.asarray(pred_col.probability),
        )

    def metric_of(self, metrics: EvalMetrics) -> float:
        return float(metrics[self.default_metric])
