"""Forecast evaluator.

Reference: core/.../evaluators/OpForecastEvaluator.scala — SMAPE (default,
smaller better), SeasonalError, and MASE (:83-121): rows are consumed in
order (capped at maxItems, default 87660 = 10 years hourly), the seasonal
error is mean |y_i - y_{i+window}| over the first cnt-window rows, and
MASE = sum|y-yhat| / (seasonalError * cnt). SMAPE sums |y-yhat|/(|y|+|yhat|)
only where the denominator is positive (:103-105), times 2/cnt.
"""
from __future__ import annotations

import numpy as np

from .base import Evaluator


class ForecastEvaluator(Evaluator):
    default_metric = "SMAPE"
    is_larger_better = False
    name = "forecastEval"

    def __init__(self, seasonal_window: int = 1, max_items: int = 87660):
        if seasonal_window <= 0:
            raise ValueError("seasonalWindow must be positive")
        if max_items <= 0:
            raise ValueError("maxItems must be positive")
        self.seasonal_window = seasonal_window
        self.max_items = max_items

    def evaluate_arrays(self, y, pred, prob):
        y = np.asarray(y, dtype=np.float64)[: self.max_items]
        pred = np.asarray(pred, dtype=np.float64)[: self.max_items]
        cnt = len(y)
        abs_diff = np.abs(y - pred)
        denom = np.abs(y) + np.abs(pred)
        safe = np.where(denom > 0, denom, 1.0)
        smape = (
            2.0 * float(np.where(denom > 0, abs_diff / safe, 0.0).sum()) / cnt
            if cnt > 0
            else 0.0
        )
        w = self.seasonal_window
        seasonal_limit = cnt - w
        seasonal_err = (
            float(np.abs(y[:seasonal_limit] - y[w:]).sum()) / seasonal_limit
            if seasonal_limit > 0
            else 0.0
        )
        mase_denom = seasonal_err * cnt
        return {
            "SMAPE": smape,
            "SeasonalError": seasonal_err,
            "MASE": float(abs_diff.sum()) / mase_denom if mase_denom > 0 else 0.0,
            "MAE": float(abs_diff.mean()) if cnt else 0.0,
        }
