"""Regression evaluator.

Reference: core/.../evaluators/OpRegressionEvaluator.scala — RMSE (default,
smaller better), MSE, R2, MAE, plus the signed-percentage-error histogram
(:63-71 default bins [-inf, -100..100 by 10, +inf]; :75-95 scaledErrorCutoff
1e-3 with optional smartCutoffRatio; :183-190 error formula
100*(pred-label)/max(|label|, cutoff)).
"""
from __future__ import annotations

import numpy as np

from .base import Evaluator


def signed_percentage_error_histogram(
    pred: np.ndarray,
    y: np.ndarray,
    bins: np.ndarray | None = None,
    scaled_error_cutoff: float = 1e-3,
    smart_cutoff_ratio: float | None = None,
) -> dict:
    """Histogram of 100*(pred-y)/max(|y|, cutoff) over ``bins``.

    With ``smart_cutoff_ratio`` set, the cutoff becomes
    max(ratio * mean|y|, scaled_error_cutoff)
    (OpRegressionEvaluator.calculateSmartCutoff:170-177)."""
    if bins is None:
        bins = np.concatenate(
            [[-np.inf], np.arange(-100.0, 101.0, 10.0), [np.inf]]
        )
    bins = np.asarray(bins, dtype=np.float64)
    finite = bins[np.isfinite(bins)]
    if len(bins) < 2 or (np.diff(finite) < 0).any():
        raise ValueError("histogram bins must be sorted")
    cutoff = scaled_error_cutoff
    if smart_cutoff_ratio is not None:
        cutoff = max(
            smart_cutoff_ratio * float(np.mean(np.abs(y))), scaled_error_cutoff
        )
    errors = 100.0 * (pred - y) / np.maximum(np.abs(y), cutoff)
    counts, _ = np.histogram(errors, bins=bins)
    return {
        "bins": [float(b) for b in bins],
        "counts": [int(c) for c in counts],
        "scaledErrorCutoff": float(cutoff),
    }


class RegressionEvaluator(Evaluator):
    default_metric = "RMSE"
    is_larger_better = False
    name = "regEval"

    def __init__(
        self,
        histogram_bins: np.ndarray | None = None,
        scaled_error_cutoff: float = 1e-3,
        smart_cutoff_ratio: float | None = None,
    ):
        self.histogram_bins = histogram_bins
        self.scaled_error_cutoff = scaled_error_cutoff
        self.smart_cutoff_ratio = smart_cutoff_ratio

    def evaluate_arrays(self, y, pred, prob):
        err = y - pred
        mse = float(np.mean(err**2))
        ss_tot = float(np.sum((y - y.mean()) ** 2))
        ss_res = float(np.sum(err**2))
        return {
            "RMSE": float(np.sqrt(mse)),
            "MSE": mse,
            "R2": 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0,
            "MAE": float(np.mean(np.abs(err))),
            "SignedPercentageErrorHistogram": signed_percentage_error_histogram(
                pred, y,
                bins=self.histogram_bins,
                scaled_error_cutoff=self.scaled_error_cutoff,
                smart_cutoff_ratio=self.smart_cutoff_ratio,
            ),
        }
