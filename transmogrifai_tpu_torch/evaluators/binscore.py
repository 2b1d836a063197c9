"""Bin-score (calibration) evaluator.

Reference: core/.../evaluators/OpBinScoreEvaluator.scala — bins the positive-
class score range into `num_bins` equal-width bins over [min, max] observed
score and reports per-bin average score / conversion rate / counts plus the
overall Brier score (the selection metric; smaller is better).
"""
from __future__ import annotations

import logging

import numpy as np

from .base import Evaluator

log = logging.getLogger(__name__)


class BinScoreEvaluator(Evaluator):
    default_metric = "BrierScore"
    is_larger_better = False
    name = "binScore"

    def __init__(self, num_bins: int = 100):
        if num_bins <= 0:
            raise ValueError("num_bins must be positive")
        self.num_bins = num_bins

    def evaluate_arrays(self, y, pred, prob):
        if prob is not None and prob.ndim == 2:
            score = prob[:, 1]
        else:
            # calibration metrics need a probability score; hard predictions
            # degenerate to two bins and a misclassification-rate Brier
            log.warning(
                "BinScoreEvaluator: no probability column available — "
                "binning hard predictions; calibration metrics will be "
                "degenerate (use a probabilistic classifier)"
            )
            score = np.asarray(pred, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n = len(y)
        if n == 0:
            return {
                "BrierScore": 0.0, "binSize": 0.0, "binCenters": [],
                "numberOfDataPoints": [], "numberOfPositiveLabels": [],
                "averageScore": [], "averageConversionRate": [],
            }
        lo, hi = float(score.min()), float(score.max())
        diff = hi - lo
        # getBinIndex (OpBinScoreEvaluator.scala:137-139): equal-width over
        # the observed range, top edge clamped into the last bin
        if diff > 0:
            idx = np.minimum(
                (self.num_bins * (score - lo) / diff).astype(np.int64),
                self.num_bins - 1,
            )
        else:
            idx = np.zeros(n, dtype=np.int64)
        counts = np.bincount(idx, minlength=self.num_bins).astype(np.int64)
        score_sum = np.bincount(idx, weights=score, minlength=self.num_bins)
        pos = np.bincount(idx, weights=y, minlength=self.num_bins)
        sq_err = np.bincount(idx, weights=(score - y) ** 2, minlength=self.num_bins)
        safe = np.maximum(counts, 1)
        avg_score = np.where(counts > 0, score_sum / safe, 0.0)
        conv_rate = np.where(counts > 0, pos / safe, 0.0)
        bin_size = diff / self.num_bins
        centers = [lo + bin_size * (i + 0.5) for i in range(self.num_bins)]
        return {
            "BrierScore": float(sq_err.sum() / n),
            "binSize": bin_size,
            "binCenters": centers,
            "numberOfDataPoints": counts.tolist(),
            "numberOfPositiveLabels": pos.astype(np.int64).tolist(),
            "averageScore": avg_score.tolist(),
            "averageConversionRate": conv_rate.tolist(),
        }
