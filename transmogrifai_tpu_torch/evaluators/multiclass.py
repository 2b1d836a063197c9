"""Multiclass evaluator.

Reference: core/.../evaluators/OpMultiClassificationEvaluator.scala:307 —
weighted precision/recall/F1, error, topK accuracy, and confidence-binned
ThresholdMetrics. Default selection metric: F1 (weighted), larger better.
"""
from __future__ import annotations

import numpy as np

from .base import Evaluator


def calculate_threshold_metrics(
    prob: np.ndarray,          # [N, C] class probabilities
    y: np.ndarray,             # [N] true class indices
    top_ns: tuple[int, ...] = (1, 3),
    thresholds: np.ndarray | None = None,
) -> dict:
    """Confidence-binned correct/incorrect/no-prediction counts.

    Parity: OpMultiClassificationEvaluator.calculateThresholdMetrics
    (OpMultiClassificationEvaluator.scala:153-238; defaults topNs (1,3)
    :74, thresholds 0.00..1.00 step .01 :84). Per row, at threshold j a
    topN prediction is *correct* when the true class is in the top-N
    scores AND the true-class score clears the threshold; *incorrect*
    when the top score clears it but the true class doesn't (or isn't in
    the top N); otherwise *no prediction*. The three count arrays sum to
    N at every threshold. Unseen labels (index ≥ C) score 0.0 (:192).
    Vectorized as tail-counts of searchsorted cutoff indices instead of
    the reference's per-row treeAggregate."""
    if thresholds is None:
        thresholds = np.arange(101) / 100.0
    thresholds = np.asarray(thresholds, dtype=np.float64)
    if len(thresholds) == 0:
        raise ValueError("thresholds cannot be empty")
    if ((thresholds < 0) | (thresholds > 1)).any():
        raise ValueError("thresholds must be in [0, 1]")
    if (np.diff(thresholds) < 0).any():
        # searchsorted requires ascending thresholds; unsorted input would
        # silently produce garbage counts
        raise ValueError("thresholds must be sorted ascending")
    if len(top_ns) == 0 or any(t <= 0 for t in top_ns):
        raise ValueError("topNs must be positive")
    n, c = prob.shape
    n_t = len(thresholds)
    y_int = np.asarray(y).astype(int)
    seen = (y_int >= 0) & (y_int < c)
    true_score = np.where(
        seen, prob[np.arange(n), np.clip(y_int, 0, c - 1)], 0.0
    )
    top_score = prob.max(axis=1)
    # indexWhere(_ > s): number of thresholds <= s (thresholds ascending)
    t_cut = np.searchsorted(thresholds, true_score, side="right")
    m_cut = np.searchsorted(thresholds, top_score, side="right")
    order = np.argsort(-prob, axis=1, kind="stable")

    def tail_counts(cuts, mask):
        """counts[j] = #selected rows whose cutoff index exceeds j."""
        h = np.bincount(cuts[mask], minlength=n_t + 1)
        ge = np.cumsum(h[::-1])[::-1]  # ge[v] = #rows with cut >= v
        return ge[1:]

    correct, incorrect, nopred = {}, {}, {}
    for t in top_ns:
        kk = min(t, c)
        in_top = (order[:, :kk] == y_int[:, None]).any(axis=1)
        corr = tail_counts(t_cut, in_top)
        # in-top rows: incorrect on [trueCut, maxCut); others: [0, maxCut)
        inc = (tail_counts(m_cut, in_top) - corr) + tail_counts(m_cut, ~in_top)
        correct[str(t)] = corr.tolist()
        incorrect[str(t)] = inc.tolist()
        nopred[str(t)] = (n - corr - inc).tolist()
    return {
        "topNs": [int(t) for t in top_ns],
        "thresholds": [float(x) for x in thresholds],
        "correctCounts": correct,
        "incorrectCounts": incorrect,
        "noPredictionCounts": nopred,
    }


class MultiClassificationEvaluator(Evaluator):
    default_metric = "F1"
    is_larger_better = True
    name = "multiEval"

    def __init__(
        self,
        top_ks: tuple[int, ...] = (1, 3, 5, 10, 20, 50, 100),
        top_ns: tuple[int, ...] = (1, 3),
        thresholds: np.ndarray | None = None,
    ):
        self.top_ks = top_ks
        self.top_ns = top_ns
        self.thresholds = thresholds

    def evaluate_arrays(self, y, pred, prob):
        classes = np.unique(np.concatenate([y, pred]))
        n = max(len(y), 1)
        weights, precisions, recalls, f1s = [], [], [], []
        for c in classes:
            tp = float(((pred == c) & (y == c)).sum())
            fp = float(((pred == c) & (y != c)).sum())
            fn = float(((pred != c) & (y == c)).sum())
            support = float((y == c).sum())
            p = tp / (tp + fp) if tp + fp > 0 else 0.0
            r = tp / (tp + fn) if tp + fn > 0 else 0.0
            f = 2 * p * r / (p + r) if p + r > 0 else 0.0
            weights.append(support / n)
            precisions.append(p)
            recalls.append(r)
            f1s.append(f)
        w = np.asarray(weights)
        metrics = {
            "Precision": float(np.dot(w, precisions)),
            "Recall": float(np.dot(w, recalls)),
            "F1": float(np.dot(w, f1s)),
            "Error": float((pred != y).mean()),
        }
        if prob is not None and prob.ndim == 2:
            order = np.argsort(-prob, axis=1)
            y_int = y.astype(int)
            topk = {}
            for k in self.top_ks:
                kk = min(k, prob.shape[1])
                hit = (order[:, :kk] == y_int[:, None]).any(axis=1)
                topk[str(k)] = float(hit.mean())
            metrics["TopKAccuracy"] = topk
            metrics["ThresholdMetrics"] = calculate_threshold_metrics(
                prob, y, top_ns=self.top_ns, thresholds=self.thresholds
            )
        return metrics
