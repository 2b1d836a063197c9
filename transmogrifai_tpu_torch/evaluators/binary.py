"""Binary classification evaluator.

Reference: core/.../evaluators/OpBinaryClassificationEvaluator.scala —
AuROC, AuPR, Precision, Recall, F1, Error, TP/TN/FP/FN and threshold curves.
Default selection metric: AuPR (larger better), matching
BinaryClassificationModelSelector's default.

AuROC/AuPR follow mllib's BinaryClassificationMetrics semantics: sort by
descending score, one curve point per distinct score threshold, trapezoidal
area for ROC and rectangular-interpolation area for PR.
"""
from __future__ import annotations

import numpy as np

from .base import Evaluator


def _curve_counts(y: np.ndarray, score: np.ndarray):
    """Cumulative TP/FP at each distinct descending score threshold."""
    order = np.argsort(-score, kind="stable")
    ys = y[order]
    ss = score[order]
    tp = np.cumsum(ys)
    fp = np.cumsum(1.0 - ys)
    # keep last index of each run of equal scores
    distinct = np.nonzero(np.diff(ss, append=-np.inf))[0]
    return tp[distinct], fp[distinct], ss[distinct]


def auroc(y: np.ndarray, score: np.ndarray) -> float:
    pos, neg = y.sum(), (1.0 - y).sum()
    if pos == 0 or neg == 0:
        return 0.0
    tp, fp, _ = _curve_counts(y, score)
    tpr = np.concatenate([[0.0], tp / pos, [1.0]])
    fpr = np.concatenate([[0.0], fp / neg, [1.0]])
    return float(np.trapezoid(tpr, fpr))


def aupr(y: np.ndarray, score: np.ndarray) -> float:
    pos = y.sum()
    if pos == 0:
        return 0.0
    tp, fp, _ = _curve_counts(y, score)
    precision = tp / np.maximum(tp + fp, 1e-12)
    recall = tp / pos
    # mllib prepends (0, p@first) and uses trapezoids
    recall = np.concatenate([[0.0], recall])
    precision = np.concatenate([[precision[0]], precision])
    return float(np.trapezoid(precision, recall))


class BinaryClassificationEvaluator(Evaluator):
    default_metric = "AuPR"
    is_larger_better = True
    name = "binEval"

    def __init__(self, num_thresholds: int = 100):
        self.num_thresholds = num_thresholds

    def evaluate_arrays(self, y, pred, prob):
        score = prob[:, 1] if prob is not None and prob.ndim == 2 else pred
        tp = float(((pred == 1) & (y == 1)).sum())
        tn = float(((pred == 0) & (y == 0)).sum())
        fp = float(((pred == 1) & (y == 0)).sum())
        fn = float(((pred == 0) & (y == 1)).sum())
        n = max(len(y), 1)
        precision = tp / (tp + fp) if tp + fp > 0 else 0.0
        recall = tp / (tp + fn) if tp + fn > 0 else 0.0
        f1 = (
            2 * precision * recall / (precision + recall)
            if precision + recall > 0
            else 0.0
        )
        thresholds = np.linspace(0.0, 1.0, self.num_thresholds, endpoint=False)
        curve_p, curve_r, curve_f = [], [], []
        for t in thresholds:
            p_t = (score >= t).astype(np.float64)
            tp_t = float(((p_t == 1) & (y == 1)).sum())
            fp_t = float(((p_t == 1) & (y == 0)).sum())
            fn_t = float(((p_t == 0) & (y == 1)).sum())
            pr = tp_t / (tp_t + fp_t) if tp_t + fp_t > 0 else 0.0
            rc = tp_t / (tp_t + fn_t) if tp_t + fn_t > 0 else 0.0
            curve_p.append(pr)
            curve_r.append(rc)
            curve_f.append(2 * pr * rc / (pr + rc) if pr + rc > 0 else 0.0)
        return {
            "AuROC": auroc(y, score),
            "AuPR": aupr(y, score),
            "Precision": precision,
            "Recall": recall,
            "F1": f1,
            "Error": (fp + fn) / n,
            "TP": tp,
            "TN": tn,
            "FP": fp,
            "FN": fn,
            "thresholds": thresholds.tolist(),
            "precisionByThreshold": curve_p,
            "recallByThreshold": curve_r,
            "f1ByThreshold": curve_f,
        }
