"""Isotonic regression calibrator, the port of the JAX package's
``models/isotonic.py`` (host numpy, as there).

Reference: core/.../stages/impl/regression/IsotonicRegressionCalibrator.scala
— BinaryEstimator[RealNN label, RealNN score] -> RealNN wrapping Spark
IsotonicRegression (univariate, isotonic=true by default). Fit is the
pool-adjacent-violators algorithm; prediction interpolates linearly between
learned boundaries exactly as Spark's IsotonicRegressionModel does.

PAV is inherently sequential over *distinct score values* (tiny after the
tie-collapse), so it runs host-side in numpy; scoring is vectorized
interpolation (np.interp == Spark's linear interpolation + boundary clamp).
"""
from __future__ import annotations

import numpy as np

from ..dataset import Dataset
from ..stages.base import Estimator, Model
from ..types import RealNN
from ..types.columns import Column, NumericColumn


def _pav(x: np.ndarray, y: np.ndarray, w: np.ndarray):
    """Pool-adjacent-violators on (x sorted ascending, y, weights); returns
    (boundaries, predictions) like Spark's IsotonicRegressionModel."""
    order = np.argsort(x, kind="stable")
    xs, ys, ws = x[order], y[order].astype(np.float64), w[order].astype(np.float64)
    # collapse ties on x (weighted mean) — Spark does this pre-pass
    ux, inv = np.unique(xs, return_inverse=True)
    wsum = np.bincount(inv, weights=ws)
    ysum = np.bincount(inv, weights=ys * ws)
    ym = ysum / np.maximum(wsum, 1e-300)
    # stack-based PAV; pooling mutates the stack tops in place so the whole
    # fit is O(n) even on all-distinct continuous scores
    vals: list[float] = []
    wts: list[float] = []
    lo: list[int] = []
    hi: list[int] = []
    for i in range(len(ux)):
        vals.append(float(ym[i])); wts.append(float(wsum[i])); lo.append(i); hi.append(i)
        while len(vals) > 1 and vals[-2] > vals[-1]:
            w2 = wts[-2] + wts[-1]
            v = (vals[-2] * wts[-2] + vals[-1] * wts[-1]) / w2
            h2 = hi[-1]
            vals.pop(); wts.pop(); lo.pop(); hi.pop()
            vals[-1] = v; wts[-1] = w2; hi[-1] = h2
    boundaries: list[float] = []
    predictions: list[float] = []
    for v, l, h in zip(vals, lo, hi):
        boundaries.append(float(ux[l])); predictions.append(v)
        if h != l:
            boundaries.append(float(ux[h])); predictions.append(v)
    return np.asarray(boundaries), np.asarray(predictions)


class IsotonicRegressionCalibratorModel(Model):
    output_type = RealNN

    def __init__(self, boundaries, predictions, isotonic: bool = True, uid=None):
        super().__init__("isotonicCalibrator", uid=uid)
        self.boundaries = np.asarray(boundaries, dtype=np.float64)
        self.predictions = np.asarray(predictions, dtype=np.float64)
        self.isotonic = isotonic

    def get_arrays(self):
        return {"boundaries": self.boundaries, "predictions": self.predictions}

    def get_params(self):
        return {"isotonic": self.isotonic}

    @classmethod
    def from_params(cls, params, arrays):
        return cls(arrays["boundaries"], arrays["predictions"],
                   params.get("isotonic", True))

    def transform_columns(self, *cols: Column, num_rows: int) -> NumericColumn:
        score = cols[-1]
        assert isinstance(score, NumericColumn)
        x = score.values.astype(np.float64)
        # boundaries are stored ascending for both directions (fit reverses
        # the antitonic solution), so plain interpolation covers both.
        out = np.interp(x, self.boundaries, self.predictions)
        return NumericColumn(RealNN, out, np.ones(num_rows, dtype=bool))


class IsotonicRegressionCalibrator(Estimator):
    """BinaryEstimator[(RealNN label, RealNN score)] -> RealNN calibrated."""

    input_types = (RealNN, RealNN)
    output_type = RealNN

    def __init__(self, isotonic: bool = True, uid: str | None = None):
        super().__init__("isotonicCalibrator", uid=uid)
        self.isotonic = isotonic

    def get_params(self):
        return {"isotonic": self.isotonic}

    def fit_model(self, dataset: Dataset) -> IsotonicRegressionCalibratorModel:
        label_name, score_name = self.input_names
        label = dataset[label_name]
        score = dataset[score_name]
        assert isinstance(label, NumericColumn) and isinstance(score, NumericColumn)
        y = label.values.astype(np.float64)
        x = score.values.astype(np.float64)
        if not self.isotonic:
            x = -x
        b, p = _pav(x, y, np.ones_like(y))
        if not self.isotonic:
            b = (-b)[::-1]
            p = p[::-1]
        self.metadata["numBoundaries"] = int(len(b))
        return IsotonicRegressionCalibratorModel(b, p, self.isotonic)
