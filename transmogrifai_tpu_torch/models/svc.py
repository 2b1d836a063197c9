"""Linear SVM classifier, the port of the JAX package's ``models/svc.py``.

Reference: core/.../stages/impl/classification/OpLinearSVC.scala wraps
Spark LinearSVC (hinge loss, L2, OWL-QN). The fit is
``solvers.fit_linear_svc`` on the device (FISTA on the Huberized hinge,
four steps per Spark iteration); the model's core is the float64 margin
``x @ w + b`` on its device. An SVC has no probability column (Spark emits
rawPrediction only), so the evaluators rank by the margin; like the
reference's, the model has no fused device predict.
"""
from __future__ import annotations

import numpy as np

from ..utils.device import resolve_device
from .base import LinearCoreModel, PredictorEstimator
from .solvers import download_lanes, fit_linear_svc, packed_lanes


class LinearSVCModel(LinearCoreModel):
    def __init__(self, weights, intercept, uid=None):
        super().__init__("linearSVC", uid=uid)
        self.weights = np.asarray(weights, dtype=np.float64)
        self.intercept = float(np.asarray(intercept))

    def get_arrays(self):
        return {"weights": self.weights,
                "intercept": np.asarray(self.intercept)}

    @classmethod
    def from_params(cls, params, arrays):
        return cls(arrays["weights"], arrays["intercept"])

    def _coefficients(self):
        return self.weights, np.float64(self.intercept)

    def predictions_from_core(self, core: np.ndarray):
        margin = np.asarray(core, dtype=np.float64)
        raw = np.stack([-margin, margin], axis=1)
        return (margin > 0).astype(np.float64), None, raw

    def fused_predict_spec(self):
        from ..compiler.fused import Unfuseable

        raise Unfuseable("LinearSVCModel has no fused device predict")


class LinearSVC(PredictorEstimator):
    """Spark defaults: regParam=0.0, maxIter=100, standardization=true,
    fitIntercept=true (OpLinearSVC.scala)."""

    model_type = "OpLinearSVC"

    def __init__(self, reg_param: float = 0.0, max_iter: int = 100,
                 fit_intercept: bool = True, standardization: bool = True,
                 device=None, uid: str | None = None):
        super().__init__("linearSVC", uid=uid)
        self.reg_param = reg_param
        self.max_iter = max_iter
        self.fit_intercept = fit_intercept
        self.standardization = standardization
        #: ``None`` fits on the card; ``"cpu"`` runs on the CPU
        self.device = device

    def get_params(self):
        return {
            "reg_param": self.reg_param,
            "max_iter": self.max_iter,
            "fit_intercept": self.fit_intercept,
            "standardization": self.standardization,
        }

    def fit_arrays(self, x, y, row_mask):
        # the smoothed-hinge FISTA takes ~4 steps per OWL-QN iteration
        dev = resolve_device(self.device)
        params = fit_linear_svc(
            np.asarray(x, dtype=np.float32), np.asarray(y, dtype=np.float32),
            np.asarray(row_mask, dtype=np.float32), float(self.reg_param),
            num_iters=int(self.max_iter) * 4,
            fit_intercept=bool(self.fit_intercept),
            standardization=bool(self.standardization), device=dev,
        )
        lane = download_lanes([packed_lanes(params)])[0]
        model = LinearSVCModel(lane[:-1], lane[-1])
        model.default_device = dev
        return model
