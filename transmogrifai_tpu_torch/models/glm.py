"""Generalized linear regression (IRLS), the port of the JAX package's
``models/glm.py``.

Reference: core/.../stages/impl/regression/OpGeneralizedLinearRegression.
scala wraps Spark GeneralizedLinearRegression (families gaussian, binomial,
poisson, gamma; canonical and explicit links; IRLS with maxIter=25; L2
regParam). The fit is ``solvers.fit_glm_irls`` on the device; the model's
core is the float64 linear predictor on its device and the host epilogue
the link's inverse. ``fused_predict_spec`` (``LinearCoreModel``) puts a
winner in the fused graph as a float32 ``plane @ w + b``.
"""
from __future__ import annotations

import numpy as np

from ..utils.device import resolve_device
from .base import LinearCoreModel, PredictorEstimator
from .solvers import (
    GLM_DEFAULT_LINK, GLM_FAMILIES, GLM_LINKS, download_lanes, fit_glm_irls,
    packed_lanes,
)


def _linkinv_np(eta: np.ndarray, link: str) -> np.ndarray:
    if link == "identity":
        return eta
    if link == "log":
        return np.exp(eta)
    if link == "logit":
        return 1.0 / (1.0 + np.exp(-eta))
    if link == "inverse":
        safe = np.where(np.abs(eta) > 1e-7, eta, 1e-7)
        return 1.0 / safe
    if link == "sqrt":
        return eta * eta
    raise ValueError(f"unknown link {link}")


class GeneralizedLinearRegressionModel(LinearCoreModel):
    def __init__(self, weights, intercept, family: str, link: str, uid=None):
        super().__init__("glm", uid=uid)
        self.weights = np.asarray(weights, dtype=np.float64)
        self.intercept = float(np.asarray(intercept))
        self.family = family
        self.link = link

    def get_arrays(self):
        return {"weights": self.weights, "intercept": np.asarray(self.intercept)}

    def get_params(self):
        return {"family": self.family, "link": self.link}

    @classmethod
    def from_params(cls, params, arrays):
        return cls(arrays["weights"], arrays["intercept"],
                   params["family"], params["link"])

    def _coefficients(self):
        return self.weights, np.float64(self.intercept)

    def fused_descriptor(self) -> str:
        return f"glm:{self.family}:{self.link}"

    def predictions_from_core(self, core: np.ndarray):
        """The host epilogue shared by staged predict and the fused graph:
        the link's inverse over the linear predictor eta."""
        mu = _linkinv_np(np.asarray(core, dtype=np.float64), self.link)
        return mu.astype(np.float64), None, None


class GeneralizedLinearRegression(PredictorEstimator):
    """Spark defaults: family='gaussian', link=canonical, regParam=0,
    maxIter=25, fitIntercept=true (OpGeneralizedLinearRegression.scala)."""

    model_type = "OpGeneralizedLinearRegression"

    def __init__(self, family: str = "gaussian", link: str | None = None,
                 reg_param: float = 0.0, max_iter: int = 25,
                 fit_intercept: bool = True, device=None,
                 uid: str | None = None):
        super().__init__("glm", uid=uid)
        if family not in GLM_FAMILIES:
            raise ValueError(f"unknown family {family}")
        link = link or GLM_DEFAULT_LINK[family]
        if link not in GLM_LINKS:
            raise ValueError(f"unknown link {link}")
        self.family = family
        self.link = link
        self.reg_param = reg_param
        self.max_iter = max_iter
        self.fit_intercept = fit_intercept
        #: ``None`` fits on the card; ``"cpu"`` runs on the CPU
        self.device = device

    def get_params(self):
        return {
            "family": self.family,
            "link": self.link,
            "reg_param": self.reg_param,
            "max_iter": self.max_iter,
            "fit_intercept": self.fit_intercept,
        }

    def with_params(self, **params):
        # a grid point that changes the family without naming a link takes
        # the new family's canonical link, not this instance's resolved one
        if "family" in params and "link" not in params:
            params = {**params, "link": GLM_DEFAULT_LINK[params["family"]]}
        return super().with_params(**params)

    def fit_arrays(self, x, y, row_mask):
        dev = resolve_device(self.device)
        params = fit_glm_irls(
            np.asarray(x, dtype=np.float32), np.asarray(y, dtype=np.float32),
            np.asarray(row_mask, dtype=np.float32), float(self.reg_param),
            family=GLM_FAMILIES[self.family], link=GLM_LINKS[self.link],
            num_iters=int(self.max_iter),
            fit_intercept=bool(self.fit_intercept), device=dev,
        )
        lane = download_lanes([packed_lanes(params)])[0]
        model = GeneralizedLinearRegressionModel(
            lane[:-1], lane[-1], self.family, self.link)
        model.default_device = dev
        return model
