"""Naive Bayes classifier (multinomial and bernoulli), the port of the JAX
package's ``models/naive_bayes.py``.

Reference: core/.../stages/impl/classification/OpNaiveBayes.scala wraps
Spark NaiveBayes (modelType multinomial|bernoulli, smoothing=1.0). The fit
is one product on the device, the per-class feature sums
``one_hot(y).T @ x``, plus logs; negative features are refused on the host
before anything is uploaded. Scoring is the reference's float64 numpy on
the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .base import PredictorEstimator, PredictorModel, num_classes
from .solvers import _check_precision, to_device


def _fit_nb(x: torch.Tensor, y: torch.Tensor, row_mask: torch.Tensor,
            smoothing: float, n_classes: int, bernoulli: bool):
    """(log priors [C], log feature likelihoods [C, D]) in float32."""
    s = float(np.float32(smoothing))
    y1h = (y.long()[:, None] == torch.arange(n_classes, device=x.device)
           ).to(x.dtype) * row_mask[:, None]
    class_count = y1h.sum(0)                                # [C]
    pi = torch.log(class_count + s) - torch.log(
        class_count.sum() + s * n_classes)
    xb = (x > 0).to(x.dtype) if bernoulli else x
    feat_sum = y1h.T @ xb                                   # [C, D]
    if bernoulli:
        theta = torch.log(feat_sum + s) - torch.log(
            (class_count + 2.0 * s)[:, None])
    else:
        theta = torch.log(feat_sum + s) - torch.log(
            (feat_sum.sum(1) + s * x.shape[1])[:, None])
    return pi, theta


class NaiveBayesModel(PredictorModel):
    def __init__(self, pi, theta, model_kind: str = "multinomial", uid=None):
        super().__init__("naiveBayes", uid=uid)
        self.pi = np.asarray(pi, dtype=np.float64)        # [C]
        self.theta = np.asarray(theta, dtype=np.float64)  # [C, D]
        self.model_kind = model_kind

    def get_arrays(self):
        return {"pi": self.pi, "theta": self.theta}

    def get_params(self):
        return {"model_kind": self.model_kind}

    @classmethod
    def from_params(cls, params, arrays):
        return cls(arrays["pi"], arrays["theta"],
                   params.get("model_kind", "multinomial"))

    def predict_arrays(self, x: np.ndarray):
        if self.model_kind == "bernoulli":
            # Spark's bernoulli score: pi + x.theta + (1-x).log(1 - e^theta)
            xb = (x > 0).astype(np.float64)
            neg = np.log1p(-np.minimum(np.exp(self.theta), 1.0 - 1e-12))
            raw = self.pi + xb @ self.theta.T + (1.0 - xb) @ neg.T
        else:
            raw = self.pi + x @ self.theta.T
        shifted = raw - raw.max(axis=1, keepdims=True)
        e = np.exp(shifted)
        prob = e / e.sum(axis=1, keepdims=True)
        pred = raw.argmax(axis=1).astype(np.float64)
        return pred, prob, raw


class NaiveBayes(PredictorEstimator):
    """Spark defaults: smoothing=1.0, modelType='multinomial'
    (OpNaiveBayes.scala). Features must be non-negative (count-like)."""

    model_type = "OpNaiveBayes"

    def __init__(self, smoothing: float = 1.0, model_kind: str = "multinomial",
                 device=None, uid: str | None = None):
        super().__init__("naiveBayes", uid=uid)
        if model_kind not in ("multinomial", "bernoulli"):
            raise ValueError(f"unknown modelType {model_kind}")
        self.smoothing = smoothing
        self.model_kind = model_kind
        #: ``None`` fits on the card; ``"cpu"`` runs on the CPU
        self.device = device

    def get_params(self):
        return {"smoothing": self.smoothing, "model_kind": self.model_kind}

    def fit_arrays(self, x, y, row_mask):
        row_mask = np.asarray(row_mask, dtype=np.float32)
        n_classes = num_classes(y, row_mask)
        if np.any(np.asarray(x)[row_mask > 0] < 0):
            raise ValueError(
                "NaiveBayes requires non-negative feature values "
                "(Spark NaiveBayes semantics)"
            )
        dev = resolve_device(self.device)
        _check_precision(dev)
        pi, theta = _fit_nb(
            to_device(x, dev), to_device(y, dev), to_device(row_mask, dev),
            self.smoothing, n_classes, self.model_kind == "bernoulli",
        )
        return NaiveBayesModel(pi.cpu().numpy(), theta.cpu().numpy(),
                               self.model_kind)
