"""Logistic regression: the fitted model (binary and multinomial predict)
and the estimator, the port of the JAX package's ``models/logistic.py``.

The estimator fits on the card unless built with ``device="cpu"``: binary
labels through ``solvers.fit_logistic_binary_batched`` (L-BFGS/OWL-QN),
three or more classes through ``solvers.fit_logistic_multinomial_batched``
(FISTA at four times ``max_iter``, as the reference runs it).
``sweep_dispatch_masks`` issues a folds x grid sweep and returns a
collector: the fits run on the device while the caller does other work,
and the collector's download is the sweep's one host sync. Under an
execution mesh the binary sweep runs sharded (``parallel/fit.py::
sweep_parallel_fit``: rows over the data axis, lanes over the model
axis), and ``fit_arrays`` over this rank's rows with the sums
all-reduced. Not ported: the compile plane's donation and executable bank
(A14).
"""
from __future__ import annotations

import numpy as np
import torch

from ..compiler import bucketing
from ..parallel.fit import ambient_fit, sweep_parallel_fit
from ..parallel.mesh import execution_mesh
from ..utils.device import resolve_device
from .base import (
    LinearCoreModel, PredictorEstimator, collect_lanes, group_grid_by_statics,
    num_classes,
)
from .solvers import (
    GLMParams, download_lanes, fit_logistic_binary, fit_logistic_binary_batched,
    fit_logistic_multinomial, fit_logistic_multinomial_batched, packed_lanes,
    to_device,
)


#: FISTA's iterations per ``max_iter`` for the multinomial fit (the
#: reference's budget: binary runs quasi-Newton at ``max_iter``)
MULTINOMIAL_ITERS_PER_MAX_ITER = 4


def _multi_packed(params: GLMParams) -> torch.Tensor:
    """Multinomial lanes as one [K, D * C + C] tensor: the row-major [D, C]
    weights, then the [C] intercept."""
    k = params.weights.shape[0]
    return torch.cat([params.weights.reshape(k, -1), params.intercept], dim=1)


def _lane_model(lane: np.ndarray, num_classes: int, dev) -> "LogisticRegressionModel":
    """A fitted model from one downloaded lane (``packed_lanes`` for two
    classes, ``_multi_packed`` for more)."""
    if num_classes == 2:
        model = LogisticRegressionModel(lane[:-1], lane[-1], 2)
    else:
        dc = lane.shape[0] - num_classes
        model = LogisticRegressionModel(
            lane[:dc].reshape(dc // num_classes, num_classes), lane[dc:],
            num_classes)
    model.default_device = dev
    return model


class LogisticRegressionModel(LinearCoreModel):
    def __init__(self, weights: np.ndarray, intercept: np.ndarray,
                 num_classes: int, uid: str | None = None):
        super().__init__("logreg", uid=uid)
        self.weights = np.asarray(weights, dtype=np.float64)     # [D] or [D, C]
        self.intercept = np.asarray(intercept, dtype=np.float64)  # scalar or [C]
        self.num_classes = num_classes

    def get_arrays(self):
        return {"weights": self.weights, "intercept": self.intercept}

    def get_params(self):
        return {"num_classes": self.num_classes}

    @classmethod
    def from_params(cls, params, arrays):
        return cls(arrays["weights"], arrays["intercept"], params["num_classes"])

    def _coefficients(self):
        return self.weights, self.intercept

    def fused_descriptor(self) -> str:
        return f"logreg:{self.num_classes}"

    def predictions_from_core(self, core: np.ndarray):
        """(pred, prob, raw) from the linear core (binary margin [N] or
        multinomial logits [N, C]): the float64 host epilogue."""
        core = np.asarray(core, dtype=np.float64)
        if self.num_classes == 2:
            margin = core
            p1 = 1.0 / (1.0 + np.exp(-margin))
            prob = np.stack([1.0 - p1, p1], axis=1)
            raw = np.stack([-margin, margin], axis=1)
        else:
            logits = core - core.max(axis=1, keepdims=True)
            e = np.exp(logits)
            prob = e / e.sum(axis=1, keepdims=True)
            raw = logits
        pred = prob.argmax(axis=1).astype(np.float64)
        return pred, prob, raw


class LogisticRegression(PredictorEstimator):
    """Params mirror Spark LR defaults (regParam=0, elasticNetParam=0,
    maxIter=100, standardization=true, fitIntercept=true)."""

    model_type = "OpLogisticRegression"
    #: GLM lanes pad onto lane buckets; the collector split lets a caller
    #: overlap them with tree fits
    lane_family = "glm"

    _KNOWN_KEYS = frozenset(
        ("reg_param", "elastic_net_param", "fit_intercept", "max_iter",
         "standardization")
    )

    def __init__(self, reg_param: float = 0.0, elastic_net_param: float = 0.0,
                 max_iter: int = 100, fit_intercept: bool = True,
                 standardization: bool = True, device=None,
                 uid: str | None = None):
        super().__init__("logreg", uid=uid)
        self.reg_param = reg_param
        self.elastic_net_param = elastic_net_param
        self.max_iter = max_iter
        self.fit_intercept = fit_intercept
        self.standardization = standardization
        #: ``None`` fits on the card; ``"cpu"`` runs on the CPU
        self.device = device

    def get_params(self):
        return {
            "reg_param": self.reg_param,
            "elastic_net_param": self.elastic_net_param,
            "max_iter": self.max_iter,
            "fit_intercept": self.fit_intercept,
            "standardization": self.standardization,
        }

    def fit_arrays(self, x, y, row_mask):
        row_mask = np.asarray(row_mask, dtype=np.float32)
        n_classes = num_classes(y, row_mask)
        dev = resolve_device(self.device)
        if n_classes != 2:
            params = ambient_fit(
                fit_logistic_multinomial,
                np.asarray(x, dtype=np.float32), np.asarray(y, dtype=np.float32),
                row_mask, float(self.reg_param), float(self.elastic_net_param),
                n_classes,
                num_iters=int(self.max_iter) * MULTINOMIAL_ITERS_PER_MAX_ITER,
                fit_intercept=bool(self.fit_intercept),
                standardization=bool(self.standardization), device=dev,
            )
            lane = torch.cat([params.weights.reshape(-1), params.intercept])
            return _lane_model(download_lanes([lane[None]])[0], n_classes, dev)
        params = ambient_fit(
            fit_logistic_binary,
            np.asarray(x, dtype=np.float32), np.asarray(y, dtype=np.float32),
            row_mask, float(self.reg_param), float(self.elastic_net_param),
            num_iters=int(self.max_iter), fit_intercept=bool(self.fit_intercept),
            standardization=bool(self.standardization), device=dev,
        )
        return _lane_model(download_lanes([packed_lanes(params)])[0], 2, dev)

    # ---- batched sweeps ------------------------------------------------

    def _static_groups(self, points) -> tuple[dict, list[int]]:
        """Group point indices by their static params (fit_intercept,
        max_iter, standardization); reg and elastic-net vary inside a group
        and batch as lanes."""
        return group_grid_by_statics(
            points, self._KNOWN_KEYS,
            lambda p: (
                bool(p.get("fit_intercept", self.fit_intercept)),
                int(p.get("max_iter", self.max_iter)),
                bool(p.get("standardization", self.standardization)),
            ),
        )

    def _grid_values(self, points) -> tuple[np.ndarray, np.ndarray]:
        regs = np.asarray(
            [p.get("reg_param", self.reg_param) for p in points],
            dtype=np.float32,
        )
        ens = np.asarray(
            [p.get("elastic_net_param", self.elastic_net_param) for p in points],
            dtype=np.float32,
        )
        return regs, ens

    def fit_arrays_batched(self, x, y, row_mask, grid_points):
        """One mask, many grid points."""
        return self.fit_arrays_batched_masks(x, y, [row_mask], grid_points)[0]

    def _batched_fit(self, xd, yd, rm, regs, ens, n_classes, statics,
                     dev) -> torch.Tensor:
        """One static group's lanes on the device: binary [k, D + 1], the
        lane count padded onto its bucket with copies of lane 0 and the
        real lanes sliced back with ``[:k]``; multinomial [k, D * C + C],
        unpadded, as the reference's ``vmap`` runs them."""
        fit_intercept, max_iter, standardization = statics
        mesh = execution_mesh()
        if mesh is not None:
            # the sharded sweep: lanes over the model axis, rows over the
            # data axis, every sum over rows all-reduced
            fit_fn, name, kw = (
                (fit_logistic_binary_batched, "sweep_logistic_binary_sharded",
                 dict(num_iters=max_iter)) if n_classes == 2 else
                (fit_logistic_multinomial_batched,
                 "sweep_logistic_multinomial_sharded",
                 dict(num_classes=n_classes,
                      num_iters=max_iter * MULTINOMIAL_ITERS_PER_MAX_ITER)))
            out = sweep_parallel_fit(
                fit_fn, name, mesh, xd, yd, rm, regs, ens,
                fit_intercept=fit_intercept, standardization=standardization,
                device=dev, **kw)
            return packed_lanes(out) if n_classes == 2 else _multi_packed(out)
        if n_classes != 2:
            return _multi_packed(fit_logistic_multinomial_batched(
                xd, yd, rm, regs, ens, n_classes,
                num_iters=max_iter * MULTINOMIAL_ITERS_PER_MAX_ITER,
                fit_intercept=fit_intercept, standardization=standardization,
                device=dev))
        k, (rm, regs, ens) = bucketing.bucket_sweep_lanes(rm, regs, ens)
        out = fit_logistic_binary_batched(
            xd, yd, rm, regs, ens, num_iters=max_iter,
            fit_intercept=fit_intercept, standardization=standardization,
            device=dev,
        )
        return packed_lanes(out)[:k]

    def sweep_dispatch_masks(self, x, y, masks, grid_points):
        """Issue the folds x grid sweep and return a collector closure.

        Each same-(fit_intercept, max_iter, standardization) group batches
        its (fold mask, reg, elastic-net) triples, mask-major, as the lanes
        of one fit; points with unknown params fit sequentially inside the
        collector. The fits are issued here; the collector downloads every
        group's lanes in one copy and builds the models."""
        masks = [np.asarray(m, dtype=np.float32) for m in masks]
        groups, sequential = self._static_groups(grid_points)
        n_classes = num_classes(y, np.max(np.stack(masks), axis=0))
        n_masks = len(masks)
        dev = resolve_device(self.device)
        stacked_groups: list[tuple[list[int], torch.Tensor]] = []
        if groups:
            xd, yd = to_device(x, dev), to_device(y, dev)
            masksp = np.stack(masks)
            for statics, idxs in groups.items():
                pts = [grid_points[i] for i in idxs]
                regs, ens = self._grid_values(pts * n_masks)
                rm = np.repeat(masksp, len(pts), axis=0)  # [K, N], mask-major
                stacked_groups.append((idxs, self._batched_fit(
                    xd, yd, rm, regs, ens, n_classes, statics, dev)))

        def make_model(lane):
            return _lane_model(lane, n_classes, dev)

        def collect() -> list[list]:
            lanes = (download_lanes([s for _, s in stacked_groups])
                     if stacked_groups else None)
            models = collect_lanes(
                [(idxs, s.shape[0]) for idxs, s in stacked_groups], lanes,
                n_masks, len(grid_points), make_model)
            for i in sequential:
                est = self.with_params(**grid_points[i])
                for mi, m in enumerate(masks):
                    models[mi][i] = est.fit_arrays(x, y, m)
            return models

        return collect

    def fit_arrays_batched_masks(self, x, y, masks, grid_points):
        """Folds x grid in as few fits as the grid's static params allow:
        dispatch, then collect at once."""
        return self.sweep_dispatch_masks(x, y, masks, grid_points)()
