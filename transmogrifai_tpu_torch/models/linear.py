"""Linear regression with elastic net: the fitted model and the
estimator, the port of the JAX package's ``models/linear.py``.

``fit_arrays`` runs ``solvers.fit_linear``; sweeps run
``solvers.fit_linear_batched`` with the dispatch / collect split of the
logistic estimator (one host sync, the collector's download). Under an
execution mesh the sweep runs sharded (``parallel/fit.py::
sweep_parallel_fit``) and ``fit_arrays`` over this rank's rows with the
sums all-reduced.
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
)
from .solvers import (
    download_lanes, fit_linear, fit_linear_batched, packed_lanes, to_device,
)


class LinearRegressionModel(LinearCoreModel):
    def __init__(self, weights: np.ndarray, intercept: float, uid: str | None = None):
        super().__init__("linreg", uid=uid)
        self.weights = np.asarray(weights, dtype=np.float64)
        self.intercept = float(intercept)

    def get_arrays(self):
        return {"weights": self.weights, "intercept": np.float64(self.intercept)}

    @classmethod
    def from_params(cls, params, arrays):
        return cls(arrays["weights"], float(arrays["intercept"]))

    def _coefficients(self):
        return self.weights, np.float64(self.intercept)

    def fused_descriptor(self) -> str:
        return "linreg"

    def predictions_from_core(self, core: np.ndarray):
        return np.asarray(core, dtype=np.float64), None, None


def _iters(max_iter) -> int:
    """FISTA's budget for a Spark ``maxIter``."""
    return max(int(max_iter) * 4, 200)


class LinearRegression(PredictorEstimator):
    model_type = "OpLinearRegression"
    #: GLM lanes pad onto lane buckets; the collector split lets a caller
    #: overlap them with tree fits
    lane_family = "glm"

    _KNOWN_KEYS = frozenset(
        ("reg_param", "elastic_net_param", "fit_intercept", "max_iter")
    )

    def __init__(self, reg_param: float = 0.0, elastic_net_param: float = 0.0,
                 max_iter: int = 100, fit_intercept: bool = True, device=None,
                 uid: str | None = None):
        super().__init__("linreg", uid=uid)
        self.reg_param = reg_param
        self.elastic_net_param = elastic_net_param
        self.max_iter = max_iter
        self.fit_intercept = fit_intercept
        #: ``None`` fits on the card; ``"cpu"`` runs on the CPU
        self.device = device

    def get_params(self):
        return {
            "reg_param": self.reg_param,
            "elastic_net_param": self.elastic_net_param,
            "max_iter": self.max_iter,
            "fit_intercept": self.fit_intercept,
        }

    def fit_arrays(self, x, y, row_mask):
        dev = resolve_device(self.device)
        params = ambient_fit(
            fit_linear,
            np.asarray(x, dtype=np.float32), np.asarray(y, dtype=np.float32),
            np.asarray(row_mask, dtype=np.float32), float(self.reg_param),
            float(self.elastic_net_param), num_iters=_iters(self.max_iter),
            fit_intercept=bool(self.fit_intercept), device=dev,
        )
        lane = download_lanes([packed_lanes(params)])[0]
        model = LinearRegressionModel(lane[:-1], lane[-1])
        model.default_device = dev
        return model

    def sweep_dispatch_masks(self, x, y, masks, grid_points):
        """Issue the folds x grid sweep and return a collector closure.

        Same-(fit_intercept, max_iter) groups batch their (fold mask, reg,
        elastic-net) triples, mask-major, as the lanes of one
        ``fit_linear_batched``, the lane count padded onto its bucket;
        points with unknown params fit sequentially inside the collector."""
        masks = [np.asarray(m, dtype=np.float32) for m in masks]
        n_masks = len(masks)
        groups, sequential = group_grid_by_statics(
            grid_points, self._KNOWN_KEYS,
            lambda p: (
                bool(p.get("fit_intercept", self.fit_intercept)),
                int(p.get("max_iter", self.max_iter)),
            ),
        )
        dev = resolve_device(self.device)
        mesh = execution_mesh()
        stacked_groups: list[tuple[list[int], torch.Tensor]] = []
        if groups:
            xd, yd = to_device(x, dev), to_device(y, dev)
        for (fit_intercept, max_iter), idxs in groups.items():
            pts = [grid_points[i] for i in idxs] * n_masks
            regs = np.asarray(
                [p.get("reg_param", self.reg_param) for p in pts],
                dtype=np.float32,
            )
            ens = np.asarray(
                [p.get("elastic_net_param", self.elastic_net_param)
                 for p in pts],
                dtype=np.float32,
            )
            rm = np.repeat(np.stack(masks), len(idxs), axis=0)  # mask-major
            if mesh is not None:
                out = sweep_parallel_fit(
                    fit_linear_batched, "sweep_linear_sharded", mesh, xd, yd,
                    rm, regs, ens, num_iters=_iters(max_iter),
                    fit_intercept=fit_intercept, device=dev)
                stacked_groups.append((idxs, packed_lanes(out)))
                continue
            k, (rm, regs, ens) = bucketing.bucket_sweep_lanes(rm, regs, ens)
            out = fit_linear_batched(
                xd, yd, rm, regs, ens, num_iters=_iters(max_iter),
                fit_intercept=fit_intercept, device=dev,
            )
            stacked_groups.append((idxs, packed_lanes(out)[:k]))

        def make_model(lane):
            model = LinearRegressionModel(lane[:-1], lane[-1])
            model.default_device = dev
            return model

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

    def fit_arrays_batched(self, x, y, row_mask, grid_points):
        """One mask, many grid points."""
        return self.fit_arrays_batched_masks(x, y, [row_mask], grid_points)[0]
