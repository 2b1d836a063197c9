"""Predictor stage bases: a fitted (label, features) -> Prediction model
whose transform emits the Prediction column (prediction + probability_* +
rawPrediction_*), and the estimator that fits one from dense arrays."""
from __future__ import annotations

import copy
import threading
from typing import Any

import numpy as np
import torch

from ..stages.base import Estimator, Model
from ..types import OPVector, Prediction, RealNN
from ..types.columns import Column, NumericColumn, PredictionColumn, VectorColumn
from ..utils import uid as uid_util


class PredictorModel(Model):
    output_type = Prediction
    #: the CUDA libraries (``csrc/<name>.cu``) this model's predict loads
    #: on the card; a serving service builds them at start
    kernel_libraries: tuple[str, ...] = ()

    def predict_arrays(
        self, x: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray | None, np.ndarray | None]:
        """(prediction [N], probability [N,C]|None, raw [N,C]|None)."""
        raise NotImplementedError

    def transform_columns(self, *cols: Column, num_rows: int) -> PredictionColumn:
        vec = cols[-1]
        if not isinstance(vec, VectorColumn):
            raise TypeError("predictor expects (label, features)")
        pred, prob, raw = self.predict_arrays(
            np.asarray(vec.values, dtype=np.float32)
        )
        return PredictionColumn(
            Prediction,
            np.asarray(pred, dtype=np.float64),
            None if prob is None else np.asarray(prob, dtype=np.float64),
            None if raw is None else np.asarray(raw, dtype=np.float64),
        )


class PredictorEstimator(Estimator):
    """Base for model-family estimators. Subclasses implement
    ``fit_arrays(x, y, row_mask) -> PredictorModel`` and expose their
    hyperparameters as attributes and through ``get_params``."""

    input_types = (RealNN, OPVector)
    output_type = Prediction

    def get_params(self) -> dict[str, Any]:
        return {}

    def extract_xy(self, dataset) -> tuple[np.ndarray, np.ndarray]:
        label_name, vec_name = self.input_names
        label = dataset[label_name]
        vec = dataset[vec_name]
        if not isinstance(label, NumericColumn) or not isinstance(vec, VectorColumn):
            raise TypeError(f"{self}: expected (numeric label, vector) columns")
        return (
            np.asarray(vec.values, dtype=np.float32),
            label.values.astype(np.float32),
        )

    def fit_model(self, dataset) -> PredictorModel:
        x, y = self.extract_xy(dataset)
        return self.fit_arrays(x, y, np.ones(len(y), dtype=np.float32))

    def fit_arrays(
        self, x: np.ndarray, y: np.ndarray, row_mask: np.ndarray
    ) -> PredictorModel:
        raise NotImplementedError

    def with_params(self, **params: Any) -> "PredictorEstimator":
        """A copy with hyperparameters overridden (grid expansion)."""
        c = copy.copy(self)
        c.uid = uid_util.make_uid(type(self))
        c.metadata = {}
        for k, v in params.items():
            if not hasattr(c, k):
                raise AttributeError(f"{type(self).__name__} has no param {k}")
            setattr(c, k, v)
        return c


def num_classes(y: np.ndarray, mask: np.ndarray) -> int:
    """Classes in the labels the mask keeps (at least 2)."""
    present = np.asarray(y)[np.asarray(mask) > 0]
    return max(int(present.max()) + 1 if len(present) else 2, 2)


def collect_lanes(groups, lanes: np.ndarray, n_masks: int, n_points: int,
                  make_model) -> list[list]:
    """models[mask][point] from a sweep's downloaded lanes: ``groups`` is
    [(point indices, lanes of the group)] in download order, each group's
    lanes mask-major (lane = mask * len(indices) + j); ``make_model(lane
    row)`` builds a model from its weights and intercept. Points of no
    group stay None."""
    models: list[list] = [[None] * n_points for _ in range(n_masks)]
    at = 0
    for idxs, n_lanes in groups:
        for mi in range(n_masks):
            for j, i in enumerate(idxs):
                models[mi][i] = make_model(lanes[at + mi * len(idxs) + j])
        at += n_lanes
    return models


def group_grid_by_statics(points, known_keys, statics_of):
    """Group grid-point indices by their static (shape-affecting) params,
    so the dynamic params batch as lanes of one fit; points carrying
    unknown keys fall out to a sequential list. Shared by the logistic and
    linear sweeps. ``statics_of(point) -> hashable key``; returns
    ``(groups, sequential)``, groups mapping key -> [point indices]."""
    groups: dict[Any, list[int]] = {}
    sequential: list[int] = []
    for i, p in enumerate(points):
        if set(p) - known_keys:
            sequential.append(i)
            continue
        groups.setdefault(statics_of(p), []).append(i)
    return groups, sequential


class LinearCoreModel(PredictorModel):
    """A fitted GLM whose core is ``x @ weights + intercept``: the
    reference's float64 host arithmetic, here in float64 on the model's
    device. ``to(device)`` places the coefficients there; a fitted model
    places itself on its fit's device at its first predict. The epilogue
    ``predictions_from_core`` runs on the host in float64."""

    def __init__(self, operation_name: str, uid=None):
        super().__init__(operation_name, uid=uid)
        self.device: torch.device | None = None
        #: where a fitted model places itself at its first predict
        self.default_device: torch.device | None = None
        self._dev_w: torch.Tensor | None = None
        self._dev_b: torch.Tensor | None = None

    def _coefficients(self) -> tuple[np.ndarray, np.ndarray]:
        """(weights [D] or [D, C], intercept scalar or [C]), float64."""
        raise NotImplementedError

    def to(self, device) -> "LinearCoreModel":
        device = torch.device(device)
        if self.device == device:
            return self
        w, b = self._coefficients()
        self._dev_w = torch.from_numpy(np.ascontiguousarray(w, np.float64)).to(device)
        self._dev_b = torch.from_numpy(
            np.ascontiguousarray(b, np.float64).reshape(np.shape(b))).to(device)
        self.device = device
        return self

    def predict_core(self, x: np.ndarray) -> np.ndarray:
        """float64 ``x @ w + b`` on the model's device: [N] (binary margin,
        regression) or [N, C] (multinomial logits)."""
        if self.device is None and self.default_device is not None:
            self.to(self.default_device)
        if self.device is None:
            raise RuntimeError(f"{self}: place the model with .to(device) first")
        x = np.asarray(x, dtype=np.float32)
        d = self._dev_w.shape[0]
        if x.ndim != 2 or x.shape[1] != d:
            raise ValueError(f"{self}: expected [N, {d}] features, got {x.shape}")
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        core = xt.double() @ self._dev_w + self._dev_b
        return core.cpu().numpy()

    def predictions_from_core(self, core: np.ndarray):
        raise NotImplementedError

    def predict_arrays(self, x):
        return self.predictions_from_core(self.predict_core(x))

    def fused_predict_spec(self):
        """The fused graph's device core: the reference's fused arithmetic,
        a float32 ``plane @ w + b`` with float32 copies of the coefficients
        (scores within 1e-6 of the staged float64 core), not the staged
        float64. TF32 is off inside the call, so the product is full
        float32."""
        from ..compiler.fused import PredictorPlan

        w, b = self._coefficients()
        params = {"w": np.asarray(w, dtype=np.float32),
                  "b": np.asarray(b, dtype=np.float32)}

        def core(plane, p):
            with FULL_FLOAT32:
                return plane @ p["w"] + p["b"]

        return PredictorPlan(
            stage=self, in_dim=int(params["w"].shape[0]), params=params,
            core=core, epilogue=self.predictions_from_core,
            outputs_per_row=int(np.prod(params["w"].shape[1:], dtype=int)),
            descriptor=self.fused_descriptor(),
        )

    def fused_descriptor(self) -> str:
        """The predictor's part of the fused program's fingerprint."""
        raise NotImplementedError


class _FullFloat32:
    """Float32 matrix products with TF32 off on the card inside a block.
    The flag is process-wide, so overlapping blocks (threads scoring
    through one closure) share one count: the first to enter turns TF32
    off, the last to leave restores the caller's setting."""

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = False

    def __enter__(self):
        with self._lock:
            if self._depth == 0:
                self._saved = torch.backends.cuda.matmul.allow_tf32
                torch.backends.cuda.matmul.allow_tf32 = False
            self._depth += 1

    def __exit__(self, *exc):
        with self._lock:
            self._depth -= 1
            if self._depth == 0:
                torch.backends.cuda.matmul.allow_tf32 = self._saved
        return False


FULL_FLOAT32 = _FullFloat32()
