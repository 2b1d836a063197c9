"""Tree-ensemble predictor stages: the XGBoost, GBT, random-forest and
decision-tree classifiers (binary and one-vs-rest multiclass) and
regressors (estimators and fitted models).

A model holds its quantile thresholds and stacked trees as numpy arrays,
from a saved model or from a fit; ``to(device)`` validates them once, packs
each stack into the traversal kernel's node layout on the host
(``serve_trees.pack_trees``) and places it on the device (a fitted model
places itself on its fit's device at its first predict). Every predict bins the
batch there, runs the traversal (the ``serve_trees`` kernel on the card),
reduces per family, and finishes with the float64 host epilogue
``predictions_from_core``. The reduction follows the JAX package's route
for the batch: tree order up to ``TPTPU_HOST_PREDICT_MAX`` rows (default
16384; its host route), its device route's leaf-window order above.

The estimators bin the training matrix on the device once, then grow
trees through ``trees.py``; ``fit_arrays_batched_masks`` fits folds x grid
points that share their static shape as the K lanes of one batched fit.
On three or more classes the boosted families and the decision trees fit
one-vs-rest, model by model, as the reference does; the random forest
fits masks x points x classes lanes in one batched fit, lane
``(mask * n_points + point) * C + c`` training class c's indicator.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..utils.cuda_build import is_kernel_fault
from ..utils.device import resolve_device
from . import serve_trees as ST
from . import trees as TR
from .base import PredictorEstimator, PredictorModel
from .base import num_classes as _num_classes

def _sigmoid(m: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-m))


def _tree_from_arrays(arrays: dict, prefix: str = "") -> TR.Tree:
    return TR.Tree(
        split_feat=arrays[f"{prefix}split_feat"],
        split_bin=arrays[f"{prefix}split_bin"],
        leaf_value=arrays[f"{prefix}leaf_value"],
    )


def _class_trees_from_arrays(arrays: dict) -> list[TR.Tree]:
    out = []
    c = 0
    while f"c{c}__split_feat" in arrays:
        out.append(_tree_from_arrays(arrays, prefix=f"c{c}__"))
        c += 1
    return out


def _validate_stack(t: TR.Tree, num_features: int) -> None:
    """Shape and index checks, once per model placement: the kernel reads
    ``binned[r, split_feat]`` unchecked."""
    sf = np.asarray(t.split_feat)
    lv = np.asarray(t.leaf_value)
    if sf.ndim != 3 or np.asarray(t.split_bin).shape != sf.shape:
        raise ValueError(f"tree stack: bad split array shape {sf.shape}")
    if lv.shape != (sf.shape[0], 1 << sf.shape[1]):
        raise ValueError(
            f"tree stack: leaf table {lv.shape} does not match depth "
            f"{sf.shape[1]} (expected {(sf.shape[0], 1 << sf.shape[1])})"
        )
    if sf.size and (sf.max() >= num_features or sf.min() < -1):
        raise ValueError(
            f"tree stack: split feature index out of [-1, {num_features}) "
            f"(min {sf.min()}, max {sf.max()})"
        )


class _BinnedModel(PredictorModel):
    """Shared state for binned-tree models."""

    #: K1 walks the stacks, the tree sum adds them (both routes)
    kernel_libraries = ("serve_trees", "tree_sum")

    def __init__(self, operation_name: str, thresholds: np.ndarray, uid=None):
        super().__init__(operation_name, uid=uid)
        self.thresholds = np.asarray(thresholds, dtype=np.float32)
        self.device: torch.device | None = None
        #: where a fitted model places itself at its first predict
        self.default_device: torch.device | None = None
        self._dev_thr: torch.Tensor | None = None
        self.device_stacks: list[ST.PackedTrees] = []
        #: per stack, its leaf-window stack (the device route's; made at the
        #: first batch that takes that route)
        self.window_stacks: list[ST.PackedTrees] = []

    def _tree_stacks(self) -> tuple[list[TR.Tree], bool]:
        """(host tree stacks, one per output column; boosted?)"""
        raise NotImplementedError

    def to(self, device) -> "_BinnedModel":
        device = torch.device(device)
        if self.device == device:
            return self
        stacks, _ = self._tree_stacks()
        num_f = self.thresholds.shape[0]
        for t in stacks:
            _validate_stack(t, num_f)

        def host(a, dtype):
            return torch.tensor(np.asarray(a, dtype=dtype))

        self._dev_thr = host(self.thresholds, np.float32).to(device)
        # the kernel's node layout, packed here once from the host arrays
        self.device_stacks = [
            ST.pack_trees(
                host(t.split_feat, np.int32), host(t.split_bin, np.int32),
                host(t.leaf_value, np.float32), num_f,
            ).to(device)
            for t in stacks
        ]
        self.window_stacks = []
        self.device = device
        return self

    def _use_host(self, x) -> bool:
        """Whether the JAX package would score this batch on its host route
        (tree order) rather than its device route: ``len(x)`` at most
        ``TPTPU_HOST_PREDICT_MAX`` (default 16384), read per call as the
        reference reads it."""
        return len(x) <= int(os.environ.get("TPTPU_HOST_PREDICT_MAX", "16384"))

    def predict_core(self, x: np.ndarray) -> np.ndarray:
        """float64 [N, k] of margins (boosted) or mean-leaf values (forest),
        one column per tree stack, computed on the model's device."""
        if self.device is None and self.default_device is not None:
            self.to(self.default_device)
        if self.device is None:
            raise RuntimeError(f"{self}: place the model with .to(device) first")
        x = np.asarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.thresholds.shape[0]:
            raise ValueError(
                f"{self}: expected [N, {self.thresholds.shape[0]}] features, "
                f"got {x.shape}"
            )
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        core = self.device_core(xt, device_route=not self._use_host(x))
        return core.cpu().numpy().astype(np.float64)

    def _window_stacks(self) -> list[ST.PackedTrees]:
        """Each stack's leaf-window stack, made once (the device route's)."""
        if not self.window_stacks:
            self.window_stacks = [ST.window_stack(p) for p in self.device_stacks]
        return self.window_stacks

    def device_core(self, xt: torch.Tensor, device_route: bool) -> torch.Tensor:
        """float32 [N, k] core of a float32 [N, F] tensor on the model's
        device: ``bin_data``, then per stack the walk (K1) and its sum, in
        the reference's device-route order or its tree order. The staged
        predict and the fused graph's core both run this."""
        _, boosted = self._tree_stacks()
        binned = TR.bin_data(xt, self._dev_thr)
        eta, base = ((self.eta, self.base_score) if boosted else (0.0, 0.0))
        if device_route:
            outs = [ST.predict_device_route(binned, t, w, boosted, eta, base)
                    for t, w in zip(self.device_stacks, self._window_stacks())]
        elif boosted:
            outs = [ST.predict_boosted(binned, t, eta, base)
                    for t in self.device_stacks]
        else:
            outs = [ST.predict_forest(binned, t) for t in self.device_stacks]
        # one stack (every ported family's) is a view: no device copy
        return outs[0][:, None] if len(outs) == 1 else torch.stack(outs, dim=1)

    def fused_predict_spec(self):
        """The fused graph's device core: ``device_core`` over the plane on
        its device route (the fused graph runs only above the host-predict
        cutoff, as the reference's does), the window stacks made here, once
        before the first batch; the epilogue is the staged one, so scores
        are equal."""
        from ..compiler.fused import PredictorPlan, Unfuseable

        if self.device is None and self.default_device is not None:
            self.to(self.default_device)
        if self.device is None:
            raise Unfuseable(f"{self} is not placed on a device")
        stacks, boosted = self._tree_stacks()
        self._window_stacks()
        return PredictorPlan(
            stage=self, in_dim=int(self.thresholds.shape[0]), params={},
            core=lambda plane, p: self.device_core(plane, device_route=True),
            epilogue=self.predictions_from_core, outputs_per_row=len(stacks),
            descriptor=f"{'boost' if boosted else 'forest'}:{len(stacks)}",
        )

    def fused_bin_thresholds(self) -> np.ndarray:
        """Per-input bin edges for the quantized plane: bin-aligned codes
        that re-bin to themselves on the device, so quantized tree scores
        equal the float32 plane's (``featurize/quantize.py``)."""
        return np.asarray(self.thresholds, dtype=np.float32)

    def predictions_from_core(self, core: np.ndarray):
        """(pred, prob, raw) from the [N, k] core: the float64 host tail."""
        raise NotImplementedError

    def predict_arrays(self, x):
        return self.predictions_from_core(self.predict_core(x))

    def detach_from_sweep(self) -> None:
        """Drop this model's references to its sweep's stack (every lane's
        trees and [K, N] training outputs), so the selected model does not
        keep the whole folds x grid sweep alive; its trees are its own
        copy."""
        for attr in ("_sweep_stack", "_sweep_lane", "_sweep_lanes"):
            self.__dict__.pop(attr, None)


class BoostedBinaryModel(_BinnedModel):
    def __init__(self, thresholds, trees: TR.Tree, eta: float, base_score: float, uid=None):
        super().__init__("xgbClassifier", thresholds, uid=uid)
        self.trees = trees
        self.eta = float(eta)
        self.base_score = float(base_score)

    @classmethod
    def from_params(cls, params, arrays):
        return cls(
            arrays["thresholds"], _tree_from_arrays(arrays),
            params["eta"], params["base_score"],
        )

    def get_arrays(self):
        return _stack_arrays(self.thresholds, self.trees)

    def get_params(self):
        return {"eta": self.eta, "base_score": self.base_score}

    def _tree_stacks(self):
        return [self.trees], True

    def predictions_from_core(self, core):
        return self.predictions_from_sweep(
            np.asarray(core, dtype=np.float64)[:, 0]
        )

    # ---- the validators' batched sweep evaluation ------------------------
    def predictions_from_sweep(self, margin):
        """(pred, prob, raw) from a lane's margins, in the reference's
        arithmetic: the sigmoid in float64, ``raw`` in the margins' own
        dtype (float32 from a sweep's outputs)."""
        p1 = _sigmoid(np.asarray(margin, dtype=np.float64))
        prob = np.stack([1 - p1, p1], axis=1)
        raw = np.stack([-margin, margin], axis=1)
        return (p1 > 0.5).astype(np.float64), prob, raw


class BoostedMultiModel(_BinnedModel):
    """One-vs-rest stack of boosted binary models: per class a sigmoid of
    its margin, the row normalised by its sum (floored at 1e-12), then the
    argmax."""

    def __init__(self, thresholds, trees_per_class: list[TR.Tree], eta: float,
                 base_score: float, uid=None):
        super().__init__("xgbClassifier", thresholds, uid=uid)
        self.trees_per_class = trees_per_class
        self.eta = float(eta)
        self.base_score = float(base_score)

    @classmethod
    def from_params(cls, params, arrays):
        return cls(
            arrays["thresholds"], _class_trees_from_arrays(arrays),
            params["eta"], params["base_score"],
        )

    def get_arrays(self):
        return _class_stack_arrays(self.thresholds, self.trees_per_class)

    def get_params(self):
        return {"eta": self.eta, "base_score": self.base_score}

    def _tree_stacks(self):
        return self.trees_per_class, True

    def predictions_from_core(self, core):
        margins = np.asarray(core, dtype=np.float64)
        p = _sigmoid(margins)
        prob = p / np.maximum(p.sum(axis=1, keepdims=True), 1e-12)
        return prob.argmax(axis=1).astype(np.float64), prob, margins


class ForestClassifierModel(_BinnedModel):
    """Per-class probability forests (leaf value = class fraction)."""

    def __init__(self, thresholds, forests_per_class: list[TR.Tree], uid=None):
        super().__init__("rfClassifier", thresholds, uid=uid)
        self.forests_per_class = forests_per_class

    @classmethod
    def from_params(cls, params, arrays):
        return cls(arrays["thresholds"], _class_trees_from_arrays(arrays))

    def get_arrays(self):
        return _class_stack_arrays(self.thresholds, self.forests_per_class)

    def _tree_stacks(self):
        return self.forests_per_class, False

    def predictions_from_core(self, core):
        return self._probs_to_predictions(np.asarray(core, dtype=np.float64))

    @staticmethod
    def _probs_to_predictions(probs):
        probs = np.clip(probs, 0.0, 1.0)
        if probs.shape[1] == 1:  # binary trained on the positive indicator
            probs = np.concatenate([1 - probs, probs], axis=1)
        raw = probs.copy()
        prob = probs / np.maximum(probs.sum(axis=1, keepdims=True), 1e-12)
        return prob.argmax(axis=1).astype(np.float64), prob, raw

    # the sweep evaluation: a binary forest reads its one lane, a
    # multiclass one its C lanes (``_sweep_lanes``) of the fit's outputs
    def predictions_from_sweep(self, preds):
        if len(self.forests_per_class) != 1:
            raise ValueError("sweep path is single-forest only")
        return self._probs_to_predictions(
            np.asarray(preds, dtype=np.float64)[:, None]
        )

    def predictions_from_sweep_multi(self, rows):
        """(pred, prob, raw) from [C, N] per-class mean-leaf outputs (one
        sweep lane per class)."""
        return self._probs_to_predictions(np.asarray(rows, dtype=np.float64).T)


def _stack_arrays(thresholds, trees: TR.Tree) -> dict:
    """The saved arrays of a model with one (host) tree stack."""
    return {"thresholds": thresholds,
            **{name: np.asarray(a) for name, a in trees._asdict().items()}}


def _class_stack_arrays(thresholds, stacks: list[TR.Tree]) -> dict:
    """The saved arrays of a model with a tree stack per class
    (``c{c}__split_feat`` / ``__split_bin`` / ``__leaf_value``)."""
    out = {"thresholds": thresholds}
    for c, t in enumerate(stacks):
        for name, a in t._asdict().items():
            out[f"c{c}__{name}"] = np.asarray(a)
    return out


class BoostedRegressionModel(_BinnedModel):
    """Boosted regression trees: prediction = base + eta * sum of rounds."""

    def __init__(self, thresholds, trees: TR.Tree, eta: float, base_score: float,
                 uid=None):
        super().__init__("xgbRegressor", thresholds, uid=uid)
        self.trees = trees
        self.eta = float(eta)
        self.base_score = float(base_score)

    @classmethod
    def from_params(cls, params, arrays):
        return cls(
            arrays["thresholds"], _tree_from_arrays(arrays),
            params["eta"], params["base_score"],
        )

    def get_params(self):
        return {"eta": self.eta, "base_score": self.base_score}

    def get_arrays(self):
        return _stack_arrays(self.thresholds, self.trees)

    def _tree_stacks(self):
        return [self.trees], True

    def predictions_from_core(self, core):
        return np.asarray(core, dtype=np.float64)[:, 0], None, None

    @staticmethod
    def predictions_from_sweep(margin):
        return np.asarray(margin, dtype=np.float64), None, None


class ForestRegressionModel(_BinnedModel):
    """Random-forest regression: prediction = mean leaf over the trees."""

    def __init__(self, thresholds, trees: TR.Tree, uid=None):
        super().__init__("rfRegressor", thresholds, uid=uid)
        self.trees = trees

    @classmethod
    def from_params(cls, params, arrays):
        return cls(arrays["thresholds"], _tree_from_arrays(arrays))

    def get_arrays(self):
        return _stack_arrays(self.thresholds, self.trees)

    def _tree_stacks(self):
        return [self.trees], False

    def predictions_from_core(self, core):
        return np.asarray(core, dtype=np.float64)[:, 0], None, None

    @staticmethod
    def predictions_from_sweep(preds):
        return np.asarray(preds, dtype=np.float64), None, None


# ---------------------------------------------------------------------------
# estimators
# ---------------------------------------------------------------------------
def _feature_bin_groups(x: np.ndarray):
    """(narrow_idx, wide_idx) int32 partition of the columns: 0/1 indicator
    columns (NaN allowed) and the rest, or None when no column is binary."""
    xf = np.asarray(x)
    with np.errstate(invalid="ignore"):
        binary = ((xf == 0) | (xf == 1) | ~np.isfinite(xf)).all(axis=0)
    narrow = np.nonzero(binary)[0].astype(np.int32)
    wide = np.nonzero(~binary)[0].astype(np.int32)
    if len(narrow) == 0:
        return None
    return narrow, wide


def _host_tree(t: TR.Tree) -> TR.Tree:
    return TR.Tree(*(a.detach().cpu().numpy() for a in t))


# (data address, shape, strides, max_bins, device) -> (x, thresholds,
# binned, feature groups): every family of a sweep bins the same matrix
_BINNED_CACHE: dict = {}
_BINNED_LOCK = threading.Lock()


class _TreeEstimator(PredictorEstimator):
    #: grid params that fix shapes: points sharing them batch into one fit
    _STATIC_GRID_KEYS: tuple = ()

    def __init__(self, operation_name: str, max_depth: int, max_bins: int,
                 device=None, uid=None):
        super().__init__(operation_name, uid=uid)
        self.max_depth = max_depth
        self.max_bins = max_bins
        #: ``None`` fits on the card; ``"cpu"`` runs the plain versions
        self.device = device

    def _binned(self, x: np.ndarray):
        """(device, thresholds, binned codes on the device, feature groups),
        cached per (matrix, max_bins, device); the cache holds ``x``."""
        dev = resolve_device(self.device)
        x = np.ascontiguousarray(x, dtype=np.float32)
        key = (x.__array_interface__["data"][0], x.shape, x.strides,
               int(self.max_bins), str(dev))
        with _BINNED_LOCK:
            hit = _BINNED_CACHE.get(key)
        if hit is not None:
            return dev, hit[1], hit[2], hit[3]
        thresholds = TR.quantile_thresholds(x, self.max_bins)
        binned = TR.bin_data(torch.from_numpy(x).to(dev),
                             torch.from_numpy(thresholds).to(dev))
        fgroups = _feature_bin_groups(x)
        with _BINNED_LOCK:
            _BINNED_CACHE[key] = (x, thresholds, binned, fgroups)
            while len(_BINNED_CACHE) > 4:
                _BINNED_CACHE.pop(next(iter(_BINNED_CACHE)))
        return dev, thresholds, binned, fgroups

    def _fit_group_masks(self, x, y, masks, group_points):
        """Fit len(masks) x len(group_points) models of one static shape as
        the lanes of one batched fit, or return None: the caller then fits
        the group model by model. ``masks`` is [M, N] float32."""
        return None

    def fit_arrays_batched_masks(self, x, y, masks, points):
        """Validator hook: folds x grid points, batched per group of points
        that share static shapes (deepest group first). Returns
        models[mask][point]."""
        masks = np.stack([np.asarray(m, dtype=np.float32) for m in masks])
        y = np.asarray(y)
        groups: dict[tuple, list[int]] = {}
        for i, p in enumerate(points):
            merged = {**self.get_params(), **p}
            groups.setdefault(
                tuple(merged.get(k) for k in self._STATIC_GRID_KEYS), []
            ).append(i)

        def depth_of(item):
            merged = {**self.get_params(), **points[item[1][0]]}
            return -int(merged.get("max_depth", 0) or 0)

        models: list[list] = [[None] * len(points) for _ in masks]
        for _, idxs in sorted(groups.items(), key=depth_of):
            fitted = self._fit_group_masks(x, y, masks, [points[i] for i in idxs])
            if fitted is None:
                fitted = [[self.with_params(**points[i]).fit_arrays(x, y, m)
                           for i in idxs] for m in masks]
            for mi in range(len(masks)):
                for j, i in enumerate(idxs):
                    models[mi][i] = fitted[mi][j]
        return models

    def sweep_eval_batched(self, models_by_fold, x, y, folds, evaluator):
        """Validator hook: the metric of every (fold, grid point) from the
        [K, N] training outputs each fitted stack keeps, with the per-lane
        probability and metric arithmetic of ``predict_arrays`` on the host.
        Returns [n_points][n_folds] values, or None where a model lacks the
        sweep protocol or its stack keeps no outputs (the validator then
        predicts model by model)."""
        flat = [m for fold_models in models_by_fold for m in fold_models]
        if not flat or any(
            getattr(m, "_sweep_stack", None) is None
            or m._sweep_stack.get("outputs") is None
            or not hasattr(m, "predictions_from_sweep")
            # a multiclass stack reads its C lanes (``_sweep_lanes``)
            or (len(getattr(m, "forests_per_class", [None])) != 1
                and getattr(m, "_sweep_lanes", None) is None)
            for m in flat
        ):
            return None
        try:
            values: list[list[float]] = [[] for _ in models_by_fold[0]]
            for fi, (_train_mask, val_mask) in enumerate(folds):
                val_idx = np.nonzero(val_mask)[0]
                for gi, m in enumerate(models_by_fold[fi]):
                    outputs = m._sweep_stack["outputs"]
                    lanes = getattr(m, "_sweep_lanes", None)
                    if lanes is not None:
                        pred, prob, _ = m.predictions_from_sweep_multi(
                            outputs[lanes][:, val_idx])
                    else:
                        pred, prob, _ = m.predictions_from_sweep(
                            outputs[m._sweep_lane][val_idx])
                    metrics = evaluator.evaluate_arrays(y[val_idx], pred, prob)
                    values[gi].append(evaluator.metric_of(metrics))
            return values
        except Exception as e:
            if is_kernel_fault(e):
                raise
            return None

    def _batched_group_fit(self, x, masks, group_points, run_batched,
                           make_model, normalize=None):
        """Bin once, merge (and ``normalize``) params, stack the float knobs
        mask-major (lane k = mask_index * n_points + point_index), run the
        family's batched trainer, and slice the lanes back out.
        ``run_batched(binned, m0, row_mask_K, knob, fgroups)`` returns
        ([K, ...] trees, [K, N] training outputs);
        ``make_model(thresholds, trees, merged_params, mask_index)``. Each
        model keeps the host stack and its lane in ``_sweep_stack`` /
        ``_sweep_lane``."""
        base = self.with_params(**group_points[0])
        dev, thresholds, binned, fgroups = base._binned(x)
        norm = normalize or (lambda m: m)
        merged = [norm({**self.get_params(), **p}) for p in group_points]
        n_masks, n_pts = masks.shape[0], len(merged)
        row_mask_k = torch.from_numpy(np.repeat(masks, n_pts, axis=0)).to(dev)

        def knob(name):
            return np.asarray(
                [float(m[name]) for m in merged] * n_masks, dtype=np.float32
            )

        trees, outputs = run_batched(binned, merged[0], row_mask_k, knob, fgroups)
        stack = {
            "trees": _host_tree(trees),
            "thresholds": thresholds,
            "k": n_masks * n_pts,
            "outputs": outputs.detach().cpu().numpy(),
        }
        models = []
        for mi in range(n_masks):
            row = []
            for j in range(n_pts):
                lane = mi * n_pts + j
                model = make_model(
                    thresholds, TR.Tree(*(a[lane].copy() for a in stack["trees"])),
                    merged[j], mi,
                )
                model.default_device = dev
                model._sweep_stack = stack
                model._sweep_lane = lane
                row.append(model)
            models.append(row)
        return models


class _BoostedEstimator(_TreeEstimator):
    """XGBoost-style boosting: the families differ in their objective, the
    labels they take, their base scores and their model class."""

    _STATIC_GRID_KEYS = ("num_round", "max_depth", "max_bins")
    _OBJECTIVE = ""

    def __init__(self, operation_name: str, num_round: int, eta: float,
                 max_depth: int, reg_lambda: float, gamma: float,
                 min_child_weight: float, min_info_gain: float, max_bins: int,
                 device=None, uid: str | None = None):
        super().__init__(operation_name, max_depth, max_bins, device=device,
                         uid=uid)
        self.num_round = num_round
        self.eta = eta
        self.reg_lambda = reg_lambda
        self.gamma = gamma
        self.min_child_weight = min_child_weight
        self.min_info_gain = min_info_gain

    def get_params(self):
        return {
            "num_round": self.num_round, "eta": self.eta,
            "max_depth": self.max_depth, "reg_lambda": self.reg_lambda,
            "gamma": self.gamma, "min_child_weight": self.min_child_weight,
            "min_info_gain": self.min_info_gain, "max_bins": self.max_bins,
        }

    def _normalize_boost(self, merged: dict) -> dict:
        """This family's params as the boosting knobs (GBT renames them)."""
        return merged

    def _base_score(self, y: np.ndarray, row_mask: np.ndarray) -> float:
        """The starting margin of ``fit_arrays``."""
        return 0.0

    def _base_scores(self, y: np.ndarray, masks: np.ndarray) -> np.ndarray:
        """The starting margin of each mask's fit in a batched fit,
        [masks] float64."""
        return np.zeros(masks.shape[0])

    def _model(self, thresholds, trees: TR.Tree, eta: float, base: float):
        raise NotImplementedError

    def _fit_one(self, binned, target, row_mask, base, fgroups) -> TR.Tree:
        """One boosted stack on ``target``, on the host."""
        trees, _ = TR.fit_boosted(
            binned, np.asarray(target, dtype=np.float32), row_mask,
            num_rounds=int(self.num_round), max_depth=int(self.max_depth),
            num_bins=int(self.max_bins), eta=float(self.eta),
            reg_lambda=float(self.reg_lambda), gamma=float(self.gamma),
            min_child_weight=float(self.min_child_weight),
            min_info_gain=float(self.min_info_gain), base_score=base,
            objective=self._OBJECTIVE, feature_groups=fgroups,
        )
        return _host_tree(trees)

    def _targets(self, y: np.ndarray, row_mask: np.ndarray) -> list:
        """The target of each stack ``fit_arrays`` fits: ``y`` alone, or a
        class indicator each for a one-vs-rest model."""
        return [y]

    def fit_arrays(self, x, y, row_mask):
        row_mask = np.asarray(row_mask, dtype=np.float32)
        y = np.asarray(y)
        base = self._base_score(y, row_mask)
        dev, thresholds, binned, fgroups = self._binned(x)
        stacks = [self._fit_one(binned, t, row_mask, base, fgroups)
                  for t in self._targets(y, row_mask)]
        if len(stacks) == 1:
            model = self._model(thresholds, stacks[0], float(self.eta), base)
        else:
            model = BoostedMultiModel(thresholds, stacks, float(self.eta), base)
        model.default_device = dev
        return model

    def _fit_group_masks(self, x, y, masks, group_points):
        base = self._base_scores(y, masks)
        base_k = np.repeat(base, len(group_points)).astype(np.float32)
        yj = np.asarray(y, dtype=np.float32)

        def run_batched(binned, m0, row_mask_k, knob, fgroups):
            # the final margin is each lane's raw output on every row
            return TR.fit_boosted_batched(
                binned, yj, row_mask_k, num_rounds=int(m0["num_round"]),
                max_depth=int(m0["max_depth"]), num_bins=int(m0["max_bins"]),
                eta=knob("eta"), reg_lambda=knob("reg_lambda"),
                gamma=knob("gamma"), min_child_weight=knob("min_child_weight"),
                min_info_gain=knob("min_info_gain"), base_score=base_k,
                objective=self._OBJECTIVE, feature_groups=fgroups,
            )

        return self._batched_group_fit(
            x, masks, group_points, run_batched,
            lambda th, tr, m, mi: self._model(th, tr, float(m["eta"]),
                                              float(base[mi])),
            normalize=self._normalize_boost,
        )


class XGBoostClassifier(_BoostedEstimator):
    """XGBoost classification (OpXGBoostClassifier parity: eta 0.3,
    maxDepth 6, lambda 1 by default); three or more classes fit one
    boosted stack per class indicator (``BoostedMultiModel``)."""

    model_type = "OpXGBoostClassifier"
    _OBJECTIVE = "binary:logistic"

    def __init__(self, num_round: int = 100, eta: float = 0.3,
                 max_depth: int = 6, reg_lambda: float = 1.0,
                 gamma: float = 0.0, min_child_weight: float = 1.0,
                 min_info_gain: float = 0.0, max_bins: int = 32,
                 device=None, uid: str | None = None):
        super().__init__("xgbClassifier", num_round, eta, max_depth,
                         reg_lambda, gamma, min_child_weight, min_info_gain,
                         max_bins, device=device, uid=uid)

    def _targets(self, y, row_mask):
        num_classes = _num_classes(y, row_mask)
        if num_classes == 2:
            return [y]
        return [(y == c).astype(np.float32) for c in range(num_classes)]

    def _fit_group_masks(self, x, y, masks, group_points):
        if _num_classes(np.asarray(y), masks.max(axis=0)) != 2:
            return None  # the one-vs-rest loop stays sequential
        return super()._fit_group_masks(x, y, masks, group_points)

    def _model(self, thresholds, trees, eta, base):
        return BoostedBinaryModel(thresholds, trees, eta, base)


class _SparkNamedBoost:
    """Spark's GBT knobs (maxIter, stepSize, minInstancesPerNode; defaults
    20, 0.1, maxDepth 5) over a boosted estimator: variance-style gain with
    no regularization (lambda 0, gamma 0, min_child_weight =
    minInstancesPerNode). ``fit_arrays`` syncs the boosting knobs; the
    batched fits map them per point."""

    _STATIC_GRID_KEYS = ("max_iter", "max_depth", "max_bins")

    def __init__(self, max_iter: int = 20, step_size: float = 0.1,
                 max_depth: int = 5, min_instances_per_node: int = 1,
                 min_info_gain: float = 0.0, max_bins: int = 32,
                 device=None, uid: str | None = None):
        super().__init__(
            num_round=max_iter, eta=step_size, max_depth=max_depth,
            reg_lambda=0.0, gamma=0.0,
            min_child_weight=float(min_instances_per_node),
            min_info_gain=min_info_gain, max_bins=max_bins, device=device,
            uid=uid,
        )
        self.max_iter = max_iter
        self.step_size = step_size
        self.min_instances_per_node = min_instances_per_node

    def get_params(self):
        return {
            "max_iter": self.max_iter, "step_size": self.step_size,
            "max_depth": self.max_depth,
            "min_instances_per_node": self.min_instances_per_node,
            "min_info_gain": self.min_info_gain, "max_bins": self.max_bins,
        }

    def fit_arrays(self, x, y, row_mask):
        # keep the boosting knobs in step with the Spark-named params
        self.num_round = self.max_iter
        self.eta = self.step_size
        self.min_child_weight = float(self.min_instances_per_node)
        return super().fit_arrays(x, y, row_mask)

    def _normalize_boost(self, merged):
        return {
            "num_round": merged["max_iter"], "eta": merged["step_size"],
            "reg_lambda": 0.0, "gamma": 0.0,
            "min_child_weight": float(merged["min_instances_per_node"]),
            "min_info_gain": merged["min_info_gain"],
            "max_depth": merged["max_depth"], "max_bins": merged["max_bins"],
        }


class GBTClassifier(_SparkNamedBoost, XGBoostClassifier):
    """OpGBTClassifier parity: binary or one-vs-rest multiclass."""

    model_type = "OpGBTClassifier"


class XGBoostRegressor(_BoostedEstimator):
    """XGBoost regression (OpXGBoostRegressor parity): squared error, each
    fit starting from the mean target over its rows."""

    model_type = "OpXGBoostRegressor"
    _OBJECTIVE = "reg:squarederror"

    def __init__(self, num_round: int = 100, eta: float = 0.3,
                 max_depth: int = 6, reg_lambda: float = 1.0,
                 gamma: float = 0.0, min_child_weight: float = 1.0,
                 min_info_gain: float = 0.0, max_bins: int = 32,
                 device=None, uid: str | None = None):
        super().__init__("xgbRegressor", num_round, eta, max_depth,
                         reg_lambda, gamma, min_child_weight, min_info_gain,
                         max_bins, device=device, uid=uid)

    # the mean target as the reference takes it: numpy's mean in y's own
    # dtype for one fit, float64 sums over float32 counts for a batch
    def _base_score(self, y, row_mask):
        on = row_mask > 0
        return float(np.mean(np.asarray(y)[on])) if on.any() else 0.0

    def _base_scores(self, y, masks):
        sums = masks @ np.asarray(y).astype(np.float64)
        cnts = masks.sum(axis=1)
        return np.where(cnts > 0, sums / np.maximum(cnts, 1), 0.0)

    def _model(self, thresholds, trees, eta, base):
        return BoostedRegressionModel(thresholds, trees, eta, base)


class GBTRegressor(_SparkNamedBoost, XGBoostRegressor):
    """OpGBTRegressor parity."""

    model_type = "OpGBTRegressor"


class _ForestEstimator(_TreeEstimator):
    """Bagged forests: the families differ in their target, their feature
    subset rate and their model class."""

    _STATIC_GRID_KEYS = ("num_trees", "max_depth", "max_bins", "seed")

    def __init__(self, operation_name: str, num_trees: int, max_depth: int,
                 min_instances_per_node: int, min_info_gain: float,
                 subsampling_rate: float, max_bins: int, seed: int,
                 device=None, uid: str | None = None):
        super().__init__(operation_name, max_depth, max_bins, device=device,
                         uid=uid)
        self.num_trees = num_trees
        self.min_instances_per_node = min_instances_per_node
        self.min_info_gain = min_info_gain
        self.subsampling_rate = subsampling_rate
        self.seed = seed

    def get_params(self):
        return {
            "num_trees": self.num_trees, "max_depth": self.max_depth,
            "min_instances_per_node": self.min_instances_per_node,
            "min_info_gain": self.min_info_gain,
            "subsampling_rate": self.subsampling_rate,
            "max_bins": self.max_bins, "seed": self.seed,
        }

    @staticmethod
    def _colsample(num_features: int) -> float:
        raise NotImplementedError

    def _model(self, thresholds, forests: list[TR.Tree]):
        raise NotImplementedError

    #: False for the decision trees: one unbagged, full-feature tree
    _BAGGED = True

    def _forest_one(self, binned, target, row_mask, fgroups, num_features):
        """One forest on ``target``, on the host."""
        bagged = self._BAGGED
        return _host_tree(TR.fit_forest(
            binned, target, row_mask,
            num_trees=int(self.num_trees), max_depth=int(self.max_depth),
            num_bins=int(self.max_bins),
            subsample_rate=float(self.subsampling_rate) if bagged else 1.0,
            colsample_rate=float(self._colsample(num_features)) if bagged else 1.0,
            min_instances=float(self.min_instances_per_node),
            min_info_gain=float(self.min_info_gain), seed=int(self.seed),
            bootstrap=bagged, feature_groups=fgroups,
        ))

    def _targets(self, y: np.ndarray, row_mask: np.ndarray) -> list[np.ndarray]:
        """The float32 value each forest's leaves average, one per forest."""
        raise NotImplementedError

    def fit_arrays(self, x, y, row_mask):
        row_mask = np.asarray(row_mask, dtype=np.float32)
        targets = self._targets(np.asarray(y), row_mask)
        dev, thresholds, binned, fgroups = self._binned(x)
        model = self._model(thresholds, [
            self._forest_one(binned, t, row_mask, fgroups, x.shape[1])
            for t in targets])
        model.default_device = dev
        return model

    def _fit_group_masks(self, x, y, masks, group_points):
        targets = self._targets(np.asarray(y), masks.max(axis=0))
        if len(targets) != 1:
            return self._fit_group_masks_multiclass(x, targets, masks,
                                                    group_points)
        target = targets[0]
        colsample = self._colsample(x.shape[1])

        def run_batched(binned, m0, row_mask_k, knob, fgroups):
            # mixed depths ride the lane axis as per-lane caps
            depth = knob("max_depth")
            uniform = bool((depth == depth[0]).all())
            return TR.fit_forest_batched(
                binned, target, row_mask_k, num_trees=int(m0["num_trees"]),
                max_depth=int(depth.max()), num_bins=int(m0["max_bins"]),
                subsample_rate=knob("subsampling_rate"),
                colsample_rate=float(colsample),
                min_instances=knob("min_instances_per_node"),
                min_info_gain=knob("min_info_gain"), seed=int(m0["seed"]),
                feature_groups=fgroups,
                max_depth_v=None if uniform else depth.astype(np.int32),
                return_outputs=True,
            )

        return self._batched_group_fit(
            x, masks, group_points, run_batched,
            lambda th, tr, m, mi: self._model(th, [tr]),
        )

    def _fit_group_masks_multiclass(self, x, targets, masks, group_points):
        """The one-vs-rest sweep as one batched fit per static group: lane
        ``(mask * n_points + point) * C + c`` trains class c's indicator
        (per-lane targets, [K * C, N]). Each model keeps its C lanes of
        the fit's [K * C, N] outputs (``_sweep_lanes``) for the sweep's
        evaluation. Bins with this estimator's ``max_bins``, as the
        reference does."""
        from ..parallel.mesh import execution_mesh

        if execution_mesh() is not None:
            # per-lane targets are single-device only (trees.py raises);
            # under a mesh the family fits model by model, one class at a
            # time, so it is not dropped
            return None
        dev, thresholds, binned, fgroups = self._binned(x)
        colsample = self._colsample(x.shape[1])
        merged = [{**self.get_params(), **p} for p in group_points]
        n_masks, n_pts, c = masks.shape[0], len(merged), len(targets)
        ind = np.stack(targets).astype(np.float32)                  # [C, N]
        rm = np.repeat(np.repeat(masks, n_pts, axis=0), c, axis=0)  # [K*C, N]
        tg = np.tile(ind, (n_masks * n_pts, 1))                     # [K*C, N]

        def knob(name):
            return np.repeat(np.asarray(
                [float(m[name]) for m in merged] * n_masks, dtype=np.float32), c)

        # max_depth is a static grid key: one depth serves the whole group
        m0 = merged[0]
        trees, outputs = TR.fit_forest_batched(
            binned, tg, torch.from_numpy(rm).to(dev),
            num_trees=int(m0["num_trees"]), max_depth=int(m0["max_depth"]),
            num_bins=int(m0["max_bins"]),
            subsample_rate=knob("subsampling_rate"),
            colsample_rate=float(colsample),
            min_instances=knob("min_instances_per_node"),
            min_info_gain=knob("min_info_gain"), seed=int(m0["seed"]),
            feature_groups=fgroups, return_outputs=True,
        )
        stack = {"trees": _host_tree(trees), "thresholds": thresholds,
                 "k": n_masks * n_pts * c,
                 "outputs": outputs.detach().cpu().numpy()}
        models = []
        for mi in range(n_masks):
            row = []
            for j in range(n_pts):
                lanes = [(mi * n_pts + j) * c + cls for cls in range(c)]
                model = self._model(thresholds, [
                    TR.Tree(*(a[lane].copy() for a in stack["trees"]))
                    for lane in lanes])
                model.default_device = dev
                model._sweep_stack = stack
                model._sweep_lanes = lanes
                row.append(model)
            models.append(row)
        return models


class RandomForestClassifier(_ForestEstimator):
    """Random-forest classification (OpRandomForestClassifier parity:
    Spark's featureSubsetStrategy 'auto' = sqrt for classification): one
    forest on the positive indicator, or one per class indicator on three
    or more classes."""

    model_type = "OpRandomForestClassifier"

    def __init__(self, num_trees: int = 20, max_depth: int = 5,
                 min_instances_per_node: int = 1, min_info_gain: float = 0.0,
                 subsampling_rate: float = 1.0, max_bins: int = 32,
                 seed: int = 42, device=None, uid: str | None = None):
        super().__init__("rfClassifier", num_trees, max_depth,
                         min_instances_per_node, min_info_gain,
                         subsampling_rate, max_bins, seed, device=device,
                         uid=uid)

    @staticmethod
    def _colsample(num_features: int) -> float:
        return 1.0 / np.sqrt(max(num_features, 1))

    def _targets(self, y, row_mask):
        num_classes = _num_classes(y, row_mask)
        classes = [1] if num_classes == 2 else range(num_classes)
        return [(y == c).astype(np.float32) for c in classes]

    def _model(self, thresholds, forests):
        return ForestClassifierModel(thresholds, forests)


class RandomForestRegressor(_ForestEstimator):
    """Random-forest regression (OpRandomForestRegressor parity: Spark's
    featureSubsetStrategy 'auto' = onethird for regression)."""

    model_type = "OpRandomForestRegressor"

    def __init__(self, num_trees: int = 20, max_depth: int = 5,
                 min_instances_per_node: int = 1, min_info_gain: float = 0.0,
                 subsampling_rate: float = 1.0, max_bins: int = 32,
                 seed: int = 42, device=None, uid: str | None = None):
        super().__init__("rfRegressor", num_trees, max_depth,
                         min_instances_per_node, min_info_gain,
                         subsampling_rate, max_bins, seed, device=device,
                         uid=uid)

    @staticmethod
    def _colsample(num_features: int) -> float:
        return 1.0 / 3.0

    def _targets(self, y, row_mask):
        return [np.asarray(y, dtype=np.float32)]

    def _model(self, thresholds, forests):
        return ForestRegressionModel(thresholds, forests[0])


class _SingleTree:
    """One unbagged, full-feature tree (the decision trees): the forest
    estimators with ``num_trees=1`` and ``bootstrap=False``. Its batched
    fit is refused, so the sweep fits it model by model (the forests'
    batched fit bootstraps and samples columns); its params mirror
    ``__init__`` so that saving round-trips."""

    _BAGGED = False

    def __init__(self, max_depth: int = 5, min_instances_per_node: int = 1,
                 min_info_gain: float = 0.0, max_bins: int = 32,
                 device=None, uid: str | None = None):
        super().__init__(
            num_trees=1, max_depth=max_depth,
            min_instances_per_node=min_instances_per_node,
            min_info_gain=min_info_gain, max_bins=max_bins, device=device,
            uid=uid,
        )

    def get_params(self):
        return {
            "max_depth": self.max_depth,
            "min_instances_per_node": self.min_instances_per_node,
            "min_info_gain": self.min_info_gain, "max_bins": self.max_bins,
        }

    def _fit_group_masks(self, x, y, masks, group_points):
        return None


class DecisionTreeClassifier(_SingleTree, RandomForestClassifier):
    """OpDecisionTreeClassifier parity: one tree on the positive indicator,
    or one per class indicator."""

    model_type = "OpDecisionTreeClassifier"


class DecisionTreeRegressor(_SingleTree, RandomForestRegressor):
    """OpDecisionTreeRegressor parity."""

    model_type = "OpDecisionTreeRegressor"
