"""Fitted tree-ensemble predictor stages: XGBoost's binary model and the
random forest classifier.

A model holds its quantile thresholds and stacked trees as numpy arrays
from the saved model; ``to(device)`` validates them once and places them on
the device as int32/float32 tensors. Every predict bins the batch there,
runs the traversal (the ``serve_trees`` kernel on the card), reduces per
family, and finishes with the float64 host epilogue
``predictions_from_core``, whatever the batch size.
"""
from __future__ import annotations

import numpy as np
import torch

from . import serve_trees as ST
from . import trees as TR
from .base import PredictorModel


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

    def __init__(self, operation_name: str, thresholds: np.ndarray, uid=None):
        super().__init__(operation_name, uid=uid)
        self.thresholds = np.asarray(thresholds, dtype=np.float32)
        self.device: torch.device | None = None
        self._dev_thr: torch.Tensor | None = None
        self.device_stacks: list[TR.Tree] = []

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

        def put(a, dtype):
            return torch.as_tensor(
                np.ascontiguousarray(a, dtype=dtype), device=device
            )

        self._dev_thr = put(self.thresholds, np.float32)
        self.device_stacks = [
            TR.Tree(
                put(t.split_feat, np.int32), put(t.split_bin, np.int32),
                put(t.leaf_value, np.float32),
            )
            for t in stacks
        ]
        self.device = device
        return self

    def predict_core(self, x: np.ndarray) -> np.ndarray:
        """float64 [N, k] of margins (boosted) or mean-leaf values (forest),
        one column per tree stack, computed on the model's device."""
        if self.device is None:
            raise RuntimeError(f"{self}: place the model with .to(device) first")
        x = np.asarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.thresholds.shape[0]:
            raise ValueError(
                f"{self}: expected [N, {self.thresholds.shape[0]}] features, "
                f"got {x.shape}"
            )
        _, boosted = self._tree_stacks()
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        binned = TR.bin_data(xt, self._dev_thr)
        if boosted:
            outs = [
                ST.predict_boosted(binned, t, self.eta, self.base_score)
                for t in self.device_stacks
            ]
        else:
            outs = [ST.predict_forest(binned, t) for t in self.device_stacks]
        return torch.stack(outs, dim=1).cpu().numpy().astype(np.float64)

    def predictions_from_core(self, core: np.ndarray):
        """(pred, prob, raw) from the [N, k] core: the float64 host tail."""
        raise NotImplementedError

    def predict_arrays(self, x):
        return self.predictions_from_core(self.predict_core(x))


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

    def _tree_stacks(self):
        return [self.trees], True

    def predictions_from_core(self, core):
        margin = np.asarray(core, dtype=np.float64)[:, 0]
        p1 = _sigmoid(margin)
        prob = np.stack([1 - p1, p1], axis=1)
        raw = np.stack([-margin, margin], axis=1)
        return (p1 > 0.5).astype(np.float64), prob, raw


class ForestClassifierModel(_BinnedModel):
    """Per-class probability forests (leaf value = class fraction)."""

    def __init__(self, thresholds, forests_per_class: list[TR.Tree], uid=None):
        super().__init__("rfClassifier", thresholds, uid=uid)
        self.forests_per_class = forests_per_class

    @classmethod
    def from_params(cls, params, arrays):
        return cls(arrays["thresholds"], _class_trees_from_arrays(arrays))

    def _tree_stacks(self):
        return self.forests_per_class, False

    def predictions_from_core(self, core):
        probs = np.clip(np.asarray(core, dtype=np.float64), 0.0, 1.0)
        if probs.shape[1] == 1:  # binary trained on the positive indicator
            probs = np.concatenate([1 - probs, probs], axis=1)
        raw = probs.copy()
        prob = probs / np.maximum(probs.sum(axis=1, keepdims=True), 1e-12)
        return prob.argmax(axis=1).astype(np.float64), prob, raw
