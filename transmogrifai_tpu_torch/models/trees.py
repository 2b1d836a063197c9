"""Tree-ensemble predict machinery in PyTorch: quantile binning and the
traversal of dense perfect-binary trees (level d uses node slots [0, 2^d);
``split_feat = -1`` marks a leaf that routes every row left).

Fitting is not ported yet: trees arrive fitted, from a saved model.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import serve_trees as ST


class Tree(NamedTuple):
    """Dense perfect-binary-tree arrays; stacked ensembles carry a leading
    tree axis [T, ...]."""

    split_feat: torch.Tensor  # [depth, 2^depth] int32, -1 = leaf (route left)
    split_bin: torch.Tensor   # [depth, 2^depth] int32, right when bin > split_bin
    leaf_value: torch.Tensor  # [2^depth] float32


def bin_data(x: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """int32 bin codes [N, F]: the number of thresholds strictly below x
    (NaN compares false, so a NaN value bins to 0). Accumulated one
    threshold column at a time so peak memory stays one [N, F] plane."""
    codes = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for j in range(thresholds.shape[1]):
        codes += x > thresholds[:, j]
    return codes


def predict_tree(binned: torch.Tensor, tree: Tree) -> torch.Tensor:
    """Leaf value per row for one tree: the plain gather walk over a
    one-tree stack."""
    stack = (a.unsqueeze(0).contiguous() for a in tree)
    return ST.serve_trees_reference(binned, *stack)[:, 0]


def predict_forest_raw(
    x: torch.Tensor, thresholds: torch.Tensor, trees: Tree
) -> torch.Tensor:
    """Bin + forest mean over the stacked trees -> [N] float32."""
    return ST.predict_forest(bin_data(x, thresholds), trees)


def predict_boosted_raw(
    x: torch.Tensor, thresholds: torch.Tensor, trees: Tree, eta, base_score,
) -> torch.Tensor:
    """Bin + ``base + eta * Σ rounds`` -> [N] float32."""
    return ST.predict_boosted(bin_data(x, thresholds), trees, eta, base_score)
