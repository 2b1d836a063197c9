"""Generate the training fixture that pins the PyTorch port's tree fits to the
JAX package.

Run from the repository root, on the CPU (it trains with the JAX package):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_training_fixtures.py

It writes ``tests/fixtures/torch_training/``:

* ``table.npz``: ``x`` [N, F] float32, ``y`` [N] float32 (0/1), the
  continuous regression target ``target`` [N] float32 and ``masks``
  [3, N] float32, the training masks of 3 folds (row r is held out of fold
  ``r % 3``);
* ``config.json``: the four families' grid points;
* ``xgb.npz``, ``rf.npz``, ``gbtr.npz`` and ``rfr.npz``: the JAX
  package's ``fit_arrays_batched_masks(x, label, masks, [point])`` for
  each family (``y`` for the classifiers, ``target`` for the regressors),
  as the stacked lanes (one per fold): ``split_feat``, ``split_bin``,
  ``leaf_value`` [3, T, ...] and ``outputs`` [3, N], each lane's training
  margin (boosting) or mean-leaf output (random forest) on every row.

The table (``SEED = 5``, ``N_ROWS = 5000``, above the 4096 rows where the
reference's histogram policy leaves the one-hot GEMM, so the card builds
its histograms with kernel K2) has ``F = 40`` columns:

* 0-9 continuous, ``rng.normal``; columns 0, 1 and 2 have about 20% NaN
  (a Titanic-Age-like missing rate);
* 10-39 binary indicators, ``rng.uniform < 0.05`` (one-hot pivots and
  hashed-text indicators);
* ``target = x0 - 0.8 x3 + 1.5 x10 - x11 + 0.7 x12 + 0.5 x4 * x5
  + normal(0, 0.7)``, with NaN read as 0, and ``y = 1`` where
  ``target > 0``.

The grid points (with 3 masks each family is one batched fit of 3 lanes):

* ``xgb``: ``XGBoostClassifier`` ``num_round=20, eta=0.3, gamma=0.0,
  max_depth=6, min_child_weight=1.0, max_bins=32``;
* ``rf``: ``RandomForestClassifier`` ``num_trees=10, max_depth=6,
  min_instances_per_node=10, min_info_gain=0.001, max_bins=32, seed=42``
  (Poisson(1) bootstrap, sqrt(F) exact-count feature subsets per tree);
* ``gbtr``: ``GBTRegressor`` ``max_iter=10, max_depth=6,
  min_instances_per_node=10, max_bins=256`` (step size 0.1; lambda 0,
  gamma 0, min child weight 10; each fold's base score its mean target);
* ``rfr``: ``RandomForestRegressor`` ``num_trees=10, max_depth=6,
  min_instances_per_node=10, min_info_gain=0.001, max_bins=256, seed=42``
  (Poisson(1) bootstrap, exact-count feature subsets of a third).

At 256 bins the 10 continuous columns form the wide group, which the card
builds with kernel K3, and the indicators the 2-bin group (K2).

The GLM fixtures fit the same table with NaN read as 0 (``np.nan_to_num``:
the GLMs take a transmogrified vector, which has no NaN) and the same 3
folds, at the selectors' default GLM grids (``GLM_GRIDS``: ``reg_param``
in {0.001, 0.01, 0.1, 0.2} x ``elastic_net_param`` in {0.1, 0.5},
``max_iter=50``, ``fit_intercept=True``; the 8 points in that order, reg
varying fastest), one batched sweep of 24 lanes each:

* ``lr.npz``: ``LogisticRegression().fit_arrays_batched_masks(x, y,
  masks, grid)``;
* ``linr.npz``: ``LinearRegression().fit_arrays_batched_masks(x, target,
  masks, grid)``;

each as ``weights`` [3, 8, F] float32 and ``intercept`` [3, 8] float32
(fold, grid point). ``config.json`` lists the grids under ``glm_grids``.

Run with family names (``... make_training_fixtures.py lr linr``) to
rewrite only those families and ``config.json``.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

SEED = 5
N_ROWS = 5000
N_CONT = 10
N_BIN = 30
OUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "fixtures", "torch_training",
)
POINTS = {
    "xgb": {"num_round": 20, "eta": 0.3, "gamma": 0.0, "max_depth": 6,
            "min_child_weight": 1.0, "max_bins": 32},
    "rf": {"num_trees": 10, "max_depth": 6, "min_instances_per_node": 10,
           "min_info_gain": 0.001, "max_bins": 32, "seed": 42},
    "gbtr": {"max_iter": 10, "max_depth": 6, "min_instances_per_node": 10,
             "max_bins": 256},
    "rfr": {"num_trees": 10, "max_depth": 6, "min_instances_per_node": 10,
            "min_info_gain": 0.001, "max_bins": 256, "seed": 42},
}
#: the families whose label is the continuous target
REGRESSORS = ("gbtr", "rfr", "linr")
#: the default GLM grid of the binary and regression selectors
#: (selector/model_selector.py: REGULARIZATION x ELASTIC_NET, MAX_ITER_LIN,
#: FIT_INTERCEPT)
GLM_GRID = [
    {"reg_param": r, "elastic_net_param": e, "max_iter": 50,
     "fit_intercept": True}
    for e in (0.1, 0.5) for r in (0.001, 0.01, 0.1, 0.2)
]
GLM_GRIDS = {"lr": GLM_GRID, "linr": GLM_GRID}


def table():
    rng = np.random.default_rng(SEED)
    x = np.empty((N_ROWS, N_CONT + N_BIN), dtype=np.float32)
    x[:, :N_CONT] = rng.normal(size=(N_ROWS, N_CONT))
    x[:, N_CONT:] = rng.uniform(size=(N_ROWS, N_BIN)) < 0.05
    for c in range(3):
        x[rng.uniform(size=N_ROWS) < 0.2, c] = np.nan
    z = np.nan_to_num(x)
    score = (z[:, 0] - 0.8 * z[:, 3] + 1.5 * z[:, 10] - z[:, 11]
             + 0.7 * z[:, 12] + 0.5 * z[:, 4] * z[:, 5]
             + rng.normal(0.0, 0.7, size=N_ROWS))
    y = (score > 0).astype(np.float32)
    masks = np.stack([
        (np.arange(N_ROWS) % 3 != i).astype(np.float32) for i in range(3)
    ])
    return x, y, score.astype(np.float32), masks


def fit(name, x, label, masks):
    from transmogrifai_tpu.models.gbdt import (
        GBTRegressor, RandomForestClassifier, RandomForestRegressor,
        XGBoostClassifier, _host_trees,
    )

    est = {"xgb": XGBoostClassifier, "rf": RandomForestClassifier,
           "gbtr": GBTRegressor, "rfr": RandomForestRegressor}[name]()
    models = est.fit_arrays_batched_masks(x, label, list(masks), [POINTS[name]])
    stack = models[0][0]._sweep_stack
    trees = _host_trees(stack["trees"])
    return {
        "split_feat": np.asarray(trees.split_feat, np.int32),
        "split_bin": np.asarray(trees.split_bin, np.int32),
        "leaf_value": np.asarray(trees.leaf_value, np.float32),
        "outputs": np.asarray(stack["outputs"], np.float32),
    }


def fit_glm(name, x, label, masks):
    from transmogrifai_tpu.models.linear import LinearRegression
    from transmogrifai_tpu.models.logistic import LogisticRegression

    est = {"lr": LogisticRegression, "linr": LinearRegression}[name]()
    models = est.fit_arrays_batched_masks(
        np.nan_to_num(x), label, list(masks), GLM_GRIDS[name])
    return {
        "weights": np.asarray(
            [[m.weights for m in row] for row in models], np.float32),
        "intercept": np.asarray(
            [[m.intercept for m in row] for row in models], np.float32),
    }


def main(names: list[str]) -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    x, y, target, masks = table()
    if not names:
        np.savez_compressed(os.path.join(OUT_DIR, "table.npz"), x=x, y=y,
                            target=target, masks=masks)
    with open(os.path.join(OUT_DIR, "config.json"), "w") as fh:
        json.dump({"seed": SEED, "n_rows": N_ROWS, "points": POINTS,
                   "glm_grids": GLM_GRIDS}, fh, indent=1)
    for name in [*POINTS, *GLM_GRIDS]:
        if names and name not in names:
            continue
        path = os.path.join(OUT_DIR, f"{name}.npz")
        label = target if name in REGRESSORS else y
        arrays = (fit_glm if name in GLM_GRIDS else fit)(name, x, label, masks)
        np.savez_compressed(path, **arrays)
        print(f"{name}: wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.dirname(OUT_DIR)))
    )
    main(sys.argv[1:])
