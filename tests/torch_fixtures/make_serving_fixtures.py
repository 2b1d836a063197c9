"""Generate the serving fixtures that pin the PyTorch port to the JAX package.

Run from the repository root, on the CPU (it trains with the JAX package):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_serving_fixtures.py

It runs the flagship flow (``from_dataset`` -> ``transmogrify`` ->
``sanity_check(remove_bad_features=True)`` -> ``BinaryClassificationModelSelector``
restricted to one candidate -> ``Workflow.train()``) over a
``testkit.random_dataset`` twin of the Titanic table, and writes, for each
model, ``tests/fixtures/torch_serving/<name>/``:

* ``manifest.json`` + ``arrays.npz``: ``model.save(...)``;
* ``rows.json``: the raw scoring rows (``null`` for a missing value);
* ``expected.npz``: the JAX package's ``score_function(model).batch(rows)``
  outputs for those rows: ``prediction`` [N], ``probability`` [N, 2] and
  ``raw`` [N, 2], all float64.

The twin (seed ``SEED = 891``, ``N_ROWS = 891``) is, column by column
(``random_dataset`` derives column i's seed as ``SEED + 1000 * i``):

* ``age``: Real, ``RandomReal.normal(30, 14)``, probability_of_empty 0.2;
* ``fare``: Real, ``RandomReal.log_normal(3.0, 1.0)``, probability_of_empty 0.05;
* ``ticket_score``: Real, ``RandomReal.uniform(0, 1)``, probability_of_empty 0.1;
* ``sibsp``: Integral, ``RandomIntegral.integrals(0, 6)``;
* ``embarked``: PickList over ``("S", "C", "Q")`` weighted ``(0.7, 0.2, 0.1)``;
* ``label``: RealNN, ``1`` where ``0.04*age_or_30 - 0.3*log1p(fare)
  + 0.5*(embarked == "C") - 0.2*sibsp + noise < 0.2``, the noise drawn
  from ``np.random.default_rng(SEED)`` as ``normal(0, 0.7)``.

The grid points (one candidate each, selector seed 42, 3-fold CV):

* ``xgb``: ``XGBoostClassifier`` at the default selector's binary point:
  ``num_round=200, eta=0.02, gamma=0.8, max_depth=10,
  min_child_weight=1.0, max_bins=32``;
* ``rf``: ``RandomForestClassifier`` with ``num_trees=50, max_depth=12,
  min_instances_per_node=10, min_info_gain=0.001, max_bins=32``;
* ``lr``: ``LogisticRegression`` at the default selector's binary point
  ``reg_param=0.01, elastic_net_param=0.1, max_iter=50,
  fit_intercept=True``.

``ROWS_PER_FIXTURE = 256`` rows (the first rows of the table, label
included as the reference rows carry it) are kept for scoring.
"""
from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np

SEED = 891
N_ROWS = 891
ROWS_PER_FIXTURE = 256
OUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "fixtures", "torch_serving",
)


def twin_dataset():
    """The flagship twin: typed Dataset with a learnable RealNN label."""
    from transmogrifai_tpu import types as T
    from transmogrifai_tpu.testkit import (
        RandomIntegral, RandomReal, RandomText, random_dataset,
    )
    from transmogrifai_tpu.types.columns import column_from_values

    ds = random_dataset(
        {
            "age": RandomReal.normal(30, 14).with_probability_of_empty(0.2),
            "fare": RandomReal.log_normal(3.0, 1.0).with_probability_of_empty(
                0.05
            ),
            "ticket_score": RandomReal.uniform(0, 1).with_probability_of_empty(
                0.1
            ),
            "sibsp": RandomIntegral.integrals(0, 6),
            "embarked": RandomText.pick_lists(["S", "C", "Q"], [0.7, 0.2, 0.1]),
        },
        n=N_ROWS,
        seed=SEED,
    )
    age = np.where(ds["age"].mask, ds["age"].values, 30.0)
    fare = np.where(ds["fare"].mask, ds["fare"].values, 0.0)
    emb_c = np.array([v == "C" for v in ds["embarked"].values], dtype=float)
    sibsp = ds["sibsp"].values.astype(float)
    noise = np.random.default_rng(SEED).normal(0.0, 0.7, size=N_ROWS)
    score = (
        0.04 * age - 0.3 * np.log1p(np.abs(fare)) + 0.5 * emb_c
        - 0.2 * sibsp + noise
    )
    label = (score < 0.2).astype(float)
    return ds.with_column("label", column_from_values(T.RealNN, label))


def candidates():
    from transmogrifai_tpu.models.gbdt import (
        RandomForestClassifier, XGBoostClassifier,
    )
    from transmogrifai_tpu.models.logistic import LogisticRegression

    return {
        "xgb": (
            XGBoostClassifier(),
            {
                "num_round": [200], "eta": [0.02], "gamma": [0.8],
                "max_depth": [10], "min_child_weight": [1.0],
                "max_bins": [32],
            },
        ),
        "rf": (
            RandomForestClassifier(),
            {
                "num_trees": [50], "max_depth": [12],
                "min_instances_per_node": [10], "min_info_gain": [0.001],
                "max_bins": [32],
            },
        ),
        "lr": (
            LogisticRegression(),
            {
                "reg_param": [0.01], "elastic_net_param": [0.1],
                "max_iter": [50], "fit_intercept": [True],
            },
        ),
    }


def train(ds, candidate):
    """The flagship flow over ``ds`` with the selector cut to one
    candidate; returns the fitted WorkflowModel."""
    import transmogrifai_tpu.dsl  # noqa: F401  (installs sanity_check)
    from transmogrifai_tpu.features import from_dataset
    from transmogrifai_tpu.ops import transmogrify
    from transmogrifai_tpu.selector import BinaryClassificationModelSelector
    from transmogrifai_tpu.utils import uid as uid_util
    from transmogrifai_tpu.workflow.workflow import Workflow

    uid_util.reset()
    resp, preds = from_dataset(ds, response="label")
    vec = transmogrify(list(preds))
    checked = resp.sanity_check(vec, remove_bad_features=True)
    sel = BinaryClassificationModelSelector(seed=42, models=[candidate])
    pred = sel.set_input(resp, checked).get_output()
    return Workflow().set_result_features(pred).set_input_dataset(ds).train()


def scoring_rows(ds, n: int) -> list[dict]:
    """The first ``n`` rows as plain JSON-able dicts (None = missing)."""
    rows = ds.take(np.arange(n)).rows()
    out = []
    for r in rows:
        out.append({
            k: (None if v is None else (v.item() if hasattr(v, "item") else v))
            for k, v in r.items()
        })
    return out


def expected_scores(model, rows) -> dict[str, np.ndarray]:
    from transmogrifai_tpu.local.scoring import score_function

    fn = score_function(model)
    out = fn.batch(rows)
    name = model.result_features[0].name
    preds = [r[name] for r in out]
    return {
        "prediction": np.array([p["prediction"] for p in preds], np.float64),
        "probability": np.array(
            [[p["probability_0"], p["probability_1"]] for p in preds],
            np.float64,
        ),
        "raw": np.array(
            [[p["rawPrediction_0"], p["rawPrediction_1"]] for p in preds],
            np.float64,
        ),
    }


def write_fixture(name: str, model, rows) -> str:
    path = os.path.join(OUT_DIR, name)
    shutil.rmtree(path, ignore_errors=True)
    model.save(path)
    with open(os.path.join(path, "rows.json"), "w") as fh:
        json.dump(rows, fh)
    np.savez(os.path.join(path, "expected.npz"), **expected_scores(model, rows))
    return path


def main(names: list[str]) -> None:
    ds = twin_dataset()
    rows = scoring_rows(ds, ROWS_PER_FIXTURE)
    for name, cand in candidates().items():
        if names and name not in names:
            continue
        model = train(ds, cand)
        path = write_fixture(name, model, rows)
        size = sum(
            os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)
        )
        print(f"{name}: wrote {path} ({size} bytes)")


if __name__ == "__main__":
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.dirname(OUT_DIR)))
    )
    main(sys.argv[1:])
