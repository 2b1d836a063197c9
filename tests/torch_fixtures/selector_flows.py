"""The five-line flow at reduced grids through both packages, shared by the
port's selector, workflow and workflow-CV tests.

Every flow builds the flagship twin
(``tests/fixtures/torch_fit_side/flagship_table.json``) with the package's
own ``Dataset``, resets the package's uid counter, and runs
``from_dataset`` -> ``transmogrify`` -> ``sanity_check`` -> a selector ->
``Workflow().train()``; the port runs on the CPU (``device="cpu"``). The
JAX package trains on one device (``set_parallelism(None)``): the test
session's eight virtual CPU devices would otherwise shard its tree fits'
histograms, which sum in another order than its single-device route, the
route the port (one card) mirrors.

Tolerances (measured first on these flows on the CPU, then stated; the
GLM lanes are not bit-identical, the GEMMs block differently); every tree
candidate's value, tree and score is EQUAL:

* ``LR_METRIC_TOL`` = 2e-4: a logistic candidate's CV metric values
  (measured: at most 1.14e-4; 1.37e-4 at the default grids);
* ``LR_SCORE_TOL`` = 1e-3: a logistic winner's scores (measured: 4.39e-4,
  its refit lane of the batched sweep);
* ``LR_MARGIN_TOL`` = 5e-3: its raw margins (measured: 2.33e-3);
* ``LR_EVAL_TOL`` = 2.5e-3: a logistic winner's train, holdout and
  ``evaluate`` metric dicts (measured: 1.19e-3, one row crossing a
  threshold of the precision curve).
"""
from __future__ import annotations

import json
import math
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
TABLE = os.path.join(ROOT, "tests", "fixtures", "torch_fit_side",
                     "flagship_table.json")

LR_METRIC_TOL = 2e-4
LR_SCORE_TOL = 1e-3
LR_MARGIN_TOL = 5e-3
LR_EVAL_TOL = 2.5e-3
#: families whose lanes are not bit-identical across the packages
GLM_FAMILIES = ("LogisticRegression", "LinearRegression")
#: summary keys of planes the port does not have yet
UNPORTED_KEYS = ("compileStats", "distributedResilience")
#: summary keys holding a process ledger's counts and seconds, which differ
#: between the packages: compared by their key sets
LEDGER_KEYS = ("featurizeStats",)

XGB_GRID = {"num_round": [10], "eta": [0.02], "gamma": [0.8],
            "max_depth": [10], "min_child_weight": [1.0, 10.0]}
RF_GRID = {"max_depth": [3, 6], "min_info_gain": [0.001, 0.01, 0.1],
           "min_instances_per_node": [10, 100], "num_trees": [5]}
LR_GRID = {"fit_intercept": [True], "elastic_net_param": [0.1],
           "max_iter": [50], "reg_param": [0.01, 0.1]}
#: the smaller grids of the secondary flows
RF_SMALL = {"max_depth": [3, 6], "min_info_gain": [0.001],
            "min_instances_per_node": [10], "num_trees": [5]}
GBT_SMALL = {"max_depth": [3], "min_info_gain": [0.001],
             "min_instances_per_node": [10], "max_iter": [5]}


def table() -> dict:
    with open(TABLE) as fh:
        return json.load(fh)


def dataset(pkg: str):
    """The flagship twin as ``pkg``'s ("jax" or "port") Dataset."""
    if pkg == "jax":
        from transmogrifai_tpu import types as T
        from transmogrifai_tpu.dataset import Dataset
        from transmogrifai_tpu.types.columns import column_from_values
    else:
        from transmogrifai_tpu_torch import types as T
        from transmogrifai_tpu_torch.dataset import Dataset
        from transmogrifai_tpu_torch.types.columns import column_from_values
    t = table()
    return Dataset.of({
        k: column_from_values(T.feature_type_by_name(t["schema"][k]), v)
        for k, v in t["columns"].items()
    })


def modules(pkg: str) -> dict:
    """The package's modules a flow needs, by short name."""
    if pkg == "jax":
        import transmogrifai_tpu.dsl  # noqa: F401
        from transmogrifai_tpu.features import from_dataset
        from transmogrifai_tpu.models import gbdt, linear, logistic
        from transmogrifai_tpu.ops import transmogrify
        from transmogrifai_tpu.selector import model_selector, validators
        from transmogrifai_tpu.utils import uid
        from transmogrifai_tpu.workflow import workflow
    else:
        import transmogrifai_tpu_torch.dsl  # noqa: F401
        from transmogrifai_tpu_torch.features import from_dataset
        from transmogrifai_tpu_torch.models import gbdt, linear, logistic
        from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
        from transmogrifai_tpu_torch.selector import model_selector, validators
        from transmogrifai_tpu_torch.utils import uid
        from transmogrifai_tpu_torch.workflow import workflow
    return dict(from_dataset=from_dataset, gbdt=gbdt, linear=linear,
                logistic=logistic, transmogrify=transmogrify,
                model_selector=model_selector, validators=validators, uid=uid,
                workflow=workflow)


def dev(pkg: str) -> dict:
    """Constructor kwargs that put the port's estimators on the CPU."""
    return {} if pkg == "jax" else {"device": "cpu"}


def feature_side(pkg: str, ds, response: str = "label"):
    m = modules(pkg)
    label, predictors = m["from_dataset"](ds, response=response)
    vec = m["transmogrify"](list(predictors))
    checked = label.sanity_check(vec, remove_bad_features=True, **dev(pkg))
    return label, checked


def binary_candidates(pkg: str, families=("lr", "rf", "xgb"), small=False):
    m = modules(pkg)
    make = {
        "lr": lambda: (m["logistic"].LogisticRegression(**dev(pkg)), LR_GRID),
        "rf": lambda: (m["gbdt"].RandomForestClassifier(**dev(pkg)),
                       RF_SMALL if small else RF_GRID),
        "xgb": lambda: (m["gbdt"].XGBoostClassifier(**dev(pkg)), XGB_GRID),
    }
    return [make[f]() for f in families]


def train(pkg: str, selector_fn, workflow_cv: bool = False):
    """(dataset, model, prediction feature, selector) of one flow;
    ``selector_fn(pkg, modules)`` builds the selector."""
    m = modules(pkg)
    m["uid"].reset()
    ds = dataset(pkg)
    label, checked = feature_side(pkg, ds)
    selector = selector_fn(pkg, m)
    pred = selector.set_input(label, checked).get_output()
    wf = m["workflow"].Workflow().set_result_features(pred).set_input_dataset(ds)
    if pkg == "jax":
        wf = wf.set_parallelism(None)
    if workflow_cv:
        wf = wf.with_workflow_cv()
    return ds, wf.train(), pred, selector


def default_binary(pkg: str, m):
    return m["model_selector"].BinaryClassificationModelSelector(
        models=binary_candidates(pkg))


def without_unported(summary: dict) -> dict:
    return {k: v for k, v in summary.items()
            if k not in UNPORTED_KEYS + LEDGER_KEYS}


def dump(obj) -> str:
    return json.dumps(obj, sort_keys=True, default=float)


def assert_same_results(got: list[dict], want: list[dict],
                        tol: float = LR_METRIC_TOL) -> float:
    """Validation results in the same order, with the same names, uids and
    grids; tree families' metric values EQUAL, GLM families' within
    ``tol``. Returns the largest GLM difference."""
    assert [(r["modelName"], r["modelUID"], dump(r["grid"])) for r in got] == [
        (r["modelName"], r["modelUID"], dump(r["grid"])) for r in want]
    worst = 0.0
    for g, w in zip(got, want):
        assert all(math.isfinite(v) for v in g["metricValues"]), g
        if g["modelName"] in GLM_FAMILIES:
            d = float(np.max(np.abs(np.subtract(g["metricValues"],
                                                w["metricValues"]))))
            assert d <= tol, (g, w)
            worst = max(worst, d)
        else:
            assert g["metricValues"] == w["metricValues"], (g, w)
            assert g["metricMean"] == w["metricMean"]
    return worst


def assert_same_summary(got: dict, want: dict, glm_winner: bool) -> None:
    """A selector summary against the reference's: the results under
    ``assert_same_results``, the winner and grid equal, the metric dicts
    EQUAL for a tree winner and within ``LR_EVAL_TOL`` for a GLM one,
    every other key (candidate attempts, splitter summary, uids) EQUAL."""
    got, want = without_unported(got), without_unported(want)
    assert set(got) == set(want)
    assert_same_results(got["validationResults"], want["validationResults"])
    for key in ("trainEvaluation", "holdoutEvaluation"):
        if glm_winner:
            assert_close_metrics(got[key], want[key], LR_EVAL_TOL)
        else:
            assert dump(got[key]) == dump(want[key]), key
    rest = [k for k in got if k not in (
        "validationResults", "trainEvaluation", "holdoutEvaluation")]
    assert dump({k: got[k] for k in rest}) == dump({k: want[k] for k in rest})


def assert_close_metrics(got: dict, want: dict, tol: float) -> None:
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            assert_close_metrics(got[k], want[k], tol)
        else:
            np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                       np.asarray(want[k], np.float64),
                                       rtol=0, atol=tol, err_msg=k)
