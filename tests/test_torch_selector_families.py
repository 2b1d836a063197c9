"""The selector's whole catalog in the port (``make_candidates`` over every
binary, multiclass and regression name), the ``SelectedModelCombiner`` in
both strategies, and the new families' persistence, against the JAX
package on the same seeded tables, on the CPU.

What is compared:

* ``make_candidates``: class names, default grids and params EQUAL;
* a selection: the winner EQUAL where the JAX package's best two
  candidates lie farther apart than ``METRIC_TOL`` (``ROADMAP.md`` C's
  rule for logistic winners), every tree candidate's CV metrics EQUAL and
  every other candidate's within ``METRIC_TOL``, the summary's keys EQUAL;
* persistence: models the JAX package saved load in the port and score
  within the families' bounds (``tests/test_torch_families.py``).

``METRIC_TOL`` = 2e-4, the logistic lanes' own bound
(``selector_flows.LR_METRIC_TOL``). Measured over these flows (jax 0.9.0,
torch 2.13 CPU): every classification metric EQUAL, the GLR's RMSE values
6.7e-7 apart and the linear regression's 2.2e-9; the best two candidates
lie 3.3e-3 (binary), 5.5e-3 (multiclass) and 4.2e-3 (regression) apart,
so every winner is compared.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "torch_fixtures"))

from transmogrifai_tpu.selector import combiner as JC  # noqa: E402
from transmogrifai_tpu.selector import model_selector as JMS  # noqa: E402
from transmogrifai_tpu_torch.selector import combiner as PC  # noqa: E402
from transmogrifai_tpu_torch.selector import model_selector as PMS  # noqa: E402

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

METRIC_TOL = 2e-4
TREE_FAMILIES = {"RandomForestClassifier", "XGBoostClassifier",
                 "GBTClassifier", "DecisionTreeClassifier",
                 "RandomForestRegressor", "XGBoostRegressor", "GBTRegressor",
                 "DecisionTreeRegressor"}
#: small grids for the tree families (the default grids take minutes on
#: the CPU); the other families keep their default grids
SMALL = {
    "RandomForestClassifier": {"max_depth": [3], "num_trees": [5],
                               "min_instances_per_node": [10]},
    "RandomForestRegressor": {"max_depth": [3], "num_trees": [5],
                              "min_instances_per_node": [10]},
    "XGBoostClassifier": {"num_round": [10], "max_depth": [3]},
    "XGBoostRegressor": {"num_round": [10], "max_depth": [3]},
    "GBTClassifier": {"max_iter": [5], "max_depth": [3]},
    "GBTRegressor": {"max_iter": [5], "max_depth": [3]},
    "DecisionTreeClassifier": {"max_depth": [3, 6]},
    "DecisionTreeRegressor": {"max_depth": [3, 6]},
    "LogisticRegression": {"reg_param": [0.01, 0.1], "max_iter": [50]},
    "LinearRegression": {"reg_param": [0.01, 0.1], "max_iter": [50]},
    "MLPClassifier": {"max_iter": [50]},
}
CATALOGS = {
    "BinaryClassification": "BINARY_CLASSIFICATION_MODELS",
    "MultiClassification": "MULTI_CLASSIFICATION_MODELS",
    "Regression": "REGRESSION_MODELS",
}


def _table(kind: str, n: int = 240, seed: int = 3):
    """Non-negative count-like features (Naive Bayes takes them) and a
    label of the kind."""
    rng = np.random.default_rng(seed)
    x = rng.poisson(2.0, size=(n, 5)).astype(np.float32)
    x[:, 4] = rng.random(n).astype(np.float32) * 3
    s = x[:, 0] - 0.6 * x[:, 1] + 0.4 * x[:, 4] + rng.normal(scale=0.8, size=n)
    if kind == "BinaryClassification":
        y = (s > np.median(s)).astype(np.float32)
    elif kind == "MultiClassification":
        y = np.digitize(s, np.quantile(s, [1 / 3, 2 / 3])).astype(np.float32)
    else:
        y = (np.exp(0.15 * s) + 0.1).astype(np.float32)  # positive: gamma
    return x, y


def _candidates(mod, kind, names, **kw):
    out = mod.make_candidates(kind, names, **kw)
    return [(e, SMALL.get(type(e).__name__, g)) for e, g in out]


def _selector(mod, kind, names, **kw):
    models = _candidates(mod, kind, names, **kw)
    factory = {"BinaryClassification": "BinaryClassificationModelSelector",
               "MultiClassification": "MultiClassificationModelSelector",
               "Regression": "RegressionModelSelector"}[kind]
    fkw = {"num_folds": 3} if kind != "Regression" else {}
    return getattr(mod, factory)(models=models, seed=7, **fkw)


def _fit(sel, x, y, pkg):
    from transmogrifai_tpu.utils import uid as juid
    from transmogrifai_tpu_torch.utils import uid as puid

    (juid if pkg == "jax" else puid).reset()
    return sel.fit_arrays(x, y, np.ones(len(y), np.float32))


def _compare_selection(jm, pm, larger_better: bool):
    js, ps = jm.summary, pm.summary
    assert set(ps) >= set(js) - {"distributedResilience"}
    jr = {(r["modelName"], json.dumps(r["grid"], sort_keys=True)): r
          for r in js["validationResults"]}
    pr = {(r["modelName"], json.dumps(r["grid"], sort_keys=True)): r
          for r in ps["validationResults"]}
    assert set(pr) == set(jr)
    for key, r in jr.items():
        got = np.asarray(pr[key]["metricValues"])
        want = np.asarray(r["metricValues"])
        if key[0] in TREE_FAMILIES:
            np.testing.assert_array_equal(got, want, err_msg=str(key))
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=METRIC_TOL,
                                       err_msg=str(key))
    means = sorted((r["metricMean"] for r in js["validationResults"]),
                   reverse=larger_better)
    if len(means) < 2 or abs(means[0] - means[1]) > METRIC_TOL:
        assert ps["bestModelType"] == js["bestModelType"]
        assert ps["bestGrid"] == js["bestGrid"]
    assert [a["modelName"] for a in ps["candidateAttempts"]] == \
        [a["modelName"] for a in js["candidateAttempts"]]
    assert [a["excluded"] for a in ps["candidateAttempts"]] == \
        [a["excluded"] for a in js["candidateAttempts"]]


# ------------------------------------------------------------- catalog
@pytest.mark.parametrize("kind", sorted(CATALOGS))
def test_make_candidates_covers_every_name(kind):
    names = list(getattr(JMS, CATALOGS[kind]))
    assert names == list(getattr(PMS, CATALOGS[kind]))
    got = PMS.make_candidates(kind, names, device="cpu")
    want = JMS.make_candidates(kind, names)
    assert [(type(e).__name__, g, e.get_params()) for e, g in got] == \
        [(type(e).__name__, g, e.get_params()) for e, g in want]
    assert all(e.device == "cpu" for e, _ in got)


# ------------------------------------------------------------ selections
@pytest.mark.parametrize("kind", sorted(CATALOGS))
def test_every_family_trains_in_a_selector(kind):
    """One selector over every name of the kind's catalog: the port's
    selection equals the JAX package's (module docstring)."""
    x, y = _table(kind)
    names = list(getattr(JMS, CATALOGS[kind]))
    jm = _fit(_selector(JMS, kind, names), x, y, "jax")
    pm = _fit(_selector(PMS, kind, names, device="cpu"), x, y, "port")
    larger = kind != "Regression"
    _compare_selection(jm, pm, larger)
    assert not any(a["excluded"] for a in pm.summary["candidateAttempts"])
    assert {r["modelName"] for r in pm.summary["validationResults"]} == \
        {type(e).__name__ for e, _ in PMS.make_candidates(kind, names)}


def test_naive_bayes_is_excluded_on_negative_features_as_the_reference_does():
    x, y = _table("BinaryClassification")
    x = x - 1.0
    names = ["OpNaiveBayes", "OpLogisticRegression"]
    jm = _fit(_selector(JMS, "BinaryClassification", names), x, y, "jax")
    pm = _fit(_selector(PMS, "BinaryClassification", names, device="cpu"),
              x, y, "port")
    _compare_selection(jm, pm, True)
    att = {a["modelName"]: a for a in pm.summary["candidateAttempts"]}
    assert att["NaiveBayes"]["excluded"]
    assert "non-negative" in att["NaiveBayes"]["error"]


def test_regression_selector_with_glr():
    x, y = _table("Regression")
    names = ["OpLinearRegression", "OpGeneralizedLinearRegression"]
    jm = _fit(_selector(JMS, "Regression", names), x, y, "jax")
    pm = _fit(_selector(PMS, "Regression", names, device="cpu"), x, y, "port")
    _compare_selection(jm, pm, False)
    glr = [r for r in pm.summary["validationResults"]
           if r["modelName"] == "GeneralizedLinearRegression"]
    assert len(glr) == 12  # 3 families x 4 regs


# ------------------------------------------------------------- combiner
def _combiner(mod, cmod, strategy, **kw):
    kind = "BinaryClassification"
    s1 = _selector(mod, kind, ["OpLogisticRegression", "OpNaiveBayes"], **kw)
    s2 = _selector(mod, kind, ["OpRandomForestClassifier", "OpLinearSVC"], **kw)
    return cmod.SelectedModelCombiner(
        s1, s2, getattr(cmod.CombinationStrategy, strategy))


@pytest.mark.parametrize("strategy", ["BEST", "WEIGHTED"])
def test_combiner_matches_the_reference(strategy):
    from transmogrifai_tpu.features import FeatureBuilder as JFB
    from transmogrifai_tpu_torch.features import FeatureBuilder as PFB

    x, y = _table("BinaryClassification")
    out = {}
    for pkg, mod, cmod, fb, kw in (
            ("jax", JMS, JC, JFB, {}), ("port", PMS, PC, PFB, {"device": "cpu"})):
        comb = _combiner(mod, cmod, strategy, **kw)
        comb.set_input(fb.RealNN("label").as_response(),
                       fb.OPVector("vec").as_predictor())
        model = _fit(comb, x, y, pkg)
        if pkg == "port":
            model.to("cpu")
        out[pkg] = (model, model.summary, model.predict_arrays(x))
    (jm, js, jp), (pm, ps, pp) = out["jax"], out["port"]
    assert ps["bestModelType"] == js["bestModelType"]
    assert ps.get("combinationStrategy") == js.get("combinationStrategy")
    assert len(ps["validationResults"]) == len(js["validationResults"])
    if strategy == "WEIGHTED":
        np.testing.assert_allclose(ps["weights"], js["weights"], rtol=0,
                                   atol=METRIC_TOL)
        assert type(pm.best_model).__name__ == "CombinedModel"
        np.testing.assert_allclose(pp[1], jp[1], rtol=0, atol=5e-3)
    else:
        assert abs(ps["otherModelValidation"] - js["otherModelValidation"]) \
            <= METRIC_TOL


def test_combiner_splits_workflow_cv_results():
    """Workflow CV hands the combiner the union's results; each selector
    gets its own families' share, as the reference's does."""
    from transmogrifai_tpu_torch.features import FeatureBuilder as PFB
    from transmogrifai_tpu_torch.selector.validators import CandidateResult

    comb = _combiner(PMS, PC, "BEST", device="cpu")
    comb.set_input(PFB.RealNN("label").as_response(),
                   PFB.OPVector("vec").as_predictor())
    u1 = [e.uid for e, _ in comb.selector1.models]
    u2 = [e.uid for e, _ in comb.selector2.models]
    comb.precomputed_results = [
        CandidateResult(type(e).__name__, e.uid, {}, [0.5 + 0.1 * i])
        for i, (e, _) in enumerate(comb.selector1.models
                                   + comb.selector2.models)]
    seen = {}
    for sel in (comb.selector1, comb.selector2):
        real = sel.fit_arrays

        def spy(x, y, m, _sel=sel, _real=real):
            seen[id(_sel)] = [r.model_uid for r in _sel.precomputed_results or []]
            return _real(x, y, m)

        sel.fit_arrays = spy
    x, y = _table("BinaryClassification")
    comb.fit_arrays(x, y, np.ones(len(y), np.float32))
    assert seen[id(comb.selector1)] == u1
    assert seen[id(comb.selector2)] == u2
    assert comb.precomputed_results is None


# ----------------------------------------------------------- persistence
@pytest.mark.parametrize("name", ["OpNaiveBayes", "OpLinearSVC",
                                  "OpMultilayerPerceptronClassifier",
                                  "OpGeneralizedLinearRegression", "combined"])
def test_jax_saved_models_load_and_score_in_the_port(name, tmp_path):
    """A workflow the JAX package trained around the family and saved
    loads in the port and scores within the family's bound."""
    import transmogrifai_tpu.types as JT
    from transmogrifai_tpu.dataset import Dataset
    from transmogrifai_tpu.features import FeatureBuilder as JFB
    from transmogrifai_tpu.types.columns import VectorColumn, column_from_values
    from transmogrifai_tpu.utils import uid as juid
    from transmogrifai_tpu.workflow.workflow import Workflow
    from transmogrifai_tpu_torch.workflow.persistence import load_workflow_model

    kind = "Regression" if name == "OpGeneralizedLinearRegression" else \
        "BinaryClassification"
    x, y = _table(kind)
    juid.reset()
    label = JFB.RealNN("label").as_response()
    vec = JFB.OPVector("vec").as_predictor()
    if name == "combined":
        sel = _combiner(JMS, JC, "WEIGHTED")
    else:
        sel = _selector(JMS, kind, [name])
    pred = sel.set_input(label, vec).get_output()
    ds = Dataset.of({"label": column_from_values(JT.RealNN, y.tolist()),
                     "vec": VectorColumn(JT.OPVector, x)})
    model = Workflow().set_result_features(pred).set_input_dataset(ds).train()
    path = str(tmp_path / "m")
    model.save(path)
    want = model.score(ds)[pred.name]
    loaded = load_workflow_model(path, device="cpu")
    import transmogrifai_tpu_torch.types as PT
    from transmogrifai_tpu_torch.dataset import Dataset as PDataset
    from transmogrifai_tpu_torch.types.columns import (
        VectorColumn as PVC, column_from_values as pcfv,
    )

    pds = PDataset.of({"label": pcfv(PT.RealNN, y.tolist()),
                       "vec": PVC(PT.OPVector, x)})
    got = loaded.score(pds)[pred.name]
    np.testing.assert_allclose(got.prediction, want.prediction, rtol=1e-6,
                               atol=1e-6)
    if want.probability is not None:
        np.testing.assert_allclose(got.probability, want.probability,
                                   rtol=0, atol=1e-6)
    assert loaded.attribution_profiles == json.loads(
        json.dumps(model.attribution_profiles))
