"""``Workflow.train()`` and the ``WorkflowModel`` of the port against the JAX
package's: the five-line flow on the flagship twin at the reduced grids of
``torch_fixtures/selector_flows.py``, trained once per package and case,
on the CPU (``device="cpu"``).

Cases: ``main`` (LR + RF + XGBoost; a logistic candidate wins), ``raising``
(the logistic family raises, is excluded and recorded in
``candidateAttempts``; a tree family wins), ``regression``
(``RegressionModelSelector``: ``TrainValidationSplit``, linear + RF + GBT
regressors). Tree candidates, tree winners' scores, holdout and train
metrics and ``evaluate`` are EQUAL; a logistic winner's are within the
measured tolerances stated in ``selector_flows.py`` (``LR_METRIC_TOL``,
``LR_SCORE_TOL``, ``LR_MARGIN_TOL``, ``LR_EVAL_TOL``). Saving: a model the port saved loads in
the port and in the JAX package with scores EQUAL, and one the JAX package
saved loads in the port with scores EQUAL.
"""
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from transmogrifai_tpu.workflow.persistence import load_workflow_model as j_load

from transmogrifai_tpu_torch.local.scoring import score_function
from transmogrifai_tpu_torch.models import logistic as PL
from transmogrifai_tpu_torch.selector import model_selector as PMS
from transmogrifai_tpu_torch.workflow import dag as PD
from transmogrifai_tpu_torch.workflow import workflow as PW
from transmogrifai_tpu_torch.workflow.persistence import load_workflow_model

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "torch_fixtures", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


F = _load("selector_flows")


def _raising_selector(pkg, m):
    class BrokenLogistic(m["logistic"].LogisticRegression):
        def sweep_dispatch_masks(self, x, y, masks, grid_points):
            raise ValueError("broken candidate")

    models = [(BrokenLogistic(**F.dev(pkg)), F.LR_GRID)] + F.binary_candidates(
        pkg, ("rf", "xgb"))
    return m["model_selector"].BinaryClassificationModelSelector(models=models)


def _regression_selector(pkg, m):
    d = F.dev(pkg)
    return m["model_selector"].RegressionModelSelector(models=[
        (m["linear"].LinearRegression(**d), F.LR_GRID),
        (m["gbdt"].RandomForestRegressor(**d), F.RF_SMALL),
        (m["gbdt"].GBTRegressor(**d), F.GBT_SMALL),
    ])


CASES = {"main": F.default_binary, "raising": _raising_selector,
         "regression": _regression_selector}
_TRAINED: dict = {}


def flows(case: str):
    """{pkg: (dataset, model, prediction feature, selector)}, trained once
    per module."""
    if case not in _TRAINED:
        _TRAINED[case] = {pkg: F.train(pkg, CASES[case]) for pkg in ("jax", "port")}
    return _TRAINED[case]


def summaries(case: str):
    return [flows(case)[pkg][1].summary_json()["modelSelectorSummary"]
            for pkg in ("port", "jax")]


def glm_winner(case: str) -> bool:
    return summaries(case)[1]["bestModelType"] in F.GLM_FAMILIES


@pytest.mark.parametrize("case", list(CASES))
def test_selector_summary_matches_the_reference(case):
    got, want = summaries(case)
    F.assert_same_summary(got, want, glm_winner(case))
    for key in F.UNPORTED_KEYS:
        assert got[key] is None
    for key in F.LEDGER_KEYS:
        assert set(got[key]) == set(want[key])


def test_the_cases_cover_both_kinds_of_winner():
    assert glm_winner("main")
    assert not glm_winner("raising")
    assert summaries("regression")[0]["validationType"] == "TrainValidationSplit"


def test_a_raising_candidate_is_excluded_and_recorded():
    got, want = summaries("raising")
    attempts = got["candidateAttempts"]
    assert [a["excluded"] for a in attempts] == [True, False, False]
    assert attempts[0]["modelName"] == "BrokenLogistic"
    assert attempts[0]["error"] == "broken candidate"
    assert attempts == want["candidateAttempts"]
    assert {r["modelName"] for r in got["validationResults"]} == {
        "RandomForestClassifier", "XGBoostClassifier"}


def _lead(pretty: str) -> list[str]:
    return pretty.split("\n\nSelected model")[0].splitlines()


@pytest.mark.parametrize("case", list(CASES))
def test_summary_pretty_lead_lines_match_the_reference(case):
    """Equal line for line; a GLM family's line names its metric range,
    which is within ``LR_METRIC_TOL``."""
    pm, jm = flows(case)["port"][1], flows(case)["jax"][1]
    got, want = _lead(pm.summary_pretty()), _lead(jm.summary_pretty())
    assert len(got) == len(want) >= 2
    number = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")
    for g, w in zip(got, want):
        if any(f" {name} " in w for name in F.GLM_FAMILIES):
            assert number.sub("#", g) == number.sub("#", w)
            np.testing.assert_allclose(
                [float(v) for v in number.findall(g)],
                [float(v) for v in number.findall(w)], rtol=0,
                atol=F.LR_METRIC_TOL)
        else:
            assert g == w
    assert "Model evaluation metrics:" in pm.summary_pretty()
    assert pm.summary_pretty().splitlines()[-1] == jm.summary_pretty().splitlines()[-1]


def _scores(case, pkg, model=None):
    """(prediction, probability, raw) of the model's scores on the twin;
    a regression's probability and raw are None."""
    ds, trained, pred, _ = flows(case)[pkg]
    col = (model or trained).score(ds)[pred.name]
    return tuple(None if a is None else np.asarray(a)
                 for a in (col.prediction, col.probability, col.raw))


@pytest.mark.parametrize("case", list(CASES))
def test_scores_match_the_reference(case):
    got, want = _scores(case, "port"), _scores(case, "jax")
    tols = (F.LR_SCORE_TOL, F.LR_SCORE_TOL, F.LR_MARGIN_TOL)
    for g, w, tol in zip(got, want, tols):
        if w is None:
            assert g is None
        elif glm_winner(case):
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", list(CASES))
def test_evaluate_matches_the_reference(case):
    got = flows(case)["port"][1].evaluate(flows(case)["port"][0])
    want = flows(case)["jax"][1].evaluate(flows(case)["jax"][0])
    if glm_winner(case):
        F.assert_close_metrics(got, want, F.LR_EVAL_TOL)
    else:
        assert F.dump(got) == F.dump(want)
    scores, metrics = flows(case)["port"][1].score_and_evaluate(flows(case)["port"][0])
    assert F.dump(metrics) == F.dump(got)
    assert list(scores.columns) == [flows(case)["port"][2].name]


def test_model_fields_match_the_reference():
    pm, jm = flows("main")["port"][1], flows("main")["jax"][1]
    assert (pm.train_rows, pm.holdout_rows) == (jm.train_rows, jm.holdout_rows)
    assert pm.selector_info == jm.selector_info
    assert F.dump(pm.label_summary) == F.dump(jm.label_summary)
    ps, js = pm.summary_json(), jm.summary_json()
    for key in ("trainRows", "holdoutRows", "rawFeatures", "resultFeatures",
                "blocklistedFeatures"):
        assert ps[key] == js[key], key
    assert set(ps) == set(js)
    assert set(ps["stageMetadata"]) == set(js["stageMetadata"])


def test_score_function_equals_model_score():
    ds, model, pred, _ = flows("raising")["port"]
    fn = score_function(model, device="cpu")
    rows = ds.rows()
    out = fn.batch(rows)
    col = model.score(ds)[pred.name]
    np.testing.assert_array_equal([r[pred.name]["prediction"] for r in out],
                                  col.prediction)
    np.testing.assert_array_equal(
        [[r[pred.name]["probability_0"], r[pred.name]["probability_1"]] for r in out],
        col.probability)


# ------------------------------------------------------------------ saving
def test_port_saved_model_loads_in_both_packages(tmp_path):
    path = str(tmp_path / "model")
    ds, model, pred, _ = flows("raising")["port"]
    model.save(path)
    model.save(path)  # an existing save is replaced whole
    want = _scores("raising", "port")
    loaded = PW.WorkflowModel.load(path, device="cpu")
    for g, w in zip(_scores("raising", "port", loaded), want, strict=True):
        np.testing.assert_array_equal(g, w)
    summary = model.summary_json()["modelSelectorSummary"]
    assert loaded.summary_json()["modelSelectorSummary"] == F.without_unported(
        summary) | {k: None for k in F.UNPORTED_KEYS} | {
            k: summary[k] for k in F.LEDGER_KEYS}
    jloaded = j_load(path)
    jds = flows("raising")["jax"][0]
    col = jloaded.score(jds)[pred.name]
    for g, w in zip((col.prediction, col.probability, col.raw), want):
        np.testing.assert_array_equal(np.asarray(g), w)
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]


def test_jax_saved_model_loads_in_the_port(tmp_path):
    path = str(tmp_path / "model")
    flows("raising")["jax"][1].save(path)
    loaded = load_workflow_model(path, device="cpu")
    for g, w in zip(_scores("raising", "port", loaded), _scores("raising", "jax")):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------- workflow's own rules
def test_planes_not_ported_name_their_item():
    """A mesh (A13) raises naming its item (``None``, one device, is the
    port's layout); train's checkpoint, stream and run-ledger arguments
    are ported and reach train's own checks."""
    wf = PW.Workflow()
    with pytest.raises(NotImplementedError, match="A13"):
        wf.set_parallelism(object())
    assert wf.set_parallelism(None) is wf
    for kwargs in ({"checkpoint_dir": "x"}, {"stream": True},
                   {"progress": print}, {"run_dir": "x"}):
        with pytest.raises(ValueError, match="setResultFeatures"):
            wf.train(**kwargs)


def test_train_refuses_two_selectors_and_an_empty_workflow():
    with pytest.raises(ValueError, match="setResultFeatures"):
        PW.Workflow().train()
    m = F.modules("port")
    ds = F.dataset("port")
    label, checked = F.feature_side("port", ds)
    p1 = PMS.BinaryClassificationModelSelector(device="cpu").set_input(
        label, checked).get_output()
    p2 = PMS.BinaryClassificationModelSelector(device="cpu").set_input(
        label, checked).get_output()
    wf = m["workflow"].Workflow().set_result_features(p1, p2).set_input_dataset(ds)
    with pytest.raises(ValueError, match="Only one ModelSelector"):
        wf.train()


def test_validate_stages_names_every_finding():
    lr = PL.LogisticRegression(device="cpu")
    with pytest.raises(ValueError, match="no input features wired"):
        PD.validate_stages([[lr]])
    ds = F.dataset("port")
    label, checked = F.feature_side("port", ds)
    PD.validate_stages(PD.compute_dag([checked]))


def test_compute_data_up_to_and_warm_start():
    ds, model, pred, _ = flows("raising")["port"]
    label_feature, vec_feature = pred.origin_stage.input_features
    wf = PW.Workflow().set_result_features(pred).set_input_dataset(ds)
    wf.with_model_stages(model)
    data = wf.compute_data_up_to(vec_feature)
    np.testing.assert_array_equal(
        data[vec_feature.name].values,
        model.score(ds, keep_intermediate_features=True)[vec_feature.name].values)
