"""Workflow-level CV (``Workflow().with_workflow_cv()``) in the port against
the JAX package's: the five-line flow on the flagship twin at the reduced
grids of ``torch_fixtures/selector_flows.py``, once per package, on the CPU
(``device="cpu"``). Each fold fits the DAG up to the selector's inputs on
its training rows again; the candidate results are EQUAL for the tree
families and within ``LR_METRIC_TOL`` (2e-4; measured here 5.62e-5) for
the logistic family, the winner and grid are equal, and the winner's
scores and metrics are within the stated logistic tolerances. The
pipeline's order (every GLM family issued, the tree families fitted, then
the GLM lanes collected) and the failure isolation are checked on the
port alone."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.models import gbdt as PG
from transmogrifai_tpu_torch.models import logistic as PL
from transmogrifai_tpu_torch.selector import model_selector as PMS
from transmogrifai_tpu_torch.utils import cuda_build
from transmogrifai_tpu_torch.workflow import cv as PCV

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


@pytest.fixture(scope="module")
def flows():
    return {pkg: F.train(pkg, F.default_binary, workflow_cv=True)
            for pkg in ("jax", "port")}


def _summary(flows, pkg):
    return flows[pkg][1].summary_json()["modelSelectorSummary"]


def test_candidate_results_match_the_reference(flows):
    got, want = _summary(flows, "port"), _summary(flows, "jax")
    assert len(got["validationResults"]) == 2 + 12 + 2
    assert F.assert_same_results(got["validationResults"],
                                 want["validationResults"]) <= F.LR_METRIC_TOL
    assert (got["bestModelType"], got["bestGrid"]) == (
        want["bestModelType"], want["bestGrid"])


@pytest.mark.parametrize("family", ["RandomForestClassifier", "XGBoostClassifier"])
def test_tree_candidates_are_equal(flows, family):
    got = [r for r in _summary(flows, "port")["validationResults"]
           if r["modelName"] == family]
    want = [r for r in _summary(flows, "jax")["validationResults"]
            if r["modelName"] == family]
    assert got and F.dump(got) == F.dump(want)


def test_summary_matches_the_reference(flows):
    got, want = _summary(flows, "port"), _summary(flows, "jax")
    winner_glm = want["bestModelType"] in F.GLM_FAMILIES
    F.assert_same_summary(got, want, winner_glm)
    # the precomputed results skip the selector's validator: no attempts
    assert got["candidateAttempts"] == want["candidateAttempts"] == []


def test_scores_match_the_reference(flows):
    (pds, pm, ppred, _), (jds, jm, jpred, _) = flows["port"], flows["jax"]
    got, want = pm.score(pds)[ppred.name], jm.score(jds)[jpred.name]
    winner_glm = _summary(flows, "jax")["bestModelType"] in F.GLM_FAMILIES
    for name, tol in (("prediction", F.LR_SCORE_TOL),
                      ("probability", F.LR_SCORE_TOL), ("raw", F.LR_MARGIN_TOL)):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        if winner_glm:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


# ------------------------------------------------- the pipeline, port alone
class _Recording:
    events: list = []


class _RecordingLogistic(PL.LogisticRegression):
    def sweep_dispatch_masks(self, x, y, masks, grid_points):
        _Recording.events.append("dispatch")
        collect = super().sweep_dispatch_masks(x, y, masks, grid_points)

        def collector():
            _Recording.events.append("collect")
            return collect()
        return collector


class _RecordingForest(PG.RandomForestClassifier):
    def fit_arrays_batched_masks(self, x, y, masks, points):
        _Recording.events.append("trees")
        return super().fit_arrays_batched_masks(x, y, masks, points)


def _small_cv(models):
    ds = F.dataset("port")
    label, checked = F.feature_side("port", ds)
    selector = PMS.BinaryClassificationModelSelector(models=models)
    selector.set_input(label, checked).get_output()
    return PCV.workflow_cv_results(selector, ds)


def test_glm_lanes_are_issued_before_the_trees_and_collected_after():
    _Recording.events = []
    results = _small_cv([
        (_RecordingForest(device="cpu"), F.RF_SMALL),
        (_RecordingLogistic(device="cpu"), F.LR_GRID),
    ])
    assert _Recording.events == ["dispatch", "trees", "collect"] * 3
    assert len(results) == 2 + 2
    assert all(len(r.metric_values) == 3 for r in results)


class _Failing(PG.RandomForestClassifier):
    error: Exception = ValueError("broken fold")

    def fit_arrays_batched_masks(self, x, y, masks, points):
        raise self.error


def test_a_failing_family_is_dropped_and_a_kernel_fault_propagates():
    results = _small_cv([
        (_Failing(device="cpu"), F.RF_SMALL),
        (PL.LogisticRegression(device="cpu"), F.LR_GRID),
    ])
    assert {r.model_name for r in results} == {"LogisticRegression"}
    bad = _Failing(device="cpu")
    bad.error = cuda_build.KernelLaunchError("hist_binloop kernel launch failed")
    with pytest.raises(cuda_build.KernelLaunchError):
        _small_cv([(bad, F.RF_SMALL),
                   (PL.LogisticRegression(device="cpu"), F.LR_GRID)])
