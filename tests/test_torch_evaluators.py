"""The port's evaluators, splitters, validators' fold masks and table
renderer against the JAX package's, on seeded numpy arrays: every metric
dict, mask, index array and summary is EQUAL (no tolerance; both run the
same float64 numpy), including the edge cases (no positives, no negatives,
ties in the scores, one class, a degenerate score, imbalanced labels)."""
import json

import numpy as np
import pytest
import torch

from transmogrifai_tpu import evaluators as JE
from transmogrifai_tpu import types as JT
from transmogrifai_tpu.prep import splitters as JS
from transmogrifai_tpu.selector import validators as JV
from transmogrifai_tpu.types import columns as JCOL
from transmogrifai_tpu.utils.table import render_table as j_render_table

from transmogrifai_tpu_torch import evaluators as PE
from transmogrifai_tpu_torch import types as PT
from transmogrifai_tpu_torch.prep import splitters as PS
from transmogrifai_tpu_torch.selector import validators as PV
from transmogrifai_tpu_torch.types import columns as PCOL
from transmogrifai_tpu_torch.utils.table import render_table

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]


def same(a, b) -> bool:
    """Equal as JSON (NaN equals NaN; floats compared exactly)."""
    dump = lambda d: json.dumps(d, sort_keys=True, default=float)  # noqa: E731
    return dump(a) == dump(b)


def binary_case(name: str, n: int = 257, seed: int = 0):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.4).astype(np.float64)
    p1 = np.clip(0.35 * y + rng.random(n) * 0.65, 0.0, 1.0)
    if name == "no_positives":
        y[:] = 0.0
    elif name == "no_negatives":
        y[:] = 1.0
    elif name == "ties":
        p1 = np.round(p1 * 4) / 4  # five distinct scores
    elif name == "constant_score":
        p1[:] = 0.5
    elif name == "imbalanced":
        y = (rng.random(n) < 0.03).astype(np.float64)
    prob = np.stack([1 - p1, p1], axis=1)
    pred = (p1 > 0.5).astype(np.float64)
    return y, pred, prob


BINARY_CASES = ["plain", "no_positives", "no_negatives", "ties",
                "constant_score", "imbalanced"]


@pytest.mark.parametrize("case", BINARY_CASES)
def test_binary_evaluator_matches_the_reference(case):
    y, pred, prob = binary_case(case)
    got = PE.BinaryClassificationEvaluator().evaluate_arrays(y, pred, prob)
    want = JE.BinaryClassificationEvaluator().evaluate_arrays(y, pred, prob)
    assert same(got, want)
    # hard predictions only: the score is the prediction itself
    assert same(PE.BinaryClassificationEvaluator().evaluate_arrays(y, pred, None),
                JE.BinaryClassificationEvaluator().evaluate_arrays(y, pred, None))


@pytest.mark.parametrize("case", BINARY_CASES)
def test_bin_score_evaluator_matches_the_reference(case):
    y, pred, prob = binary_case(case, seed=1)
    assert same(PE.BinScoreEvaluator().evaluate_arrays(y, pred, prob),
                JE.BinScoreEvaluator().evaluate_arrays(y, pred, prob))


@pytest.mark.parametrize("case", ["plain", "one_class", "ties", "unseen_pred"])
def test_multiclass_evaluator_matches_the_reference(case):
    rng = np.random.default_rng(2)
    n, c = 300, 4
    y = rng.integers(0, c, n).astype(np.float64)
    logits = rng.normal(size=(n, c)) + 2.0 * np.eye(c)[y.astype(int)]
    if case == "ties":
        logits = np.round(logits)
    prob = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    pred = prob.argmax(axis=1).astype(np.float64)
    if case == "one_class":
        y[:] = 2.0
    elif case == "unseen_pred":
        pred[:7] = 5.0
    assert same(PE.MultiClassificationEvaluator().evaluate_arrays(y, pred, prob),
                JE.MultiClassificationEvaluator().evaluate_arrays(y, pred, prob))


@pytest.mark.parametrize("case", ["plain", "constant_label", "exact"])
def test_regression_and_forecast_evaluators_match_the_reference(case):
    rng = np.random.default_rng(3)
    y = rng.normal(3.0, 2.0, 200)
    pred = y + rng.normal(0.0, 0.5, 200)
    if case == "constant_label":
        y[:] = 1.5
    elif case == "exact":
        pred = y.copy()
    assert same(PE.RegressionEvaluator().evaluate_arrays(y, pred, None),
                JE.RegressionEvaluator().evaluate_arrays(y, pred, None))
    assert same(PE.ForecastEvaluator().evaluate_arrays(y, pred, None),
                JE.ForecastEvaluator().evaluate_arrays(y, pred, None))


def test_evaluators_have_the_reference_names_and_metrics():
    for name in ("BinaryClassificationEvaluator", "MultiClassificationEvaluator",
                 "RegressionEvaluator", "ForecastEvaluator", "BinScoreEvaluator"):
        p, j = getattr(PE, name)(), getattr(JE, name)()
        assert (p.name, p.default_metric, p.is_larger_better) == (
            j.name, j.default_metric, j.is_larger_better)


def test_evaluate_on_columns_matches_the_reference():
    y, pred, prob = binary_case("plain", seed=4)
    got = PE.BinaryClassificationEvaluator().evaluate(
        PCOL.NumericColumn(PT.RealNN, y, np.ones(len(y), bool)),
        PCOL.PredictionColumn(PT.Prediction, pred, prob, None))
    want = JE.BinaryClassificationEvaluator().evaluate(
        JCOL.NumericColumn(JT.RealNN, y, np.ones(len(y), bool)),
        JCOL.PredictionColumn(JT.Prediction, pred, prob, None))
    assert same(got, want)


# ---------------------------------------------------------------- splitters
@pytest.mark.parametrize("n,seed", [(891, 42), (10, 7), (1, 0)])
def test_data_splitter_split_matches_the_reference(n, seed):
    got = PS.DataSplitter(seed=seed).split(n)
    want = JS.DataSplitter(seed=seed).split(n)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["balanced", "rare_positives", "rare_negatives",
                                  "one_class", "capped"])
def test_splitter_prepare_masks_match_the_reference(case):
    rng = np.random.default_rng(5)
    n = 2000
    frac = {"rare_positives": 0.03, "rare_negatives": 0.97}.get(case, 0.4)
    y = (rng.random(n) < frac).astype(np.float64)
    if case == "one_class":
        y[:] = 1.0
    kw = {"max_training_sample": 500} if case == "capped" else {}
    for cls in ("DataBalancer", "DataSplitter"):
        p, j = getattr(PS, cls)(seed=11, **kw), getattr(JS, cls)(seed=11, **kw)
        np.testing.assert_array_equal(p.prepare(y), j.prepare(y))
        assert same(p.summary.to_json(), j.summary.to_json())
        assert p.get_params() == j.get_params()


@pytest.mark.parametrize("min_fraction", [0.0, 0.05])
def test_data_cutter_matches_the_reference(min_fraction):
    rng = np.random.default_rng(6)
    y = rng.choice(8, size=1500, p=[0.3, 0.2, 0.2, 0.1, 0.1, 0.06, 0.03, 0.01])
    y = y.astype(np.float64)
    p = PS.DataCutter(max_label_categories=5, min_label_fraction=min_fraction)
    j = JS.DataCutter(max_label_categories=5, min_label_fraction=min_fraction)
    np.testing.assert_array_equal(p.prepare(y), j.prepare(y))
    assert p.labels_kept == j.labels_kept
    assert same(p.summary.to_json(), j.summary.to_json())


# ------------------------------------------------------- validators' masks
@pytest.mark.parametrize("stratify", [False, True])
@pytest.mark.parametrize("num_folds", [2, 3, 5])
def test_cross_validator_folds_match_the_reference(num_folds, stratify):
    y = (np.random.default_rng(8).random(891) < 0.38).astype(np.float64)
    got = PV.CrossValidator(num_folds, stratify, seed=42).split_masks(y)
    want = JV.CrossValidator(num_folds, stratify, seed=42).split_masks(y)
    assert len(got) == len(want) == num_folds
    for (gt, gv), (wt, wv) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("ratio", [0.75, 0.5])
def test_train_validation_split_matches_the_reference(ratio):
    y = np.zeros(400)
    (gt, gv), = PV.TrainValidationSplit(ratio, seed=3).split_masks(y)
    (wt, wv), = JV.TrainValidationSplit(ratio, seed=3).split_masks(y)
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_array_equal(gv, wv)


def test_cross_validator_refuses_one_fold():
    with pytest.raises(ValueError, match="num_folds"):
        PV.CrossValidator(num_folds=1)


def test_expand_grid_and_best_match_the_reference():
    grid = {"a": [1, 2], "b": [0.1, 0.5, 0.9], "c": [True]}
    assert PV.expand_grid(grid) == JV.expand_grid(grid)
    rows = [("m", "u1", {"a": 1}, [0.5, 0.7]), ("m", "u1", {"a": 2}, [0.6, 0.6]),
            ("n", "u2", {"b": 1}, [float("nan"), 0.9]),
            ("n", "u2", {"b": 2}, [0.7, 0.5])]
    p = [PV.CandidateResult(*r) for r in rows]
    j = [JV.CandidateResult(*r) for r in rows]
    assert same([r.to_json() for r in p], [r.to_json() for r in j])
    for ev in ("BinaryClassificationEvaluator", "RegressionEvaluator"):
        got = PV.Validator.best(p, getattr(PE, ev)())
        want = JV.Validator.best(j, getattr(JE, ev)())
        assert got.grid == want.grid and got.model_name == want.model_name


def test_render_table_matches_the_reference():
    rows = [["AuPR", "0.8512", "0.9"], ["F1", "", "1.0"], ["a longer name", "x", "y"]]
    headers = ["Metric Name", "Hold Out Set Value", "Training Set Value"]
    assert render_table(headers, rows) == j_render_table(headers, rows)
