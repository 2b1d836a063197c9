"""The port's model selector and validators against the JAX package's, on
the CPU (``device="cpu"``), and the selector fixture the JAX package made
at the default grids.

The sweep runs once per package: ``CrossValidator.validate`` over the
flagship twin's checked vector (the port's fit side, equal to the JAX
package's) with the reduced grids of ``torch_fixtures/selector_flows.py``
(XGBoost ``num_round`` 10, 2 points; random forest 5 trees at depths
{3, 6}, 12 points; logistic regression 2 points) and the DataBalancer's
refit mask as the extra lane. Every tree candidate's CV metric values, the
refit lanes' trees and the winner are EQUAL; the logistic candidates are
within ``LR_METRIC_TOL`` = 2e-4 (measured: 1.14e-4).
"""
import importlib.util
import json
import os
import threading

import numpy as np
import pytest
import torch

from transmogrifai_tpu.evaluators import BinaryClassificationEvaluator as JBinEval
from transmogrifai_tpu.prep.splitters import DataBalancer as JDataBalancer
from transmogrifai_tpu.selector import validators as JV

from transmogrifai_tpu_torch import evaluators as PE
from transmogrifai_tpu_torch.models import gbdt as PG
from transmogrifai_tpu_torch.models import hist as PH
from transmogrifai_tpu_torch.models import logistic as PL
from transmogrifai_tpu_torch.prep.splitters import DataBalancer
from transmogrifai_tpu_torch.selector import model_selector as PMS
from transmogrifai_tpu_torch.selector import validators as PV
from transmogrifai_tpu_torch.utils import cuda_build
from transmogrifai_tpu_torch.workflow import persistence as PP
from transmogrifai_tpu_torch.workflow.fit import fit_and_transform_dag

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "torch_selector")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "torch_fixtures", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


F = _load("selector_flows")


@pytest.fixture(scope="module")
def arrays():
    """(x, y, refit mask) of the flagship twin's checked vector."""
    ds = F.dataset("port")
    label, checked = F.feature_side("port", ds)
    data, _ = fit_and_transform_dag(ds, [checked])
    x = np.asarray(data[checked.name].values, dtype=np.float32)
    y = data[label.name].values.astype(np.float64)
    mask = DataBalancer(seed=42).prepare(y)
    np.testing.assert_array_equal(mask, JDataBalancer(seed=42).prepare(y))
    return x, y, mask.astype(np.float32)


def _sweep(pkg, arrays):
    x, y, mask = arrays
    mods = F.modules(pkg)
    mods["uid"].reset()
    validator = (JV if pkg == "jax" else PV).CrossValidator(seed=42)
    evaluator = (JBinEval if pkg == "jax" else PE.BinaryClassificationEvaluator)()
    results = validator.validate(F.binary_candidates(pkg), x, y, evaluator,
                                 extra_masks=[mask])
    return results, validator, evaluator


@pytest.fixture(scope="module")
def swept(arrays):
    return {pkg: _sweep(pkg, arrays) for pkg in ("jax", "port")}


def test_candidate_metrics_match_the_reference(swept):
    got = [r.to_json() for r in swept["port"][0]]
    want = [r.to_json() for r in swept["jax"][0]]
    assert len(got) == 2 + 12 + 2
    assert F.assert_same_results(got, want) <= F.LR_METRIC_TOL


@pytest.mark.parametrize("family", ["RandomForestClassifier", "XGBoostClassifier"])
def test_tree_candidates_are_equal(swept, family):
    got = [r.to_json() for r in swept["port"][0] if r.model_name == family]
    want = [r.to_json() for r in swept["jax"][0] if r.model_name == family]
    assert got and F.dump(got) == F.dump(want)


def test_winner_and_attempts_match_the_reference(swept):
    (pres, pval, pev), (jres, jval, jev) = swept["port"], swept["jax"]
    pbest, jbest = PV.Validator.best(pres, pev), JV.Validator.best(jres, jev)
    assert (pbest.model_name, pbest.model_uid, pbest.grid) == (
        jbest.model_name, jbest.model_uid, jbest.grid)
    assert pval.last_attempt_info == jval.last_attempt_info


@pytest.mark.parametrize("family", ["RandomForestClassifier", "XGBoostClassifier"])
def test_refit_lanes_trees_are_equal(swept, family):
    """The refit mask rides every group of the family's sweep as one more
    lane; each point's refit model has the JAX package's trees."""
    def refits(validator, results):
        uid = next(r.model_uid for r in results if r.model_name == family)
        points, rows = validator.last_extra_models[uid]
        assert len(rows) == 1
        return points, rows[0]

    ppoints, pmodels = refits(swept["port"][1], swept["port"][0])
    jpoints, jmodels = refits(swept["jax"][1], swept["jax"][0])
    assert ppoints == jpoints
    for pm, jm in zip(pmodels, jmodels, strict=True):
        pa, ja = pm.get_arrays(), jm.get_arrays()
        assert sorted(pa) == sorted(ja)
        for k in ja:
            np.testing.assert_array_equal(np.asarray(pa[k]), np.asarray(ja[k]),
                                          err_msg=k)
        assert pm.get_params() == jm.get_params()


@pytest.mark.parametrize("family", ["RandomForestClassifier", "XGBoostClassifier"])
def test_refit_lane_outputs_match_the_reference(swept, family):
    """The train metrics come from the refit lane's training outputs (the
    fit's own, not a predict): those outputs and the predictions made from
    them equal the JAX package's; detaching frees the stack."""
    def refit(pkg):
        results, validator, _ = swept[pkg]
        uid = next(r.model_uid for r in results if r.model_name == family)
        return validator.last_extra_models[uid][1][0]

    for pm, jm in zip(refit("port"), refit("jax"), strict=True):
        got = PMS._refit_outputs(pm)
        want = np.asarray(jm._sweep_stack["outputs"])[jm._sweep_lane]
        np.testing.assert_array_equal(got, want)
        for a, b in zip(pm.predictions_from_sweep(got),
                        jm.predictions_from_sweep(want)):
            np.testing.assert_array_equal(a, b)
    model = refit("port")[0]
    model.detach_from_sweep()
    assert not hasattr(model, "_sweep_stack") and PMS._refit_outputs(model) is None


@pytest.mark.parametrize("family", ["xgb", "rf"])
def test_a_stack_without_outputs_is_traversed_again(family):
    """Where a stack keeps no training outputs, ``sweep_eval_batched``
    returns None and the validator walks each lane again through its
    model's predict route; the metrics equal those the stacks' outputs
    give."""
    x, y = _tiny()
    cls = PG.XGBoostClassifier if family == "xgb" else PG.RandomForestClassifier
    knobs = ({"num_round": 3} if family == "xgb" else {"num_trees": 3})

    class _NoOutputs(cls):
        def fit_arrays_batched_masks(self, *a):
            models = super().fit_arrays_batched_masks(*a)
            for row in models:
                for m in row:
                    m._sweep_stack["outputs"] = None
            return models

    grid = {"min_info_gain": [0.0, 0.01]}
    ev = PE.BinaryClassificationEvaluator()
    bare = _NoOutputs(max_depth=3, device="cpu", **knobs)
    folds = PV.CrossValidator(seed=2).split_masks(y)
    models = bare.fit_arrays_batched_masks(
        x, y, [t.astype(np.float32) for t, _ in folds], PV.expand_grid(grid))
    assert bare.sweep_eval_batched(models, x, y, folds, ev) is None
    got = PV.CrossValidator(seed=2).validate([(bare, grid)], x, y, ev)
    want = PV.CrossValidator(seed=2).validate(
        [(cls(max_depth=3, device="cpu", **knobs), grid)], x, y, ev)
    assert [r.metric_values for r in got] == [r.metric_values for r in want]


# --------------------------------------------------------- isolation rules
def _tiny():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 4)).astype(np.float32)
    y = (x[:, 0] + 0.3 * rng.normal(size=200) > 0).astype(np.float64)
    return x, y


class _Raising(PL.LogisticRegression):
    error: Exception = ValueError("broken candidate")

    def sweep_dispatch_masks(self, x, y, masks, grid_points):
        raise self.error


@pytest.mark.parametrize("error,propagates", [
    (ValueError("broken candidate"), False),
    (RuntimeError("out of lanes"), False),
    (cuda_build.KernelLaunchError("hist_binloop kernel launch failed"), True),
    (cuda_build.KernelBuildError("nvcc exited 1"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    *([(torch.AcceleratorError("CUDA error: misaligned address"), True)]
      if hasattr(torch, "AcceleratorError") else []),
])
def test_kernel_faults_propagate_and_other_errors_are_isolated(error, propagates):
    x, y = _tiny()
    bad = _Raising(device="cpu")
    bad.error = error
    candidates = [
        (bad, {"reg_param": [0.1]}),
        (PG.XGBoostClassifier(num_round=2, max_depth=2, device="cpu"),
         {"eta": [0.3]}),
    ]
    validator = PV.CrossValidator(seed=1)
    if propagates:
        with pytest.raises(type(error)):
            validator.validate(candidates, x, y, PE.BinaryClassificationEvaluator())
        return
    results = validator.validate(candidates, x, y, PE.BinaryClassificationEvaluator())
    assert [r.model_name for r in results] == ["XGBoostClassifier"]
    assert validator.last_attempt_info[0] == {
        "modelName": "_Raising", "modelUID": bad.uid, "attempts": 1,
        "error": str(error), "excluded": True, "fromCheckpoint": False,
    }


def test_a_lane_that_fails_scoring_is_nan_and_a_kernel_fault_propagates():
    x, y = _tiny()
    est = PL.LogisticRegression(device="cpu")
    grid = {"reg_param": [0.01, 0.1]}
    dispatch = est.sweep_dispatch_masks

    def poisoned(fault):
        """The family's sweep, with its second point's models failing to
        score with ``fault``."""
        def sweep(*a):
            models = dispatch(*a)()
            for row in models:
                def broken(_x):
                    raise fault
                row[1].predict_arrays = broken
            return lambda: models
        return sweep

    est.sweep_dispatch_masks = poisoned(ValueError("nan lane"))
    results = PV.CrossValidator(seed=1).validate(
        [(est, grid)], x, y, PE.BinaryClassificationEvaluator())
    assert np.isfinite(results[0].metric_values).all()
    assert np.isnan(results[1].metric_values).all()
    assert PV.Validator.best(results, PE.BinaryClassificationEvaluator()) is results[0]
    est.sweep_dispatch_masks = poisoned(
        cuda_build.KernelLaunchError("serve_trees kernel launch failed"))
    with pytest.raises(cuda_build.KernelLaunchError):
        PV.CrossValidator(seed=1).validate(
            [(est, grid)], x, y, PE.BinaryClassificationEvaluator())


def test_all_candidates_failing_raises():
    x, y = _tiny()
    with pytest.raises(RuntimeError, match="All model candidates failed"):
        PV.CrossValidator(seed=1).validate(
            [(_Raising(device="cpu"), {"reg_param": [0.1]})], x, y,
            PE.BinaryClassificationEvaluator())


def test_launch_counts_are_exact_across_threads():
    def wrapper():
        pass
    wrapper.launches = 0

    def bump():
        for _ in range(20000):
            cuda_build.count_launch(wrapper)

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert wrapper.launches == 8 * 20000


# ------------------------------------------------------------- the factories
def test_factories_put_default_candidates_on_the_device():
    for factory, families in (
        (PMS.BinaryClassificationModelSelector,
         ["LogisticRegression", "RandomForestClassifier", "XGBoostClassifier"]),
        (PMS.RegressionModelSelector,
         ["LinearRegression", "RandomForestRegressor", "GBTRegressor"]),
        (PMS.MultiClassificationModelSelector,
         ["LogisticRegression", "RandomForestClassifier"]),
    ):
        sel = factory(device="cpu")
        assert [type(e).__name__ for e, _ in sel.models] == families
        assert all(e.device == "cpu" for e, _ in sel.models)
        assert all(e.device is None for e, _ in factory().models)


def test_default_grids_match_the_reference():
    from transmogrifai_tpu.selector import model_selector as JMS

    for grid in ("_lr_grid", "_rf_grid", "_gbt_grid", "_xgb_binary_grid"):
        assert getattr(PMS, grid)() == getattr(JMS, grid)()
    sizes = [len(PV.expand_grid(g)) for _, g in
             PMS.BinaryClassificationModelSelector().models]
    assert sizes == [8, 18, 2]


@pytest.mark.parametrize("name,item", [
    pytest.param("OpNaiveBayes", None, id="OpNaiveBayes-A9"),
    pytest.param("OpLinearSVC", None, id="OpLinearSVC-A9"),
    pytest.param("OpMultilayerPerceptronClassifier", None,
                 id="OpMultilayerPerceptronClassifier-A9"),
    pytest.param("OpGBTClassifier", None, id="OpGBTClassifier-A4"),
    pytest.param("OpDecisionTreeClassifier", None, id="OpDecisionTreeClassifier-A4"),
])
def test_families_still_to_port_name_their_item(name, item):
    """The families once still to port (their ids keep the ROADMAP item
    they raised with: A4's in the multiclass slice, A9's in the families
    slice) build on the CPU with the reference's default grid and fit a
    binary label; an SVC has no probability column."""
    from transmogrifai_tpu.selector import model_selector as JMS

    (est, grid), = PMS.make_candidates("BinaryClassification", [name], device="cpu")
    (jest, jgrid), = JMS.make_candidates("BinaryClassification", [name])
    assert type(est).__name__ == type(jest).__name__ and grid == jgrid
    assert est.get_params() == jest.get_params()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(200, 4)).astype(np.float32)
    y = (x[:, 0] + 0.3 * rng.normal(size=200) > 0).astype(np.float32)
    if name == "OpNaiveBayes":  # counts: non-negative features
        x = np.abs(x) * (x > 0)
    point = dict(PV.expand_grid(grid)[0]) if grid else {}
    if hasattr(est, "max_depth"):
        point["max_depth"] = 3
    model = est.with_params(**point).fit_arrays(x, y, np.ones(200, np.float32))
    pred, prob, _ = model.predict_arrays(x)
    assert (pred == y).mean() > 0.8
    assert prob is None if name == "OpLinearSVC" else prob.shape == (200, 2)


def test_make_candidates_builds_ported_families():
    cands = PMS.make_candidates(
        "Regression", ["OpLinearRegression", "OpXGBoostRegressor"], device="cpu")
    assert [type(e).__name__ for e, _ in cands] == ["LinearRegression",
                                                     "XGBoostRegressor"]
    with pytest.raises(ValueError, match="not a Regression model"):
        PMS.make_candidates("Regression", ["OpNaiveBayes"])


# ------------------------------------------------ saving: params and arrays
def _stage_instances():
    from transmogrifai_tpu_torch.models.linear import LinearRegressionModel
    from transmogrifai_tpu_torch.models.trees import Tree
    from transmogrifai_tpu_torch.ops import (
        categorical, combiner, numeric, text, text_stages,
    )
    from transmogrifai_tpu_torch.prep.derived_filter import FeatureRemovalModel
    from transmogrifai_tpu_torch.stages.metadata import ColumnMeta, VectorMetadata

    rng = np.random.default_rng(3)
    thr = np.sort(rng.normal(size=(3, 7)).astype(np.float32), axis=1)
    tree = Tree(rng.integers(-1, 3, (2, 2, 4)).astype(np.int32),
                rng.integers(0, 8, (2, 2, 4)).astype(np.int32),
                rng.normal(size=(2, 4)).astype(np.float32))
    meta = VectorMetadata("v", (ColumnMeta(("a",), "Real", index=0),))
    return [
        numeric.NumericVectorizerModel([1.5, 0.25], True, [[0.0, 2.0], [1.0, 3.0]]),
        numeric.BinaryVectorizer(fill_value=True, track_nulls=False),
        numeric.RealNNVectorizer(),
        categorical.OneHotModel([["a", "b"], ["c"]], True, False),
        text.SmartTextModel(["Pivot", "Hash"], [["x", "y"], []], 16, True, True),
        combiner.VectorsCombiner(),
        FeatureRemovalModel([0, 2, 3], True, meta),
        PG.BoostedBinaryModel(thr, tree, 0.3, 0.0),
        PG.ForestClassifierModel(thr, [tree]),
        PG.BoostedRegressionModel(thr, tree, 0.1, 2.5),
        PG.ForestRegressionModel(thr, tree),
        PL.LogisticRegressionModel(rng.normal(size=3), np.float64(0.5), 2),
        LinearRegressionModel(rng.normal(size=3), -1.25),
        PMS.SelectedModel(PG.BoostedBinaryModel(thr, tree, 0.3, 0.0),
                          {"bestModelType": "XGBoostClassifier"}),
        PG.BoostedMultiModel(thr, [tree, tree, tree], 0.2, 0.0),
        text_stages.OpStringIndexerModel(["b", "a", "c"], "skip"),
        text_stages.OpIndexToString(["b", "a", "c"], "unknown"),
        *_feature_stage_instances(),
        *_dsl_stage_instances(),
        *_family_stage_instances(),
        *_text_stage_instances(),
    ]


def _text_stage_instances():
    """One instance of each stage class of the text stages and the
    embeddings, with params off their defaults."""
    from transmogrifai_tpu_torch.ops import embeddings, text_stages as T

    rng = np.random.default_rng(5)
    return [
        T.TextTokenizer(False, 3, "de", True), T.OpNGram(3),
        T.OpStopWordsRemover(["a", "b"], True),
        T.OpCountVectorizerModel(["x", "y", "z"], True), T.OpHashingTF(64, True),
        T.OpIDFModel(rng.normal(size=5)), T.JaccardSimilarity(),
        T.NGramSimilarity(2), T.LangDetector(), T.MimeTypeDetector(),
        T.MimeTypeMapDetector(), T.ValidEmailTransformer(),
        T.HumanNameDetectorModel(True, frozenset({"ann", "bo"}), False),
        T.NameEntityRecognizer(),
        embeddings.OpWord2VecModel(["x", "y"], rng.normal(size=(2, 4))),
        embeddings.OpLDAModel(np.abs(rng.normal(size=(3, 5)))),
    ]


def _family_stage_instances():
    """One instance of each stage class of the other families, the
    combiner and the insights plane, with params off their defaults."""
    from transmogrifai_tpu_torch.insights.correlation import (
        RecordInsightsCorrModel,
    )
    from transmogrifai_tpu_torch.insights.loco import RecordInsightsLOCO
    from transmogrifai_tpu_torch.models import glm, isotonic, mlp, naive_bayes, svc
    from transmogrifai_tpu_torch.selector.combiner import CombinedModel

    rng = np.random.default_rng(4)
    lr = PL.LogisticRegressionModel(rng.normal(size=3), np.float64(0.5), 2)
    return [
        naive_bayes.NaiveBayesModel(rng.normal(size=2), rng.normal(size=(2, 3)),
                                    "bernoulli"),
        svc.LinearSVCModel(rng.normal(size=3), 0.25),
        glm.GeneralizedLinearRegressionModel(rng.normal(size=3), -0.5,
                                             "gamma", "log"),
        mlp.MLPClassifierModel(
            [{"w": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=4).astype(np.float32)},
             {"w": rng.normal(size=(4, 2)).astype(np.float32),
              "b": rng.normal(size=2).astype(np.float32)}], 2),
        isotonic.IsotonicRegressionCalibratorModel([0.0, 0.5, 1.0],
                                                   [0.1, 0.4, 0.9], False),
        CombinedModel(lr, svc.LinearSVCModel(rng.normal(size=3), 0.1), 0.7,
                      0.3, "BinaryClassification"),
        RecordInsightsLOCO(lr, top_k=5, strategy="positive_negative"),
        RecordInsightsCorrModel(rng.normal(size=(2, 3)), "zscore",
                                rng.normal(size=3), np.abs(rng.normal(size=3)), 4),
    ]


def _feature_stage_instances():
    """One instance of each stage class of transmogrify's date, phone,
    list, domain and map vectorizers, with params off their defaults."""
    from transmogrifai_tpu_torch.ops import (
        dates, domains, lists, maps, phone, time_period,
    )

    return [
        dates.DateVectorizer(123, ("HourOfDay", "DayOfWeek"), False),
        dates.DateToUnitCircleTransformer("DayOfYear"),
        time_period.TimePeriodTransformer("WeekOfYear"),
        time_period.TimePeriodListTransformer("MonthOfYear"),
        time_period.TimePeriodMapTransformer("DayOfMonth"),
        phone.PhoneVectorizer("GB", False),
        phone.ParsePhoneDefaultCountry("DE", True),
        phone.ParsePhoneNumber("FR", region_codes=["FR"],
                               country_names=["FRANCE"]),
        phone.IsValidPhoneDefaultCountry("ZW"),
        phone.IsValidPhoneNumber(),
        phone.IsValidPhoneMapDefaultCountry("CA", True),
        lists.TextListModel([[0.5, 0.0, 1.25, 2.0]], 4, True, 7, False),
        lists.DateListVectorizer("ModeDay", 5, False),
        lists.GeolocationModel([[1.0, 2.0, 0.0]], True),
        lists.TextListNullTransformer(),
        domains.EmailToPickListTransformer(),
        domains.UrlMapToPickListMapTransformer(),
        maps.RealMapModel([["a", "b"]], [[1.5, 2.0]], False, True),
        maps.DateMapModel([["k"]], 99, ["HourOfDay"], True, True),
        maps.TextMapPivotModel([["k"]], [[["x", "y"]]], False, True, True),
        maps.SmartTextMapModel([["j", "k"]], [["Pivot", "Hash"]],
                               [[["x"], []]], 16, False, True, True),
        maps.GeolocationMapModel([["h"]], False, True),
        maps.PhoneMapModel([["c"]], "US", False, False),
        maps.TextMapNullModel([["a"]], False),
        maps.TextMapLenModel([["a", "b"]], True),
    ]


def _dsl_stage_instances():
    """One instance of each stage class of the math, scaler, bucketizer,
    simple and prediction stages and the per-key map bucketizer, with
    params off their defaults (callables module-level, from
    ``tests/torch_fixtures/dsl_flow.py``)."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_fixtures"))
    import dsl_flow as D

    from transmogrifai_tpu_torch.ops import (
        bucketizers, maps, prediction, scalers, simple,
    )
    from transmogrifai_tpu_torch.ops import math as M

    return [
        M.AddTransformer(), M.SubtractTransformer(), M.MultiplyTransformer(),
        M.DivideTransformer(), M.ScalarAddTransformer(1.5),
        M.ScalarSubtractTransformer(-2.0), M.ScalarMultiplyTransformer(3.0),
        M.ScalarDivideTransformer(4.0), M.AbsoluteValueTransformer(),
        M.CeilTransformer(), M.FloorTransformer(), M.RoundTransformer(),
        M.RoundDigitsTransformer(3), M.ExpTransformer(), M.SqrtTransformer(),
        M.LogTransformer(10.0), M.PowerTransformer(2.5),
        scalers.OpScalarStandardScalerModel(1.25, 0.5),
        scalers.FillMissingWithMeanModel(-3.0),
        scalers.ScalerTransformer("Linear", {"slope": 2.0, "intercept": 1.0}),
        scalers.DescalerTransformer(),
        scalers.PercentileCalibratorModel([0.0, 0.5, 2.0, 9.0], 10),
        bucketizers.NumericBucketizer([-1.0, 0.0, 2.0], False, True,
                                      ["lo", "hi"]),
        bucketizers.DecisionTreeNumericBucketizerModel(
            [-np.inf, 0.25, np.inf], True, False, True),
        bucketizers.DropIndicesByTransformer(D.is_null_indicator),
        simple.AliasTransformer("renamed"),
        simple.FilterTransformer(D.is_positive, 0.0),
        simple.ReplaceTransformer("a", "b"), simple.SubstringTransformer(),
        simple.ToOccurTransformer(D.is_positive),
        simple.ExistsTransformer(D.is_long_text), simple.TextLenTransformer(),
        simple.FilterMap(["a"], ["b"], D.above_half),
        simple.MultiLabelJoiner(["x", "y"]), simple.TopNLabelProbMap(3),
        prediction.PredictionFieldExtractor("probability"),
        maps.DecisionTreeNumericMapBucketizerModel(
            [["k"]], [[[-np.inf, 0.5, np.inf]]], [[True]], False, True, False),
    ]


def test_every_loadable_class_saves():
    assert {type(s).__name__ for s in _stage_instances()} == set(PP.STAGE_CLASSES)


@pytest.mark.parametrize("index", range(103))
def test_params_and_arrays_are_the_inverse_of_loading(index):
    stage = _stage_instances()[index]
    params = json.loads(json.dumps(stage.get_params(), default=PP._json_default))
    get_arrays = getattr(stage, "get_arrays", dict)  # transformers hold none
    arrays = {k: np.asarray(v) for k, v in get_arrays().items()}
    again = PP.construct_stage(type(stage).__name__, params, arrays)
    assert json.loads(json.dumps(again.get_params(), default=PP._json_default)) == params
    got = getattr(again, "get_arrays", dict)()
    assert sorted(got) == sorted(arrays)
    for k in arrays:
        np.testing.assert_array_equal(np.asarray(got[k]), arrays[k])


# ------------------------------------------- the default-grid fixture (JAX)
@pytest.mark.parametrize("name", ["selector", "workflow_cv", "selector_trees"])
def test_selector_fixture_is_self_consistent(name):
    with open(os.path.join(FIXTURE, f"{name}.json")) as fh:
        fx = json.load(fh)
    scores = np.load(os.path.join(FIXTURE, f"{name}.npz"))
    s = fx["summary"]
    results = s["validationResults"]
    names = [r["modelName"] for r in results]
    families = {"RandomForestClassifier": 18, "XGBoostClassifier": 2}
    if name != "selector_trees":
        families["LogisticRegression"] = 8
    assert {n: names.count(n) for n in set(names)} == families
    for r in results:
        assert len(r["metricValues"]) == 3
        assert np.isfinite(r["metricValues"]).all()
        assert r["metricMean"] == float(np.mean(r["metricValues"]))
    best = max(results, key=lambda r: r["metricMean"])
    assert (s["bestModelType"], s["bestGrid"]) == (best["modelName"], best["grid"])
    assert s["bestModelName"] == f"{best['modelName']}_{best['modelUID']}"
    assert not any(a["excluded"] for a in s["candidateAttempts"])
    n = len(fx["holdout_idx"])
    assert n == fx["holdout_rows"] and fx["train_rows"] + n == 891
    assert scores["prediction"].shape == (n,)
    assert scores["probability"].shape == scores["raw"].shape == (n, 2)
    np.testing.assert_allclose(scores["probability"].sum(axis=1), 1.0)
    np.testing.assert_array_equal(scores["prediction"],
                                  scores["probability"].argmax(axis=1))
    assert fx["lead_lines"][0] == (
        f"Evaluated {', '.join(sorted(families))} models with 3 folds and "
        "AuPR metric.")
    if name == "selector_trees":  # the flow the card holds a tree winner to
        assert s["bestModelType"] in families


# ---------------------------------------------------------------- the card
def test_selector_sweep_on_the_card(arrays):
    """Needs a CUDA card (skips here): the same sweep on the card gives the
    CPU's tree candidates and refit trees bit for bit, the logistic
    candidates within ``LR_METRIC_TOL``, and the same winner."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, y, mask = arrays

    def sweep(device):
        validator = PV.CrossValidator(seed=42)
        cands = [(PL.LogisticRegression(device=device), F.LR_GRID),
                 (PG.RandomForestClassifier(device=device), F.RF_GRID),
                 (PG.XGBoostClassifier(device=device), F.XGB_GRID)]
        results = validator.validate(cands, x, y, PE.BinaryClassificationEvaluator(),
                                     extra_masks=[mask])
        return results, validator

    card, cpu = sweep("cuda"), sweep("cpu")
    F.assert_same_results(
        [dict(r.to_json(), modelUID="") for r in card[0]],
        [dict(r.to_json(), modelUID="") for r in cpu[0]])
    ev = PE.BinaryClassificationEvaluator()
    assert PV.Validator.best(card[0], ev).grid == PV.Validator.best(cpu[0], ev).grid
    for (_, (_, crow)), (_, (_, prow)) in zip(
            sorted(card[1].last_extra_models.items()),
            sorted(cpu[1].last_extra_models.items())):
        for cm, pm in zip(crow[0], prow[0]):
            if isinstance(cm, PL.LogisticRegressionModel):
                continue
            for k, v in pm.get_arrays().items():
                np.testing.assert_array_equal(cm.get_arrays()[k], v, err_msg=k)


def test_threaded_launches_on_the_card():
    """Needs a CUDA card (skips here): the histogram kernels launched from
    several host threads at once, each thread at another width and bin
    count (so another shared-memory size), as the selector's families
    launch them; every launch is accepted and equals the plain version on
    the CPU. A kernel's shared-memory limit is raised once to the most,
    never per call (a per-call limit let one thread lower it under
    another's launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from concurrent.futures import ThreadPoolExecutor

    shapes = [(4096, 918, 2, "binloop"), (4096, 10, 32, "binloop"),
              (4096, 64, 64, "binloop"), (2048, 10, 256, "wide")]

    def run(i):
        n, f, b, kind = shapes[i % len(shapes)]
        gen = np.random.default_rng(i)
        host = [gen.integers(0, b, (n, f)).astype(np.int32),
                gen.integers(-1, 8, (2, n)).astype(np.int32),
                gen.normal(size=(2, n)).astype(np.float32),
                (gen.random((2, n)) * 0.9 + 0.1).astype(np.float32)]
        fn = PH.build_histogram_binloop if kind == "binloop" else PH.build_histogram_wide
        want = fn(*[torch.from_numpy(a) for a in host], 8, b)
        card = [torch.from_numpy(a).cuda() for a in host]
        for _ in range(30):
            got = fn(*card, 8, b)
        torch.cuda.synchronize()
        return torch.equal(got.cpu(), want)

    with ThreadPoolExecutor(max_workers=8) as pool:
        assert all(pool.map(run, range(16)))
