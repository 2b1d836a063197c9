"""The port's multiclass path against the JAX package: the string indexer
and its inverse, the multinomial logistic fit and its batched lanes, the
one-vs-rest boosted model (``BoostedMultiModel``), multiclass XGBoost,
``GBTClassifier`` (binary and multiclass), both decision trees, the random
forest's multiclass sweep, and the whole flow (``string_indexed`` ->
``transmogrify`` -> ``sanity_check`` -> ``MultiClassificationModelSelector``
-> ``train()`` -> save, load, staged and fused scoring), on the CPU.

Trees, their training outputs, the tree candidates' metrics and a tree
winner's scores are EQUAL; the multinomial lanes' probabilities agree
within ``MULTINOMIAL_PROB_TOL`` (1e-5; ``tests/torch_fixtures/
multiclass_flow.py`` says what was measured), a logistic winner's fused
scores within 1e-6 of its staged ones. The flows are held to the fixture
``tests/fixtures/torch_multiclass`` (``make_multiclass_fixtures.py``); the
smaller comparisons run both packages here.
"""
import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from transmogrifai_tpu.models import gbdt as JG
from transmogrifai_tpu.models import logistic as JL
from transmogrifai_tpu.ops import text_stages as JTS
from transmogrifai_tpu.prep.splitters import DataCutter as JDataCutter
from transmogrifai_tpu.selector import model_selector as JMS

from transmogrifai_tpu_torch import load_workflow_model, score_function
from transmogrifai_tpu_torch.models import gbdt as PG
from transmogrifai_tpu_torch.models import logistic as PL
from transmogrifai_tpu_torch.ops import text_stages as PTS
from transmogrifai_tpu_torch.prep.splitters import DataCutter
from transmogrifai_tpu_torch.selector import model_selector as PMS
from transmogrifai_tpu_torch.selector import validators as PV
from transmogrifai_tpu_torch.types import RealNN, Text
from transmogrifai_tpu_torch.types.columns import NumericColumn, TextColumn
from transmogrifai_tpu_torch.workflow import persistence as PP

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "torch_fixtures"))
import multiclass_flow as MF  # noqa: E402

MULTINOMIAL_PROB_TOL = MF.MULTINOMIAL_PROB_TOL
#: a logistic winner's fused scores against its staged ones (the fused
#: core is float32, the staged one float64: the reference's own bound)
FUSED_GLM_ATOL = 1e-6


def _fixture(name: str):
    with open(os.path.join(MF.FIXTURE, f"{name}.json")) as fh:
        record = json.load(fh)
    return record, np.load(os.path.join(MF.FIXTURE, f"{name}.npz"))


def _same_json(a, b) -> bool:
    return (json.dumps(a, sort_keys=True, default=float)
            == json.dumps(b, sort_keys=True, default=float))


def _tree_equal(got, want) -> bool:
    return all(np.array_equal(np.asarray(g), np.asarray(w), equal_nan=True)
               for g, w in zip(got, want))


# ----------------------------------------------------------------- labels
LABELS = ["b", "a", "c", "b", "a", "b", "d", None, "c", "a", "d", "b"]
FRESH = ["a", "e", None, "d", "zz", "b"]


@pytest.mark.parametrize("handle_invalid", ["keep", "skip", "error"])
def test_string_indexer_equals_the_reference(handle_invalid):
    """Labels by descending count, ties by the label's order (``a`` before
    ``d``... and ``b`` first); an unseen label kept, skipped or refused as
    the reference does."""
    from transmogrifai_tpu import types as JT
    from transmogrifai_tpu.dataset import Dataset as JDataset
    from transmogrifai_tpu.features import FeatureBuilder as JFB
    from transmogrifai_tpu.types.columns import TextColumn as JTextColumn
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.features import FeatureBuilder as PFB

    def fit(pkg):
        mod, ds_cls, col_cls, text, fb = (
            (JTS, JDataset, JTextColumn, JT.Text, JFB) if pkg == "jax" else
            (PTS, Dataset, TextColumn, Text, PFB))
        est = mod.OpStringIndexer(handle_invalid=handle_invalid)
        est.set_input(fb.Text("label").as_predictor())
        col = col_cls(text, np.asarray(LABELS, dtype=object))
        model = est.fit_model(ds_cls.of({"label": col}))
        fresh = col_cls(text, np.asarray(FRESH, dtype=object))
        return model, [model.transform_columns(c, num_rows=len(c.values))
                       for c in (col, fresh)], est

    if handle_invalid == "error":
        for pkg in ("jax", "port"):
            with pytest.raises(ValueError, match="Unseen label None"):
                fit(pkg)
        return
    jm, jout, jest = fit("jax")
    pm, pout, pest = fit("port")
    assert pm.labels == jm.labels == ["b", "a", "c", "d"]
    assert pest.metadata["labels"] == jest.metadata["labels"]
    for got, want in zip(pout, jout):
        assert np.array_equal(got.values, want.values)
        assert np.array_equal(got.mask, want.mask)
    params = json.loads(json.dumps(pm.get_params()))
    assert params == json.loads(json.dumps(jm.get_params()))
    again = PP.construct_stage("OpStringIndexerModel", params, {})
    fresh = TextColumn(Text, np.asarray(FRESH, dtype=object))
    assert np.array_equal(again.transform_columns(fresh, num_rows=6).values,
                          pout[1].values)


def test_index_to_string_equals_the_reference():
    from transmogrifai_tpu import types as JT
    from transmogrifai_tpu.types.columns import NumericColumn as JNumericColumn

    vals = np.asarray([0.0, 3.0, 1.0, 4.0, -1.0, 2.0, 0.0])
    mask = np.asarray([True, True, True, True, True, True, False])
    labels = ["b", "a", "c", "d"]
    got = PTS.OpIndexToString(labels).transform_columns(
        NumericColumn(RealNN, vals, mask), num_rows=7)
    want = JTS.OpIndexToString(labels).transform_columns(
        JNumericColumn(JT.RealNN, vals, mask), num_rows=7)
    assert list(got.values) == list(want.values) == [
        "b", "d", "a", "UnseenIndex", "UnseenIndex", "c", "UnseenIndex"]
    stage = PP.construct_stage("OpIndexToString", {"labels": labels,
                                                   "unseen": "?"}, {})
    assert stage.get_params() == {"labels": labels, "unseen": "?"}


def test_dsl_string_indexed_builds_the_indexer():
    import transmogrifai_tpu_torch.dsl  # noqa: F401
    from transmogrifai_tpu_torch.features import FeatureBuilder

    label = FeatureBuilder.PickList("species").as_response()
    indexed = label.string_indexed(handle_invalid="skip")
    assert indexed.ftype is RealNN
    assert isinstance(indexed.origin_stage, PTS.OpStringIndexer)
    assert indexed.origin_stage.handle_invalid == "skip"


# ------------------------------------------------------------ multinomial
def _small():
    rng = np.random.default_rng(21)
    x = rng.normal(size=(300, 6)).astype(np.float32)
    x[:, 4] = 3.0  # a constant column
    x[:, 5] = rng.random(300) < 0.2
    y = np.digitize(x[:, 0] + 0.7 * x[:, 1] + 0.4 * rng.normal(size=300),
                    [-0.6, 0.2, 0.9]).astype(np.float32)
    return x, y


MULTI_CASES = {
    "default": {},
    "elastic_net": dict(reg_param=0.05, elastic_net_param=0.5),
    "no_intercept": dict(fit_intercept=False, reg_param=0.01),
    "unstandardized": dict(standardization=False, reg_param=0.01),
    "unstandardized_no_intercept": dict(standardization=False,
                                        fit_intercept=False),
}


@pytest.mark.parametrize("case", sorted(MULTI_CASES))
def test_multinomial_fit_matches_the_reference(case):
    x, y = _small()
    mask = (np.arange(len(y)) % 4 != 0).astype(np.float32)
    params = dict(max_iter=25, **MULTI_CASES[case])
    pm = PL.LogisticRegression(**params, device="cpu").fit_arrays(x, y, mask)
    jm = JL.LogisticRegression(**params).fit_arrays(x, y, mask)
    assert pm.num_classes == jm.num_classes == 4
    assert pm.weights.shape == jm.weights.shape == (6, 4)
    got, want = pm.predict_arrays(x), jm.predict_arrays(x)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=MULTINOMIAL_PROB_TOL)
    assert (got[0] != want[0]).mean() < 0.01


def test_multinomial_sweep_lanes_match_the_reference():
    """Lanes over (mask, reg, elastic net), mask-major, one download; each
    lane within the tolerance of the reference's ``vmap`` lane and of the
    port's own single fit of the same mask and point."""
    x, y = _small()
    masks = [(np.arange(len(y)) % 3 != i).astype(np.float32) for i in range(3)]
    points = [dict(reg_param=r, elastic_net_param=e, max_iter=20)
              for r in (0.001, 0.1) for e in (0.1, 0.5)]
    est = PL.LogisticRegression(device="cpu")
    got = est.fit_arrays_batched_masks(x, y, masks, points)
    want = JL.LogisticRegression().fit_arrays_batched_masks(x, y, masks, points)
    worst = 0.0
    for mi, (grow, wrow) in enumerate(zip(got, want)):
        for j, (g, w) in enumerate(zip(grow, wrow)):
            d = np.abs(g.predict_arrays(x)[1] - w.predict_arrays(x)[1]).max()
            worst = max(worst, float(d))
            single = est.with_params(**points[j]).fit_arrays(x, y, masks[mi])
            np.testing.assert_allclose(single.predict_arrays(x)[1],
                                       g.predict_arrays(x)[1], rtol=0,
                                       atol=MULTINOMIAL_PROB_TOL)
    assert worst <= MULTINOMIAL_PROB_TOL


# --------------------------------------------------------- boosted models
def _jax_multi(kind: str):
    x, y = _small()
    mask = np.ones(len(y), np.float32)
    if kind == "boosted":
        return JG.XGBoostClassifier(num_round=12, max_depth=4).fit_arrays(x, y, mask), x
    return JG.RandomForestClassifier(num_trees=7, max_depth=5).fit_arrays(x, y, mask), x


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("kind", ["boosted", "forest"])
def test_multiclass_models_from_jax_arrays_score_equal(kind, route, monkeypatch):
    """The JAX package's fitted arrays loaded into the port score EQUAL on
    the host route (tree order) and on the device route (the cutoff
    lowered below the batch, which both packages read per call)."""
    jm, x = _jax_multi(kind)
    if route == "device":
        monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "64")
    cls = PG.BoostedMultiModel if kind == "boosted" else PG.ForestClassifierModel
    params = json.loads(json.dumps(jm.get_params()))
    arrays = {k: np.asarray(v) for k, v in jm.get_arrays().items()}
    pm = PP.construct_stage(type(jm).__name__, params, arrays)
    assert type(pm) is cls
    pm.to("cpu")
    for got, want in zip(pm.predict_arrays(x), jm.predict_arrays(x)):
        assert np.array_equal(got, want)
    # the saved arrays are the inverse of loading
    assert sorted(pm.get_arrays()) == sorted(arrays)
    for k, v in arrays.items():
        assert np.array_equal(pm.get_arrays()[k], v, equal_nan=v.dtype.kind == "f")


def test_boosted_multi_epilogue_normalises_sigmoids():
    margins = np.asarray([[0.0, 0.0, 0.0], [2.0, -1.0, 0.5], [-40.0, -45.0, -50.0]])
    thr = np.zeros((1, 1), np.float32)
    pred, prob, raw = PG.BoostedMultiModel(thr, [], 0.3, 0.0).predictions_from_core(
        margins)
    jpred, jprob, jraw = JG.BoostedMultiModel(thr, [], 0.3, 0.0).predictions_from_core(
        margins)
    assert np.array_equal(prob, jprob) and np.array_equal(pred, jpred)
    assert np.array_equal(raw, jraw)
    # a row whose sigmoids sum below the floor keeps their small values
    np.testing.assert_allclose(prob[:2].sum(axis=1), 1.0, rtol=1e-12)
    assert prob[2].sum() < 1e-3


# ------------------------------------------------------------ direct fits
@pytest.fixture(scope="module")
def trees_vector():
    record, arrays = _fixture("multiclass_trees")
    return arrays["x"], arrays["y"]


@pytest.fixture(scope="module")
def fits():
    return np.load(os.path.join(MF.FIXTURE, "fits.npz"))


@pytest.mark.parametrize("name", sorted(MF.DIRECT_FITS))
def test_direct_multiclass_fits_equal_the_fixture(name, trees_vector, fits):
    """Multiclass XGBoost, GBTClassifier and the decision tree: each class's
    stack EQUAL to the JAX package's (``fits.npz``)."""
    x, y = trees_vector
    family, params = MF.DIRECT_FITS[name]
    model = MF.estimator("port", family, **params).fit_arrays(
        x, y, MF.sweep_masks(len(y))[0])
    stacks = getattr(model, "trees_per_class", None) or model.forests_per_class
    assert len(stacks) == 4
    for k, t in enumerate(stacks):
        want = [fits[f"{name}__c{k}__{f}"] for f in t._fields]
        assert _tree_equal(t, want), (name, k)


def test_decision_tree_regressor_equals_the_fixture(trees_vector, fits):
    x, y = trees_vector
    model = PG.DecisionTreeRegressor(max_depth=5, device="cpu").fit_arrays(
        x, y, MF.sweep_masks(len(y))[0])
    assert _tree_equal(model.trees, [fits[f"dt_reg__{f}"] for f in model.trees._fields])
    assert model.trees.split_feat.shape[0] == 1


def test_rf_multiclass_sweep_equals_the_fixture(trees_vector, fits):
    """The forest's one-vs-rest sweep: one batched fit, lane
    ``(mask * n_points + point) * C + c``, its trees and [K * C, N]
    training outputs EQUAL lane for lane; each model reads its C lanes."""
    x, y = trees_vector
    masks = MF.sweep_masks(len(y))
    models = PG.RandomForestClassifier(device="cpu").fit_arrays_batched_masks(
        x, y, masks, MF.RF_SWEEP_POINTS)
    stack = models[0][0]._sweep_stack
    assert stack["k"] == len(masks) * len(MF.RF_SWEEP_POINTS) * 4
    assert _tree_equal(stack["trees"], [fits[f"rf_sweep__{f}"]
                                        for f in stack["trees"]._fields])
    assert np.array_equal(stack["outputs"], fits["rf_sweep__outputs"])
    for mi, row in enumerate(models):
        for j, m in enumerate(row):
            lanes = [(mi * len(row) + j) * 4 + c for c in range(4)]
            assert m._sweep_lanes == lanes
            for c, t in zip(lanes, m.forests_per_class):
                assert _tree_equal(t, [a[c] for a in stack["trees"]])
    # the sweep's metrics from the outputs equal predicting model by model
    folds = [(m > 0, m == 0) for m in masks]
    from transmogrifai_tpu_torch.evaluators import MultiClassificationEvaluator

    ev = MultiClassificationEvaluator()
    swept = PG.RandomForestClassifier(device="cpu").sweep_eval_batched(
        models, x, y, folds, ev)
    for gi in range(len(MF.RF_SWEEP_POINTS)):
        for fi, (_, val) in enumerate(folds):
            m = models[fi][gi]
            pred, prob, _ = m.predict_arrays(x[val])
            assert swept[gi][fi] == ev.metric_of(ev.evaluate_arrays(y[val], pred, prob))
    # detaching keeps the model's own trees and drops the stack
    m = models[1][1]
    m.detach_from_sweep()
    assert not hasattr(m, "_sweep_stack") and not hasattr(m, "_sweep_lanes")
    assert m.predict_arrays(x)[1].shape == (len(y), 4)


@pytest.mark.parametrize("labels", ["binary", "multiclass"])
def test_gbt_classifier_equals_the_reference(labels):
    """GBTClassifier's Spark knobs, synced by ``fit_arrays`` and mapped per
    point in the batched fit: trees EQUAL on binary and multiclass labels."""
    x, y = _small()
    if labels == "binary":
        y = (y >= 2).astype(np.float32)
    masks = [(np.arange(len(y)) % 3 != i).astype(np.float32) for i in range(2)]
    params = dict(max_iter=4, step_size=0.2, max_depth=3, min_instances_per_node=5)
    pm = PG.GBTClassifier(**params, device="cpu").fit_arrays(x, y, masks[0])
    jm = JG.GBTClassifier(**params).fit_arrays(x, y, masks[0])
    assert type(pm).__name__ == type(jm).__name__
    for got, want in zip(pm.predict_arrays(x), jm.predict_arrays(x)):
        assert np.array_equal(got, want)
    points = [dict(max_iter=3, step_size=s, max_depth=3, min_info_gain=0.0,
                   min_instances_per_node=5) for s in (0.1, 0.3)]
    pb = PG.GBTClassifier(device="cpu").fit_arrays_batched_masks(x, y, masks, points)
    jb = JG.GBTClassifier().fit_arrays_batched_masks(x, y, masks, points)
    for prow, jrow in zip(pb, jb):
        for p, j in zip(prow, jrow):
            for got, want in zip(p.predict_arrays(x), j.predict_arrays(x)):
                assert np.array_equal(got, want)
    assert PG.GBTClassifier().get_params() == JG.GBTClassifier().get_params()


@pytest.mark.parametrize("cls", ["DecisionTreeClassifier", "DecisionTreeRegressor"])
def test_decision_tree_params_mirror_the_constructor(cls):
    est = getattr(PG, cls)(max_depth=7, min_instances_per_node=3,
                           min_info_gain=0.02, max_bins=16, device="cpu")
    params = est.get_params()
    assert params == getattr(JG, cls)(max_depth=7, min_instances_per_node=3,
                                      min_info_gain=0.02, max_bins=16).get_params()
    again = getattr(PG, cls)(**params, device="cpu")
    assert again.get_params() == params
    assert est._fit_group_masks(None, None, None, None) is None


def test_data_cutter_on_multiclass_labels_equals_the_reference():
    rng = np.random.default_rng(4)
    y = rng.choice(6, size=500, p=[0.4, 0.25, 0.2, 0.1, 0.04, 0.01]).astype(float)
    for kw in ({}, dict(max_label_categories=3),
               dict(min_label_fraction=0.05)):
        got, want = DataCutter(**kw), JDataCutter(**kw)
        assert np.array_equal(got.prepare(y), want.prepare(y))
        assert got.labels_kept == want.labels_kept
        assert _same_json(got.summary.to_json(), want.summary.to_json())


def test_sanity_checker_on_the_multiclass_label_equals_the_reference():
    """The feature side of the flow (the indexed four-class label) in both
    packages: the SanityChecker's summary (its contingency statistics over
    the four classes, Cramer's V, the drop reasons) and keep-set EQUAL, its
    float64 moments within 1e-12."""
    schema, columns = MF.multiclass_table()
    got = {}
    for pkg in ("jax", "port"):
        m = MF.modules(pkg)
        if pkg == "jax":
            from transmogrifai_tpu.workflow.fit import fit_and_transform_dag
        else:
            from transmogrifai_tpu_torch.workflow.fit import fit_and_transform_dag
        m["uid"].reset()
        ds = MF.dataset(pkg, schema, columns)
        _, checked, _ = MF.feature_side(pkg, ds)
        _, fitted = fit_and_transform_dag(ds, [checked])
        got[pkg] = fitted[checked.origin_stage.uid].metadata["sanityCheckerSummary"]
    ps, js = got["port"], got["jax"]
    assert {k: v for k, v in ps.items() if k != "columns"} == {
        k: v for k, v in js.items() if k != "columns"}
    assert any(c["dropped"] for c in js["columns"])
    for jc, pc in zip(js["columns"], ps["columns"], strict=True):
        jc, pc = dict(jc), dict(pc)
        for key in ("mean", "variance", "corr_label"):
            assert pc.pop(key) == pytest.approx(jc.pop(key), abs=1e-12,
                                                nan_ok=True)
        assert _same_json(pc, jc)


# -------------------------------------------------------------- the flows
@pytest.fixture(scope="module")
def flows():
    """Both fixture flows trained by the port on the CPU."""
    schema, columns = MF.multiclass_table()
    out = {}
    for name, families in MF.FLOWS.items():
        ds = MF.dataset("port", schema, columns)
        model, pred, selector, label = MF.train("port", ds, families)
        out[name] = (ds, model, pred, selector)
    return out


@pytest.mark.parametrize("name", sorted(MF.FLOWS))
def test_flow_candidates_and_winner_match_the_fixture(name, flows):
    """Every tree candidate's CV metrics EQUAL, logistic ones within
    ``LR_METRIC_TOL``; uids, grids, winner, candidate attempts, splitter
    summary and train / holdout evaluations EQUAL."""
    record, _ = _fixture(name)
    _, model, _, _ = flows[name]
    got = MF.without_unported(model.summary_json()["modelSelectorSummary"])
    want = MF.without_unported(record["summary"])
    assert set(got) == set(want)
    gr, wr = got["validationResults"], want["validationResults"]
    assert [(r["modelName"], r["modelUID"], r["grid"]) for r in gr] == [
        (r["modelName"], r["modelUID"], r["grid"]) for r in wr]
    for g, w in zip(gr, wr):
        if g["modelName"] == "LogisticRegression":
            np.testing.assert_allclose(g["metricValues"], w["metricValues"],
                                       rtol=0, atol=MF.LR_METRIC_TOL)
        else:
            assert g["metricValues"] == w["metricValues"], g["modelName"]
    for key in got:
        if key != "validationResults":
            assert _same_json(got[key], want[key]), key


@pytest.mark.parametrize("name", sorted(MF.FLOWS))
def test_flow_labels_and_vector_match_the_fixture(name, flows):
    record, arrays = _fixture(name)
    ds, model, _, selector = flows[name]
    labels = next(s.labels for s in model.fitted.values()
                  if isinstance(s, PTS.OpStringIndexerModel))
    assert labels == record["labels"]
    data = model.score(ds, keep_intermediate_features=True)
    info = model.selector_info
    vec = data[info["vectorName"]]
    assert vec.metadata.column_names() == record["vector_columns"]
    assert np.array_equal(np.asarray(vec.values, np.float32), arrays["x"])
    assert np.array_equal(np.asarray(data[info["labelName"]].values, np.float32),
                          arrays["y"])
    assert (model.train_rows, model.holdout_rows) == (record["train_rows"],
                                                      record["holdout_rows"])


@pytest.mark.parametrize("name", sorted(MF.FLOWS))
def test_flow_holdout_scores_save_load_and_fused(name, flows, monkeypatch):
    """The holdout's scores against the JAX package's (a tree winner's
    EQUAL, a logistic one's within ``MULTINOMIAL_PROB_TOL``), a save and
    load round trip, ``score_function`` staged, and fused above a lowered
    cutoff (EQUAL to staged for a tree winner, within 1e-6 for a logistic
    one), with C probability columns; the predictions map back to labels."""
    record, arrays = _fixture(name)
    ds, model, pred, _ = flows[name]
    holdout = ds.take(np.asarray(record["holdout_idx"]))
    col = model.score(holdout)[pred.name]
    glm = record["summary"]["bestModelType"] == "LogisticRegression"
    tol = MULTINOMIAL_PROB_TOL if glm else 0.0
    np.testing.assert_allclose(col.probability, arrays["probability"], rtol=0,
                               atol=tol)
    if not glm:
        assert np.array_equal(col.prediction, arrays["prediction"])
        assert np.array_equal(col.raw, arrays["raw"])
    with tempfile.TemporaryDirectory() as tmp:
        model.save(os.path.join(tmp, "m"))
        loaded = load_workflow_model(os.path.join(tmp, "m"), device="cpu")
    again = loaded.score(holdout)[pred.name]
    assert np.array_equal(again.probability, col.probability)
    rows = ds.take(np.arange(MF.FUSED_ROWS)).rows()
    staged_fn = score_function(loaded, device="cpu")
    staged = staged_fn.batch(rows)
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", str(MF.FUSED_ROWS // 2))
    fused_fn = score_function(loaded, device="cpu")
    fused = fused_fn.batch(rows)
    md = fused_fn.metadata()["fused"]
    assert md["dispatches"] == 1, md
    name_ = pred.name
    keys = [f"probability_{k}" for k in range(4)]
    assert all(k in staged[0][name_] for k in keys)
    s = np.asarray([[r[name_][k] for k in keys] for r in staged])
    f = np.asarray([[r[name_][k] for k in keys] for r in fused])
    np.testing.assert_allclose(f, s, rtol=0, atol=FUSED_GLM_ATOL if glm else 0.0)
    # the indices back to the labels
    labels = next(st.labels for st in loaded.fitted.values()
                  if isinstance(st, PTS.OpStringIndexerModel))
    idx = PTS.OpIndexToString(labels).transform_columns(
        NumericColumn(RealNN, col.prediction, np.ones(len(col.prediction), bool)),
        num_rows=len(col.prediction))
    assert set(idx.values) <= set(MF.CLASSES)


@pytest.mark.parametrize("route", ["staged", "fused"])
def test_jax_saved_model_scores_equal_the_fixture(route, monkeypatch):
    """The JAX package's saved multiclass-trees model (a one-vs-rest
    boosted winner), loaded by the port: its scores of ``FUSED_ROWS`` rows
    EQUAL the JAX package's, staged (host route) and fused (one program
    over every class stack; the JAX package's fused program at 256 rows)."""
    schema, columns = MF.multiclass_table()
    ds = MF.dataset("port", schema, columns)
    rows = ds.take(np.arange(MF.FUSED_ROWS)).rows()
    want = np.load(os.path.join(MF.FIXTURE, "scores.npz"))
    if route == "fused":
        monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", str(MF.FUSED_ROWS // 2))
    model = load_workflow_model(os.path.join(MF.FIXTURE, "model"), device="cpu")
    fn = score_function(model, device="cpu")
    out = fn.batch(rows)
    assert fn.metadata()["fused"]["dispatches"] == (route == "fused")
    record, _ = _fixture("multiclass_trees")
    name = record["pred_name"]
    for key, fmt in (("probability", "probability_{}"), ("raw", "rawPrediction_{}")):
        got = np.asarray([[r[name][fmt.format(k)] for k in range(4)] for r in out])
        assert np.array_equal(got, want[f"{route}_{key}"]), key
    assert np.array_equal([r[name]["prediction"] for r in out],
                          want[f"{route}_prediction"])


def test_default_multiclass_selector_trains_its_candidates():
    """``MultiClassificationModelSelector()``'s default candidates are the
    reference's (LR + RF at the default grids, DataCutter, weighted F1);
    the same estimators train through ``train()`` at small grids."""
    sel = PMS.MultiClassificationModelSelector(device="cpu")
    jsel = JMS.MultiClassificationModelSelector()
    assert [type(e).__name__ for e, _ in sel.models] == [
        type(e).__name__ for e, _ in jsel.models]
    assert [g for _, g in sel.models] == [g for _, g in jsel.models]
    assert [len(PV.expand_grid(g)) for _, g in sel.models] == [8, 18]
    assert type(sel.splitter).__name__ == "DataCutter"
    assert all(e.device == "cpu" for e, _ in sel.models)
    schema, columns = MF.multiclass_table(300, 3)
    ds = MF.dataset("port", schema, columns)
    wf, pred, selector, _ = MF.build("port", ds, None)
    selector.models = [(e, MF.GRIDS["lr" if isinstance(e, PL.LogisticRegression)
                                   else "rf"]) for e, _ in selector.models]
    model = wf.train()
    summary = model.summary_json()["modelSelectorSummary"]
    assert not any(a["excluded"] for a in summary["candidateAttempts"])
    assert {r["modelName"] for r in summary["validationResults"]} == {
        "LogisticRegression", "RandomForestClassifier"}
    scores = model.score(ds)[pred.name]
    assert np.asarray(scores.probability).shape == (300, 4)


def test_make_candidates_covers_every_ported_multiclass_name():
    ported = [n for n, c in PMS.MULTI_CLASSIFICATION_MODELS.items() if c is not None]
    assert ported == ["OpLogisticRegression", "OpRandomForestClassifier",
                      "OpXGBoostClassifier", "OpDecisionTreeClassifier",
                      "OpNaiveBayes", "OpMultilayerPerceptronClassifier"]
    cands = PMS.make_candidates("MultiClassification", ported, device="cpu")
    want = JMS.make_candidates("MultiClassification", ported)
    assert [(type(e).__name__, g) for e, g in cands] == [
        (type(e).__name__, g) for e, g in want]
    for catalog in ("BINARY_CLASSIFICATION_MODELS", "REGRESSION_MODELS"):
        for name, cls in getattr(PMS, catalog).items():
            jcls = getattr(JMS, catalog)[name]
            assert cls is None or cls.__name__ == jcls.__name__
            if cls is not None:
                assert PMS._default_grid_for(cls) == JMS._default_grid_for(jcls)
    # every family of the reference's enums is ported
    for catalog in ("BINARY_CLASSIFICATION_MODELS",
                    "MULTI_CLASSIFICATION_MODELS", "REGRESSION_MODELS"):
        assert None not in getattr(PMS, catalog).values()


def test_multiclass_on_the_card():
    """The fixture's multiclass fits and the forest sweep on the card equal
    the JAX package's (every kernel of the fit on its card route)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    record, arrays = _fixture("multiclass_trees")
    fits_ = np.load(os.path.join(MF.FIXTURE, "fits.npz"))
    x, y = arrays["x"], arrays["y"]
    masks = MF.sweep_masks(len(y))
    for name, (family, params) in MF.DIRECT_FITS.items():
        model = MF.estimator("port", family, device=None, **params).fit_arrays(
            x, y, masks[0])
        stacks = getattr(model, "trees_per_class", None) or model.forests_per_class
        for k, t in enumerate(stacks):
            assert _tree_equal(t, [fits_[f"{name}__c{k}__{f}"] for f in t._fields])
    models = PG.RandomForestClassifier().fit_arrays_batched_masks(
        x, y, masks, MF.RF_SWEEP_POINTS)
    assert np.array_equal(models[0][0]._sweep_stack["outputs"],
                          fits_["rf_sweep__outputs"])
