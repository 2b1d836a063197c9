"""The port's insights plane (``transmogrifai_tpu_torch.insights``) against
the JAX package's: LOCO column groups, the batched sweep, top-k maps and
the ``RecordInsightsLOCO`` stage, correlation insights, model insights,
attribution drift and the train-time baseline, and ``summary_pretty``'s
insights lines. The same numpy-seeded inputs go through both, on the CPU.

Tolerances: LOCO over trees EQUAL (the staged cores are the bit-identical
tree sums); over a GLM within ``GLM_ATOL`` = 1e-6 (measured 2.2e-16: both
staged cores are float64 over the same coefficients); correlation
insights, contributions and drift reports EQUAL (numpy in both).

The tree case above 16384 lane rows (``test_loco_over_trees_at_lane_rows
_above_the_cutoff``) holds the device route's summation order at row
counts that are not powers of two, depth 6, two and four tree windows
(``ROADMAP.md`` B20).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "torch_fixtures"))

import insights_flow as I  # noqa: E402

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

GLM_ATOL = I.GLM_ATOL

JAX, PORT = I.package("jax"), I.package("port")


def _both():
    return (JAX, PORT)


def _lr_model(P, d=6, seed=11):
    """A fitted binary logistic model with fixed seeded coefficients, the
    same in both packages."""
    rng = np.random.default_rng(seed)
    m = P.logistic.LogisticRegressionModel(rng.normal(size=d), 0.3, 2)
    if P.name == "port":
        m.to("cpu")
    return m


def _lr_case():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(64, 6)).astype(np.float32)
    x[:, 4] = 0.0          # an all-zero column: the dedup lane
    x[5] = 0.0             # an all-zero row
    x[-1] = 0.0
    return x


def _text_hash_meta(P, n_hash=4):
    CM = P.metadata.ColumnMeta
    cols = [CM(parent_names=("désc_ünïcode",), parent_type="Text",
               grouping="désc_ünïcode", descriptor_value=f"hash_{i}", index=i)
            for i in range(n_hash)]
    cols.append(CM(parent_names=("age",), parent_type="Real", index=n_hash))
    cols.append(CM(parent_names=("when",), parent_type="Date",
                   descriptor_value="DayOfWeek", index=n_hash + 1))
    return P.metadata.VectorMetadata("vec", tuple(cols))


# ----------------------------------------------------------------- groups
def test_column_groups_equal_the_reference():
    got = {P.name: P.loco.column_groups(_text_hash_meta(P), 6) for P in _both()}
    assert got["port"] == got["jax"]
    assert dict(got["port"])["désc_ünïcode(text)"] == [0, 1, 2, 3]


def test_column_groups_meta_fallback_counts_on_the_ledger():
    for P in _both():
        before = P.ledger.snapshot()["metaFallbacks"]
        groups = P.loco.column_groups(None, 3)
        assert [n for n, _ in groups] == ["col_0", "col_1", "col_2"]
        P.loco.column_groups(_text_hash_meta(P), 99)
        assert P.ledger.snapshot()["metaFallbacks"] == before + 2


# ------------------------------------------------------------------ sweeps
def test_explain_batch_over_a_glm_matches_the_reference():
    x = _lr_case()
    out = {}
    for P in _both():
        groups = P.loco.column_groups(None, 6, count_fallback=False)
        out[P.name] = P.loco.explain_batch(_lr_model(P), x, groups)
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=0,
                               atol=GLM_ATOL)
    assert out["port"][1] == out["jax"][1]
    assert out["port"][1]["deduped"] >= 1
    assert np.all(out["port"][0][:, 4] == 0.0)
    assert np.all(out["port"][0][5] == 0.0)


def test_explain_batch_equals_the_per_group_loop():
    x = _lr_case()
    groups = PORT.loco.column_groups(None, 6, count_fallback=False)
    model = _lr_model(PORT)
    batched, _ = PORT.loco.explain_batch(model, x, groups)
    np.testing.assert_allclose(batched, PORT.loco.reference_loop(model, x, groups),
                               rtol=1e-6, atol=1e-9)
    one, _ = PORT.loco.explain_batch(model, x[:1], groups)
    np.testing.assert_allclose(one, PORT.loco.reference_loop(model, x[:1], groups),
                               rtol=1e-6, atol=1e-9)


def test_lane_chunking_matches_monolithic(monkeypatch):
    x = _lr_case()
    groups = PORT.loco.column_groups(None, 6, count_fallback=False)
    model = _lr_model(PORT)
    whole, _ = PORT.loco.explain_batch(model, x, groups)
    monkeypatch.setenv("TPTPU_EXPLAIN_LANE_BUDGET", str(x.size))
    chunked, info = PORT.loco.explain_batch(model, x, groups)
    np.testing.assert_array_equal(chunked, whole)
    assert info["dispatches"] > 1


def test_floor_lane_bucket_equals_the_reference():
    from transmogrifai_tpu.insights.loco import _floor_lane_bucket as jf
    from transmogrifai_tpu_torch.compiler.bucketing import lane_bucket
    from transmogrifai_tpu_torch.insights.loco import _floor_lane_bucket as pf

    for k in (1, 2, 3, 5, 17, 33, 63, 64, 65, 95, 96, 200):
        b = pf(k)
        assert b == jf(k) and 1 <= b <= k and lane_bucket(b) == b


def test_regression_model_tracks_the_prediction():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 4)).astype(np.float32)
    out = {}
    for P in _both():
        m = P.linear.LinearRegressionModel(np.array([2.0, 0.1, -1.0, 0.3]), 0.5)
        if P.name == "port":
            m.to("cpu")
        groups = P.loco.column_groups(None, 4, count_fallback=False)
        out[P.name] = P.loco.explain_batch(m, x, groups)[0]
    np.testing.assert_allclose(out["port"], out["jax"], rtol=0, atol=GLM_ATOL)


@pytest.mark.parametrize("strategy", ["abs", "positive_negative"])
@pytest.mark.parametrize("k", [1, 3, 10])
def test_top_k_maps_equal_the_reference(strategy, k):
    rng = np.random.default_rng(k)
    diffs = rng.normal(size=(30, 6))
    diffs[3] = 0.0
    names = [f"g{j}" for j in range(6)]
    got = PORT.loco.top_k_maps(diffs, names, k, strategy)
    want = JAX.loco.top_k_maps(diffs, names, k, strategy)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("name", ["xgb", "rf", "lr"])
def test_loco_over_the_serving_fixtures(name, monkeypatch):
    """A fixture model's staged sweep: trees EQUAL, logistic within
    1e-6. The cutoff lowered below the lanes' rows sends the lanes through
    the device route in both packages."""
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "512")
    out = {}
    for P in _both():
        model = P.load(I.model_path(name))
        sel = model.fitted[model.selector_info["estimatorUid"]]
        x = np.asarray(model.score(
            _fixture_ds(P, name, 75), keep_intermediate_features=True,
        )[model.selector_info["vectorName"]].values, dtype=np.float32)
        groups = P.loco.column_groups(None, x.shape[1], count_fallback=False)
        out[P.name] = P.loco.explain_batch(sel, x, groups)
    atol = 0.0 if name in I.TREES else GLM_ATOL
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=0, atol=atol)
    assert out["port"][1] == out["jax"][1]


def _fixture_ds(P, name, n):
    """A Dataset of the first ``n`` fixture rows."""
    model = P.load(I.model_path(name))
    rows = I.fixture_rows(name, n)
    cols = {}
    for f in model.raw_features:
        vals = [r.get(f.name) for r in rows]
        if f.is_response:
            vals = [0.0 if v is None else v for v in vals]
        cols[f.name] = P.columns.column_from_values(f.ftype, vals)
    return P.Dataset.of(cols)


@pytest.mark.parametrize("trees", [40, 100], ids=["2-windows", "4-windows"])
def test_loco_over_trees_at_lane_rows_above_the_cutoff(trees):
    """8 lanes of 2500 rows score 20000 rows: the device route at a row
    count that is not a power of two, depth 6, 2 or 4 tree windows. EQUAL
    to the reference, boosted and forest."""
    out = {}
    for P in _both():
        x, models = I.depth6_models(P, trees)
        groups = P.loco.column_groups(None, x.shape[1], count_fallback=False)
        out[P.name] = [P.loco.explain_batch(m, x, groups) for m in models]
    for (gd, gi), (wd, wi) in zip(out["port"], out["jax"]):
        assert gi == wi and gi["lanes"] == 8
        np.testing.assert_array_equal(gd, wd)


# ------------------------------------------------------- the LOCO stage
def _builder(P):
    base = {"jax": "transmogrifai_tpu", "port": "transmogrifai_tpu_torch"}[P.name]
    return __import__(f"{base}.features", fromlist=["x"]).FeatureBuilder


def _loco_stage(P, x, top_k=3, strategy="abs"):
    vecf = _builder(P).OPVector("vec").as_predictor()
    loco = P.loco.RecordInsightsLOCO(_lr_model(P), top_k=top_k,
                                     strategy=strategy).set_input(vecf)
    ds = P.Dataset.of({"vec": P.columns.VectorColumn(P.T.OPVector, x)})
    return loco, loco.transform(ds)[loco.output_name].to_list()


@pytest.mark.parametrize("top_k,strategy", [(3, "abs"), (50, "abs"),
                                            (2, "positive_negative")])
def test_record_insights_loco_matches_the_reference(top_k, strategy):
    x = _lr_case()
    got = _loco_stage(PORT, x, top_k, strategy)[1]
    want = _loco_stage(JAX, x, top_k, strategy)[1]
    I.same_attributions(got, want, GLM_ATOL)


def test_record_insights_loco_saves_and_loads_across_packages(tmp_path):
    from transmogrifai_tpu.workflow import persistence as JP
    from transmogrifai_tpu_torch.workflow import persistence as PP

    x = _lr_case()
    stage, _ = _loco_stage(JAX, x)
    params = json.loads(json.dumps(stage.get_params(), default=JP._json_default))
    arrays = {k: np.asarray(v) for k, v in stage.get_arrays().items()}
    again = PP.construct_stage("RecordInsightsLOCO", params, arrays)
    again.to("cpu")
    assert again.get_params() == params
    groups = PORT.loco.column_groups(None, 6, count_fallback=False)
    np.testing.assert_allclose(
        PORT.loco.explain_batch(again.model, x, groups)[0],
        JAX.loco.explain_batch(stage.model, x, groups)[0], rtol=0, atol=GLM_ATOL)


# ------------------------------------------------------------ correlation
@pytest.mark.parametrize("norm", ["minmax", "zscore", "none"])
@pytest.mark.parametrize("corr", ["pearson", "spearman"])
@pytest.mark.parametrize("pred_kind", ["prediction", "vector"])
def test_record_insights_corr_equals_the_reference(norm, corr, pred_kind):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(50, 5)).astype(np.float32)
    x[:, 3] = 1.0  # a constant column
    prob = rng.random((50, 1))
    out = {}
    for P in _both():
        fb = _builder(P)
        cols = P.columns
        if pred_kind == "prediction":
            pf = fb.Prediction("pred").as_predictor()
            pcol = cols.PredictionColumn(
                P.T.Prediction, (prob[:, 0] > 0.5).astype(float),
                np.hstack([1 - prob, prob]), None)
        else:
            pf = fb.OPVector("pred").as_predictor()
            pcol = cols.VectorColumn(P.T.OPVector, prob.astype(np.float32))
        vf = fb.OPVector("vec").as_predictor()
        est = P.insights.RecordInsightsCorr(top_k=3, norm_type=norm,
                                            correlation_type=corr)
        est.set_input(pf, vf)
        ds = P.Dataset.of({"pred": pcol,
                           "vec": cols.VectorColumn(P.T.OPVector, x)})
        model = est.fit(ds)
        out[P.name] = (model.transform(ds)[est.output_name].to_list(),
                       model.get_arrays(), model.get_params(),
                       est.metadata["numPredCols"])
    assert out["port"][0] == out["jax"][0]
    for k in out["jax"][1]:
        np.testing.assert_array_equal(out["port"][1][k], out["jax"][1][k])
    assert out["port"][2:] == out["jax"][2:]


# -------------------------------------------------------- model insights
@pytest.mark.parametrize("name", ["xgb", "rf", "lr"])
def test_model_insights_equal_the_reference(name):
    docs = {}
    for P in _both():
        model = P.load(I.model_path(name))
        docs[P.name] = json.loads(json.dumps(
            P.model_insights.model_insights(model), default=str, sort_keys=True))
    for doc in docs.values():
        for info in doc["stageInfo"].values():
            info.pop("params", None)   # each package's stage params
        doc.pop("selectedModelInfo", None)
    assert docs["port"] == docs["jax"]


def test_feature_contributions_cover_every_family():
    from transmogrifai_tpu.models import mlp as JM
    from transmogrifai_tpu_torch.models import mlp as PM

    rng = np.random.default_rng(0)
    layers = [{"w": rng.normal(size=(5, 4)).astype(np.float32),
               "b": np.zeros(4, np.float32)},
              {"w": rng.normal(size=(4, 2)).astype(np.float32),
               "b": np.zeros(2, np.float32)}]
    got = PORT.model_insights.feature_contributions(PM.MLPClassifierModel(layers, 2), 5)
    want = JAX.model_insights.feature_contributions(JM.MLPClassifierModel(layers, 2), 5)
    np.testing.assert_array_equal(got, want)
    for P in _both():
        np.testing.assert_array_equal(
            P.model_insights.feature_contributions(_lr_model(P), 6),
            np.abs(_lr_model(P).weights))


# ---------------------------------------------------------------- drift
def _profile_from(P, diffs, names):
    from transmogrifai_tpu_torch.utils.streaming_histogram import (
        histogram_from_values,
    )

    return {"rows": len(diffs), "groups": {
        name: {"count": len(diffs),
               "meanAbs": float(np.abs(diffs[:, g]).mean()),
               "histogram": histogram_from_values(diffs[:, g], 32).to_json()}
        for g, name in enumerate(names)}}


@pytest.mark.parametrize("case", ["matching", "shifted", "torn"])
def test_attribution_drift_reports_equal_the_reference(case):
    rng = np.random.default_rng({"matching": 0, "shifted": 1, "torn": 2}[case])
    base = rng.normal(0.0, 0.05, size=(400, 2))
    if case == "shifted":
        live = np.column_stack([rng.normal(5.0, 0.05, 200),
                                rng.normal(0.0, 0.05, 200)])
    else:
        live = rng.normal(0.0, 0.05, size=(200, 2))
    reports = {}
    for P in _both():
        profile = _profile_from(P, base, ["a", "b"])
        if case == "torn":
            profile["groups"]["b"]["histogram"] = {"torn": True}
        P.events.reset_for_tests()
        before = P.ledger.snapshot()["attributionDriftAlerts"]
        mon = P.drift.AttributionDriftMonitor(profile)
        mon.observe(["a", "b"], live)
        first = mon.report()
        again = mon.report()
        events = [e for e in P.events.recent() if e["kind"] == "attribution_drift"]
        reports[P.name] = (first, again, mon.torn,
                           P.ledger.snapshot()["attributionDriftAlerts"] - before,
                           [(e["group"], e["jsDivergence"]) for e in events])
    assert reports["port"] == reports["jax"]
    if case == "shifted":
        assert reports["port"][0]["alerts"] == ["a"]
        assert reports["port"][3] == 1


@pytest.mark.parametrize("name", ["xgb", "lr"])
def test_attribution_profile_equals_the_reference(name):
    out = {}
    for P in _both():
        model = P.load(I.model_path(name))
        sel = model.fitted[model.selector_info["estimatorUid"]]
        scored = model.score(_fixture_ds(P, name, 300),
                             keep_intermediate_features=True)
        vec = scored[model.selector_info["vectorName"]]
        out[P.name] = P.drift.compute_attribution_profile(
            sel, np.asarray(vec.values, np.float32), vec.metadata, max_rows=64)
    if name in I.TREES:
        assert out["port"] == out["jax"]
    else:
        assert out["port"]["rows"] == out["jax"]["rows"] == 64
        assert list(out["port"]["groups"]) == list(out["jax"]["groups"])
        for g, cell in out["jax"]["groups"].items():
            assert abs(out["port"]["groups"][g]["meanAbs"] - cell["meanAbs"]) <= GLM_ATOL


def test_train_captures_the_baseline_and_the_manifest_carries_it(tmp_path):
    """The port's train() captures the profile as the reference's does
    (the same groups over the same training rows); it survives the port's save
    and the JAX package's load, and the JAX package's save and the port's
    load."""
    from transmogrifai_tpu.workflow.persistence import load_workflow_model as jload
    from transmogrifai_tpu_torch.workflow.persistence import (
        load_workflow_model as pload,
    )

    pm = I.train_mixed(PORT)
    jm = I.train_mixed(JAX)
    assert pm.attribution_profiles["rows"] == jm.attribution_profiles["rows"]
    assert pm.attribution_profiles["rows"] == pm.train_rows
    assert list(pm.attribution_profiles["groups"]) == \
        list(jm.attribution_profiles["groups"])
    assert pm.attribution_seconds is not None and pm.attribution_seconds > 0
    pm.save(str(tmp_path / "port"))
    assert jload(str(tmp_path / "port")).attribution_profiles == \
        json.loads(json.dumps(pm.attribution_profiles))
    jm.save(str(tmp_path / "jax"))
    assert pload(str(tmp_path / "jax"), device="cpu").attribution_profiles == \
        json.loads(json.dumps(jm.attribution_profiles))


def test_train_baseline_disabled_by_env(monkeypatch):
    monkeypatch.setenv("TPTPU_ATTRIBUTION_PROFILE_ROWS", "0")
    assert I.train_mixed(PORT).attribution_profiles is None


def test_a_kernel_fault_in_the_train_baseline_propagates(monkeypatch):
    """The reference drops any failure of the baseline; the port drops
    every one but a kernel fault, which fails train()."""
    from transmogrifai_tpu_torch.insights import drift as pdrift
    from transmogrifai_tpu_torch.utils.cuda_build import KernelLaunchError

    def boom(*a, **kw):
        raise KernelLaunchError("serve_trees: launch failed")

    monkeypatch.setattr(pdrift, "compute_attribution_profile", boom)
    with pytest.raises(KernelLaunchError):
        I.train_mixed(PORT)

    def other(*a, **kw):
        raise MemoryError("lane plane")

    monkeypatch.setattr(pdrift, "compute_attribution_profile", other)
    assert I.train_mixed(PORT).attribution_profiles is None


# ------------------------------------------------------------ the summary
#: the lines that follow the insights tables (the reference's compile and
#: featurize plane lines among them)
_AFTER_INSIGHTS = ("Compile plane", "Featurize plane", "Record insights",
                   "Trained on")


def _insights_block(text: str) -> list[str]:
    lines = text.splitlines()
    start = lines.index("Top model insights computed using correlation:")
    end = start
    while not lines[end].startswith(_AFTER_INSIGHTS):
        end += 1
    return lines[start:end]


@pytest.mark.parametrize("name", ["xgb", "rf", "lr"])
def test_summary_pretty_insights_lines_equal_the_reference(name):
    texts = {}
    for P in _both():
        P.ledger.stats().reset()
        model = P.load(I.model_path(name))
        fn = P.score(model)
        fn.batch(I.fixture_rows(name, 4), explain=2)
        texts[P.name] = model.summary_pretty()
    assert _insights_block(texts["port"]) == _insights_block(texts["jax"])
    line = {k: next(ln for ln in t.splitlines() if ln.startswith("Record insights"))
            for k, t in texts.items()}
    strip = [ln.split(" @ ")[0] + ln[ln.index(" rows/s") + 7:]
             if " @ " in ln else ln for ln in (line["port"], line["jax"])]
    assert strip[0] == strip[1]
