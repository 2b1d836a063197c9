"""The RawFeatureFilter: the port's ``prep/raw_feature_filter.py`` and its
wiring into ``Workflow.train()`` against the JAX package's on the CPU.

* The cases of the JAX package's ``tests/test_raw_feature_filter.py`` and
  ``tests/test_bad_feature_zoo.py::TestRawFeatureFilterZoo`` (low fill,
  train / score drift, null-to-label leakage), and more (text, set, list
  and map distributions, unlabeled rows, protected features), run in both
  packages over the same seeded columns: the exclusions and the results
  JSON EQUAL. The port hashes each distinct text token once; its
  histograms hold the same integers.
* ``Workflow.with_raw_feature_filter``: the blocklist rewrite with its
  cascade (a fixed-arity stage fed by a blocklisted feature dies and its
  output is blocklisted; variable-arity stages shrink; a result feature
  left with nothing raises), the filter under ``with_workflow_cv()`` (run
  once, before the folds), ``rffResults`` through save and load in both
  directions, and the summary fields: EQUAL the JAX package's.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "torch_fixtures"))

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

N = 400


def _mods(pkg: str):
    import importlib

    root = "transmogrifai_tpu" if pkg == "jax" else "transmogrifai_tpu_torch"
    return {name: importlib.import_module(f"{root}.{name}") for name in (
        "types", "types.columns", "dataset", "features",
        "prep.raw_feature_filter", "models.gbdt", "selector", "utils.uid",
        "workflow.workflow", "workflow.persistence")}


def _dump(obj) -> str:
    return json.dumps(obj, sort_keys=True)


def _col(pkg: str, type_name: str, values, mask=None):
    M = _mods(pkg)
    T, C = M["types"], M["types.columns"]
    if mask is not None:
        return C.NumericColumn(getattr(T, type_name),
                               np.asarray(values, np.float64), mask)
    return C.column_from_values(getattr(T, type_name), values)


WORDS = ("alpha", "Beta", "gamma-ray", "delta", "eps", "zeta!", "Eta", "theta")


def table(seed: int, n: int = N, shift: float = 0.0, labeled: float = 1.0):
    """Seeded columns (type name, values, mask or None) of every kind the
    filter bins: numeric, text, pick list, set, list and map."""
    rng = np.random.default_rng(seed)
    y = (rng.random(n) > 0.5).astype(np.float64)
    label_mask = rng.random(n) < labeled
    words = np.asarray(WORDS, dtype=object)

    def text(p_empty):
        return [None if rng.random() < p_empty else
                " ".join(words[rng.integers(0, 8, 2)]) for _ in range(n)]

    return {
        "label": ("RealNN" if labeled == 1.0 else "Real", y, label_mask),
        "good": ("Real", rng.normal(shift, 1.0, n), np.ones(n, bool)),
        "count": ("Integral", rng.integers(0, 9, n).astype(float),
                  rng.random(n) > 0.1),
        "sparse": ("Real", rng.normal(size=n), np.arange(n) < 2),
        "drifty": ("Real", rng.normal(0.0 + 25.0 * (shift != 0), 1.0, n),
                   np.ones(n, bool)),
        "leaky": ("Real", rng.normal(size=n), y < 0.5),
        "text": ("Text", text(0.2), None),
        "pick": ("PickList", [None if rng.random() < 0.1 else
                              str(words[rng.integers(0, 3 + int(shift))])
                              for _ in range(n)], None),
        "tags": ("MultiPickList", [set(words[rng.integers(0, 8, rng.integers(0, 3))])
                                   for _ in range(n)], None),
        "tokens": ("TextList", [list(words[rng.integers(0, 8, rng.integers(0, 4))])
                                for _ in range(n)], None),
        "amounts": ("RealMap", [{k: float(np.round(rng.normal(shift), 3))
                                 for k in ("a", "b", "c") if rng.random() > 0.3}
                                for _ in range(n)], None),
        "notes": ("TextMap", [{k: str(words[rng.integers(0, 8)])
                               for k in ("x", "y") if rng.random() > 0.4}
                              for _ in range(n)], None),
    }


def dataset(pkg: str, cols: dict, names=None):
    M = _mods(pkg)
    names = names or list(cols)
    return M["dataset"].Dataset.of({
        k: _col(pkg, *cols[k]) for k in names})


def features(pkg: str, ds, cols: dict):
    """(response, predictors) of ``pkg`` over ``ds``'s columns, typed as
    ``cols`` (the label may have unlabeled rows)."""
    M = _mods(pkg)
    M["utils.uid"].reset()
    FB = M["features"].FeatureBuilder
    resp = getattr(FB, cols["label"][0])("label").as_response()
    return resp, [getattr(FB, cols[k][0])(k).as_predictor()
                  for k in ds.columns if k != "label"]


# ------------------------------------------------- distributions, EQUAL
@pytest.mark.parametrize("name", [k for k in table(0) if k != "label"])
def test_distribution_equals_the_reference(name):
    train, score = table(1), table(2, shift=1.0)
    out = {}
    for pkg in ("jax", "port"):
        rff = _mods(pkg)["prep.raw_feature_filter"]
        col = _col(pkg, *train[name])
        d = rff.compute_distribution(name, col)
        rng = ((d.summary["min"], d.summary["max"])
               if "min" in d.summary else None)
        s = rff.compute_distribution(name, _col(pkg, *score[name]),
                                     numeric_range=rng)
        out[pkg] = (d, s)
    (jd, js), (pd, ps) = out["jax"], out["port"]
    for got, want in ((pd, jd), (ps, js)):
        assert (got.name, got.count, got.nulls) == (want.name, want.count,
                                                    want.nulls)
        assert got.distribution.dtype == want.distribution.dtype
        np.testing.assert_array_equal(got.distribution, want.distribution)
        assert _dump(got.summary) == _dump(want.summary)
        assert got.fill_rate == want.fill_rate
    assert pd.js_divergence(ps) == jd.js_divergence(js)
    assert pd.relative_fill_ratio(ps) == jd.relative_fill_ratio(js)


# --------------------------------------------------- exclusions, EQUAL
#: (id, filter params, score rows?, predictor names, labeled share)
CASES = [
    ("low_fill", {"min_fill": 0.01}, False, ["good", "sparse"], 1.0),
    ("train_score_drift", {"max_js_divergence": 0.5}, True,
     ["good", "drifty"], 1.0),
    ("null_label_leakage", {}, False, ["good", "leaky"], 1.0),
    ("zoo_mostly_null", {"min_fill": 0.1}, False, ["sparse", "good"], 1.0),
    ("zoo_label_leaking_nulls", {"max_null_label_corr": 0.2, "min_fill": 0.0},
     False, ["leaky", "good"], 1.0),
    ("zoo_drift", {"max_js_divergence": 0.5, "min_fill": 0.0}, True,
     ["drifty", "good"], 1.0),
    ("every_kind_defaults", {}, True, None, 1.0),
    ("every_kind_strict", {"max_js_divergence": 0.05,
                           "max_fill_difference": 0.01,
                           "max_fill_ratio_diff": 1.01, "bins": 20}, True,
     None, 1.0),
    ("protected", {"protected_features": ("leaky", "sparse")}, True, None,
     1.0),
    ("unlabeled_rows", {"max_null_label_corr": 0.5}, False, None, 0.6),
]


def _exclusions(pkg: str, params: dict, with_score: bool, names, labeled):
    train, score = table(3, labeled=labeled), table(4, shift=1.0)
    names = ["label"] + (names or [k for k in train if k != "label"])
    ds = dataset(pkg, train, names)
    resp, preds = features(pkg, ds, train)
    sds = dataset(pkg, score, names[1:]) if with_score else None
    rff = _mods(pkg)["prep.raw_feature_filter"].RawFeatureFilter(**params)
    excluded = rff.compute_exclusions(ds, [resp] + preds, score=sds,
                                      label_name="label")
    return excluded, rff.results.to_json()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_exclusions_equal_the_reference(case):
    _, params, with_score, names, labeled = case
    got = _exclusions("port", params, with_score, names, labeled)
    want = _exclusions("jax", params, with_score, names, labeled)
    assert got[0] == want[0]
    assert _dump(got[1]) == _dump(want[1])
    for p in params.get("protected_features", ()):
        assert p not in got[0]


def test_known_bad_features_are_excluded():
    """The reference tests' verdicts, on the port: the sparse, leaky and
    drifting features go, the good one stays, each for its reason."""
    excluded, res = _exclusions("port", {"max_js_divergence": 0.5,
                                         "min_fill": 0.01}, True,
                                ["good", "sparse", "leaky", "drifty"], 1.0)
    assert set(excluded) == {"sparse", "leaky", "drifty"}
    reasons = res["exclusionReasons"]
    assert any(r.startswith("fillRate") for r in reasons["sparse"])
    assert any(r.startswith("nullLabelCorr") for r in reasons["leaky"])
    assert any(r.startswith("jsDivergence") for r in reasons["drifty"])


# ------------------------------------------------------ the workflow path
def _flow(pkg: str, workflow_cv: bool = False, kill_result: bool = False):
    """label + good, sparse, drifty, count, text -> ``sparse * good``
    (fixed arity, dies with ``sparse``) and ``count + drifty`` -> transmogrify
    -> an RF selector -> ``Workflow`` with the filter against drifted
    scoring rows."""
    M = _mods(pkg)
    if pkg == "jax":
        import transmogrifai_tpu.dsl  # noqa: F401
        from transmogrifai_tpu.ops import transmogrify
    else:
        import transmogrifai_tpu_torch.dsl  # noqa: F401
        from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    names = ["label", "good", "sparse", "drifty", "count", "text"]
    cols = table(5)
    ds = dataset(pkg, cols, names)
    sds = dataset(pkg, table(6, shift=1.0), names[1:])
    resp, preds = features(pkg, ds, cols)
    f = {p.name: p for p in preds}
    product = f["sparse"] * f["good"]
    total = f["count"] + f["drifty"]
    vec = transmogrify(preds + [product, total])
    dev = {} if pkg == "jax" else {"device": "cpu"}
    sel = M["selector"].BinaryClassificationModelSelector(models=[(
        M["models.gbdt"].RandomForestClassifier(**dev),
        {"num_trees": [5], "max_depth": [3], "min_info_gain": [0.001],
         "min_instances_per_node": [10]})])
    pred = sel.set_input(resp, vec).get_output()
    results = (pred, product) if kill_result else (pred,)
    wf = (M["workflow.workflow"].Workflow().set_result_features(*results)
          .set_input_dataset(ds)
          .with_raw_feature_filter(score_dataset=sds, max_js_divergence=0.5,
                                   min_fill=0.01))
    if workflow_cv:
        wf = wf.with_workflow_cv()
    if pkg == "jax":
        wf = wf.set_parallelism(None)
    return wf, ds, pred, product


def _trained(pkg: str, workflow_cv: bool = False):
    wf, ds, pred, product = _flow(pkg, workflow_cv)
    return wf.train(), ds, pred, product


def _summary(model) -> dict:
    s = model.summary_json()
    sel = {k: v for k, v in s["modelSelectorSummary"].items()
           if k not in ("compileStats", "featurizeStats",
                        "distributedResilience")}
    return {"blocklistedFeatures": s["blocklistedFeatures"],
            "rawFeatureFilterResults": s["rawFeatureFilterResults"],
            "rawFeatures": s["rawFeatures"], "selector": sel,
            "trainRows": s["trainRows"], "holdoutRows": s["holdoutRows"]}


def _pred_arrays(col) -> list:
    return [np.asarray(col.prediction).tolist(),
            np.asarray(col.probability).tolist()]


@pytest.mark.parametrize("workflow_cv", [False, True],
                         ids=["selector", "workflow_cv"])
def test_blocklist_rewrite_equals_the_reference(workflow_cv):
    """The cascade: ``sparse`` and ``drifty`` are blocklisted, the product
    stage dies with ``sparse`` and its output joins the blocklist, the sum
    and the vectorizers shrink; the summary and the scores EQUAL."""
    jm, jds, jpred, jprod = _trained("jax", workflow_cv)
    pm, pds, ppred, pprod = _trained("port", workflow_cv)
    assert pm.blocklisted == jm.blocklisted
    assert {"sparse", "drifty", pprod.name} <= set(pm.blocklisted)
    assert _dump(_summary(pm)) == _dump(_summary(jm))
    assert not {"sparse", "drifty"} & {f.name for f in pm.raw_features}
    assert _pred_arrays(pm.score(pds)[ppred.name]) == _pred_arrays(
        jm.score(jds)[jpred.name])


def test_filter_runs_once_before_the_folds(monkeypatch):
    """Under ``with_workflow_cv()`` the filter runs once, on every training
    row, before the holdout split and the folds."""
    from transmogrifai_tpu_torch.prep import raw_feature_filter as R

    calls = []
    real = R.RawFeatureFilter.compute_exclusions

    def counted(self, train, *a, **kw):
        calls.append(train.num_rows)
        return real(self, train, *a, **kw)

    monkeypatch.setattr(R.RawFeatureFilter, "compute_exclusions", counted)
    model, ds, _, _ = _trained("port", workflow_cv=True)
    assert calls == [ds.num_rows]
    assert model.train_rows + model.holdout_rows == ds.num_rows


def test_a_result_feature_left_with_nothing_raises():
    for pkg in ("jax", "port"):
        wf, _, _, product = _flow(pkg, kill_result=True)
        with pytest.raises(ValueError, match="removed everything feeding"):
            wf.train()


def test_rff_results_through_save_and_load_both_ways(tmp_path):
    """``rffResults`` and the blocklist in the manifest: the port's save
    loads in the JAX package and the JAX package's in the port, and each
    scores EQUAL."""
    jm, jds, jpred, _ = _trained("jax")
    pm, pds, ppred, _ = _trained("port")
    for src, model in (("jax", jm), ("port", pm)):
        path = str(tmp_path / src)
        model.save(path)
        with open(os.path.join(path, "manifest.json")) as fh:
            manifest = json.load(fh)
        assert _dump(manifest["rffResults"]) == _dump(jm.rff_results)
        assert manifest["blocklisted"] == jm.blocklisted
        for dst, ds, pred in (("jax", jds, jpred), ("port", pds, ppred)):
            P = _mods(dst)["workflow.persistence"]
            loaded = (P.load_workflow_model(path) if dst == "jax" else
                      P.load_workflow_model(path, device="cpu"))
            assert _dump(loaded.rff_results) == _dump(jm.rff_results)
            assert loaded.blocklisted == jm.blocklisted
            s = loaded.summary_json()
            assert s["blocklistedFeatures"] == jm.blocklisted
            assert _dump(s["rawFeatureFilterResults"]) == _dump(jm.rff_results)
            assert _pred_arrays(loaded.score(ds)[pred.name]) == _pred_arrays(
                jm.score(jds)[jpred.name])
