"""Every type of ``transmogrify``'s default dispatch, end to end: the
PyTorch port against the JAX package on the CPU.

* The dispatch builds, for every feature type, the vectorizer class the
  reference builds, with the same params.
* On ``tests/torch_fixtures/all_types.py``'s table (22 predictors, one per
  type group, about 20% of each empty) both packages' ``transmogrify`` and
  ``sanity_check`` give the same vector, metadata, checked vector and
  SanityChecker summary: EQUAL.
* The all-types flow through the tree selector and ``train()`` is held to
  ``tests/fixtures/torch_all_types`` (``make_all_types_fixtures.py``, the
  JAX package on one device): the selector summary (winner, every
  candidate's metric values), the holdout scores and the fresh rows'
  scores below the host-predict cutoff and above it
  (``TPTPU_HOST_PREDICT_MAX=0``) EQUAL; the fused planner refuses the plan
  with the reference's reason and the batch scores staged, counted as the
  reference counts it.
* Persistence both ways: the JAX-saved model loads in the port and the
  port-saved model loads in the JAX package, and both score EQUAL.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import transmogrifai_tpu.types as T
from transmogrifai_tpu import testkit as JTK
from transmogrifai_tpu.local.scoring import score_function as j_score_function
from transmogrifai_tpu.ops.defaults import DEFAULTS as J_DEFAULTS
from transmogrifai_tpu.workflow.persistence import load_workflow_model as j_load

from transmogrifai_tpu_torch import testkit as PTK
from transmogrifai_tpu_torch import types as PT
from transmogrifai_tpu_torch.local.scoring import score_function
from transmogrifai_tpu_torch.ops.defaults import DEFAULTS as P_DEFAULTS
from transmogrifai_tpu_torch.workflow.persistence import load_workflow_model

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "torch_all_types")


def _load_module(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "torch_fixtures", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


AT = _load_module("all_types")
SF = _load_module("selector_flows")

with open(os.path.join(FIXTURE, "flow.json")) as _fh:
    FLOW = json.load(_fh)
SCORES = dict(np.load(os.path.join(FIXTURE, "scores.npz")))
#: the SanityChecker's float64 statistics (summed in another order than the
#: reference's): relative, since the currency column's variance is ~8e4,
#: where an ulp is 1.5e-11 (measured: 1.4e-15 relative); the keep-set and
#: the drop reasons are EQUAL
STATS_RTOL = 1e-12


# ------------------------------------------------------------- the dispatch
DISPATCH_TYPES = [t.__name__ for t in T.ALL_FEATURE_TYPES
                  if t not in (T.OPVector, T.Prediction)]


@pytest.mark.parametrize("name", DISPATCH_TYPES)
def test_dispatch_builds_the_reference_vectorizer(name):
    from transmogrifai_tpu.ops.transmogrify import _vectorizer_for as j_for

    from transmogrifai_tpu_torch.ops.transmogrify import _vectorizer_for

    d_j, d_p = AT.defaults(J_DEFAULTS), AT.defaults(P_DEFAULTS)
    want = j_for(getattr(T, name), d_j)
    got = _vectorizer_for(PT.feature_type_by_name(name), d_p)
    assert type(got).__name__ == type(want).__name__
    assert got.operation_name == want.operation_name
    assert json.dumps(got.get_params(), sort_keys=True) == json.dumps(
        want.get_params(), sort_keys=True)


def test_every_dispatch_type_is_in_the_table():
    """The all-types table holds one feature of each type group."""
    ds = AT.all_types_table(50, 1)
    got = {type(c).__name__ for c in ds.columns.values()}
    assert got == {"NumericColumn", "TextColumn", "SetColumn", "ListColumn",
                   "MapColumn"}
    assert len(ds.columns) == 23


# ----------------------------------------------------- feature side, EQUAL
def _rows_of(ds):
    return [{k: (sorted(v) if isinstance(v, frozenset) else v)
             for k, v in r.items()} for r in ds.rows()]


@pytest.fixture(scope="module")
def tables():
    jds = AT.all_types_table(AT.FLOW_ROWS, AT.FLOW_SEED, JTK)
    pds = AT.all_types_table(AT.FLOW_ROWS, AT.FLOW_SEED)
    return jds, pds


def test_both_testkits_draw_the_same_table(tables):
    jds, pds = tables
    assert list(jds.columns) == list(pds.columns)
    assert _rows_of(jds) == _rows_of(pds)
    for name in jds.columns:
        assert jds[name].feature_type.__name__ == pds[name].feature_type.__name__


def _metas(col):
    import dataclasses

    return [{k: (list(v) if isinstance(v, tuple) else v)
             for k, v in dataclasses.asdict(c).items()}
            for c in col.metadata.columns]


@pytest.fixture(scope="module")
def feature_sides(tables):
    jds, pds = tables
    return (AT.feature_side("jax", jds),
            AT.feature_side("port", pds, device="cpu"))


def test_transmogrify_vector_and_metadata_equal_the_reference(feature_sides):
    (jdata, jvec, _, _), (pdata, pvec, _, _) = feature_sides
    assert pvec.name == jvec.name
    got, want = pdata[pvec.name], jdata[jvec.name]
    assert got.values.dtype == np.float32
    np.testing.assert_array_equal(got.values, np.asarray(want.values, np.float32))
    assert _metas(got) == _metas(want)
    # every predictor contributed columns
    parents = {p for c in got.metadata.columns for p in c.parent_names}
    assert parents == {n for n in AT.generators(PTK)}


def test_keep_set_and_checker_summary_equal_the_reference(feature_sides):
    (jdata, _, jchk, js), (pdata, _, pchk, ps) = feature_sides
    got, want = pdata[pchk.name], jdata[jchk.name]
    np.testing.assert_array_equal(got.values, np.asarray(want.values, np.float32))
    assert _metas(got) == _metas(want)
    assert (ps["numRows"], ps["numColumns"], ps["numDropped"]) == (
        js["numRows"], js["numColumns"], js["numDropped"])
    for jc, pc in zip(js["columns"], ps["columns"], strict=True):
        assert (pc["name"], pc["dropped"], pc["reasons"]) == (
            jc["name"], jc["dropped"], jc["reasons"])
        assert pc["cramers_v"] == jc["cramers_v"]
        for key in ("mean", "variance", "corr_label"):  # float64 statistics
            assert pc[key] == pytest.approx(jc[key], rel=STATS_RTOL,
                                            abs=STATS_RTOL, nan_ok=True)


# ------------------------------------------------ the flow, to the fixture
@pytest.fixture(scope="module")
def trained(tables):
    _, pds = tables
    model, pred, checked, selector = AT.train_flow("port", pds, device="cpu")
    return pds, model, pred, checked, selector


def test_selector_summary_equals_the_fixture(trained):
    ds, model, pred, checked, _ = trained
    data = model.score(ds, keep_intermediate_features=True)
    vec = checked.origin_stage.input_features[-1]
    assert data[vec.name].values.shape[1] == FLOW["vector_width"]
    assert data[checked.name].values.shape[1] == FLOW["checked_width"]
    got = model.summary_json()["modelSelectorSummary"]
    SF.assert_same_summary(got, FLOW["summary"], glm_winner=False)
    assert got["bestModelType"] in ("RandomForestClassifier", "XGBoostClassifier")
    assert (pred.name, checked.name) == (FLOW["pred_name"], FLOW["checked_name"])
    assert (model.train_rows, model.holdout_rows) == (
        FLOW["train_rows"], FLOW["holdout_rows"])


def _assert_scores(prefix, prediction, probability, raw):
    np.testing.assert_array_equal(prediction, SCORES[f"{prefix}_prediction"])
    np.testing.assert_array_equal(probability, SCORES[f"{prefix}_probability"])
    np.testing.assert_array_equal(raw, SCORES[f"{prefix}_raw"])


def test_holdout_scores_equal_the_fixture(trained):
    ds, model, pred, _, selector = trained
    _, holdout_idx = selector.splitter.split(ds.num_rows)
    assert holdout_idx.tolist() == FLOW["holdout_idx"]
    col = model.score(ds.take(holdout_idx))[pred.name]
    _assert_scores("holdout", col.prediction, col.probability, col.raw)


def _fresh_rows():
    fresh = AT.all_types_table(AT.FRESH_ROWS, AT.FRESH_SEED)
    return fresh.rows([n for n in fresh.columns if n != "label"])


def _batch(out, name):
    rows = [r[name] for r in out]
    return (np.array([r["prediction"] for r in rows]),
            np.array([[r["probability_0"], r["probability_1"]] for r in rows]),
            np.array([[r["rawPrediction_0"], r["rawPrediction_1"]]
                      for r in rows]))


def test_fresh_rows_score_equal_the_fixture_on_both_routes(trained,
                                                           monkeypatch):
    """Below the cutoff the tree order; with ``TPTPU_HOST_PREDICT_MAX=0``
    the device route (20 rounds of depth 3 sum in 4 lanes there, C4):
    EQUAL; the fused planner refuses the plan with the reference's reason,
    and each eligible batch is counted as the reference counts it."""
    _, model, pred, _, _ = trained
    rows = _fresh_rows()
    fn = score_function(model, device="cpu")
    _assert_scores("host", *_batch(fn.batch(rows), pred.name))
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    _assert_scores("device", *_batch(fn.batch(rows), pred.name))
    fused = fn.metadata()["fused"]
    assert {k: fused[k] for k in FLOW["fused"]} == FLOW["fused"]
    assert not fn.prime_fused()


# ------------------------------------------------- persistence, both ways
def test_jax_saved_model_loads_in_the_port(monkeypatch):
    model = load_workflow_model(os.path.join(FIXTURE, "model"), device="cpu")
    fn = score_function(model, device="cpu")
    rows = _fresh_rows()
    _assert_scores("host", *_batch(fn.batch(rows), FLOW["pred_name"]))
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    _assert_scores("device", *_batch(fn.batch(rows), FLOW["pred_name"]))


def test_port_saved_model_loads_in_both_packages(trained, tmp_path,
                                                 monkeypatch):
    _, model, pred, _, _ = trained
    path = str(tmp_path / "port_model")
    model.save(path)
    jrows = AT.all_types_table(AT.FRESH_ROWS, AT.FRESH_SEED, JTK)
    jrows = jrows.rows([n for n in jrows.columns if n != "label"])
    _assert_scores("host", *_batch(j_score_function(j_load(path)).batch(jrows),
                                   pred.name))
    again = load_workflow_model(path, device="cpu")
    _assert_scores("host", *_batch(
        score_function(again, device="cpu").batch(_fresh_rows()), pred.name))
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    _assert_scores("device", *_batch(
        j_score_function(j_load(path)).batch(jrows), pred.name))
