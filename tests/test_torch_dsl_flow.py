"""The DSL flows end to end: the feature stages off the default dispatch and
the raw feature filter, the PyTorch port against the JAX package's fixture
``tests/fixtures/torch_dsl`` (``tests/torch_fixtures/make_dsl_fixtures.py``,
the JAX package on one device).

* F1 (``dsl_flow.build_f1``, the first 4096 rows of ``dsl_table``): the
  filter's results JSON and blocklist (``r_drift``, ``r_leak``,
  ``r_sparse`` and the stage ``r_drift * r7``, which dies with ``r_drift``),
  the rewritten DAG's vector, its metadata and the keep-set (sha256 of the
  float32 values and of the metadata), the tree selector's summary and the
  fresh rows' scores on both routes: EQUAL. The fused planner refuses the
  plan with the reference's message (a bucketizer member) and the batch
  scores staged.
* F2 (``dsl_flow.build_f2``, ``wide_hash_table``'s first 2048 rows): the
  plan fuses with the arithmetic, scaler and log stages as its host prefix;
  the fused scores of 256 fresh rows EQUAL the staged ones and the JAX
  package's fused path.
* Saved models both ways: the JAX package's load in the port and score
  EQUAL; the port's load in the JAX package (filter results included).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "torch_fixtures"))

import dsl_flow as D  # noqa: E402
import fit_side_tables as FT  # noqa: E402
import make_dsl_fixtures as MK  # noqa: E402
import selector_flows as SF  # noqa: E402

from transmogrifai_tpu.local.scoring import score_function as j_score_function  # noqa: E402
from transmogrifai_tpu.workflow.persistence import load_workflow_model as j_load  # noqa: E402

from transmogrifai_tpu_torch.local.scoring import score_function  # noqa: E402
from transmogrifai_tpu_torch.workflow.persistence import load_workflow_model  # noqa: E402

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

FIXTURE = os.path.join(HERE, "fixtures", "torch_dsl")
with open(os.path.join(FIXTURE, "flow.json")) as _fh:
    FLOW = json.load(_fh)
SCORES = dict(np.load(os.path.join(FIXTURE, "scores.npz")))
F1, F2 = FLOW["f1"], FLOW["f2"]


def _dump(obj) -> str:
    return json.dumps(obj, sort_keys=True)


def _scores(prefix: str, out: list[dict], pred_name: str) -> None:
    got = MK.batch_arrays(prefix, out, pred_name)
    for k, v in got.items():
        np.testing.assert_array_equal(v, SCORES[k], err_msg=k)


@pytest.fixture(scope="module")
def f1():
    ds, score_ds = D.tables("port", D.SMALL_ROWS)
    flow = D.build_f1("port", ds, score_ds, device="cpu")
    return ds, flow, flow["workflow"].train()


def test_f1_filter_results_and_blocklist_equal_the_fixture(f1):
    _, flow, model = f1
    assert _dump(model.rff_results) == _dump(F1["rff_results"])
    assert model.blocklisted == F1["blocklisted"]
    dead = flow["derived"]["drift_product"].name
    assert set(D.BLOCKED_RAW) | {dead} == set(model.blocklisted)
    summary = model.summary_json()
    assert summary["blocklistedFeatures"] == F1["blocklisted"]
    assert _dump(summary["rawFeatureFilterResults"]) == _dump(F1["rff_results"])
    # the rewritten DAG: no blocklisted raw feature is read, the dead
    # stage is gone
    assert not {f.name for f in model.raw_features} & set(D.BLOCKED_RAW)
    assert dead not in {s.output_name for s in model.fitted.values()}


def test_f1_vector_metadata_and_keep_set_equal_the_fixture(f1):
    ds, flow, model = f1
    got = MK.flow_record(model, flow, ds)
    for key in ("pred_name", "vector_name", "checked_name", "derived",
                "train_rows", "holdout_rows", "vector_width", "checked_width",
                "vector_sha256", "vector_metadata_sha256", "checked_sha256",
                "checked_metadata_sha256"):
        assert got[key] == F1[key], key


def test_f1_selector_summary_equals_the_fixture(f1):
    _, _, model = f1
    got = model.summary_json()["modelSelectorSummary"]
    SF.assert_same_summary(got, F1["summary"], glm_winner=False)


def test_f1_fresh_rows_score_equal_the_fixture_on_both_routes(f1, monkeypatch):
    """Below the cutoff the tree order; with ``TPTPU_HOST_PREDICT_MAX=0``
    the device route, staged: the planner refuses a bucketizer member."""
    _, flow, model = f1
    rows = D.fresh_rows(D.dsl_table)
    fn = score_function(model, device="cpu")
    _scores("f1_host", fn.batch(rows), flow["pred"].name)
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    _scores("f1_device", fn.batch(rows), flow["pred"].name)
    md = fn.metadata()["fused"]
    assert {k: md[k] for k in F1["fused"]} == F1["fused"]
    assert "(NumericBucketizer) has no fused kernel" in md["reason"]


def test_f1_jax_saved_model_loads_in_the_port(monkeypatch):
    model = load_workflow_model(os.path.join(FIXTURE, "f1_model"), device="cpu")
    assert _dump(model.rff_results) == _dump(F1["rff_results"])
    assert model.blocklisted == F1["blocklisted"]
    rows = D.fresh_rows(D.dsl_table)
    _scores("f1_host", score_function(model, device="cpu").batch(rows),
            F1["pred_name"])
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    _scores("f1_device", score_function(model, device="cpu").batch(rows),
            F1["pred_name"])


def test_f1_port_saved_model_loads_in_both_packages(f1, tmp_path):
    _, flow, model = f1
    path = str(tmp_path / "f1")
    model.save(path)
    rows = D.fresh_rows(D.dsl_table)
    for loaded, fn in ((j_load(path), j_score_function),
                       (load_workflow_model(path, device="cpu"),
                        lambda m: score_function(m, device="cpu"))):
        assert _dump(loaded.rff_results) == _dump(F1["rff_results"])
        assert loaded.blocklisted == F1["blocklisted"]
        _scores("f1_host", fn(loaded).batch(rows), flow["pred"].name)


# ------------------------------------------------------ F2, the host prefix
@pytest.fixture(scope="module")
def f2():
    ds = D.hash_tables("port", MK.F2_ROWS)
    flow = D.build_f2("port", ds, device="cpu")
    return ds, flow, flow["workflow"].train()


def _fused_and_staged(model, pred_name: str, monkeypatch) -> dict:
    rows = D.fresh_rows(FT.wide_hash_table, MK.F2_FUSED_ROWS)
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    fn = score_function(model, device="cpu")
    _scores("f2_fused", fn.batch(rows), pred_name)
    md = fn.metadata()["fused"]
    monkeypatch.setenv("TPTPU_FUSED", "0")
    _scores("f2_staged", fn.batch(rows), pred_name)
    return md


def test_f2_summary_and_vector_equal_the_fixture(f2):
    ds, flow, model = f2
    got = MK.flow_record(model, flow, ds)
    for key in ("pred_name", "vector_name", "checked_name", "derived",
                "vector_width", "checked_width", "vector_sha256",
                "vector_metadata_sha256", "checked_sha256",
                "checked_metadata_sha256"):
        assert got[key] == F2[key], key
    SF.assert_same_summary(got["summary"], F2["summary"], glm_winner=False)


def test_f2_fuses_with_its_host_prefix(f2, monkeypatch):
    """Fused EQUAL staged EQUAL the JAX package's fused path, one dispatch,
    the math and scaler stages as the host prefix."""
    _, flow, model = f2
    md = _fused_and_staged(model, flow["pred"].name, monkeypatch)
    assert md["active"] and md["dispatches"] == 1 and md["fallbacks"] == 0
    assert md["hostPrefixStages"] == F2["fused"]["hostPrefixStages"]
    derived = {f.name for f in flow["derived"].values()}
    assert derived <= set(md["hostPrefixStages"])


def test_f2_jax_saved_model_fuses_in_the_port(monkeypatch):
    model = load_workflow_model(os.path.join(FIXTURE, "f2_model"), device="cpu")
    md = _fused_and_staged(model, F2["pred_name"], monkeypatch)
    assert {k: md[k] for k in F2["fused"]} == F2["fused"]


# ------------------------------------------------------------------ the card
def test_dsl_flow_on_the_card():
    """F1 at the small grids on the card: the filter's results, the
    blocklist, the vector and the selector summary EQUAL the fixture; F2's
    JAX-saved model fuses on the card, EQUAL the fixture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ds, score_ds = D.tables("port", D.SMALL_ROWS)
    flow = D.build_f1("port", ds, score_ds, device="cuda")
    model = flow["workflow"].train()
    assert _dump(model.rff_results) == _dump(F1["rff_results"])
    assert model.blocklisted == F1["blocklisted"]
    got = MK.flow_record(model, flow, ds)
    assert got["checked_sha256"] == F1["checked_sha256"]
    SF.assert_same_summary(model.summary_json()["modelSelectorSummary"],
                           F1["summary"], glm_winner=False)
    rows = D.fresh_rows(D.dsl_table)
    _scores("f1_host", score_function(model, device="cuda").batch(rows),
            flow["pred"].name)
    f2 = load_workflow_model(os.path.join(FIXTURE, "f2_model"), device="cuda")
    rows2 = D.fresh_rows(FT.wide_hash_table, MK.F2_FUSED_ROWS)
    fn = score_function(f2, device="cuda")
    assert fn.prime_fused()
    os.environ["TPTPU_HOST_PREDICT_MAX"] = "0"
    try:
        _scores("f2_fused", fn.batch(rows2), F2["pred_name"])
    finally:
        del os.environ["TPTPU_HOST_PREDICT_MAX"]
