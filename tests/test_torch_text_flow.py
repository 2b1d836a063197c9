"""The text flow through ``train()`` in the port, against the JAX package's
(``tests/torch_fixtures/text.py``): word2vec, count vectors into LDA,
TF-IDF and language detection of one ``Text`` column, combined, sanity
checked and selected, with sensitive-feature detection on.

* The JAX package's trained text models (``tests/fixtures/torch_text/``,
  the tree and the logistic flow) load through the port's
  ``load_workflow_model`` and score the fresh rows EQUAL the JAX package's
  stored scores (trees) or within ``LR_ATOL`` = 1e-6 (logistic), with the
  fused attempt refused as the reference refuses it (the same fused state)
  and the sensitive-feature findings carried over.
* The port's own ``train()`` of the same flows on the CPU: the
  sensitive-feature findings and the winner EQUAL the reference's; the
  fitted count-vectorizer vocabulary, the IDF weights and the word2vec
  vocabulary EQUAL the reference's saved stages, the word2vec vectors and
  LDA's ``topic_word`` within ``tests/test_torch_embeddings.py``'s
  tolerances; the port's saved model loads in the JAX package with its
  findings.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "torch_fixtures"))
import text as TX  # noqa: E402

FIXTURE = os.path.join(HERE, "fixtures", "torch_text")
RESULTS = json.load(open(os.path.join(FIXTURE, "jax_results.json")))
LR_ATOL = 1e-6
SGNS_RTOL = 2e-6
LDA_RTOL = 2e-5
FLOWS = ("trees", "lr")


@pytest.fixture(autouse=True)
def _cutoff(monkeypatch, tmp_path):
    """Every batch attempts the fused graph, as the fixture's did; the JAX
    package's AOT bank writes into a temporary directory."""
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    monkeypatch.setenv("TPTPU_COMPILE_CACHE", str(tmp_path))


def fresh_rows():
    return TX.score_rows(TX.text_table("port", seed=TX.FRESH_SEED, **TX.SMALL))


def same_scores(name: str, got: np.ndarray) -> None:
    want = np.asarray(RESULTS[name]["scores"])
    assert got.shape == want.shape and np.isfinite(got).all()
    if name == "lr":
        np.testing.assert_allclose(got, want, rtol=0, atol=LR_ATOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", FLOWS)
def test_saved_jax_text_model_scores_equal(name):
    from transmogrifai_tpu_torch import load_workflow_model
    from transmogrifai_tpu_torch.local.scoring import score_function

    model = load_workflow_model(os.path.join(FIXTURE, name), device="cpu")
    assert model.summary_json()["sensitiveFeatures"] == \
        RESULTS[name]["sensitiveFeatures"]
    fn = score_function(model, device="cpu")
    out = fn.batch(fresh_rows())
    same_scores(name, TX.probabilities(out, RESULTS[name]["predName"]))
    assert TX.fused_state(fn) == RESULTS[name]["fused"]


def _trained(name: str):
    ds = TX.text_table("port", **TX.SMALL)
    flow = TX.build_flow("port", ds, name, TX.SMALL_STAGES, device="cpu")
    return flow["workflow"].train(), flow


@pytest.mark.parametrize("name", FLOWS)
def test_text_flow_trains_like_the_reference(name, tmp_path):
    from transmogrifai_tpu.workflow.persistence import (
        load_workflow_model as jax_load,
    )
    from transmogrifai_tpu_torch import load_workflow_model
    from transmogrifai_tpu_torch.local.scoring import score_function

    model, flow = _trained(name)
    summary = model.summary_json()
    assert summary["sensitiveFeatures"] == RESULTS[name]["sensitiveFeatures"]
    assert summary["modelSelectorSummary"]["bestModelType"] == \
        RESULTS[name]["bestModelType"]
    ref = load_workflow_model(os.path.join(FIXTURE, name), device="cpu")
    assert set(ref.fitted) == set(model.fitted)
    by_class = {}
    for uid, stage in model.fitted.items():
        want = ref.fitted[uid]
        assert type(stage) is type(want)
        by_class[type(stage).__name__] = (stage, want)
    cv, cv_ref = by_class["OpCountVectorizerModel"]
    assert cv.vocab == cv_ref.vocab
    idf, idf_ref = by_class["OpIDFModel"]
    np.testing.assert_array_equal(idf.idf, idf_ref.idf)
    w2v, w2v_ref = by_class["OpWord2VecModel"]
    assert w2v.vocab == w2v_ref.vocab and w2v.metadata == w2v_ref.metadata
    assert np.abs(w2v.vectors - w2v_ref.vectors).max() <= \
        SGNS_RTOL * np.abs(w2v_ref.vectors).max()
    lda, lda_ref = by_class["OpLDAModel"]
    assert np.abs(lda.topic_word - lda_ref.topic_word).max() <= \
        LDA_RTOL * np.abs(lda_ref.topic_word).max()
    # scored here, saved, and read back by both packages with the findings
    fn = score_function(model, device="cpu")
    got = TX.probabilities(fn.batch(fresh_rows()), flow["pred"].name)
    assert np.isfinite(got).all()
    assert TX.fused_state(fn) == RESULTS[name]["fused"]
    path = str(tmp_path / "port_text")
    model.save(path)
    again = score_function(load_workflow_model(path, device="cpu"),
                           device="cpu")
    np.testing.assert_array_equal(
        TX.probabilities(again.batch(fresh_rows()), flow["pred"].name), got)
    assert jax_load(path).summary_json()["sensitiveFeatures"] == \
        RESULTS[name]["sensitiveFeatures"]


def test_sensitive_detection_equals_the_reference():
    """``detect_sensitive_features`` over typed and sampled text columns
    (names, emails, phones, urls, mixed and plain text) EQUAL the JAX
    package's records."""
    from transmogrifai_tpu.prep.sensitive import (
        detect_sensitive_features as jax_detect,
    )
    from transmogrifai_tpu_torch.prep.sensitive import (
        detect_sensitive_features as port_detect,
    )

    rng = np.random.default_rng(5)
    names = TX.documents(120, 3, 4, 30, 5)[0]
    columns = {
        "names": ("Text", [t.split(" wrote")[0] for t in names]),
        "emails": ("Text", [f"u{i}@corp.example.com" if i % 3 else "x"
                            for i in range(120)]),
        "phones": ("Text", [f"+1 650 253 {1000 + i:04d}" for i in range(120)]),
        "urls": ("Text", [f"https://site{i}.org/p" for i in range(120)]),
        "dates": ("Text", [f"2024-0{1 + i % 9}-1{i % 9}" for i in range(120)]),
        "mixed": ("Text", [names[i].split(" wrote")[0] if rng.random() < 0.4
                           else f"id-{i}" for i in range(120)]),
        "plain": ("Text", [" ".join(n.split()[3:6]) for n in names]),
        "typed_email": ("Email", ["a@b.co"] * 120),
        "typed_phone": ("Phone", ["650-253-0000"] * 120),
        "typed_url": ("URL", ["http://x.org"] * 120),
        "empty": ("Text", [None] * 120),
    }
    records = {}
    for pkg, detect in (("jax", jax_detect), ("port", port_detect)):
        api = TX._api(pkg)
        T, C = api["types"], api["types.columns"]
        ds = api["dataset"].Dataset.of({
            k: C.column_from_values(getattr(T, t), v)
            for k, (t, v) in columns.items()})
        feats = [getattr(api["features"].FeatureBuilder, t)(k).as_predictor()
                 for k, (t, v) in columns.items()]
        for kw in ({}, {"threshold": 0.3}, {"use_model": False}):
            records[(pkg, json.dumps(kw))] = [
                r.to_json() for r in detect(ds, feats, **kw)]
    for kw in ({}, {"threshold": 0.3}, {"use_model": False}):
        key = json.dumps(kw)
        assert records[("port", key)] == records[("jax", key)]
    assert {r["kind"] for r in records[("port", "{}")]} == {
        "Name", "Email", "Phone", "Url"}
