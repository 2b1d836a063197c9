"""The text flow, built with numpy alone so that both packages, the fixture
generator and ``chip_smoke.py`` build the same rows without JAX; run as a
script it rewrites ``tests/fixtures/torch_text/``.

``documents(n_docs, seed, n_topics, words_per_topic, doc_len)`` is
``baseline_cpu.make_topic_corpus`` (the JAX package's embeddings corpus:
every word belongs to one generative topic, documents draw 90% of their
tokens from their own) with each document's author in front,
``"<first> <last> wrote: <tokens>"``; ``text_table(pkg, ...)`` is its
Dataset: ``text`` (Text) and ``label`` (RealNN, whether the document's
topic lies in the lower half).

``build_flow(pkg, ds, candidates, ...)`` is one Workflow over four text
features of ``text``: ``tokenize().word2vec()``,
``tokenize().count_vectorize().lda()``, ``tokenize().tf_idf()`` and
``detect_languages()``, combined by ``transmogrify``, then
``label.sanity_check(remove_bad_features=True)`` and a
``BinaryClassificationModelSelector`` (``candidates``: ``"default"`` its
default candidates, ``"trees"`` RF and XGBoost at ``all_types``' small
grids, ``"lr"`` one logistic point), with sensitive-feature detection on
(the authors' names flag ``text`` as a Name column). The JAX package's
runs on one device.

The fixtures, ``JAX_PLATFORMS=cpu TPTPU_COMPILE_CACHE=/tmp/cache python
tests/torch_fixtures/text.py`` (~30 s, ONE JAX device): the JAX package
trains the ``trees`` and ``lr`` flows on ``text_table(..., SMALL)`` and
saves them to ``trees/`` and ``lr/``; ``jax_results.json`` holds each
flow's summary keys the port is held to (``sensitiveFeatures``, the
winner), its scores of ``text_table(..., SMALL, FRESH_SEED)`` and its
scoring closure's fused state after one batch above the cutoff.
"""
from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_text")
for _p in (HERE, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import baseline_cpu as BC  # noqa: E402

FIRST = ("Annabelle", "Thorsten", "Svetlana", "Giuseppina", "James", "Mary",
         "Oluwaseun", "Konstanze", "Jordan", "Sophia")
LAST = ("Dupont", "Müller", "Petrova", "Rossi", "Smith", "Johnson",
        "Adeyemi", "Brown", "Garcia", "Visser")

#: the CPU tests' corpus: (docs, topics, words per topic, tokens per doc)
SMALL = dict(n_docs=300, n_topics=4, words_per_topic=30, doc_len=20)
SEED, FRESH_SEED = 7, 8
#: the CPU tests' stage settings; ``chip_smoke.py`` takes the full ones
SMALL_STAGES = dict(vector_size=16, w2v_steps=60, vocab_size=120, k=4,
                    lda_iter=5, num_terms=64)
#: the reference's embeddings configuration (bench.py embeddings)
FULL_STAGES = dict(vector_size=100, w2v_steps=None, vocab_size=2000, k=10,
                   lda_iter=20, num_terms=512)
LR_GRID = {"reg_param": [0.01], "elastic_net_param": [0.0],
           "max_iter": [50]}


def documents(n_docs: int = 5000, seed: int = SEED, n_topics: int = 10,
              words_per_topic: int = 200, doc_len: int = 40):
    """(texts, topics): the topic corpus's documents, author first."""
    vocab, ids, topics = BC.make_topic_corpus(
        n_docs=n_docs, n_topics=n_topics, words_per_topic=words_per_topic,
        doc_len=doc_len, seed=seed)
    rng = np.random.default_rng(seed + 1000)
    first = rng.integers(0, len(FIRST), n_docs)
    last = rng.integers(0, len(LAST), n_docs)
    texts = [f"{FIRST[a]} {LAST[b]} wrote: " + " ".join(vocab[i] for i in row)
             for a, b, row in zip(first, last, ids)]
    return texts, topics


def text_table(pkg: str, n_docs: int = 5000, seed: int = SEED,
               n_topics: int = 10, words_per_topic: int = 200,
               doc_len: int = 40):
    """The flow's Dataset of ``pkg``: ``text`` and ``label``."""
    api = _api(pkg)
    texts, topics = documents(n_docs, seed, n_topics, words_per_topic, doc_len)
    T, C = api["types"], api["types.columns"]
    label = (topics < n_topics // 2).astype(np.float64)
    return api["dataset"].Dataset.of({
        "text": C.column_from_values(T.Text, texts),
        "label": C.NumericColumn(T.RealNN, label, np.ones(n_docs, bool)),
    })


def _api(pkg: str) -> dict:
    import importlib

    root = "transmogrifai_tpu" if pkg == "jax" else "transmogrifai_tpu_torch"
    importlib.import_module(f"{root}.dsl")
    mods = {name: importlib.import_module(f"{root}.{name}") for name in (
        "dataset", "features", "models.gbdt", "models.logistic", "selector",
        "types", "types.columns", "utils.uid", "workflow.workflow")}
    mods["transmogrify"] = importlib.import_module(
        f"{root}.ops" if pkg == "jax" else f"{root}.ops.transmogrify"
    ).transmogrify
    return mods


def build_flow(pkg: str, ds, candidates: str = "default", stages=None,
               device=None) -> dict:
    """The text flow of ``pkg`` over ``ds`` (uid counter reset first).
    Returns a dict: ``workflow``, ``pred``, ``checked``, ``vector`` and
    ``features`` (name -> the four text features)."""
    import all_types as AT

    api = _api(pkg)
    st = dict(FULL_STAGES if stages is None else stages)
    dev = {} if pkg == "jax" else {"device": device}
    api["utils.uid"].reset()
    label, preds = api["features"].from_dataset(ds, response="label")
    text = next(p for p in preds if p.name == "text")
    tokens = text.tokenize()
    feats = {
        "word2vec": tokens.word2vec(
            vector_size=st["vector_size"], min_count=1,
            max_vocab=10_000, steps=st["w2v_steps"], **dev),
        "lda": tokens.count_vectorize(vocab_size=st["vocab_size"]).lda(
            k=st["k"], max_iter=st["lda_iter"], **dev),
        "tf_idf": tokens.tf_idf(num_terms=st["num_terms"]),
        "languages": text.detect_languages(),
    }
    vec = api["transmogrify"](list(feats.values()))
    checked = label.sanity_check(vec, remove_bad_features=True, **dev)
    gbdt, logistic = api["models.gbdt"], api["models.logistic"]
    if candidates == "default":
        selector = api["selector"].BinaryClassificationModelSelector(**dev)
    elif candidates == "trees":
        selector = api["selector"].BinaryClassificationModelSelector(models=[
            (gbdt.RandomForestClassifier(**dev), AT.RF_GRID),
            (gbdt.XGBoostClassifier(**dev), AT.XGB_GRID)])
    else:
        selector = api["selector"].BinaryClassificationModelSelector(
            models=[(logistic.LogisticRegression(**dev), LR_GRID)])
    pred = selector.set_input(label, checked).get_output()
    wf = (api["workflow.workflow"].Workflow().set_result_features(pred)
          .set_input_dataset(ds).with_sensitive_feature_detection())
    if pkg == "jax":
        wf = wf.set_parallelism(None)
    return {"workflow": wf, "pred": pred, "checked": checked, "vector": vec,
            "features": feats}


def score_rows(ds) -> list[dict]:
    """The rows of ``ds`` as the scoring closure takes them."""
    return [{"text": t} for t in ds["text"].values]


def fused_state(fn) -> dict:
    """The keys of a closure's fused state the port is held to."""
    md = fn.metadata()["fused"]
    return {k: md[k] for k in ("active", "reason", "dispatches", "fallbacks",
                               "fallbackReasons")}


def probabilities(out: list[dict], pred_name: str) -> np.ndarray:
    return np.asarray([r[pred_name]["probability_1"] for r in out],
                      dtype=np.float64)


def main() -> None:
    import json
    import shutil

    os.environ["TPTPU_HOST_PREDICT_MAX"] = "0"
    from transmogrifai_tpu.local.scoring import score_function

    ds = text_table("jax", **SMALL)
    fresh = text_table("jax", seed=FRESH_SEED, **SMALL)
    results = {}
    for name in ("trees", "lr"):
        flow = build_flow("jax", ds, name, SMALL_STAGES)
        model = flow["workflow"].train()
        path = os.path.join(FIXTURE, name)
        shutil.rmtree(path, ignore_errors=True)
        model.save(path)
        fn = score_function(model)
        out = fn.batch(score_rows(fresh))
        summary = model.summary_json()
        results[name] = {
            "sensitiveFeatures": summary["sensitiveFeatures"],
            "bestModelType": summary["modelSelectorSummary"]["bestModelType"],
            "predName": flow["pred"].name,
            "scores": probabilities(out, flow["pred"].name).tolist(),
            "fused": fused_state(fn),
        }
        print(name, results[name]["bestModelType"],
              results[name]["sensitiveFeatures"], results[name]["fused"])
    with open(os.path.join(FIXTURE, "jax_results.json"), "w") as fh:
        json.dump(results, fh, indent=1, sort_keys=True)


if __name__ == "__main__":
    main()
