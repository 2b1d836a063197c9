"""Generate the fused scoring graph's text fixtures: hash-only text flows
that the JAX package trains and saves, for the PyTorch port's fused-graph
tests (``tests/test_torch_fused.py``).

Run from the repository root, on the CPU (it trains with the JAX package):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_fused_fixtures.py

For each flow it writes ``tests/fixtures/torch_fused/<name>/``:
``manifest.json`` + ``arrays.npz`` (``model.save(...)``) and ``rows.json``
(the raw scoring rows, ``null`` for a missing value). The tests score the
rows with both packages themselves.

The table (``N_ROWS = 160``, ``np.random.default_rng(SEED)`` with
``SEED = 11``):

* ``x1``: Real, ``normal(0, 1)``, every 9th row empty;
* ``n1``: Integral, ``integers(0, 4)``;
* ``desc``: Text, 1-4 words drawn from ``WORDS`` and a unique ``id<i>``:
  160 distinct values, so ``SmartTextVectorizer`` hashes it (512 buckets
  and a null indicator: one hash-only member);
* ``label``: RealNN, ``1`` where ``x1 + 0.3 * ("alpha" in desc) +
  normal(0, 0.3) > 0``.

The flow is ``from_dataset`` -> ``transmogrify`` ->
``sanity_check(remove_bad_features=True)`` ->
``BinaryClassificationModelSelector(seed=7, num_folds=2)`` with one
candidate -> ``Workflow.train()``:

* ``text_lr``: ``LogisticRegression`` at ``reg_param=0.01``;
* ``text_xgb``: ``XGBoostClassifier`` at ``num_round=20, max_depth=4``.

The scoring rows are the table's rows, with row 3's text null and row 5's
made of unseen words.

It also writes ``tests/fixtures/torch_fused/jax_scores.npz``, the JAX
package's scores above the host-predict cutoff (``TPTPU_HOST_PREDICT_MAX=0``:
its fused path), which ``chip_smoke.py`` holds the card's to (it imports no
JAX), as ``score_matrix`` columns (prediction, probability_0,
probability_1, rawPrediction_0, rawPrediction_1; float64):

* ``text_xgb``: the flow's 160 rows (the bucket of 256 rows);
* ``xgb`` / ``rf``: the serving fixtures' (``tests/fixtures/torch_serving``)
  256 rows, which ``chip_smoke.py`` tiles to 20000 and 65536 rows. Their
  trees (200 of depth 10, 50 of depth 12) take the windowed grid's order
  at every row count, and the one-hot select at 256 rows as at 24576 and
  65536 (``models/tree_sum.py``), so a row's score is the same in those
  buckets; the JAX package's fused program at 24576 rows and more needs
  more memory than a 62 GB host has.

Name ``scores`` on the command line to write only this file.
"""
from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np

SEED = 11
N_ROWS = 160
WORDS = (
    "alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
    "hotel", "india", "juliet", "kilo", "lima", "mike", "november",
)
OUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "fixtures", "torch_fused",
)


def table() -> tuple[dict, dict]:
    """(schema, columns) of the text table: feature type name and row
    values per column."""
    rng = np.random.default_rng(SEED)
    x1 = rng.normal(size=N_ROWS)
    n1 = rng.integers(0, 4, N_ROWS)
    texts = []
    for i in range(N_ROWS):
        k = 1 + int(rng.integers(0, 4))
        words = [WORDS[int(j)] for j in rng.integers(0, len(WORDS), k)]
        texts.append(" ".join(words) + f" id{i}")
    alpha = np.array(["alpha" in t.split() for t in texts], dtype=float)
    label = (x1 + 0.3 * alpha + rng.normal(0.0, 0.3, N_ROWS) > 0).astype(float)
    x1_vals = [None if i % 9 == 0 else float(v) for i, v in enumerate(x1)]
    schema = {"label": "RealNN", "x1": "Real", "n1": "Integral", "desc": "Text"}
    columns = {"label": label.tolist(), "x1": x1_vals,
               "n1": n1.tolist(), "desc": texts}
    return schema, columns


def scoring_rows(columns: dict) -> list[dict]:
    rows = [{k: columns[k][i] for k in ("x1", "n1", "desc")}
            for i in range(N_ROWS)]
    rows[3]["desc"] = None
    rows[5]["desc"] = "zulu yankee xray"
    return rows


def candidates():
    from transmogrifai_tpu.models.gbdt import XGBoostClassifier
    from transmogrifai_tpu.models.logistic import LogisticRegression

    return {
        "text_lr": (LogisticRegression(), {"reg_param": [0.01]}),
        "text_xgb": (XGBoostClassifier(),
                     {"num_round": [20], "max_depth": [4]}),
    }


def train(schema: dict, columns: dict, candidate):
    import transmogrifai_tpu.dsl  # noqa: F401  (installs sanity_check)
    from transmogrifai_tpu import types as T
    from transmogrifai_tpu.dataset import Dataset
    from transmogrifai_tpu.features import from_dataset
    from transmogrifai_tpu.ops import transmogrify
    from transmogrifai_tpu.selector import BinaryClassificationModelSelector
    from transmogrifai_tpu.types.columns import column_from_values
    from transmogrifai_tpu.utils import uid as uid_util
    from transmogrifai_tpu.workflow.workflow import Workflow

    uid_util.reset()
    ds = Dataset.of({
        k: column_from_values(getattr(T, schema[k]), v)
        for k, v in columns.items()})
    resp, preds = from_dataset(ds, response="label")
    checked = resp.sanity_check(transmogrify(list(preds)),
                                remove_bad_features=True)
    sel = BinaryClassificationModelSelector(seed=7, num_folds=2,
                                            models=[candidate])
    pred = sel.set_input(resp, checked).get_output()
    return Workflow().set_result_features(pred).set_input_dataset(ds).train()


SERVING_DIR = os.path.join(os.path.dirname(OUT_DIR), "torch_serving")


def score_matrix(out: list[dict]) -> np.ndarray:
    preds = [next(iter(r.values())) for r in out]
    return np.array([[p["prediction"], p["probability_0"], p["probability_1"],
                      p["rawPrediction_0"], p["rawPrediction_1"]]
                     for p in preds], dtype=np.float64)


def jax_scores() -> dict:
    """The JAX package's scores above the cutoff (module docstring)."""
    from transmogrifai_tpu.local.scoring import score_function
    from transmogrifai_tpu.workflow.persistence import load_workflow_model

    out = {}
    os.environ["TPTPU_HOST_PREDICT_MAX"] = "0"
    try:
        for name, path in (("text_xgb", os.path.join(OUT_DIR, "text_xgb")),
                           ("xgb", os.path.join(SERVING_DIR, "xgb")),
                           ("rf", os.path.join(SERVING_DIR, "rf"))):
            with open(os.path.join(path, "rows.json")) as fh:
                rows = json.load(fh)
            fn = score_function(load_workflow_model(path))
            out[name] = score_matrix(fn.batch(rows))
            if fn.metadata()["fused"]["dispatches"] != 1:
                raise SystemExit(f"{name}: the batch did not fuse")
    finally:
        del os.environ["TPTPU_HOST_PREDICT_MAX"]
    return out


def main(names: list[str]) -> None:
    schema, columns = table()
    rows = scoring_rows(columns)
    for name, cand in candidates().items():
        if names and name not in names:
            continue
        model = train(schema, columns, cand)
        path = os.path.join(OUT_DIR, name)
        shutil.rmtree(path, ignore_errors=True)
        model.save(path)
        with open(os.path.join(path, "rows.json"), "w") as fh:
            json.dump(rows, fh)
        print("wrote", path)
    if not names or "scores" in names:  # after the models it scores
        np.savez(os.path.join(OUT_DIR, "jax_scores.npz"), **jax_scores())
        print("wrote", os.path.join(OUT_DIR, "jax_scores.npz"))


if __name__ == "__main__":
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.dirname(OUT_DIR)))
    )
    main(sys.argv[1:])
