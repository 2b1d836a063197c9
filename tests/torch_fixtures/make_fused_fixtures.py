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


if __name__ == "__main__":
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.dirname(OUT_DIR)))
    )
    main(sys.argv[1:])
