"""Generate the fit-side fixtures that pin the PyTorch port to the JAX package.

Run from the repository root, on the CPU, with ONE JAX device (so the
JAX package's statistics take their single-device route, the one the port
mirrors; do not set ``--xla_force_host_platform_device_count``):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_fit_side_fixtures.py

It runs the flagship flow's feature side (``from_dataset`` ->
``transmogrify`` -> ``sanity_check(remove_bad_features=True)`` ->
``fit_and_transform_dag``) with the JAX package over three tables and
writes ``tests/fixtures/torch_fit_side/``:

* ``flagship_table.json``: the 891-row typed twin of
  ``make_serving_fixtures.twin_dataset`` (schema and column values, ``null``
  for missing), so that a reader without JAX builds the same table;
* ``titanic_twin.csv``: the CSV twin, the typed twin's columns with the
  label as ``survived`` plus Titanic-shaped text (``name``: near-unique
  names, a few with non-ASCII letters, hashed into 512 buckets; ``sex``:
  2 levels, pivoted; ``embarked`` with 2 empties) and ``pclass``; every
  column's type is inferred on reading;
* ``flagship.{json,npz}``, ``csv.{json,npz}``: for each twin, the
  transmogrified vector (``vector``, float32, bit for bit), its metadata
  columns, the SanityChecker's keep-set and drop reasons, the smart-text
  summary, and its per-column mean, variance and label correlation
  (float64 route);
* ``wide.{json,npz}``: for ``fit_side_tables.wide_table()`` (16384 rows,
  1423 vector columns, the float32 route), the keep-set, drop reasons,
  column names and per-column statistics; the vector is not stored;
* ``csv_model/``: a model the JAX package trained and saved on the CSV
  twin (selector cut to one ``XGBoostClassifier`` point: ``num_round=20,
  max_depth=6, eta=0.3, max_bins=32``), with ``rows.json`` (the first
  ``MODEL_ROWS`` rows) and ``expected.npz`` (its scores for them), so the
  port loads a ``SmartTextModel`` stage and scores it.
"""
from __future__ import annotations

import csv
import json
import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, HERE)
sys.path.insert(0, ROOT)

from fit_side_tables import names, wide_table  # noqa: E402
from make_serving_fixtures import (  # noqa: E402
    expected_scores, scoring_rows, twin_dataset,
)

OUT_DIR = os.path.join(ROOT, "tests", "fixtures", "torch_fit_side")
CSV_SEED = 1912
MODEL_ROWS = 64
#: rows whose names carry non-ASCII letters (the reference hashes those
#: through its Python route, the rest natively)
NON_ASCII = {5: "Müller, Mrs. Anna", 77: "Ødegaard, Mr. Jon",
             300: "Nuñez, Miss. María José", 640: "Łukasiewicz, Dr. Jan"}


def csv_twin_rows(ds) -> tuple[list[str], list[list[str]]]:
    """The CSV twin's header and rows from the typed twin ``ds``."""
    n = ds.num_rows
    rng = np.random.default_rng(CSV_SEED)
    label = ds["label"].values
    female = rng.random(n) < np.where(label > 0, 0.7, 0.2)
    pclass = rng.choice([1, 2, 3], size=n, p=[0.24, 0.21, 0.55])
    name = names(rng, n)
    for i, v in NON_ASCII.items():
        name[i] = v
    embarked = list(ds["embarked"].values)
    for i in (61, 829):
        embarked[i] = None

    def real(col, i):
        return repr(float(col.values[i])) if col.mask[i] else ""

    header = ["survived", "pclass", "name", "sex", "age", "sibsp", "fare",
              "ticket_score", "embarked"]
    rows = []
    for i in range(n):
        rows.append([
            str(int(label[i])), str(int(pclass[i])), name[i],
            "female" if female[i] else "male", real(ds["age"], i),
            str(int(ds["sibsp"].values[i])), real(ds["fare"], i),
            real(ds["ticket_score"], i), embarked[i] or "",
        ])
    return header, rows


def table_json(ds) -> dict:
    return {
        "schema": {k: c.feature_type.__name__ for k, c in ds.columns.items()},
        "columns": {
            k: [None if v is None else (v.item() if hasattr(v, "item") else v)
                for v in c.to_list()]
            for k, c in ds.columns.items()
        },
    }


def feature_side(ds, response: str):
    """The JAX package's feature side over ``ds``: (vector column, the
    SanityChecker's summary, the smart-text summary)."""
    import transmogrifai_tpu.dsl  # noqa: F401  (installs sanity_check)
    from transmogrifai_tpu.features import from_dataset
    from transmogrifai_tpu.ops import transmogrify
    from transmogrifai_tpu.utils import uid as uid_util
    from transmogrifai_tpu.workflow.fit import fit_and_transform_dag

    uid_util.reset()
    resp, preds = from_dataset(ds, response=response)
    vec = transmogrify(list(preds))
    checked = resp.sanity_check(vec, remove_bad_features=True)
    data, fitted = fit_and_transform_dag(ds, [checked])
    summary = fitted[checked.origin_stage.uid].metadata["sanityCheckerSummary"]
    text = [s.metadata["textStats"] for s in fitted.values()
            if "textStats" in s.metadata]
    return data[vec.name], summary, text


def write_result(name: str, vec, summary, text, store_vector: bool) -> None:
    cols = summary["columns"]
    record = {
        "num_rows": summary["numRows"],
        "num_columns": summary["numColumns"],
        "keep": [j for j, c in enumerate(cols) if not c["dropped"]],
        "reasons": {str(j): c["reasons"] for j, c in enumerate(cols)
                    if c["dropped"]},
        "names": [c["name"] for c in cols],
        "text_stats": text,
    }
    if store_vector:
        record["metadata"] = [c.to_json() for c in vec.metadata.columns]
    with open(os.path.join(OUT_DIR, f"{name}.json"), "w") as fh:
        json.dump(record, fh, indent=None)
    arrays = {k: np.array([c[k] for c in cols], dtype=np.float64)
              for k in ("mean", "variance", "corr_label")}
    if store_vector:
        arrays["vector"] = np.asarray(vec.values, dtype=np.float32)
    np.savez_compressed(os.path.join(OUT_DIR, f"{name}.npz"), **arrays)


def train_csv_model(ds, rows) -> None:
    import transmogrifai_tpu.dsl  # noqa: F401
    from transmogrifai_tpu.features import from_dataset
    from transmogrifai_tpu.models.gbdt import XGBoostClassifier
    from transmogrifai_tpu.ops import transmogrify
    from transmogrifai_tpu.selector import BinaryClassificationModelSelector
    from transmogrifai_tpu.utils import uid as uid_util
    from transmogrifai_tpu.workflow.workflow import Workflow

    uid_util.reset()
    resp, preds = from_dataset(ds, response="survived")
    vec = transmogrify(list(preds))
    checked = resp.sanity_check(vec, remove_bad_features=True)
    grid = {"num_round": [20], "max_depth": [6], "eta": [0.3],
            "max_bins": [32]}
    sel = BinaryClassificationModelSelector(
        seed=42, models=[(XGBoostClassifier(), grid)])
    pred = sel.set_input(resp, checked).get_output()
    model = Workflow().set_result_features(pred).set_input_dataset(ds).train()
    path = os.path.join(OUT_DIR, "csv_model")
    shutil.rmtree(path, ignore_errors=True)
    model.save(path)
    with open(os.path.join(path, "rows.json"), "w") as fh:
        json.dump(rows, fh)
    np.savez(os.path.join(path, "expected.npz"), **expected_scores(model, rows))


def main() -> None:
    import jax

    if jax.device_count() != 1:
        raise SystemExit("run with one JAX device (see the docstring)")
    from transmogrifai_tpu import types as T
    from transmogrifai_tpu.dataset import Dataset
    from transmogrifai_tpu.readers import infer_csv_dataset
    from transmogrifai_tpu.types.columns import column_from_values

    os.makedirs(OUT_DIR, exist_ok=True)
    twin = twin_dataset()
    with open(os.path.join(OUT_DIR, "flagship_table.json"), "w") as fh:
        json.dump(table_json(twin), fh)
    header, rows = csv_twin_rows(twin)
    csv_path = os.path.join(OUT_DIR, "titanic_twin.csv")
    with open(csv_path, "w", newline="", encoding="utf-8") as fh:
        w = csv.writer(fh)
        w.writerow(header)
        w.writerows(rows)
    csv_ds = infer_csv_dataset(csv_path)

    write_result("flagship", *feature_side(twin, "label"), store_vector=True)
    write_result("csv", *feature_side(csv_ds, "survived"), store_vector=True)
    schema, columns = wide_table()
    wide = Dataset.of({
        k: column_from_values(T.feature_type_by_name(schema[k]), v)
        for k, v in columns.items()
    })
    write_result("wide", *feature_side(wide, "label"), store_vector=False)
    train_csv_model(csv_ds, scoring_rows(csv_ds, MODEL_ROWS))
    with open(os.path.join(OUT_DIR, "config.json"), "w") as fh:
        json.dump({"csv_seed": CSV_SEED, "model_rows": MODEL_ROWS,
                   "jax": jax.__version__,
                   "jax_devices": jax.device_count()}, fh, indent=1)
    total = 0
    for dirpath, _, files in os.walk(OUT_DIR):
        total += sum(os.path.getsize(os.path.join(dirpath, f)) for f in files)
    print(f"wrote {OUT_DIR} ({total} bytes)")


if __name__ == "__main__":
    main()
