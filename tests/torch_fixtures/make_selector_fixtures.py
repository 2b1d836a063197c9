"""Generate the selector fixtures that pin the PyTorch port's ``train()`` to
the JAX package at the default selector's grids.

Run from the repository root, on the CPU, with ONE JAX device (the JAX
package then sweeps its candidate families on a thread pool, as the port
does; do not set ``--xla_force_host_platform_device_count``):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_selector_fixtures.py

It runs the flagship five-line flow with the JAX package over the typed
twin (``tests/fixtures/torch_fit_side/flagship_table.json``, response
``label``): ``from_dataset`` -> ``transmogrify`` ->
``sanity_check(remove_bad_features=True)`` ->
``BinaryClassificationModelSelector()`` with its default candidates and
grids (LogisticRegression 8 points, RandomForestClassifier 18,
XGBoostClassifier 2; 3-fold CV, DataBalancer, the refit lane) ->
``Workflow().train()``, once as it is, once with ``with_workflow_cv()``
and once with only the default tree candidates
(``make_candidates("BinaryClassification", TREE_FAMILIES)``, whose winner
is a tree family), with the uid counter reset before each flow. Name flows
on the command line to write only those (``selector``, ``workflow_cv``,
``selector_trees``). It writes ``tests/fixtures/torch_selector/``:

* ``selector.json`` / ``workflow_cv.json`` / ``selector_trees.json``: the
  flow's
  ``summary_json()["modelSelectorSummary"]`` (validation results, winner,
  grid, candidate attempts, train and holdout evaluation, splitter
  summary; the keys of planes the port does not have yet dropped), the
  lead lines of ``summary_pretty()``, the holdout row indices, the
  prediction column's name and the train and holdout row counts;
* ``<flow>.npz``: ``model.score`` of the holdout
  rows (``prediction``, ``probability``, ``raw``, float64);
* ``config.json``: the JAX version and device count.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

TABLE = os.path.join(ROOT, "tests", "fixtures", "torch_fit_side",
                     "flagship_table.json")
OUT_DIR = os.path.join(ROOT, "tests", "fixtures", "torch_selector")
#: summary keys of planes the port does not have yet
UNPORTED_KEYS = ("compileStats", "featurizeStats", "distributedResilience")
#: the lines of ``summary_pretty`` up to the selected model's table
LEAD_LINES = 4
#: the default candidates of the tree-only flow
TREE_FAMILIES = ("OpRandomForestClassifier", "OpXGBoostClassifier")
#: flow name -> (workflow CV, tree candidates only)
FLOWS = {"selector": (False, False), "workflow_cv": (True, False),
         "selector_trees": (False, True)}


def lead_lines(pretty: str) -> list[str]:
    return pretty.splitlines()[:LEAD_LINES]


def flagship_dataset():
    from transmogrifai_tpu import types as T
    from transmogrifai_tpu.dataset import Dataset
    from transmogrifai_tpu.types.columns import column_from_values

    with open(TABLE) as fh:
        table = json.load(fh)
    return Dataset.of({
        k: column_from_values(T.feature_type_by_name(table["schema"][k]), v)
        for k, v in table["columns"].items()
    })


def train(workflow_cv: bool, trees_only: bool = False):
    import transmogrifai_tpu.dsl  # noqa: F401  (installs sanity_check)
    from transmogrifai_tpu.features import from_dataset
    from transmogrifai_tpu.ops import transmogrify
    from transmogrifai_tpu.selector import BinaryClassificationModelSelector
    from transmogrifai_tpu.selector.model_selector import make_candidates
    from transmogrifai_tpu.utils import uid
    from transmogrifai_tpu.workflow.workflow import Workflow

    uid.reset()
    ds = flagship_dataset()
    label, predictors = from_dataset(ds, response="label")
    checked = label.sanity_check(transmogrify(list(predictors)),
                                 remove_bad_features=True)
    models = (make_candidates("BinaryClassification", TREE_FAMILIES)
              if trees_only else None)
    selector = BinaryClassificationModelSelector(models=models)
    pred = selector.set_input(label, checked).get_output()
    wf = Workflow().set_result_features(pred).set_input_dataset(ds)
    if workflow_cv:
        wf = wf.with_workflow_cv()
    model = wf.train()
    _, holdout_idx = selector.splitter.split(ds.num_rows)
    return ds, model, pred, holdout_idx


def write(name: str) -> None:
    ds, model, pred, holdout_idx = train(*FLOWS[name])
    summary = {k: v for k, v in model.summary_json()["modelSelectorSummary"].items()
               if k not in UNPORTED_KEYS}
    col = model.score(ds.take(holdout_idx))[pred.name]
    record = {
        "summary": summary,
        "lead_lines": lead_lines(model.summary_pretty()),
        "holdout_idx": [int(i) for i in holdout_idx],
        "pred_name": pred.name,
        "train_rows": model.train_rows,
        "holdout_rows": model.holdout_rows,
    }
    with open(os.path.join(OUT_DIR, f"{name}.json"), "w") as fh:
        json.dump(record, fh, indent=1, default=float)
    np.savez(
        os.path.join(OUT_DIR, f"{name}.npz"),
        prediction=np.asarray(col.prediction, np.float64),
        probability=np.asarray(col.probability, np.float64),
        raw=np.asarray(col.raw, np.float64),
    )
    print(name, summary["bestModelType"], summary["bestGrid"])


def main() -> None:
    import jax

    if jax.device_count() != 1:
        raise SystemExit("run with one JAX device (see the docstring)")
    names = sys.argv[1:] or list(FLOWS)
    unknown = sorted(set(names) - set(FLOWS))
    if unknown:
        raise SystemExit(f"unknown flows {unknown}; choose from {list(FLOWS)}")
    os.makedirs(OUT_DIR, exist_ok=True)
    for name in names:
        write(name)
    with open(os.path.join(OUT_DIR, "config.json"), "w") as fh:
        json.dump({"jax": jax.__version__, "jax_devices": jax.device_count()},
                  fh, indent=1)


if __name__ == "__main__":
    main()
