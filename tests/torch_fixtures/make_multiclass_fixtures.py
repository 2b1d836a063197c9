"""Generate the multiclass fixtures that pin the PyTorch port's multiclass
flow to the JAX package.

Run from the repository root, on the CPU, with ONE JAX device (do not set
``--xla_force_host_platform_device_count``; a scratch compile cache keeps
the JAX package's executable bank out of the repository):

    TPTPU_COMPILE_CACHE=/tmp/tptpu_cache JAX_PLATFORMS=cpu \\
        python tests/torch_fixtures/make_multiclass_fixtures.py

It builds ``multiclass_flow.multiclass_table()`` (600 rows, a four-class
PickList label) with the JAX package and runs each flow of
``multiclass_flow.FLOWS``: ``from_dataset(response_type=PickList)`` ->
``string_indexed`` -> ``transmogrify`` ->
``sanity_check(remove_bad_features=True)`` ->
``MultiClassificationModelSelector(models=...)`` over the flow's families
at ``multiclass_flow.GRIDS`` -> ``Workflow().train()`` (about 10 s a flow).
It writes ``tests/fixtures/torch_multiclass/``:

* ``<flow>.json``: the selector summary (the keys of planes the port does
  not have yet dropped), the indexer's labels, the checked vector's column
  names, the holdout row indices, the prediction column's name and the
  train and holdout row counts;
* ``<flow>.npz``: the checked vector ``x`` and indexed label ``y`` of every
  row, and ``model.score`` of the holdout rows (``prediction``,
  ``probability``, ``raw``);
* ``model/``: the ``multiclass_trees`` flow's model as the JAX package
  saves it (a tree winner), and ``scores.npz``: its scores of the table's
  first ``FUSED_ROWS`` rows through ``score_function``, staged
  (``staged_*``, the host route) and fused above a lowered
  ``TPTPU_HOST_PREDICT_MAX`` (``fused_*``, one XLA program holding every
  class stack);
* ``fits.npz``: on the ``multiclass_trees`` flow's vector, the trees of
  ``multiclass_flow.DIRECT_FITS`` (``<name>__c<k>__<array>``) and of a
  decision-tree regressor on the label (``dt_reg__<array>``), fitted on the
  first of ``sweep_masks``, and the random forest's multiclass sweep over
  ``RF_SWEEP_POINTS`` x ``sweep_masks`` (``rf_sweep__<array>`` [K * C, T,
  ...] and ``rf_sweep__outputs`` [K * C, N]);
* ``config.json``: the JAX version and device count.
"""
from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import multiclass_flow as MF  # noqa: E402

#: summary keys of planes the port does not have yet
UNPORTED_KEYS = ("compileStats", "featurizeStats", "distributedResilience")


def column_arrays(col) -> dict:
    return {"prediction": np.asarray(col.prediction, np.float64),
            "probability": np.asarray(col.probability, np.float64),
            "raw": np.asarray(col.raw, np.float64)}


def indexer_labels(model) -> list[str]:
    from transmogrifai_tpu.ops.text_stages import OpStringIndexerModel

    return next(s.labels for s in model.fitted.values()
                if isinstance(s, OpStringIndexerModel))


def write_flow(name: str, ds) -> tuple:
    model, pred, selector, _ = MF.train("jax", ds, MF.FLOWS[name])
    summary = {k: v for k, v in model.summary_json()["modelSelectorSummary"].items()
               if k not in UNPORTED_KEYS}
    _, holdout_idx = selector.splitter.split(ds.num_rows)
    data = model.score(ds, keep_intermediate_features=True)
    info = model.selector_info
    x = np.asarray(data[info["vectorName"]].values, dtype=np.float32)
    y = np.asarray(data[info["labelName"]].values, dtype=np.float32)
    record = {
        "summary": summary,
        "labels": indexer_labels(model),
        "vector_columns": data[info["vectorName"]].metadata.column_names(),
        "holdout_idx": [int(i) for i in holdout_idx],
        "pred_name": pred.name,
        "train_rows": model.train_rows,
        "holdout_rows": model.holdout_rows,
    }
    with open(os.path.join(MF.FIXTURE, f"{name}.json"), "w") as fh:
        json.dump(record, fh, indent=1, default=float)
    np.savez(os.path.join(MF.FIXTURE, f"{name}.npz"), x=x, y=y,
             **column_arrays(model.score(ds.take(holdout_idx))[pred.name]))
    print(name, summary["bestModelType"], summary["bestGrid"])
    return model, pred, x, y


def write_model(model, pred, ds) -> None:
    from transmogrifai_tpu.local.scoring import score_function

    path = os.path.join(MF.FIXTURE, "model")
    if os.path.isdir(path):
        shutil.rmtree(path)
    model.save(path)
    rows = ds.take(np.arange(MF.FUSED_ROWS)).rows()
    out = {}
    for route, cutoff in (("staged", "16384"), ("fused", str(MF.FUSED_ROWS // 2))):
        os.environ["TPTPU_HOST_PREDICT_MAX"] = cutoff
        fn = score_function(model)
        got = fn.batch(rows)
        if route == "fused" and not fn.metadata()["fused"]["dispatches"]:
            raise SystemExit("the JAX package did not fuse the batch")
        name = pred.name
        c = len(model.fitted[model.selector_info["estimatorUid"]]
                .best_model._tree_stacks()[0])
        out[f"{route}_prediction"] = np.asarray([r[name]["prediction"] for r in got])
        out[f"{route}_probability"] = np.asarray(
            [[r[name][f"probability_{k}"] for k in range(c)] for r in got])
        out[f"{route}_raw"] = np.asarray(
            [[r[name][f"rawPrediction_{k}"] for k in range(c)] for r in got])
    os.environ.pop("TPTPU_HOST_PREDICT_MAX")
    np.savez(os.path.join(MF.FIXTURE, "scores.npz"), **out)


def tree_arrays(prefix: str, stacks) -> dict:
    from transmogrifai_tpu.models import gbdt as JG

    out = {}
    for k, t in enumerate(stacks):
        for field, a in JG._host_trees(t)._asdict().items():
            out[f"{prefix}__c{k}__{field}"] = np.asarray(a)
    return out


def write_fits(x, y) -> None:
    from transmogrifai_tpu.models import gbdt as JG

    masks = MF.sweep_masks(len(y))
    out = {}
    for name, (family, params) in MF.DIRECT_FITS.items():
        model = MF.estimator("jax", family, **params).fit_arrays(x, y, masks[0])
        stacks = getattr(model, "trees_per_class", None) or model.forests_per_class
        out.update(tree_arrays(name, stacks))
    reg = JG.DecisionTreeRegressor(max_depth=5).fit_arrays(x, y, masks[0])
    for field, a in JG._host_trees(reg.trees)._asdict().items():
        out[f"dt_reg__{field}"] = np.asarray(a)
    models = JG.RandomForestClassifier().fit_arrays_batched_masks(
        x, y, masks, MF.RF_SWEEP_POINTS)
    stack = models[0][0]._sweep_stack
    for field, a in stack["trees"]._asdict().items():
        out[f"rf_sweep__{field}"] = np.asarray(a)
    out["rf_sweep__outputs"] = np.asarray(stack["outputs"])
    np.savez(os.path.join(MF.FIXTURE, "fits.npz"), **out)


def main() -> None:
    import jax

    if jax.device_count() != 1:
        raise SystemExit("run with one JAX device (see the docstring)")
    os.makedirs(MF.FIXTURE, exist_ok=True)
    schema, columns = MF.multiclass_table()
    ds = MF.dataset("jax", schema, columns)
    write_flow("multiclass", ds)
    model, pred, x, y = write_flow("multiclass_trees", ds)
    write_model(model, pred, ds)
    write_fits(x, y)
    with open(os.path.join(MF.FIXTURE, "config.json"), "w") as fh:
        json.dump({"jax": jax.__version__, "jax_devices": jax.device_count()},
                  fh, indent=1)


if __name__ == "__main__":
    main()
