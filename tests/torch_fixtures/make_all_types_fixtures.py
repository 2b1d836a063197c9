"""Generate the all-types fixture that pins the PyTorch port's flow over every
type of ``transmogrify``'s default dispatch to the JAX package.

Run from the repository root, on the CPU, with ONE JAX device (do not set
``--xla_force_host_platform_device_count``):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_all_types_fixtures.py

It draws ``all_types.all_types_table(FLOW_ROWS, FLOW_SEED)`` with the JAX
package's ``testkit`` and trains ``all_types.train_flow("jax", ...)`` on it
(the RF and XGBoost candidates at ``RF_GRID`` / ``XGB_GRID``, 3-fold CV,
the refit lane), then writes ``tests/fixtures/torch_all_types/``:

* ``flow.json``: the selector summary (the keys of planes the port does not
  have yet dropped), the holdout row indices, the prediction and checked
  vector names, the train and holdout row counts, the vector's and the
  checked vector's widths, and the fused planner's refusal reason and
  counters after one batch of the fresh rows above the cutoff;
* ``scores.npz``: ``model.score`` of the holdout rows (``holdout_*``), and
  ``score_function(model).batch`` of ``all_types_table(FRESH_ROWS,
  FRESH_SEED)``'s rows at the default cutoff (``host_*``, the tree order)
  and with ``TPTPU_HOST_PREDICT_MAX=0`` (``device_*``, the device route;
  the fused planner refuses the plan, so the batch scores staged):
  ``prediction``, ``probability`` and ``raw``, float64;
* ``model/``: ``model.save(...)`` of the JAX package;
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
OUT_DIR = os.path.join(ROOT, "tests", "fixtures", "torch_all_types")
#: summary keys of planes the port does not have yet
UNPORTED_KEYS = ("compileStats", "featurizeStats", "distributedResilience")


def score_arrays(prefix: str, col) -> dict:
    return {f"{prefix}_prediction": np.asarray(col.prediction, np.float64),
            f"{prefix}_probability": np.asarray(col.probability, np.float64),
            f"{prefix}_raw": np.asarray(col.raw, np.float64)}


def batch_arrays(prefix: str, out: list[dict], pred_name: str) -> dict:
    rows = [r[pred_name] for r in out]
    return {f"{prefix}_prediction": np.array([r["prediction"] for r in rows]),
            f"{prefix}_probability": np.array(
                [[r["probability_0"], r["probability_1"]] for r in rows]),
            f"{prefix}_raw": np.array(
                [[r["rawPrediction_0"], r["rawPrediction_1"]] for r in rows])}


def main() -> None:
    import jax

    sys.path.insert(0, ROOT)
    sys.path.insert(0, HERE)
    import all_types as AT
    from transmogrifai_tpu import testkit as TK
    from transmogrifai_tpu.local.scoring import score_function

    if jax.device_count() != 1:
        raise SystemExit("run with one JAX device (see the docstring)")
    ds = AT.all_types_table(AT.FLOW_ROWS, AT.FLOW_SEED, TK)
    model, pred, checked, selector = AT.train_flow("jax", ds)
    _, holdout_idx = selector.splitter.split(ds.num_rows)
    summary = {k: v for k, v in
               model.summary_json()["modelSelectorSummary"].items()
               if k not in UNPORTED_KEYS}
    data = model.score(ds, keep_intermediate_features=True)
    vec_name = checked.origin_stage.input_features[-1].name
    arrays = score_arrays("holdout", model.score(ds.take(holdout_idx))[pred.name])

    fresh = AT.all_types_table(AT.FRESH_ROWS, AT.FRESH_SEED, TK)
    rows = fresh.rows([n for n in fresh.columns if n != "label"])
    arrays.update(batch_arrays("host", score_function(model).batch(rows),
                               pred.name))
    os.environ["TPTPU_HOST_PREDICT_MAX"] = "0"
    fn = score_function(model)
    arrays.update(batch_arrays("device", fn.batch(rows), pred.name))
    fused = fn.metadata()["fused"]
    del os.environ["TPTPU_HOST_PREDICT_MAX"]

    shutil.rmtree(OUT_DIR, ignore_errors=True)
    os.makedirs(OUT_DIR)
    model.save(os.path.join(OUT_DIR, "model"))
    record = {
        "summary": summary,
        "holdout_idx": [int(i) for i in holdout_idx],
        "pred_name": pred.name,
        "checked_name": checked.name,
        "train_rows": model.train_rows,
        "holdout_rows": model.holdout_rows,
        "vector_width": int(np.asarray(data[vec_name].values).shape[1]),
        "checked_width": int(np.asarray(data[checked.name].values).shape[1]),
        "fused": {k: fused[k] for k in ("active", "reason", "dispatches",
                                        "fallbacks", "fallbackReasons")},
    }
    with open(os.path.join(OUT_DIR, "flow.json"), "w") as fh:
        json.dump(record, fh, indent=1, default=float)
    np.savez(os.path.join(OUT_DIR, "scores.npz"), **arrays)
    with open(os.path.join(OUT_DIR, "config.json"), "w") as fh:
        json.dump({"jax": jax.__version__, "jax_devices": jax.device_count()},
                  fh, indent=1)
    print(summary["bestModelType"], summary["bestGrid"], record["fused"])


if __name__ == "__main__":
    main()
