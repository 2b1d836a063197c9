"""Generate the DSL-flow fixture that pins the PyTorch port's feature stages
off the default dispatch and its raw feature filter to the JAX package.

Run from the repository root, on the CPU, with ONE JAX device (do not set
``--xla_force_host_platform_device_count``):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_dsl_fixtures.py

It builds ``dsl_flow.tables("jax", SMALL_ROWS)`` and trains F1
(``dsl_flow.build_f1``: the derived features, the raw feature filter against
the scoring rows, the RF and XGBoost candidates at ``all_types``' small
grids) and F2 (``dsl_flow.build_f2`` on ``wide_hash_table(F2_ROWS)``), then
writes ``tests/fixtures/torch_dsl/``:

* ``flow.json``: per flow the selector summary (the keys of planes the port
  does not have yet dropped), the prediction, vector and checked vector
  names, the train and holdout rows, the vector's and the checked vector's
  widths and the sha256 of their float32 values and of their metadata
  (over the training table, through the fitted model), the derived
  features' names, the fused planner's counters after one batch and the
  program's host prefix stages; F1's
  filter results JSON and blocklist;
* ``scores.npz``: F1's ``score_function`` batch of ``FRESH_ROWS`` fresh rows
  at the default cutoff (``f1_host_*``) and with
  ``TPTPU_HOST_PREDICT_MAX=0`` (``f1_device_*``, staged: the planner refuses
  the plan); F2's batch of ``F2_FUSED_ROWS`` fresh rows fused
  (``f2_fused_*``, ``TPTPU_HOST_PREDICT_MAX=0``) and staged
  (``f2_staged_*``, ``TPTPU_FUSED=0``): ``prediction``, ``probability``,
  ``raw``;
* ``f1_model/``, ``f2_model/``: ``model.save(...)`` of the JAX package;
* ``config.json``: the JAX version and device count.

About 1.5 min.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT_DIR = os.path.join(ROOT, "tests", "fixtures", "torch_dsl")
#: summary keys of planes the port does not have yet
UNPORTED_KEYS = ("compileStats", "featurizeStats", "distributedResilience")
#: F2's training rows, and the fresh rows of its fused batch (a bucket)
F2_ROWS = 2048
F2_FUSED_ROWS = 256
FUSED_KEYS = ("active", "reason", "dispatches", "fallbacks",
              "fallbackReasons")


def fused_record(fn) -> dict:
    """The fused planner's counters after the batch, and the program's host
    prefix (``describe()["hostPrefixStages"]``, ``None`` without one)."""
    out = {k: fn.metadata()["fused"][k] for k in FUSED_KEYS}
    prog = fn.fused_state["program"]
    out["hostPrefixStages"] = (None if prog is None
                               else prog.describe()["hostPrefixStages"])
    return out


def digest(arr) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(arr, np.float32)).tobytes()
    ).hexdigest()


def metas_digest(col) -> str:
    metas = [{k: (list(v) if isinstance(v, tuple) else v)
              for k, v in dataclasses.asdict(c).items()}
             for c in col.metadata.columns]
    return hashlib.sha256(json.dumps(metas).encode()).hexdigest()


def batch_arrays(prefix: str, out: list[dict], pred_name: str) -> dict:
    rows = [r[pred_name] for r in out]
    return {f"{prefix}_prediction": np.array([r["prediction"] for r in rows]),
            f"{prefix}_probability": np.array(
                [[r["probability_0"], r["probability_1"]] for r in rows]),
            f"{prefix}_raw": np.array(
                [[r["rawPrediction_0"], r["rawPrediction_1"]] for r in rows])}


def flow_record(model, flow: dict, ds) -> dict:
    """The flow's names, rows, vector digests and selector summary."""
    vec_name = flow["checked"].origin_stage.input_features[-1].name
    data = model.score(ds, keep_intermediate_features=True)
    vec, checked = data[vec_name], data[flow["checked"].name]
    summary = {k: v for k, v in
               model.summary_json()["modelSelectorSummary"].items()
               if k not in UNPORTED_KEYS}
    return {
        "summary": summary, "pred_name": flow["pred"].name,
        "vector_name": vec_name, "checked_name": flow["checked"].name,
        "derived": {k: f.name for k, f in flow["derived"].items()},
        "train_rows": model.train_rows, "holdout_rows": model.holdout_rows,
        "vector_width": int(np.asarray(vec.values).shape[1]),
        "checked_width": int(np.asarray(checked.values).shape[1]),
        "vector_sha256": digest(vec.values),
        "vector_metadata_sha256": metas_digest(vec),
        "checked_sha256": digest(checked.values),
        "checked_metadata_sha256": metas_digest(checked),
    }


def main() -> None:
    import jax

    sys.path.insert(0, ROOT)
    sys.path.insert(0, HERE)
    import dsl_flow as D
    import fit_side_tables as FT
    from transmogrifai_tpu.local.scoring import score_function

    if jax.device_count() != 1:
        raise SystemExit("run with one JAX device (see the docstring)")
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    os.makedirs(OUT_DIR)
    arrays: dict = {}

    ds, score_ds = D.tables("jax", D.SMALL_ROWS)
    f1 = D.build_f1("jax", ds, score_ds)
    model = f1["workflow"].train()
    record = {"f1": flow_record(model, f1, ds)}
    record["f1"]["rff_results"] = model.rff_results
    record["f1"]["blocklisted"] = model.blocklisted
    rows = D.fresh_rows(D.dsl_table)
    pred = f1["pred"].name
    arrays.update(batch_arrays("f1_host", score_function(model).batch(rows),
                               pred))
    os.environ["TPTPU_HOST_PREDICT_MAX"] = "0"
    fn = score_function(model)
    arrays.update(batch_arrays("f1_device", fn.batch(rows), pred))
    record["f1"]["fused"] = fused_record(fn)
    del os.environ["TPTPU_HOST_PREDICT_MAX"]
    model.save(os.path.join(OUT_DIR, "f1_model"))

    ds2 = D.hash_tables("jax", F2_ROWS)
    f2 = D.build_f2("jax", ds2)
    model2 = f2["workflow"].train()
    record["f2"] = flow_record(model2, f2, ds2)
    rows2 = D.fresh_rows(FT.wide_hash_table, F2_FUSED_ROWS)
    pred2 = f2["pred"].name
    os.environ["TPTPU_HOST_PREDICT_MAX"] = "0"
    fn2 = score_function(model2)
    arrays.update(batch_arrays("f2_fused", fn2.batch(rows2), pred2))
    record["f2"]["fused"] = fused_record(fn2)
    os.environ["TPTPU_FUSED"] = "0"
    arrays.update(batch_arrays("f2_staged", score_function(model2).batch(rows2),
                               pred2))
    del os.environ["TPTPU_FUSED"], os.environ["TPTPU_HOST_PREDICT_MAX"]
    model2.save(os.path.join(OUT_DIR, "f2_model"))

    with open(os.path.join(OUT_DIR, "flow.json"), "w") as fh:
        json.dump(record, fh, indent=1, default=float)
    np.savez(os.path.join(OUT_DIR, "scores.npz"), **arrays)
    with open(os.path.join(OUT_DIR, "config.json"), "w") as fh:
        json.dump({"jax": jax.__version__, "jax_devices": jax.device_count(),
                   "f2_rows": F2_ROWS, "f2_fused_rows": F2_FUSED_ROWS},
                  fh, indent=1)
    for name in ("f1", "f2"):
        s = record[name]["summary"]
        print(name, s["bestModelType"], s["bestGrid"], record[name]["fused"])
    print("blocklisted", record["f1"]["blocklisted"])


if __name__ == "__main__":
    main()
