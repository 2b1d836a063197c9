"""Generate the fixtures that pin the port's hardened scoring closure to the
JAX package's.

Run from the repository root, on the CPU (it trains and scores with the
JAX package; ~1 min):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_hardening_fixtures.py

It writes ``tests/fixtures/torch_hardening/``:

* ``twin/``, ``graph/``, ``shifted/``: the models of the reference's
  serving-sentinel and resilience suites, trained by the JAX package and
  saved (``tests/torch_fixtures/hardening.py`` names their tables, seeds
  and grids);
* ``jax_results.json``: the JAX closure's results and ``metadata()``
  counters for every scenario of ``hardening.CPU_SCENARIOS`` (key
  ``cpu``), and for the card's scenarios over the serving fixtures (key
  ``card``): (a) the clean counters, (b) the quarantine records, (c) the
  breaker's states and the default prediction, (d) the drift reports.
  (a), (b) and (d) run at 8192 rows, as on the card; (c)'s counters do
  not depend on the row count, so it runs at 512 rows with
  ``TPTPU_HOST_PREDICT_MAX=256``, where the JAX closure fuses.

The rows are the fixtures' own (their indices and the seeds are in
``hardening.py``), so the file stores no scoring rows.
"""
from __future__ import annotations

import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, HERE)

import hardening as H  # noqa: E402


def train_models() -> None:
    import transmogrifai_tpu.dsl  # noqa: F401  (Feature arithmetic)
    from transmogrifai_tpu.features import from_dataset
    from transmogrifai_tpu.models.logistic import LogisticRegression
    from transmogrifai_tpu.ops import transmogrify
    from transmogrifai_tpu.prep import SanityChecker
    from transmogrifai_tpu.selector import BinaryClassificationModelSelector
    from transmogrifai_tpu.utils import uid as uid_util
    from transmogrifai_tpu.workflow.workflow import Workflow

    P = H.package("jax")

    def selector(seed, grid):
        return BinaryClassificationModelSelector(
            seed=seed, models=[(LogisticRegression(), grid)], num_folds=2)

    def save(model, name):
        path = os.path.join(H.HARDENING, name)
        shutil.rmtree(path, ignore_errors=True)
        model.save(path)

    uid_util.reset()
    ds = H.binary_ds(P, 160, 3)
    resp, preds = from_dataset(ds, response="label")
    pred = selector(7, {"reg_param": [0.01]}).set_input(
        resp, transmogrify(list(preds))).get_output()
    save(Workflow().set_result_features(pred).set_input_dataset(ds).train(),
         "twin")

    uid_util.reset()
    ds = H.binary_ds(P, 120, 15)
    resp, preds = from_dataset(ds, response="label")
    checked = resp.transform_with(
        SanityChecker(remove_bad_features=True), transmogrify(list(preds)))
    pred = selector(17, {"reg_param": [0.01, 0.1],
                         "elastic_net_param": [0.1]}).set_input(
        resp, checked).get_output()
    save(Workflow().set_result_features(pred).set_input_dataset(ds).train(),
         "graph")

    uid_util.reset()
    ds = H.binary_ds(P, 160, 23)
    resp, preds = from_dataset(ds, response="label")
    pred = selector(7, {"reg_param": [0.01]}).set_input(
        resp, transmogrify(list(preds))).get_output()
    shifted = resp - 1.0
    save(Workflow().set_result_features(pred, shifted)
         .set_input_dataset(ds).train(), "shifted")


def main() -> int:
    os.makedirs(H.HARDENING, exist_ok=True)
    train_models()
    P = H.package("jax")
    cpu = {key: H.run_cpu(P, key) for key in H.CPU_SCENARIOS}
    card: dict = {}
    for name in ("xgb", "rf", "lr"):
        card[name] = {
            "clean": H.scenario_card_clean(P, name),
            "quarantine": H.public(H.scenario_card_quarantine(P, name)),
            "drift": H.scenario_card_drift(P, name),
        }
        os.environ["TPTPU_HOST_PREDICT_MAX"] = str(H.SMALL_CUTOFF)
        try:
            c = H.scenario_card_breaker(P, name, H.SMALL_FUSED_ROWS)
        finally:
            del os.environ["TPTPU_HOST_PREDICT_MAX"]
        c = H.public(c)
        if c["fused"] != [0, 0, 1]:
            raise AssertionError(f"{name}: JAX fused batches {c['fused']}")
        card[name]["breaker"] = c
        alerts = card[name]["drift"]["batch"]["alerts"]
        if alerts != [H.DRIFT_FEATURE]:
            raise AssertionError(f"{name}: drift alerts {alerts}")
    with open(H.RESULTS, "w") as fh:
        json.dump({"cpu": cpu, "card": card}, fh, sort_keys=True,
                  separators=(",", ":"))
    print(f"wrote {H.RESULTS}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
