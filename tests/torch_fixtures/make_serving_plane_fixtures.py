"""Generate the fixtures that pin the port's serving plane to the JAX
package's.

Run from the repository root, on the CPU (it trains and scores with the
JAX package; ~30 s):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_serving_plane_fixtures.py

It writes ``tests/fixtures/torch_serving_plane/``:

* ``trained/``, ``trained_fused/``: the models of the reference's service
  suite (``tests/test_serving_service.py``'s ``trained`` and
  ``trained_fused`` fixtures), trained by the JAX package and saved
  (``tests/torch_fixtures/serving_plane.py`` names their tables, seeds and
  grid);
* ``jax_results.json``: the JAX package's canary decision of
  ``serving_plane.canary`` (the ``xgb`` serving fixture the control, ``rf``
  the candidate, in the deterministic fleet load test ``CANARY``), which
  ``chip_smoke.py``'s ``serving_plane (d)`` holds the card's to.
"""
from __future__ import annotations

import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, HERE)

import serving_plane as S  # noqa: E402


def train_models() -> None:
    from transmogrifai_tpu.features import from_dataset
    from transmogrifai_tpu.models.logistic import LogisticRegression
    from transmogrifai_tpu.ops import transmogrify
    from transmogrifai_tpu.selector import BinaryClassificationModelSelector
    from transmogrifai_tpu.utils import uid as uid_util
    from transmogrifai_tpu.workflow.workflow import Workflow

    P = S.package("jax")
    for name, ds in (("trained", lambda: S.binary_ds(P, 120, 3)),
                     ("trained_fused", lambda: S.fused_ds(P))):
        uid_util.reset()
        data = ds()
        resp, preds = from_dataset(data, response="label")
        vec = transmogrify(list(preds))
        selector = BinaryClassificationModelSelector(
            seed=7, models=[(LogisticRegression(), {"reg_param": [0.01]})],
            num_folds=2,
        )
        pred = selector.set_input(resp, vec).get_output()
        model = Workflow().set_result_features(pred).set_input_dataset(
            data).train()
        path = os.path.join(S.PLANE, name)
        shutil.rmtree(path, ignore_errors=True)
        model.save(path)


def main() -> None:
    os.makedirs(S.PLANE, exist_ok=True)
    train_models()
    P = S.package("jax")
    S.reset(P)
    results = {"canary": S.canary(P)}
    with open(S.RESULTS, "w") as fh:
        json.dump(results, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(json.dumps(results["canary"]["decision"]))


if __name__ == "__main__":
    main()
