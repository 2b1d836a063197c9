"""How far a sharded ``train()`` lies from the same ``train()`` on one
device, in the port and in the JAX package, on the same table.

The flow is the card phase's twin (``chip_smoke.parallel_train``): the
wide hash table (``fit_side_tables.wide_hash_table``, 1419 vector
columns), ``transmogrify`` -> ``sanity_check`` -> the default binary
selector with the cut tree grids (``chip_smoke.FAMILY_TREE_GRIDS``). Each
package trains it on one device and sharded over two: the JAX package
under ``make_mesh(n_data=2)`` on two of eight simulated CPU devices, the
port over a world of two ``gloo`` ranks on the CPU. Both score their
training rows. One JSON line per package: the winner, the largest
probability difference, the number of probability cells past the
reference's ``tests/test_workflow_mesh.py`` tolerance (rtol 1e-3 / atol
1e-5), and the largest fold-metric difference per family.

Run from the repository root (CPU only, a few minutes at 4096 rows):

    python tests/torch_fixtures/sharded_drift.py --rows 4096
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def _selector(MS, **kw):
    from chip_smoke import FAMILY_TREE_GRIDS

    default = MS.BinaryClassificationModelSelector(**kw)
    return MS.BinaryClassificationModelSelector(models=[
        (e, FAMILY_TREE_GRIDS.get(type(e).__name__, g))
        for e, g in default.models])


def _result(model, pred, ds) -> dict:
    import numpy as np

    summary = model.summary_json()["modelSelectorSummary"]
    return {"winner": summary["bestModelName"],
            "folds": [(r["modelName"], r["grid"], r["metricValues"])
                      for r in summary["validationResults"]],
            "prob": np.asarray(model.score(dataset=ds)[pred.name].probability)}


def port_train(rows: int, sharded: bool) -> dict:
    """The port's flow on the CPU; ``sharded``: over the world's data
    mesh (every rank returns the same)."""
    from fit_side_tables import wide_hash_table

    from transmogrifai_tpu_torch import types as T
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.features import from_dataset
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.parallel import make_mesh
    from transmogrifai_tpu_torch.selector import model_selector as MS
    from transmogrifai_tpu_torch.types.columns import column_from_values
    from transmogrifai_tpu_torch.utils import uid
    from transmogrifai_tpu_torch.workflow.workflow import Workflow

    schema, columns = wide_hash_table(rows)
    ds = Dataset.of({k: column_from_values(T.feature_type_by_name(schema[k]), v)
                     for k, v in columns.items()})
    uid.reset()
    label, preds = from_dataset(ds, response="label")
    checked = label.sanity_check(transmogrify(list(preds)),
                                 remove_bad_features=True, device="cpu")
    pred = _selector(MS, device="cpu").set_input(label, checked).get_output()
    mesh = make_mesh(device="cpu") if sharded else None
    model = (Workflow().set_result_features(pred).set_input_dataset(ds)
             .set_parallelism(mesh).train())
    return _result(model, pred, ds)


def jax_train(rows: int, n_data: int | None) -> dict:
    """The JAX package's flow on its CPU devices; ``n_data``: sharded
    under ``make_mesh(n_data=n_data)``, None: one device."""
    from fit_side_tables import wide_hash_table

    from transmogrifai_tpu.dataset import Dataset
    from transmogrifai_tpu.features import from_dataset
    from transmogrifai_tpu.ops.transmogrify import transmogrify
    from transmogrifai_tpu.parallel import make_mesh
    from transmogrifai_tpu.selector import model_selector as MS
    from transmogrifai_tpu.types import feature_type_by_name
    from transmogrifai_tpu.types.columns import column_from_values
    from transmogrifai_tpu.utils import uid
    from transmogrifai_tpu.workflow.workflow import Workflow

    schema, columns = wide_hash_table(rows)
    ds = Dataset.of({k: column_from_values(feature_type_by_name(schema[k]), v)
                     for k, v in columns.items()})
    uid.reset()
    label, preds = from_dataset(ds, response="label")
    checked = label.sanity_check(transmogrify(list(preds)),
                                 remove_bad_features=True)
    pred = _selector(MS).set_input(label, checked).get_output()
    mesh = None if n_data is None else make_mesh(n_data=n_data)
    model = (Workflow().set_result_features(pred).set_input_dataset(ds)
             .set_parallelism(mesh).train())
    return _result(model, pred, ds)


def drift(one: dict, sharded: dict) -> dict:
    import numpy as np

    a, b = one["prob"], sharded["prob"]
    fold = {}
    for (m1, g1, v1), (m2, g2, v2) in zip(one["folds"], sharded["folds"]):
        assert (m1, g1) == (m2, g2), "the candidates differ"
        err = float(np.abs(np.subtract(v1, v2)).max())
        fold[m1] = max(fold.get(m1, 0.0), err)
    return {"winner": one["winner"], "sharded_winner": sharded["winner"],
            "prob_max_abs_err": float(np.abs(a - b).max()),
            "prob_cells_past_tolerance": int(
                (np.abs(a - b) > 1e-5 + 1e-3 * np.abs(a)).sum()),
            "prob_cells": int(a.size), "fold_metric_max_abs_err": fold}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=4096)
    args = ap.parse_args()
    sys.path[:0] = [HERE, ROOT]
    import torch

    torch.set_num_threads(1)
    import world

    with tempfile.TemporaryDirectory() as tmp:
        ranks = world.run_world(2, "sharded_drift:port_train",
                                (args.rows, True), tmp, deadline=1800)
    one = port_train(args.rows, False)
    print(json.dumps({"package": "port", "rows": args.rows,
                      "shards": "2 gloo ranks (CPU)",
                      **drift(one, ranks[0][0])}), flush=True)
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + (
        " --xla_force_host_platform_device_count=8")).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps({"package": "jax", "rows": args.rows,
                      "shards": "make_mesh(n_data=2), CPU devices",
                      **drift(jax_train(args.rows, None),
                              jax_train(args.rows, 2))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
