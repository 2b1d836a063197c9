"""The serving fixtures above 16384 rows: the PyTorch port's scores equal
the JAX package's device route, BIT FOR BIT.

The xgb and rf fixtures (JAX-trained and saved; 200 depth-10 rounds and 50
depth-12 trees) score their rows repeated to 300 rows, above
``TPTPU_HOST_PREDICT_MAX`` lowered to 256 (both packages read it per call,
and the route's order depends on the batch only through it and the
one-hot budget), through each package's ``predict_arrays``: every output
equal. (The order itself, and the routing at the default 16384, are pinned
in ``test_torch_device_route.py``; at 16385 rows a reference run takes
about 45 s a fixture on the CPU.)
"""
import json
import os

import numpy as np
import pytest
import torch

from transmogrifai_tpu.workflow.persistence import (
    load_workflow_model as jax_load_workflow_model,
)
from transmogrifai_tpu_torch.workflow.persistence import load_workflow_model

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_serving")
#: rows of the batch, and the lowered threshold below them
ROWS, HOST_MAX = 300, 256


def _fixture_vector(model, rows, n):
    """The feature vector the port's plan hands its predictor, for the
    fixture's rows repeated to ``n``."""
    from transmogrifai_tpu_torch.types.columns import column_from_values

    cols = {f.name: column_from_values(f.ftype, [r.get(f.name) for r in rows])
            for f in model.raw_features}
    plan = model.stage_plan()
    for stage in plan[:-1]:
        cols[stage.output_name] = stage.transform_columns(
            *[cols[name] for name in stage.input_names], num_rows=len(rows))
    vec = np.asarray(cols[plan[-1].input_names[-1]].values, np.float32)
    return np.resize(vec, (n, vec.shape[1]))


@pytest.mark.parametrize("name", ["xgb", "rf"])
def test_fixture_scores_above_16384_rows_equal_the_reference(name,
                                                             monkeypatch):
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", str(HOST_MAX))
    path = os.path.join(FIXTURES, name)
    with open(os.path.join(path, "rows.json")) as fh:
        rows = json.load(fh)
    pm = load_workflow_model(path, device="cpu")
    jm = jax_load_workflow_model(path)
    vec = _fixture_vector(pm, rows, ROWS)

    def best(model):
        return next(s for s in model.fitted.values()
                    if hasattr(s, "best_model")).best_model

    pb, jb = best(pm), best(jm)
    pb.to("cpu")
    assert not jb._use_host(vec) and not pb._use_host(vec)
    for got, want in zip(pb.predict_arrays(vec), jb.predict_arrays(vec)):
        assert np.count_nonzero(got != want) == 0
