"""End-to-end serving parity: models the JAX package trains and saves are
loaded by the PyTorch port and scored on the CPU with
``score_function(model, device="cpu")``; the results must match the JAX
package's own ``score_function`` on the same rows. Also pins the committed
fixtures (``tests/fixtures/torch_serving/``, made by
``tests/torch_fixtures/make_serving_fixtures.py``): the port reproduces
their stored scores, and so does the JAX package loading the same
directory, so neither side can drift from them unnoticed.

Tolerance: none (``PROB_ATOL`` is 0). Predictions, probabilities and raw
scores are equal: both packages serve these batches (up to 16384 rows) by
summing the trees in tree order into one float32 accumulator per row and
taking the same separately rounded epilogue (``models/tree_sum.py``), and
the float64 host tail is the same numpy code.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import transmogrifai_tpu.dsl  # noqa: F401  (installs sanity_check)
import transmogrifai_tpu.types as T
from transmogrifai_tpu.dataset import Dataset
from transmogrifai_tpu.features import from_dataset
from transmogrifai_tpu.local.scoring import score_function as jax_score_function
from transmogrifai_tpu.models.gbdt import RandomForestClassifier, XGBoostClassifier
from transmogrifai_tpu.ops import transmogrify
from transmogrifai_tpu.selector import BinaryClassificationModelSelector
from transmogrifai_tpu.types.columns import column_from_values
from transmogrifai_tpu.workflow.persistence import (
    load_workflow_model as jax_load_workflow_model,
)
from transmogrifai_tpu.workflow.workflow import Workflow
from transmogrifai_tpu_torch.local.scoring import score_function
from transmogrifai_tpu_torch.types.columns import VectorColumn as PortVectorColumn
from transmogrifai_tpu_torch.types.columns import (
    column_from_values as port_column_from_values,
)
from transmogrifai_tpu_torch.workflow.persistence import load_workflow_model

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

PROB_ATOL = 0.0
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_serving")


def _flatten(out: list[dict]) -> dict[str, np.ndarray]:
    preds = [next(iter(r.values())) for r in out]
    return {
        "prediction": np.array([p["prediction"] for p in preds]),
        "probability": np.array(
            [[p["probability_0"], p["probability_1"]] for p in preds]
        ),
        "raw": np.array(
            [[p["rawPrediction_0"], p["rawPrediction_1"]] for p in preds]
        ),
    }


def _assert_scores_match(got: dict, want: dict) -> None:
    assert np.array_equal(got["prediction"], want["prediction"])
    for key in ("probability", "raw"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=PROB_ATOL)


def _small_dataset(n: int = 200):
    rng = np.random.default_rng(31)
    x1 = rng.normal(size=n)
    x1_vals = [None if m else float(v) for v, m in zip(x1, rng.random(n) < 0.15)]
    x2 = rng.integers(0, 5, size=n)
    flag = rng.random(n) < 0.4
    flag_vals = [None if m else bool(v) for v, m in zip(flag, rng.random(n) < 0.1)]
    score = rng.normal(size=n)
    city = [["sf", "la", "ny", "sea"][i] for i in rng.integers(0, 4, size=n)]
    city = [None if m else c for c, m in zip(city, rng.random(n) < 0.1)]
    label = (
        np.nan_to_num(x1) + 0.3 * x2 - 0.8 * flag + 0.5 * score
        + 0.3 * rng.normal(size=n) > 0.5
    ).astype(float)
    ds = Dataset.of({
        "label": column_from_values(T.RealNN, label),
        "x1": column_from_values(T.Real, x1_vals),
        "x2": column_from_values(T.Integral, x2.tolist()),
        "flag": column_from_values(T.Binary, flag_vals),
        "score": column_from_values(T.RealNN, score.tolist()),
        "city": column_from_values(T.PickList, city),
    })
    rows = [
        {"x1": a, "x2": int(b), "flag": c, "score": float(d), "city": e}
        for a, b, c, d, e in zip(x1_vals, x2, flag_vals, score, city)
    ]
    return ds, rows


_CANDIDATES = {
    "xgb": lambda: (XGBoostClassifier(num_round=10, max_depth=3), {"eta": [0.3]}),
    "rf": lambda: (
        RandomForestClassifier(num_trees=8, max_depth=3), {"min_info_gain": [0.0]}
    ),
}


@pytest.fixture(scope="module", params=sorted(_CANDIDATES))
def trained(request, tmp_path_factory):
    """A small flagship-flow model per family, trained and saved by the JAX
    package: (model, dataset, rows, saved directory)."""
    ds, rows = _small_dataset()
    resp, preds = from_dataset(ds, response="label")
    vec = resp.sanity_check(transmogrify(list(preds)), remove_bad_features=True)
    sel = BinaryClassificationModelSelector(
        seed=7, num_folds=2, models=[_CANDIDATES[request.param]()]
    )
    pred = sel.set_input(resp, vec).get_output()
    model = Workflow().set_result_features(pred).set_input_dataset(ds).train()
    path = str(tmp_path_factory.mktemp(request.param) / "model")
    model.save(path)
    return model, ds, rows, path


def test_port_scores_a_jax_trained_model(trained):
    model, _, rows, path = trained
    want = _flatten(jax_score_function(model).batch(rows))
    fn = score_function(load_workflow_model(path, device="cpu"), device="cpu")
    _assert_scores_match(_flatten(fn.batch(rows)), want)
    # one row alone scores as it does inside the batch
    single = _flatten([fn(rows[3])])
    assert single["prediction"][0] == want["prediction"][3]
    np.testing.assert_allclose(
        single["probability"][0], want["probability"][3], rtol=0, atol=PROB_ATOL
    )


def test_port_vectors_identical_to_reference(trained):
    """Every vector the port's fitted vectorizers, combiner and removal
    model emit equals the reference's intermediate column bit for bit,
    metadata included."""
    model, ds, rows, path = trained
    ref = model.score(dataset=ds, keep_intermediate_features=True)
    port = load_workflow_model(path, device="cpu")
    cols = {
        f.name: port_column_from_values(
            f.ftype, [r.get(f.name) for r in rows] if not f.is_response
            else ds[f.name].values.tolist()
        )
        for f in port.raw_features
    }
    compared = set()
    for stage in port.stage_plan():
        out = stage.transform_columns(
            *[cols[n] for n in stage.input_names], num_rows=len(rows)
        )
        cols[stage.output_name] = out
        if not isinstance(out, PortVectorColumn):
            continue
        want = ref[stage.output_name]
        assert np.array_equal(out.values, np.asarray(want.values))
        assert [dataclasses.astuple(c) for c in out.metadata.columns] == [
            dataclasses.astuple(c) for c in want.metadata.columns
        ]
        compared.add(type(stage).__name__)
    assert compared >= {
        "NumericVectorizerModel", "OneHotModel", "BinaryVectorizer",
        "RealNNVectorizer", "VectorsCombiner", "FeatureRemovalModel",
    }


def _fixture(name: str):
    path = os.path.join(FIXTURES, name)
    with open(os.path.join(path, "rows.json")) as fh:
        rows = json.load(fh)
    with np.load(os.path.join(path, "expected.npz")) as z:
        want = {k: z[k] for k in z.files}
    return path, rows, want


@pytest.mark.parametrize("name", ["xgb", "rf"])
def test_port_reproduces_fixture(name):
    path, rows, want = _fixture(name)
    fn = score_function(load_workflow_model(path, device="cpu"), device="cpu")
    _assert_scores_match(_flatten(fn.batch(rows)), want)


@pytest.mark.parametrize("name", ["xgb", "rf"])
def test_jax_package_still_reproduces_fixture(name):
    path, rows, want = _fixture(name)
    got = _flatten(jax_score_function(jax_load_workflow_model(path)).batch(rows))
    _assert_scores_match(got, want)


def test_fixtures_hold_the_flagship_widths():
    """The xgb fixture is the default selector's 200-round depth-10 point
    over 32 bins; the rf fixture is 50 trees at depth 12."""
    widths = {}
    for name in ("xgb", "rf"):
        with np.load(os.path.join(FIXTURES, name, "arrays.npz")) as z:
            sf = next(z[k] for k in z.files if k.endswith("split_feat"))
            thr = next(z[k] for k in z.files if k.endswith("thresholds"))
        widths[name] = (sf.shape[0], sf.shape[1], thr.shape[1] + 1)
    assert widths == {"xgb": (200, 10, 32), "rf": (50, 12, 32)}
