"""The quantized serving plane (``featurize/quantize.py`` and the fused
graph's quantize pass): the port's codec against the JAX package's on the
same columns, its decode on the device against a numpy gather, and
``score_function(model, quantized=True)`` against both the float32 plane
and the JAX package's quantized fused path on the CPU.

Tolerances: the codec's tables, codes and error ledger are EQUAL to the
JAX package's (the same float32 numpy). Tree scores through the
quantized plane EQUAL the float32 plane's (the codes are bin-aligned).
GLM probabilities within ``GLM_ATOL = 1e-6`` of the JAX package's quantized
fused path, predictions equal, raw margins within ``GLM_ATOL`` plus
``RAW_RTOL = 1e-6`` of their size (both float32 cores over the same decoded
plane, their products taken in other orders).
"""
import json
import os

import numpy as np
import pytest
import torch

from transmogrifai_tpu.compiler.fused import build_fused_plan as jax_build
from transmogrifai_tpu.featurize import quantize as JQ
from transmogrifai_tpu.local.scoring import score_function as jax_score_function
from transmogrifai_tpu.workflow.dag import compute_dag as jax_compute_dag
from transmogrifai_tpu.workflow.persistence import (
    load_workflow_model as jax_load_workflow_model,
)
from transmogrifai_tpu_torch.featurize import quantize as PQ
from transmogrifai_tpu_torch.local.scoring import score_function
from transmogrifai_tpu_torch.workflow.persistence import load_workflow_model

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

HERE = os.path.dirname(__file__)
GLM_ATOL = 1e-6
RAW_RTOL = 1e-6


def _path(name: str) -> str:
    sub = "torch_fused" if name.startswith("text") else "torch_serving"
    return os.path.join(HERE, "fixtures", sub, name)


def _rows(name: str, n: int) -> list[dict]:
    with open(os.path.join(_path(name), "rows.json")) as fh:
        rows = json.load(fh)
    return (rows * -(-n // len(rows)))[:n]


def _scores(out: list[dict]) -> np.ndarray:
    preds = [next(iter(r.values())) for r in out]
    return np.array([[p["prediction"], p["probability_0"], p["probability_1"],
                      p["rawPrediction_0"], p["rawPrediction_1"]]
                     for p in preds])


_RNG = np.random.default_rng(5)
_SORTED = np.sort(_RNG.normal(size=31)).astype(np.float32)
COLUMNS = {
    "affine": ("affine", (-2.0, 6.0)),
    "affine_tiny": ("affine", (1e-3, 1.5e-3)),
    "constant": ("affine", (4.25, 4.25)),
    "nonfinite": ("affine", (-np.inf, np.inf)),
    "bins": ("bins", _SORTED),
    "bins_dupes": ("bins", np.repeat(_SORTED[:10], 3)),
    "bins_nan": ("bins", np.concatenate([_SORTED[:5], [np.nan] * 26])),
    "bins_empty": ("bins", np.full(31, np.nan, np.float32)),
    "bins_too_many": ("bins", np.linspace(0, 1, 300)),
}
_VALUES = np.concatenate([
    _RNG.normal(size=400) * 3.0, _SORTED, np.nextafter(_SORTED, np.inf),
    [np.nan, np.inf, -np.inf, 0.0, -0.0, 4.25, 1e-3, 1.5e-3],
]).astype(np.float32)


def _make(module, kind, arg):
    cls = module.ColumnQuant
    return cls.affine(*arg) if kind == "affine" else cls.bins(arg)


@pytest.mark.parametrize("case", sorted(COLUMNS))
def test_column_codec_equals_the_reference(case):
    kind, arg = COLUMNS[case]
    got, want = _make(PQ, kind, arg), _make(JQ, kind, arg)
    if want is None:
        assert got is None
        return
    assert (got.mode, got.lo, got.hi, got.scale, got.quant_error) == (
        want.mode, want.lo, want.hi, want.scale, want.quant_error)
    assert np.array_equal(got.reps, want.reps)
    assert np.array_equal(got.encode(_VALUES), want.encode(_VALUES))
    assert got.to_json() == want.to_json()
    again = PQ.ColumnQuant.from_json(got.to_json())
    assert np.array_equal(again.reps, got.reps) and again.mode == got.mode


def test_plan_and_decode():
    cols = [_make(PQ, *COLUMNS[c]) for c in ("affine", "bins", "constant")]
    plan = PQ.QuantPlan(cols)
    ref = JQ.QuantPlan([_make(JQ, *COLUMNS[c])
                        for c in ("affine", "bins", "constant")])
    vals = np.stack([_VALUES] * 3, axis=1)
    codes = plan.encode(vals)
    assert np.array_equal(codes, ref.encode(vals))
    assert plan.descriptor() == ref.descriptor() == "q8abc"
    assert plan.errors() == ref.errors()
    assert plan.to_json() == ref.to_json()
    reps = plan.reps_table()
    got = PQ.dequantize(torch.from_numpy(codes), torch.from_numpy(reps))
    want = reps[np.arange(3)[None, :], codes.astype(np.int64)]
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    # bin-aligned codes re-bin to themselves: decoded values bin as the
    # originals do under the same thresholds
    thr = cols[1].thresholds
    dec = got.numpy()[:, 1]
    keep = ~np.isnan(_VALUES)
    assert np.array_equal((dec[keep, None] > thr[None]).sum(1),
                          (_VALUES[keep, None] > thr[None]).sum(1))


def _jax_quantized_describe(name: str) -> dict:
    model = jax_load_workflow_model(_path(name))
    plan = [model.fitted.get(s.uid, s)
            for layer in jax_compute_dag(list(model.result_features))
            for s in layer]
    return jax_build(plan, list(model.raw_features),
                     [f.name for f in model.result_features],
                     quantize=True).describe()


@pytest.mark.parametrize("name", ["xgb", "rf", "lr", "text_lr"])
def test_quantized_describe_equals_the_reference(name):
    """quantizedMembers, quantError, quantPlans, bytes per row and the
    fingerprint equal the JAX package's quantized build."""
    fn = score_function(load_workflow_model(_path(name), device="cpu"),
                        device="cpu", quantized=True)
    assert fn.prime_fused() is True
    got = fn.fused_state["program"].describe()
    assert got["quantized"] is True
    assert got == _jax_quantized_describe(name)


@pytest.mark.parametrize("name", ["xgb", "rf"])
def test_quantized_trees_equal_the_float32_plane(name, monkeypatch):
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    rows = _rows(name, 891)
    quant = score_function(load_workflow_model(_path(name), device="cpu"),
                           device="cpu", quantized=True)
    plain = score_function(load_workflow_model(_path(name), device="cpu"),
                           device="cpu")
    got = _scores(quant.batch(rows))
    assert np.array_equal(got, _scores(plain.batch(rows)))  # EQUAL
    md = quant.metadata()["fused"]
    assert (md["quantized"], md["dispatches"], md["fallbacks"]) == (True, 1, 0)
    prog = quant.fused_state["program"]
    assert prog.up_bytes_per_row < plain.fused_state["program"].up_bytes_per_row


@pytest.mark.parametrize("name", ["lr", "text_lr"])
def test_quantized_glm_within_tolerance_of_the_reference(name, monkeypatch):
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    rows = _rows(name, 300)
    fn = score_function(load_workflow_model(_path(name), device="cpu"),
                        device="cpu", quantized=True)
    got = _scores(fn.batch(rows))
    ref = jax_score_function(jax_load_workflow_model(_path(name)),
                             quantized=True)
    want = _scores(ref.batch(rows))
    assert ref.metadata()["fused"]["quantized"] is True
    assert np.array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:3], want[:, 1:3], rtol=0,
                               atol=GLM_ATOL)
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], rtol=RAW_RTOL,
                               atol=GLM_ATOL)


def test_quantized_none_defers_to_the_environment(monkeypatch):
    monkeypatch.setenv("TPTPU_FUSED_QUANT", "1")
    fn = score_function(load_workflow_model(_path("xgb"), device="cpu"),
                        device="cpu")
    assert fn.prime_fused() and fn.metadata()["fused"]["quantized"] is True
    off = score_function(load_workflow_model(_path("xgb"), device="cpu"),
                         device="cpu", quantized=False)
    assert off.prime_fused() and off.metadata()["fused"]["quantized"] is False
