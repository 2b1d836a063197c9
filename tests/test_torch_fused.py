"""The fused scoring graph (``compiler/fused.py`` with ``local/scoring.py``'s
routing): models the JAX package trained and saved are scored by the PyTorch
port's fused program on the CPU, by its staged loop, and by the JAX
package's own fused program (``TPTPU_HOST_PREDICT_MAX=0`` sends every batch
there in both packages).

Tolerances: tree scores EQUAL (no tolerance): both fused programs and the
staged loop above the cutoff sum the trees in the reference's device-route
order and share the float64 epilogue. GLM probabilities within
``GLM_ATOL = 1e-6`` of the staged path and of the JAX package's fused path
(the reference's own contract: the fused core is a float32 ``plane @ w +
b`` where the staged core is float64), predictions equal, and raw margins
within ``GLM_ATOL`` plus ``RAW_RTOL = 1e-6`` of their size (a few float32
ulps of the margin or of its terms: two float32 products of the same terms
in other orders, or a float32 against a float64 one).
"""
import json
import os

import numpy as np
import pytest
import torch

from transmogrifai_tpu.compiler.fused import Unfuseable as JaxUnfuseable
from transmogrifai_tpu.compiler.fused import build_fused_plan as jax_build
from transmogrifai_tpu.features import FeatureBuilder as JaxFeatureBuilder
from transmogrifai_tpu.local.scoring import score_function as jax_score_function
from transmogrifai_tpu.ops.categorical import OneHotModel as JaxOneHotModel
from transmogrifai_tpu.workflow.dag import compute_dag as jax_compute_dag
from transmogrifai_tpu.workflow.persistence import (
    load_workflow_model as jax_load_workflow_model,
)
from transmogrifai_tpu_torch.compiler.fused import Unfuseable
from transmogrifai_tpu_torch.dataset import Dataset
from transmogrifai_tpu_torch.features import FeatureBuilder
from transmogrifai_tpu_torch.local.scoring import bucket, score_function
from transmogrifai_tpu_torch.models import serve_trees as ST
from transmogrifai_tpu_torch.ops.categorical import OneHotModel
from transmogrifai_tpu_torch.types.columns import column_from_values
from transmogrifai_tpu_torch.utils.cuda_build import KernelLaunchError
from transmogrifai_tpu_torch.workflow.persistence import load_workflow_model

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

HERE = os.path.dirname(__file__)
SERVING = os.path.join(HERE, "fixtures", "torch_serving")
FUSED = os.path.join(HERE, "fixtures", "torch_fused")
CSV_MODEL = os.path.join(HERE, "fixtures", "torch_fit_side", "csv_model")
GLM_ATOL = 1e-6
RAW_RTOL = 1e-6
TREES = {"xgb", "rf", "text_xgb"}


def _path(name: str) -> str:
    return os.path.join(FUSED if name.startswith("text") else SERVING, name)


def _rows(name: str, n: int) -> list[dict]:
    with open(os.path.join(_path(name), "rows.json")) as fh:
        rows = json.load(fh)
    return (rows * -(-n // len(rows)))[:n]


def _scores(out: list[dict]) -> np.ndarray:
    """[N, 5]: prediction, probabilities, raw margins."""
    preds = [next(iter(r.values())) for r in out]
    return np.array([[p["prediction"], p["probability_0"], p["probability_1"],
                      p["rawPrediction_0"], p["rawPrediction_1"]]
                     for p in preds])


def _assert_close(name: str, got: np.ndarray, want: np.ndarray) -> None:
    assert np.array_equal(got[:, 0], want[:, 0])
    if name in TREES:
        assert np.array_equal(got, want)  # EQUAL, not allclose
    else:
        np.testing.assert_allclose(got[:, 1:3], want[:, 1:3], rtol=0,
                                   atol=GLM_ATOL)
        np.testing.assert_allclose(got[:, 3:], want[:, 3:], rtol=RAW_RTOL,
                                   atol=GLM_ATOL)


def _port(name: str, **kw):
    fn = score_function(load_workflow_model(_path(name), device="cpu"),
                        device="cpu", **kw)
    return fn


def _staged(fn, call, monkeypatch):
    """``call`` with the fused path opted out (read per batch)."""
    monkeypatch.setenv("TPTPU_FUSED", "0")
    try:
        return call()
    finally:
        monkeypatch.delenv("TPTPU_FUSED")


def _jax_describe(path: str, **kw) -> dict:
    model = jax_load_workflow_model(path)
    plan = [model.fitted.get(s.uid, s)
            for layer in jax_compute_dag(list(model.result_features))
            for s in layer]
    return jax_build(plan, list(model.raw_features),
                     [f.name for f in model.result_features], **kw).describe()


@pytest.mark.parametrize("name", ["xgb", "rf", "lr", "text_lr", "text_xgb"])
def test_describe_equals_the_reference(name):
    """Members, widths, gathers, bytes per row, covered stages and the
    fingerprint equal the JAX package's ``build_fused_plan`` on the same
    saved model."""
    fn = _port(name)
    assert fn.prime_fused() is True
    got = fn.fused_state["program"].describe()
    assert got == _jax_describe(_path(name))
    assert got["fingerprint"] == fn.metadata()["fused"]["fingerprint"]


@pytest.mark.parametrize("rows", [1, 48, 891])
@pytest.mark.parametrize("name", ["xgb", "rf", "lr"])
def test_fused_scores_equal_staged_and_the_reference(name, rows, monkeypatch):
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    batch = _rows(name, rows)
    fn = _port(name)
    fused = _scores(fn.batch(batch))
    md = fn.metadata()["fused"]
    assert (md["active"], md["dispatches"], md["fallbacks"]) == (True, 1, 0)
    staged = _scores(_staged(fn, lambda: fn.batch(batch), monkeypatch))
    assert fn.metadata()["fused"]["dispatches"] == 1
    jax_fn = jax_score_function(jax_load_workflow_model(_path(name)))
    reference = _scores(jax_fn.batch(batch))
    assert jax_fn.metadata()["fused"]["dispatches"] == 1
    _assert_close(name, fused, staged)
    _assert_close(name, fused, reference)


@pytest.mark.parametrize("name", ["text_lr", "text_xgb"])
def test_hash_text_flow_fuses_and_matches(name, monkeypatch):
    """A hash-only SmartText member: host tokenize and hash, the scatter
    on the device; a null text and unseen words among the rows. Both
    flows' fused paths are held to the JAX package's fused path, and the
    tree flow's staged path too (its 20 trees of depth 4 sum in 8 lanes
    above the cutoff, ROADMAP.md C4)."""
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    batch = _rows(name, 160)
    fn = _port(name)
    fused = _scores(fn.batch(batch))
    md = fn.metadata()["fused"]
    assert (md["dispatches"], md["fallbacks"], md["fallbackReasons"]) \
        == (1, 0, {})
    staged = _scores(_staged(fn, lambda: fn.batch(batch), monkeypatch))
    _assert_close(name, fused, staged)
    reference = _scores(jax_score_function(
        jax_load_workflow_model(_path(name))).batch(batch))
    _assert_close(name, fused, reference)
    if name in TREES:
        assert np.array_equal(staged, reference)


def test_token_cap_sends_the_batch_staged_and_counts_it(monkeypatch):
    """Over ``TPTPU_TEXT_FUSED_TOKENS`` distinct buckets in a row, the
    ingest refuses the batch: it scores on the staged loop, counted as the
    reference counts it."""
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    monkeypatch.setenv("TPTPU_TEXT_FUSED_TOKENS", "1")
    batch = _rows("text_lr", 160)
    fn = _port("text_lr")
    out = _scores(fn.batch(batch))
    md = fn.metadata()["fused"]
    assert (md["dispatches"], md["fallbacks"], md["lastFallback"]) \
        == (0, 1, "dispatch_error")
    assert md["fallbackReasons"] == {"dispatch_error": 1}
    jax_fn = jax_score_function(jax_load_workflow_model(_path("text_lr")))
    reference = _scores(jax_fn.batch(batch))
    jmd = jax_fn.metadata()["fused"]
    assert (jmd["fallbacks"], jmd["fallbackReasons"]) \
        == (md["fallbacks"], md["fallbackReasons"])
    # the staged loop's float64 core on both sides of the comparison
    assert np.array_equal(out, _scores(
        _staged(fn, lambda: fn.batch(batch), monkeypatch)))
    _assert_close("text_lr", out, reference)


def test_default_routing_pads_to_the_bucket(monkeypatch):
    """With no knob, 16385 rows bucket to 24576 > 16384: the batch is
    fused, its ingest padded with copies of row 0, and its n rows come
    back; 16384 rows stay staged."""
    monkeypatch.delenv("TPTPU_HOST_PREDICT_MAX", raising=False)
    fn = _port("lr")
    fn.prime_fused()
    prog = fn.fused_state["program"]
    seen = []
    real_run = prog.run

    def run(cols, b, n):
        seen.append((b, n, {k: len(c) for k, c in cols.items()}))
        return real_run(cols, b, n)

    monkeypatch.setattr(prog, "run", run)
    rows = _rows("lr", 16385)
    assert bucket(16385) == 24576 and bucket(16384) == 16384
    ds = Dataset.of({k: column_from_values(t, [r.get(k) for r in rows])
                     for k, t in _raw_types(fn).items()})
    fused = fn.columns(ds)
    assert [s[:2] for s in seen] == [(24576, 16385)]
    assert set(seen[0][2].values()) == {24576}
    assert fn.metadata()["fused"]["dispatches"] == 1
    (name, col), = fused.items()
    assert len(col) == 16385
    staged = _staged(fn, lambda: fn.columns(ds), monkeypatch)[name]
    np.testing.assert_allclose(col.probability, staged.probability, rtol=0,
                               atol=GLM_ATOL)
    np.testing.assert_allclose(col.raw, staged.raw, rtol=RAW_RTOL,
                               atol=GLM_ATOL)
    fn.batch(rows[:16384])
    assert fn.metadata()["fused"]["dispatches"] == 1


def _raw_types(fn) -> dict:
    """Feature type by name of the raw features the program's members read."""
    return {f.name: f.ftype for m in fn.fused_state["program"].members
            for f in m.stage.input_features}


def test_opt_out_and_its_reason(monkeypatch):
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    monkeypatch.setenv("TPTPU_FUSED", "0")
    fn = _port("xgb")
    assert fn.prime_fused() is False
    md = fn.metadata()["fused"]
    assert (md["active"], md["reason"]) == (False, "TPTPU_FUSED=0")
    fn.batch(_rows("xgb", 8))
    assert fn.metadata()["fused"]["dispatches"] == 0
    # lifting the opt-out erases nothing: the program builds
    monkeypatch.delenv("TPTPU_FUSED")
    assert fn.prime_fused() is True
    assert fn.metadata()["fused"]["reason"] is None


def test_set_valued_pivot_is_refused_with_the_reference_message():
    port = OneHotModel([["a", "b"]], True, True)
    port.set_input(FeatureBuilder.MultiPickList("tags").as_predictor())
    ref = JaxOneHotModel([["a", "b"]], True, True)
    ref.set_input(JaxFeatureBuilder.MultiPickList("tags").as_predictor())
    with pytest.raises(Unfuseable, match="set-valued") as got:
        port.fused_member_spec()
    with pytest.raises(JaxUnfuseable) as want:
        ref.fused_member_spec()
    assert str(got.value) == str(want.value)


def test_mixed_pivot_and_hash_text_is_refused_and_scores_staged(monkeypatch):
    """The CSV twin's SmartText member mixes Hash and Pivot slots: no
    program, the reference's reason, every eligible batch staged and
    counted as unfuseable."""
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    model = load_workflow_model(CSV_MODEL, device="cpu")
    fn = score_function(model, device="cpu")
    assert fn.prime_fused() is False
    with pytest.raises(JaxUnfuseable) as want:
        _jax_describe(CSV_MODEL)
    reason = fn.metadata()["fused"]["reason"]
    assert reason == str(want.value) == (
        "smart-text member mixes Pivot and Hash slots — not fuseable")
    with open(os.path.join(CSV_MODEL, "rows.json")) as fh:
        rows = json.load(fh)[:40]
    got = _scores(fn.batch(rows))
    md = fn.metadata()["fused"]
    assert (md["dispatches"], md["fallbacks"], md["fallbackReasons"]) \
        == (0, 0, {"unfuseable": 1})
    assert np.array_equal(
        got, _scores(_staged(fn, lambda: fn.batch(rows), monkeypatch)))


def test_run_makes_one_upload_and_one_download(monkeypatch):
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    fn = _port("rf")
    fn.prime_fused()
    prog = fn.fused_state["program"]
    rows = _rows("rf", 48)
    b = bucket(48)
    padded = rows + [rows[0]] * (b - 48)
    cols = {k: column_from_values(t, [r.get(k) for r in padded])
            for k, t in _raw_types(fn).items()}
    core, info = prog.run(cols, b, 48)
    assert core.shape == (48, 1) and core.dtype == np.float32
    assert (info["uploads"], info["downloads"]) == (1, 1)
    assert info["upBytes"] >= prog.up_bytes_per_row * b
    assert info["downBytes"] == prog.down_bytes_per_row * 48


def test_a_kernel_fault_in_a_fused_dispatch_propagates(monkeypatch):
    """Only ``Unfuseable`` sends a batch staged: a kernel fault raised in
    the dispatch comes out of ``.batch`` and ``.columns``, uncounted."""
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    fn = _port("xgb")

    def fault(*a, **kw):
        raise KernelLaunchError("serve_trees kernel launch failed: test")

    monkeypatch.setattr(ST, "predict_device_route", fault)
    rows = _rows("xgb", 16)
    with pytest.raises(KernelLaunchError):
        fn.batch(rows)
    ds = Dataset.of({k: column_from_values(t, [r.get(k) for r in rows])
                     for k, t in _raw_types(fn).items()})
    with pytest.raises(KernelLaunchError):
        fn.columns(ds)
    md = fn.metadata()["fused"]
    assert (md["dispatches"], md["fallbacks"], md["fallbackReasons"]) \
        == (0, 0, {})


def test_concurrent_batches_share_one_closure(monkeypatch):
    """Threads scoring through one closure each take a staging buffer of
    their own: every batch equals the same batch scored alone, and every
    batch is counted."""
    import sys
    import threading

    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    fn = _port("lr")
    batches = [_rows("lr", 40 + i) for i in range(8)]
    want = [_scores(fn.batch(b)) for b in batches]
    got, errors = {}, []

    def work(i):
        try:
            for _ in range(4):
                got.setdefault(i, []).append(_scores(fn.batch(batches[i])))
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    for i, outs in got.items():
        assert len(outs) == 4
        assert all(np.array_equal(o, want[i]) for o in outs)
    assert fn.metadata()["fused"]["dispatches"] == 8 + 8 * 4


def _member_case(kind: str):
    """(fitted stage, its raw columns) of one member configuration."""
    from transmogrifai_tpu_torch.ops.numeric import (
        BinaryVectorizer, NumericVectorizerModel, RealNNVectorizer,
    )
    from transmogrifai_tpu_torch.ops.text import SmartTextModel
    from transmogrifai_tpu_torch.types import (
        Binary, PickList, Real, RealNN, Text,
    )

    rng = np.random.default_rng(3)
    n = 37
    words = ["alpha", "bravo", "Charlie", "delta", "echo"]
    text = [None if i % 7 == 0 else " ".join(
        rng.choice(words, 1 + i % 4)) + (" bravo" * (i % 3)) for i in range(n)]
    reals = [None if i % 5 == 0 else float(v)
             for i, v in enumerate(rng.normal(size=n))]
    picks = [None if i % 6 == 0 else ["a", "b", "c", "zz"][i % 4]
             for i in range(n)]
    if kind.startswith("numeric"):
        nulls = kind.endswith("nulls")
        stage = NumericVectorizerModel([0.25, -1.5], nulls)
        feats = [FeatureBuilder.Real("r0").as_predictor(),
                 FeatureBuilder.Real("r1").as_predictor()]
        cols = [column_from_values(Real, reals),
                column_from_values(Real, reals[::-1])]
    elif kind == "binary":
        stage = BinaryVectorizer(fill_value=True, track_nulls=True)
        feats = [FeatureBuilder.Binary("b").as_predictor()]
        cols = [column_from_values(
            Binary, [None if v is None else v > 0 for v in reals])]
    elif kind == "realnn":
        stage = RealNNVectorizer()
        feats = [FeatureBuilder.RealNN("x").as_predictor()]
        cols = [column_from_values(RealNN, rng.normal(size=n).tolist())]
    elif kind.startswith("onehot"):
        nulls = kind.endswith("nulls")
        stage = OneHotModel([["A", "B"], ["C"]], nulls, True)
        feats = [FeatureBuilder.PickList("p0").as_predictor(),
                 FeatureBuilder.PickList("p1").as_predictor()]
        cols = [column_from_values(PickList, picks),
                column_from_values(PickList, picks[::-1])]
    else:  # hashed text: a Hash slot and an Ignore slot
        binary = kind.endswith("binary")
        stage = SmartTextModel(["Hash", "Ignore"], [[], []], 16, True,
                               kind != "hash_plain", binary_freq=binary)
        feats = [FeatureBuilder.Text("t0").as_predictor(),
                 FeatureBuilder.Text("t1").as_predictor()]
        cols = [column_from_values(Text, text),
                column_from_values(Text, text[::-1])]
    stage.set_input(*feats)
    return stage, cols


@pytest.mark.parametrize("kind", [
    "numeric_nulls", "numeric_plain", "binary", "realnn", "onehot_nulls",
    "onehot_plain", "hash_counts", "hash_binary", "hash_plain",
])
def test_member_blocks_equal_the_staged_blocks(kind):
    """Each member kind's block on the device (CPU here) EQUALS the staged
    vectorizer's float32 block on the same columns, null and untracked
    cases included."""
    from transmogrifai_tpu_torch.compiler.dispatch import StagingBuffer, layout

    stage, cols = _member_case(kind)
    n = len(cols[0])
    member = stage.fused_member_spec()
    want = np.asarray(stage.transform_columns(*cols, num_rows=n).values)
    ingest = member.ingest(cols)
    keys = sorted(ingest)
    arrays = [ingest[k] for k in keys]
    buf = StagingBuffer(layout(arrays)[1], torch.device("cpu"))
    dev = dict(zip(keys, buf.upload(arrays)))
    params = {k: torch.from_numpy(np.array(v))
              for k, v in member.params.items()}
    got = member.kernel(dev, params).numpy()
    assert got.dtype == np.float32 and got.shape == (n, member.width)
    assert np.array_equal(got, want)


def test_glm_core_turns_tf32_off_and_restores_it():
    """The GLM's fused core runs with TF32 off, and the caller's setting
    comes back after it, also when blocks overlap."""
    from transmogrifai_tpu_torch.models.base import FULL_FLOAT32

    flag = torch.backends.cuda.matmul
    before = flag.allow_tf32
    try:
        flag.allow_tf32 = True
        with FULL_FLOAT32:
            assert flag.allow_tf32 is False
            with FULL_FLOAT32:
                assert flag.allow_tf32 is False
            assert flag.allow_tf32 is False
        assert flag.allow_tf32 is True
    finally:
        flag.allow_tf32 = before
