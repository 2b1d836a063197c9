"""The resilience, telemetry and streaming slice held against the JAX
package on the same seeded inputs (``torch_fixtures/resilience_flow.py``):
the monoid aggregators and the event, joined, Avro and Parquet readers
EQUAL; streamed statistics, the reservoir, quarantine counts and the
stream cursor's resume EQUAL; layer and candidate checkpoints and resume
(resumed trees EQUAL the uninterrupted model, GLM lanes within 1e-6); RUN
reports valid under both validators with the reference's key sets and
pulse order; the retrain loop's states, events and ledger EQUAL; and the
three kernel-fault departures, each reaching the caller."""
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_fixtures"))
import resilience_flow as F  # noqa: E402

from transmogrifai_tpu_torch.utils.cuda_build import KernelLaunchError  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

J, P = F.package("jax"), F.package("port")


def _fixture() -> dict:
    with open(F.RESULTS) as fh:
        return json.load(fh)


def _kernel_fault():
    return KernelLaunchError("injected: CUDA error: an illegal memory access")


# ---------------------------------------------------------------- readers
def test_aggregators_equal_the_reference():
    got, want = F.aggregator_results(P), F.aggregator_results(J)
    assert len(got) == 18 and got == want


@pytest.fixture(scope="module")
def readers():
    return F.reader_outputs(P), F.reader_outputs(J)


@pytest.mark.parametrize("name", [
    "aggregate_all", "aggregate_cutoff", "aggregate_windows",
    "conditional_min_0", "conditional_min_1", "conditional_max_0",
    "conditional_max_1", "conditional_random_0", "conditional_random_1",
    "joined_inner", "joined_left_outer", "joined_outer", "joined_aggregate",
])
def test_reader_dataset_equals_the_reference(readers, name):
    got, want = readers[0][name], readers[1][name]
    assert got == want and len(next(iter(got.values()))) > 0


def test_avro_round_trip_equals_the_reference(tmp_path):
    got = F.avro_round_trip(P, str(tmp_path / "p.avro"))
    want = F.avro_round_trip(J, str(tmp_path / "j.avro"))
    assert got == want
    # each package reads the other's file
    assert P.avro.read_avro(str(tmp_path / "j.avro")) == got["records"]


def test_parquet_round_trip_equals_the_reference(tmp_path):
    pytest.importorskip("pyarrow")
    got = F.parquet_round_trip(P, str(tmp_path / "p.parquet"))
    want = F.parquet_round_trip(J, str(tmp_path / "j.parquet"))
    assert got == want
    back = F.dataset_of(P.parquet.read_parquet(str(tmp_path / "j.parquet")))
    assert back == want["dataset"]


# ----------------------------------------------------------------- stream
STREAM_CASES = {
    "one_chunk": dict(n=120, chunk=200),
    "even_chunks": dict(n=300, chunk=30),
    "ragged_chunks": dict(n=301, chunk=37),
    "reservoir": dict(n=300, chunk=40, cap=70),
    "quarantine": dict(n=300, chunk=40, faults=(
        ("tear_stream_chunk", 2), ("corrupt_chunk", 4), ("oom_chunk", 1))),
    "window_halvings": dict(n=300, chunk=20, inflight=8, faults=(
        ("oom_chunk", 1), ("oom_chunk", 3), ("oom_chunk", 5))),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_stream_ingest_equals_the_reference(case):
    kw = STREAM_CASES[case]
    got, want = F.stream_case(P, **kw), F.stream_case(J, **kw)
    assert got == want
    s = got["summary"]
    assert s["rowsSeen"] == kw["n"] - sum(
        min(kw["chunk"], kw["n"] - kw["chunk"] * i)
        for i in (s["chunksQuarantined"]["torn"]
                  + s["chunksQuarantined"]["corrupt"]))
    if not s["quarantinedTotal"]:
        # the streamed column statistics are the one-shot pass's, bit for
        # bit, for any chunking
        assert s["fitStats"] == got["oneShotStats"]


@pytest.mark.parametrize("crash_after", [0, 3, 6])
def test_stream_cursor_resume_equals_the_reference(tmp_path, crash_after):
    kw = dict(n=300, chunk=40, cap=100, crash_after=crash_after, faults=(
        ("tear_stream_chunk", 2), ("oom_chunk", 1)))
    got = F.stream_case(P, ckpt_dir=str(tmp_path / "p"), **kw)
    want = F.stream_case(J, ckpt_dir=str(tmp_path / "j"), **kw)
    assert got == want and got["crashed"]
    s = got["summary"]
    assert s["resumed"] and s["chunksSkippedOnResume"] == crash_after + 1


def test_stream_fixture_scenario_equals_the_stored_reference(tmp_path):
    import make_resilience_fixtures as M

    kw = dict(M.STREAM, faults=tuple(tuple(f) for f in M.STREAM["faults"]))
    got = F.stream_case(P, ckpt_dir=str(tmp_path / "p"), **kw)
    assert got == _fixture()["stream"]


import hypothesis  # noqa: E402
from hypothesis import strategies as st  # noqa: E402


@hypothesis.settings(max_examples=25, deadline=None)
@hypothesis.given(
    values=st.lists(st.one_of(
        st.none(), st.floats(allow_nan=False, allow_infinity=False,
                             width=64, min_value=-1e12, max_value=1e12)),
        min_size=1, max_size=60),
    cuts=st.lists(st.integers(min_value=0, max_value=60), max_size=6),
)
def test_streamed_stats_are_the_one_shot_pass_for_any_chunking(values, cuts):
    """ExactSum and the column statistics: any chunking of the same rows
    folds to the one-shot pass bit for bit, in both packages alike."""
    out = {}
    for X in (P, J):
        feat = X.FeatureBuilder.Real("v").extract(
            lambda r: r["v"]).as_predictor()
        recs = [{"v": v} for v in values]
        edges = sorted({0, len(recs), *[min(c, len(recs)) for c in cuts]})
        red = X.stream.ChunkStatsReducer()
        for a, b in zip(edges, edges[1:]):
            red.fold_dataset(X.readers.SimpleReader(recs[a:b])
                             .generate_dataset([feat]))
        one = X.stream.ChunkStatsReducer()
        one.fold_dataset(X.readers.SimpleReader(recs).generate_dataset([feat]))
        s = X.stream.ExactSum()
        for v in values:
            if v is not None:
                s.add(v)
        out[X.name] = (F.plain(red.finalize()), F.plain(one.finalize()),
                       s.value())
    assert out["port"][0] == out["port"][1] == out["jax"][0]
    assert out["port"][2] == out["jax"][2]


# ------------------------------------------------------------ checkpoints
def _same_models(got, want, glm_atol=0.0):
    a, b = F.fitted_arrays(got), F.fitted_arrays(want)
    assert sorted(a) == sorted(b) and a
    for k in a:
        if glm_atol and ("weights" in k or "intercept" in k):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=glm_atol)
        else:
            np.testing.assert_array_equal(a[k], b[k])


CKPT_CASES = [("xgb", "before_selector"), ("xgb", "selector"),
              ("lr", "before_selector"), ("both", "selector")]


@pytest.mark.parametrize("family,at", CKPT_CASES)
def test_crash_and_resume_equal_the_reference(tmp_path, family, at):
    """A crash after a layer, then ``resume=True``: the same faults fire,
    the same layer checkpoints exist and the same candidates come from
    their checkpoints in both packages; the resumed model EQUALS the
    uninterrupted one (a GLM winner refitted directly where its sweep's
    refit lane was skipped: within 1e-6), and the port's models EQUAL the
    JAX package's (GLM lanes within 1e-6). The JAX package's own direct
    refit of a GLM winner differs from its batched lane by about 3e-5, so
    a resumed GLM is held to the port's uninterrupted model, not to the
    JAX package's resumed one."""
    got = F.crash_resume(P, str(tmp_path / "p"), family, at)
    want = F.crash_resume(J, str(tmp_path / "j"), family, at)
    for key in ("crashed", "fired", "layers", "numLayers", "attempts",
                "hits"):
        assert got[key] == want[key], key
    assert got["crashed"]
    assert got["hits"] == (0 if at == "before_selector"
                           else len(F.tree_flow(P, got["ds"], family)[1]
                                    .origin_stage.models))
    glm = F.GLM_ATOL if family != "xgb" else 0.0
    _same_models(got["resumed"], got["reference"], glm_atol=glm)
    _same_models(got["reference"], want["reference"], glm_atol=glm)
    if family == "xgb":
        _same_models(got["resumed"], want["resumed"])
    # a restored stage comes back on the workflow's device
    sel = got["resumed"].fitted[got["pred"].origin_stage.uid]
    assert sel.best_model.device in (None, torch.device("cpu"))


def test_workflow_cv_crash_and_resume_equal_the_reference(tmp_path):
    got = F.crash_resume(P, str(tmp_path / "p"), "xgb", workflow_cv=True)
    want = F.crash_resume(J, str(tmp_path / "j"), "xgb", workflow_cv=True)
    assert (got["fired"], got["layers"]) == (want["fired"], want["layers"])
    _same_models(got["resumed"], got["reference"])
    _same_models(got["resumed"], want["resumed"])


def test_restored_tree_model_scores_on_the_workflow_device(tmp_path):
    r = F.crash_resume(P, str(tmp_path / "p"), "xgb", "selector")
    best = r["resumed"].fitted[r["pred"].origin_stage.uid].best_model
    assert best.device == torch.device("cpu")
    assert best._dev_thr.device == torch.device("cpu")
    got = r["resumed"].score(dataset=r["ds"])[r["pred"].name]
    want = r["reference"].score(dataset=r["ds"])[r["pred2"].name]
    np.testing.assert_array_equal(np.asarray(got.probability),
                                  np.asarray(want.probability))


def test_signature_leaves_the_device_out():
    est = P.XGBoostClassifier(device="cpu")
    assert "device" not in est.get_params()
    a = P.checkpoint.dag_signature([[P.SanityChecker(device="cpu")]])
    b = P.checkpoint.dag_signature([[P.SanityChecker(device="cuda")]])
    assert a == b


# ------------------------------------------------------------ run reports
@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    d = tmp_path_factory.mktemp("runs")
    return (F.recorded_train(P, str(d / "p")),
            F.recorded_train(J, str(d / "j")), str(d / "p"))


def test_run_report_valid_under_both_validators(recorded):
    (model, _), _, _ = recorded
    from transmogrifai_tpu.telemetry import runlog as JR

    assert P.runlog.validate_run_report(model.run_report) == []
    assert JR.validate_run_report(json.loads(json.dumps(
        model.run_report))) == []
    mem = model.run_report["run"]["deviceMemory"]
    assert mem["backend"] == "cpu" and mem["devicePeakBytes"] == 0


def test_run_report_keys_and_pulses_equal_the_reference(recorded):
    (pm, pp), (jm, jp), _ = recorded
    assert F.report_shape(pm.run_report) == F.report_shape(jm.run_report)
    assert F.pulse_order(pp) == F.pulse_order(jp)
    stored = _fixture()
    assert F.report_shape(pm.run_report) == stored["report_shape"]
    assert F.pulse_order(pp) == stored["pulse_order"]


def test_workflow_cv_run_report_keys_and_pulses_equal_the_reference(tmp_path):
    """With workflow CV the report carries a record per fold and a
    candidate record per family and fold, and the pulses interleave the
    folds' layers: the JAX package's key sets and order."""
    pm, pp = F.recorded_train(P, str(tmp_path / "p"), "both", True)
    jm, jp = F.recorded_train(J, str(tmp_path / "j"), "both", True)
    got, want = F.report_shape(pm.run_report), F.report_shape(jm.run_report)
    assert got == want and got["folds"] == 2 and got["fold"]
    assert F.pulse_order(pp) == F.pulse_order(jp)


def test_run_report_travels_with_the_model_both_ways(recorded, tmp_path):
    (model, _), _, run_dir = recorded
    from transmogrifai_tpu.workflow.persistence import (
        load_workflow_model as jax_load,
    )

    assert P.runlog.list_run_reports(run_dir)
    path = str(tmp_path / "m")
    model.save(path)
    rid = model.run_report["run"]["runId"]
    assert P.load(path).run_report["run"]["runId"] == rid
    assert jax_load(path).run_report["run"]["runId"] == rid
    assert model.summary_json()["run"]["run"]["runId"] == rid
    pretty = model.summary_pretty()
    assert "Run report:" in pretty and model.run_report["run"]["file"] in pretty


def test_export_surfaces_after_a_recorded_train(recorded, tmp_path):
    trace = P.export.export_chrome_trace(str(tmp_path / "trace.json"))
    assert trace["traceEvents"] and os.path.getsize(tmp_path / "trace.json")
    phases = P.export.phase_breakdown()
    assert set(phases) == set(J.export.phase_breakdown())
    assert phases["fit"] > 0.0
    assert P.export.summary_line().startswith("Telemetry: ")
    text = P.export.render_prometheus()
    assert "tptpu_run_" in text and "tptpu_retrain_" in text


# ---------------------------------------------------------------- retrain
@pytest.fixture(scope="module")
def retrain_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("retrain")
    return F.retrain_loop(P, str(d / "p")), F.retrain_loop(J, str(d / "j"))


def test_retrain_loop_equals_the_reference(retrain_results):
    got, want = retrain_results
    got = {k: v for k, v in got.items() if k != "deviceMemoryHighWater"}
    want = {k: v for k, v in want.items() if k != "deviceMemoryHighWater"}
    assert got == want
    stored = {k: v for k, v in _fixture()["retrain_loop"].items()
              if k != "deviceMemoryHighWater"}
    assert got == stored
    assert got["states"] == ["idle", "collecting", "retraining",
                             "validating", "canarying", "idle"]
    assert got["history"][-1]["outcome"] == "promoted"
    assert got["dropped"] == 0 and got["reconciled"]
    assert got["ledger"]["retrainCrashes"] == 1


# ------------------------------------------------------------- departures
def test_kernel_fault_in_the_retrain_trainer_propagates_out_of_tick(tmp_path):
    """Departure: the reference counts any trainer error as a failed
    attempt (backoff, back to idle); a kernel fault reaches the caller of
    ``tick`` and leaves the machine where it was, with nothing counted."""
    def trainer(chunks, ctx):
        raise _kernel_fault()

    with pytest.raises(KernelLaunchError):
        F.retrain_loop(P, str(tmp_path / "p"), trainer=trainer)


def test_kernel_fault_in_the_canary_scoring_propagates_out_of_tick(tmp_path):
    """A kernel fault in the canary's scoring fails the fleet and voids the
    window; ``tick`` re-raises it instead of rolling the canary back."""
    def on_canary(fleet):
        def broken(rows, *a, **kw):
            raise _kernel_fault()

        fleet.services[0].score_fn.batch = broken

    with pytest.raises(KernelLaunchError):
        F.retrain_loop(P, str(tmp_path / "p"), on_canary=on_canary)


def test_kernel_fault_while_a_chunk_is_folded_propagates(tmp_path,
                                                          monkeypatch):
    """Departure: a kernel fault while a stream chunk is featurized or
    folded is never quarantined as a torn or corrupt chunk; it propagates,
    the cursor keeps the chunks before it, and a resume completes."""
    real = P.stream.ChunkStatsReducer.fold_dataset
    calls = {"n": 0}

    def fold(self, ds):
        calls["n"] += 1
        if calls["n"] == 3:
            raise _kernel_fault()
        return real(self, ds)

    monkeypatch.setattr(P.stream.ChunkStatsReducer, "fold_dataset", fold)
    ckpt = str(tmp_path / "p")
    with pytest.raises(KernelLaunchError):
        F.stream_case(P, ckpt_dir=ckpt)
    cursor = P.checkpoint.CheckpointManager(ckpt).load_stream_cursor(
        P.stream.stream_signature(F.stream_features(P), 0))
    assert cursor["chunksDone"] == 2 and cursor["torn"] == []
    assert cursor["corrupt"] == []
    monkeypatch.setattr(P.stream.ChunkStatsReducer, "fold_dataset", real)
    reader = P.streaming.StreamingReader(
        [F.stream_records(300)[i:i + 40] for i in range(0, 300, 40)])
    ds, s = P.stream.stream_ingest(
        reader, F.stream_features(P),
        checkpoint=P.checkpoint.CheckpointManager(ckpt), resume=True)
    assert s["resumed"] and s["chunksSkippedOnResume"] == 2
    assert s["rowsSeen"] == 300 and s["quarantinedTotal"] == 0


def test_kernel_fault_mid_train_keeps_completed_checkpoints(tmp_path,
                                                            monkeypatch):
    """Departure: a kernel fault in the selector's sweep propagates out of
    ``train``; every completed layer checkpoint stays intact, no partial
    one is written, the family that finished keeps its candidate
    checkpoint, and ``resume=True`` then completes and EQUALS the
    uninterrupted model."""
    ckpt = str(tmp_path / "ck")
    ds = F.binary_ds(P)
    wf, pred = F.tree_flow(P, ds, "both")
    lr_cls = type(pred.origin_stage.models[1][0])
    real = lr_cls.sweep_dispatch_masks

    def broken(self, *a, **kw):
        raise _kernel_fault()

    monkeypatch.setattr(lr_cls, "sweep_dispatch_masks", broken)
    with pytest.raises(KernelLaunchError):
        wf.train(checkpoint_dir=ckpt)
    layers = sorted(os.listdir(os.path.join(ckpt, "layers")))
    assert layers == ["layer-000", "layer-001"]
    assert not [n for n in os.listdir(os.path.join(ckpt, "layers"))
                if ".tmp-" in n or ".old-" in n]
    assert len(os.listdir(os.path.join(ckpt, "cv"))) == 1
    monkeypatch.setattr(lr_cls, "sweep_dispatch_masks", real)
    resumed = wf.train(checkpoint_dir=ckpt, resume=True)
    attempts = resumed.fitted[pred.origin_stage.uid].summary[
        "candidateAttempts"]
    assert [a["fromCheckpoint"] for a in attempts] == [True, False]
    wf2, _ = F.tree_flow(P, ds, "both")
    _same_models(resumed, wf2.train(), glm_atol=F.GLM_ATOL)


# ------------------------------------------------------------------- card
def test_recorder_polls_the_card_without_a_sync_on_the_card():
    """Needs a CUDA card (skips here): the memory poll reads the caching
    allocator (backend ``cuda``, a peak above zero) and makes no host
    sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mem = P.runlog.poll_device_memory()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert mem["backend"] == "cuda" and mem["devicePeakBytes"] >= x.nbytes


def test_checkpoint_records_a_tensor_download_on_the_card(tmp_path):
    """Needs a CUDA card (skips here): a fitted array held as a CUDA tensor
    is downloaded by ``stage_to_entry`` and counted on the census."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from transmogrifai_tpu_torch.workflow.persistence import stage_to_entry

    class Stage:
        uid, operation_name, metadata = "s_1", "s", {}
        input_features, output_name = (), "o"

        def get_arrays(self):
            return {"w": torch.arange(256, dtype=torch.float32,
                                      device="cuda")}

        def get_params(self):
            return {}

    before = P.runlog.snapshot()
    arrays: dict = {}
    stage_to_entry("e_1", Stage(), arrays)
    d = P.runlog.delta(before)
    assert d["d2hTransfers"] == 1 and d["d2hBytes"] == 1024
    assert arrays["s_1__w"].tolist() == list(range(256))


# -------------------------------------------------------------- isolation
def test_slice_modules_import_no_jax():
    import ast

    root = os.path.dirname(os.path.abspath(P.pkg.__file__))
    for rel in ("features/aggregators.py", "readers/aggregate.py",
                "readers/joins.py", "readers/catalog.py",
                "readers/parquet.py", "readers/streaming.py",
                "utils/avro.py", "resilience/checkpoint.py",
                "resilience/retrain.py", "workflow/stream.py"):
        tree = ast.parse(open(os.path.join(root, rel)).read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and not n.level]
        assert not [m for m in names if m.split(".")[0] in
                    ("jax", "jaxlib", "transmogrifai_tpu")], rel
