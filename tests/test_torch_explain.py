"""``explain=k`` through the port's scoring closure, staged and fused, and
through ``ScoringService``, reconciled with the JAX package's closure: the
scenarios of the reference's explain suite (``tests/test_insights_batched
.py``: serving, degradation, attribution drift) and the fused graph's
explain cases (``tests/test_fused_graph.py``), each run through both
packages on the same model and rows (``tests/torch_fixtures/
insights_flow.py``). The bench-report and plan-audit (TPX007) cases are
the compile plane's (``ROADMAP.md`` A14) and stay out.

Tolerances: tree attributions EQUAL, staged and fused; logistic ones
within ``GLM_ATOL`` = 1e-6 (measured: 2.2e-16 staged, where both cores
are float64; 9.2e-8 fused, where both are float32); counters and skips
EQUAL.

Port-only rules (``ROADMAP.md`` "Departures"): a kernel fault in the
explain lanes, staged or fused, reaches the caller of ``.batch``,
``.columns`` and the service; every other explain error degrades the
attributions to None, as the reference's do.
"""
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "torch_fixtures"))

import insights_flow as I  # noqa: E402
import serving_plane as S  # noqa: E402

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

GLM_ATOL = I.GLM_ATOL
JAX, PORT = I.package("jax"), I.package("port")


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """The reference suite's ``trained`` model, trained by the JAX package
    and saved; both packages load it."""
    path = str(tmp_path_factory.mktemp("mixed") / "model")
    I.train_mixed(JAX).save(path)
    _, rows = I.mixed_ds(JAX)
    return path, rows


@pytest.fixture(scope="module")
def regression(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("regression") / "model")
    I.train_regression(JAX).save(path)
    _, rows = I.regression_ds(JAX)
    return path, rows


def _fn(P, path, **kw):
    S.reset(P)
    return P.score(P.load(path), **kw)


def _both(call):
    return {P.name: call(P) for P in (JAX, PORT)}


def _same(out, atol=GLM_ATOL):
    I.same_attributions(out["port"], out["jax"], atol)


# ----------------------------------------------------------- staged serving
def test_batch_rows_carry_top_k_attributions(mixed):
    path, rows = mixed
    out = _both(lambda P: I.attributions(
        _fn(P, path).batch([dict(r) for r in rows[:8]], explain=3)))
    _same(out)
    assert all(len(a) == 3 for a in out["port"])
    assert all(any(k.startswith("x1") for k in a) for a in out["port"])


def test_single_row_and_columns_entry_points(mixed):
    path, rows = mixed
    ds, _ = I.mixed_ds(JAX)

    def run(P):
        fn = _fn(P, path)
        one = fn(dict(rows[0]), explain=2)["attributions"]
        pds, _ = I.mixed_ds(P)
        cols = fn.columns(pds.take(np.arange(6)), explain=2)["attributions"]
        return [one] + cols

    out = _both(run)
    _same(out)
    assert out["port"][1] == out["port"][0]


def test_explain_off_leaves_rows_untouched(mixed):
    path, rows = mixed
    fn = _fn(PORT, path)
    out = fn.batch([dict(rows[0])])
    assert "attributions" not in out[0]
    assert fn.batch([dict(rows[0])], explain=0)[0].keys() == out[0].keys()
    assert fn.columns(I.mixed_ds(PORT)[0].take(np.arange(2))).keys() == \
        {k for k in out[0]}


def test_quarantined_rows_get_none_survivors_explained(mixed):
    path, rows = mixed
    bad = {"x1": "not_a_number_at_all", "x2": 1.0, "city": "a"}
    out = _both(lambda P: I.attributions(
        _fn(P, path).batch([bad, dict(rows[1]), dict(rows[2])], explain=2)))
    _same(out)
    assert out["port"][0] is None and len(out["port"][1]) == 2


def test_explain_requires_a_predictor():
    def run(P):
        P.uid.reset()
        rng = np.random.default_rng(0)
        cfv = P.columns.column_from_values
        ds = P.Dataset.of({
            "label": cfv(P.T.RealNN, rng.integers(0, 2, 32).astype(float).tolist()),
            "x1": cfv(P.T.Real, rng.normal(size=32)),
        })
        _, preds = P.from_dataset(ds, response="label")
        vec = P.transmogrify(list(preds))
        model = P.workflow.Workflow().set_result_features(vec) \
            .set_input_dataset(ds).train()
        fn = P.score(model)
        with pytest.raises(ValueError, match="explain"):
            fn.batch([{"x1": 1.0}], explain=2)
        return True

    assert _both(run) == {"jax": True, "port": True}


def test_regression_workflow_serving_explain(regression):
    path, rows = regression

    def run(P):
        fn = _fn(P, path)
        before = P.ledger.snapshot()["explainErrors"]
        out = I.attributions(fn.batch([dict(r) for r in rows[:8]], explain=2))
        assert P.ledger.snapshot()["explainErrors"] == before
        return out

    out = _both(run)
    _same(out)
    assert all(len(a) == 2 for a in out["port"])


def test_sweep_failure_keeps_scores(mixed, monkeypatch):
    path, rows = mixed

    def run(P):
        fn = _fn(P, path)
        before = P.ledger.snapshot()["explainErrors"]

        def boom(*a, **kw):
            raise MemoryError("lane plane allocation failed")

        monkeypatch.setattr(P.loco, "explain_batch", boom)
        out = fn.batch([dict(rows[0])], explain=2)
        monkeypatch.undo()
        return (out[0]["attributions"], sorted(k for k in out[0] if k != "attributions"),
                P.ledger.snapshot()["explainErrors"] - before,
                P.metrics.REGISTRY.counter("tptpu_serve_explain_errors_total").value)

    out = _both(run)
    assert out["port"] == out["jax"]
    assert out["port"][0] is None and out["port"][2] == 1


def test_negative_explain_rejected(mixed):
    path, rows = mixed
    for P in (JAX, PORT):
        fn = _fn(P, path)
        with pytest.raises(ValueError):
            fn.batch([dict(rows[0])], explain=-1)
        with pytest.raises(ValueError):
            fn.columns(I.mixed_ds(P)[0].take(np.arange(2)), explain=-1)


def test_ledger_and_metadata_surface(mixed):
    path, rows = mixed

    def run(P):
        fn = _fn(P, path)
        P.ledger.stats().reset()
        fn.batch([dict(r) for r in rows[:16]], explain=2)
        md = fn.metadata()["attributions"]
        led = md["ledger"]
        for key in ("explainSeconds", "explainRowsPerSec"):
            led.pop(key, None)
        return md["available"], md["groups"], led, md["drift"]

    out = _both(run)
    assert out["port"][:2] == out["jax"][:2]
    pl, jl = out["port"][2], out["jax"][2]
    pgroups, jgroups = pl.pop("groups"), jl.pop("groups")
    assert pl == jl
    assert set(pgroups) == set(jgroups)
    for g in jgroups:
        for key, v in jgroups[g].items():
            w = pgroups[g][key]
            assert (w == v) if not isinstance(v, float) else abs(w - v) <= GLM_ATOL
    assert out["port"][3]["rowsObserved"] == out["jax"][3]["rowsObserved"]


def test_prometheus_exposes_the_attribution_source(mixed):
    path, rows = mixed
    fn = _fn(PORT, path)
    fn.batch([dict(rows[0])], explain=1)
    prom = PORT.export.render_prometheus()
    assert "tptpu_attribution_rows_explained" in prom
    assert "tptpu_attribution_lane_dispatches" in prom


def test_summary_pretty_record_insights_line(mixed):
    path, rows = mixed
    model = PORT.load(path)
    PORT.score(model).batch([dict(rows[0])], explain=1)
    assert "Record insights:" in model.summary_pretty()


def test_determinism_pool_on_vs_off(mixed, monkeypatch):
    path, rows = mixed
    batch = [dict(r) for r in rows[:32]]
    monkeypatch.setenv("TPTPU_FEATURIZE_THREADS", "4")
    monkeypatch.setenv("TPTPU_FEATURIZE_CHUNK", "8")
    on = _fn(PORT, path).batch(batch, explain=3)
    monkeypatch.setenv("TPTPU_FEATURIZE_THREADS", "0")
    off = _fn(PORT, path).batch(batch, explain=3)
    assert I.attributions(on) == I.attributions(off)


# ----------------------------------------------- the tree fixtures, routes
@pytest.mark.parametrize("name", ["xgb", "rf", "lr"])
@pytest.mark.parametrize("route", ["staged", "fused"])
def test_fixture_attributions_equal_the_reference(name, route):
    """40 rows of each serving fixture, k = 3: trees EQUAL, staged and
    fused; lr within 1e-6."""
    out = _both(lambda P: I.explain_fixture(P, name, 40, route, cutoff=0)[0])
    _same(out, 0.0 if name in I.TREES else GLM_ATOL)


@pytest.mark.parametrize("name", ["xgb", "lr"])
def test_fused_lanes_above_the_cutoff_equal_the_reference(name):
    """100 rows bucket to 128, so the fused run's 16 lanes score 2048 rows
    through the device route at a cutoff of 64."""
    out = _both(lambda P: I.explain_fixture(P, name, 100, "fused", cutoff=64)[0])
    _same(out, 0.0 if name in I.TREES else GLM_ATOL)


@pytest.mark.parametrize("name", ["xgb", "rf"])
def test_fused_and_staged_attributions_agree(name):
    """The reference's rule between its own routes (``tests/
    test_fused_graph.py``): within 1e-5. They are not equal: the fused
    base and lanes take the device route's float32 sum, the staged base of
    40 rows the host route's."""
    fused = I.explain_fixture(PORT, name, 40, "fused", cutoff=0)[0]
    staged = I.explain_fixture(PORT, name, 40, "staged")[0]
    I.same_attributions(fused, staged, 1e-5)


def test_fused_explain_is_one_upload_and_one_download(monkeypatch):
    from transmogrifai_tpu_torch.telemetry import runlog

    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    fn = PORT.score(PORT.load(I.model_path("xgb")))
    rows = I.fixture_rows("xgb", 40)
    fn.batch(rows[:2])  # builds the program, uploads its params
    before = runlog.snapshot()
    out = fn.batch(rows, explain=3)
    delta = runlog.delta(before)
    assert delta["h2dTransfers"] == 1
    assert delta["d2hTransfers"] == 1
    assert fn.metadata()["fused"]["dispatches"] == 2
    assert all(len(r["attributions"]) == 3 for r in out)


@pytest.mark.parametrize("name,calls", [("lr", 1), ("xgb", 2)])
def test_glm_lanes_share_the_base_product(name, calls, monkeypatch):
    """A GLM's fused lanes and base come from one product, so a zeroed
    group without weight reads exactly the base's bits on any card; a tree
    core's lanes take their own call (the route's order depends on the
    row count, as in the reference's program)."""
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    fn = PORT.score(PORT.load(I.model_path(name)))
    rows = I.fixture_rows(name, 16)
    fn.batch(rows)
    pspec = fn.fused_state["program"].pspec
    seen = []
    real = pspec.core

    def core(plane, params):
        seen.append(plane.shape[0])
        return real(plane, params)

    monkeypatch.setattr(pspec, "core", core)
    fn.batch(rows, explain=2)
    assert len(seen) == calls and pspec.row_wise == (name == "lr")


def test_fused_columns_and_single_row(monkeypatch):
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")

    def run(P):
        fn = P.score(P.load(I.model_path("xgb")))
        rows = I.fixture_rows("xgb", 6)
        one = fn(rows[0], explain=2)["attributions"]
        return [one] + I.attributions(fn.batch(rows, explain=2))

    out = _both(run)
    _same(out, 0.0)


def test_fused_quarantined_row_answers_none(monkeypatch):
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")

    def run(P):
        fn = P.score(P.load(I.model_path("xgb")))
        rows = I.fixture_rows("xgb", 4)
        rows[1]["age"] = "zzz"
        return I.attributions(fn.batch(rows, explain=2))

    out = _both(run)
    _same(out, 0.0)
    assert out["port"][1] is None


def test_explain_budget_skip_keeps_scores(monkeypatch):
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    monkeypatch.setenv("TPTPU_EXPLAIN_LANE_BUDGET", "1")

    def run(P):
        fn = P.score(P.load(I.model_path("lr")))
        before = P.ledger.snapshot()
        out = fn.batch(I.fixture_rows("lr", 8), explain=2)
        delta = P.ledger.delta(before)
        return (delta["explainBudgetSkips"], I.attributions(out),
                [sorted(k for k in r if k != "attributions") for r in out],
                [e["lanes"] for e in P.events.recent()
                 if e["kind"] == "explain_budget_skip"][-1:])

    out = _both(run)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 1 and all(a is None for a in out["port"][1])


# ----------------------------------------------------------- degradation
def test_explain_is_the_first_shed_casualty(mixed):
    path, rows = mixed

    def run(P):
        fn = _fn(P, path)
        before = P.ledger.snapshot()["explainShedRows"]
        sh = P.shedding.LoadShedder(P.shedding.ShedConfig(), capacity=100)
        sh.update(40, 0, 0.0)
        try:
            assert P.shedding.explain_shed()
            shed = I.attributions(fn.batch([dict(r) for r in rows[:4]], explain=2))
            counted = P.ledger.snapshot()["explainShedRows"] - before
        finally:
            sh.reset()
        back = I.attributions(fn.batch([dict(rows[0])], explain=2))
        return shed, counted, back

    out = _both(run)
    assert out["port"][:2] == out["jax"][:2] == ([None] * 4, 4)
    I.same_attributions(out["port"][2], out["jax"][2], GLM_ATOL)


def test_deadline_budget_skips_explain_keeps_scores(mixed):
    path, rows = mixed

    def run(P):
        fn = _fn(P, path)
        P.metrics.REGISTRY.histogram(
            "tptpu_serve_seconds", labels={"stage": "explain"}).observe(30.0)
        before = P.ledger.snapshot()["explainDeadlineSkips"]
        with P.deadline.active(P.deadline.DeadlineBudget(5.0)):
            out = fn.batch([dict(rows[0])], explain=2)
        evts = [e for e in P.events.recent(20)
                if e["kind"] == "explain_deadline_skip"]
        return (out[0]["attributions"],
                sorted(k for k in out[0] if k != "attributions"),
                P.ledger.snapshot()["explainDeadlineSkips"] - before,
                evts[-1]["requiredMs"] >= 1000.0)

    out = _both(run)
    assert out["port"] == out["jax"]
    assert out["port"][0] is None and out["port"][2] == 1


def test_service_carries_explain_through_the_micro_batcher(mixed):
    path, rows = mixed

    def run(P):
        fn = _fn(P, path)
        clk = P.loadtest.VirtualClock()
        svc = P.serving.ScoringService(
            fn, P.serving.ServiceConfig(workers=0, max_queue_rows=64,
                                        max_batch_rows=16), clock=clk)
        svc.start()
        h3 = svc.submit(dict(rows[0]), explain=3)
        h1 = svc.submit(dict(rows[1]), explain=1)
        h0 = svc.submit(dict(rows[2]))
        while svc.pump():
            pass
        svc.stop()
        return (h3.result(timeout=1)[0]["attributions"],
                h1.result(timeout=1)[0]["attributions"],
                "attributions" in h0.result(timeout=1)[0])

    out = _both(run)
    I.same_attributions(list(out["port"][:2]), list(out["jax"][:2]), GLM_ATOL)
    assert len(out["port"][0]) == 3 and len(out["port"][1]) == 1
    assert out["port"][2] is out["jax"][2] is False


def test_service_admission_budgets_for_the_explain_family(mixed):
    path, rows = mixed

    def run(P):
        fn = _fn(P, path)
        P.metrics.REGISTRY.histogram(
            "tptpu_serve_seconds", labels={"stage": "explain"}).observe(40.0)
        svc = P.serving.ScoringService(
            fn, P.serving.ServiceConfig(workers=0, max_queue_rows=64),
            clock=P.loadtest.VirtualClock())
        svc.start()
        svc.submit(dict(rows[0]), deadline=10.0)
        with pytest.raises(P.deadline.DeadlineExceeded):
            svc.submit(dict(rows[1]), deadline=10.0, explain=2)
        while svc.pump():
            pass
        svc.stop()
        return svc.stats()["rejected"]["deadline"]

    assert _both(run) == {"jax": 1, "port": 1}


def test_fused_service_explains(monkeypatch):
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")

    def run(P):
        fn = P.score(P.load(I.model_path("xgb")))
        svc = P.serving.ScoringService(
            fn, P.serving.ServiceConfig(max_batch_rows=16, workers=1))
        svc.start()
        try:
            rows = I.fixture_rows("xgb", 8)
            futs = [svc.submit(r) for r in rows]
            [f.result(timeout=30.0) for f in futs]
            got = svc.submit(rows[0], explain=2).result(timeout=30.0)[0]
        finally:
            svc.stop()
        return got["attributions"], fn.metadata()["fused"]["fallbacks"]

    out = _both(run)
    I.same_attributions([out["port"][0]], [out["jax"][0]], 0.0)
    assert out["port"][1] == out["jax"][1] == 0


# --------------------------------------------------------------- drift
def test_serving_feeds_the_attribution_drift_monitor(mixed):
    path, rows = mixed

    def run(P):
        fn = _fn(P, path)
        fn.batch([dict(r) for r in rows[:8]], explain=2)
        d = fn.metadata()["attributions"]["drift"]
        return d["enabled"], d["rowsObserved"], sorted(d["groups"])

    out = _both(run)
    assert out["port"] == out["jax"]
    assert out["port"][0] and out["port"][1] == 8


def test_shifted_serving_raises_an_attribution_drift_alert(mixed):
    path, rows = mixed
    shifted = [{"x1": 9.0 + 0.01 * i, "x2": 0.0, "city": "a"} for i in range(64)]

    def run(P):
        fn = _fn(P, path)
        before = P.ledger.snapshot()["attributionDriftAlerts"]
        fn.batch(shifted, explain=2)
        rep = fn.metadata()["attributions"]["drift"]
        return (rep["alerts"], P.ledger.snapshot()["attributionDriftAlerts"] - before,
                {g: c["status"] for g, c in rep["groups"].items()})

    out = _both(run)
    assert out["port"] == out["jax"]
    assert out["port"][0] and out["port"][1] == len(out["port"][0])


# ------------------------------------------------- kernel faults (port-only)
def _launch_error():
    from transmogrifai_tpu_torch.utils.cuda_build import KernelLaunchError

    return KernelLaunchError("serve_trees: launch failed (injected)")


def test_a_kernel_fault_in_the_staged_lanes_reaches_the_caller(monkeypatch):
    """A fault of the card in the staged sweep propagates from ``.batch``
    and ``.columns`` where the reference would answer None."""
    from transmogrifai_tpu_torch.insights import loco

    fn = PORT.score(PORT.load(I.model_path("xgb")))
    rows = I.fixture_rows("xgb", 4)
    real = loco.explain_batch

    def boom(*a, **kw):
        raise _launch_error()

    monkeypatch.setattr(loco, "explain_batch", boom)
    with pytest.raises(type(_launch_error())):
        fn.batch(rows, explain=2)
    with pytest.raises(type(_launch_error())):
        fn(rows[0], explain=2)
    monkeypatch.setattr(loco, "explain_batch", real)
    assert fn.quarantine.stats()["quarantinedRows"] == 0
    assert all(a is not None for a in I.attributions(fn.batch(rows, explain=2)))


def test_a_kernel_fault_in_the_fused_explain_core_reaches_the_caller(monkeypatch):
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    fn = PORT.score(PORT.load(I.model_path("xgb")))
    rows = I.fixture_rows("xgb", 8)
    fn.batch(rows)
    prog = fn.fused_state["program"]
    calls = []
    real = prog.pspec.core

    def core(plane, params):
        calls.append(plane.shape[0])
        if len(calls) == 2:  # the lane core of the explained batch
            raise _launch_error()
        return real(plane, params)

    monkeypatch.setattr(prog.pspec, "core", core)
    with pytest.raises(type(_launch_error())):
        fn.batch(rows, explain=2)
    assert fn.metadata()["fused"]["fallbacks"] == 0


def test_a_kernel_fault_in_explain_lanes_fails_the_service(monkeypatch):
    from transmogrifai_tpu_torch.insights import loco

    fn = PORT.score(PORT.load(I.model_path("xgb")))
    svc = PORT.serving.ScoringService(fn, PORT.serving.ServiceConfig(workers=0))
    svc.start()

    def boom(*a, **kw):
        raise _launch_error()

    monkeypatch.setattr(loco, "explain_batch", boom)
    h = svc.submit(I.fixture_rows("xgb", 1)[0], explain=2)
    with pytest.raises(type(_launch_error())):
        svc.pump()
    assert h.outcome == "error"
    with pytest.raises(type(_launch_error())):
        svc.submit(I.fixture_rows("xgb", 1)[0])
    with pytest.raises(type(_launch_error())):
        svc.stop()


def test_a_kernel_fault_in_explain_lanes_fails_the_fleet(monkeypatch):
    from transmogrifai_tpu_torch.insights import loco

    fn = PORT.score(PORT.load(I.model_path("xgb")))
    fleet = PORT.serving.FleetService(fn, PORT.serving.FleetConfig(
        replicas=2, service=PORT.serving.ServiceConfig(workers=0)))
    fleet.start()

    def boom(*a, **kw):
        raise _launch_error()

    monkeypatch.setattr(loco, "explain_batch", boom)
    fleet.submit(I.fixture_rows("xgb", 1)[0], explain=2)
    with pytest.raises(type(_launch_error())):
        fleet.pump_all()
    with pytest.raises(type(_launch_error())):
        fleet.stop()


def test_explain_on_the_card():
    """The tree fixtures' staged and fused attributions on the card equal
    the CPU route's, and lr's are within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    P = I.package("port", "cuda")
    for name in ("xgb", "rf", "lr"):
        for route in ("staged", "fused"):
            got = I.explain_fixture(P, name, 100, route, cutoff=64)[0]
            want = I.explain_fixture(PORT, name, 100, route, cutoff=64)[0]
            I.same_attributions(got, want, 0.0 if name in I.TREES else GLM_ATOL)
