"""The port's standing scoring service (``serving/{queue,batcher,service,
loadtest}.py`` over ``deadline`` and ``shedding``): bounded admission,
micro-batching, deadline budgets, tiered shedding, the thread-safety of
the shared sentinels and the open-loop load test on a virtual clock.

Every case of ``tests/test_serving_service.py`` is a scenario of
``tests/torch_fixtures/serving_plane.py`` run through the JAX package and
the port on the same seeded rows: the units (queue, batcher, deadline,
shedder) and the service scenarios on the reference suite's ``trained``
and ``trained_fused`` models (``tests/fixtures/torch_serving_plane/``,
trained and saved by the JAX package) must give EQUAL results —
``stats()``, each request's outcome and typed error, the counters, the
deterministic load-test reports key for key — with the logistic scores
within ``1e-6`` (plus ``1e-6`` of their size) of the JAX closure's; the
reference suite's own assertions are checked on the port's results. One
tree scenario on the ``xgb`` serving fixture must EQUAL the JAX closure's.
The port-only rules close the file: ``explain=k`` refused at admission,
a kernel fault that fails the service, and a start that builds nothing on
a CPU closure.
"""
import os
import sys
import threading

import pytest
import torch

from transmogrifai_tpu_torch.models import serve_trees as ST
from transmogrifai_tpu_torch.utils import cuda_build

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_fixtures"))
import serving_plane as S  # noqa: E402

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

JAX = S.package("jax")
PORT = S.package("port")


def both(table, key, atol=S.GLM_ATOL):
    """The scenario through both packages: the port's results EQUAL the
    JAX package's (floats within ``atol``); returns the port's."""
    want = S.run(JAX, table, key)
    got = S.run(PORT, table, key)
    for r in (want, got):
        r.pop("_wall", None)
    S.same(got, want, atol, key)
    return got


# ------------------------------------------------------------------ units
def test_unit_cases_cover_the_reference_classes():
    names = {k.split("_")[0] for k in S.UNITS}
    assert names == {"queue", "deadline", "batcher", "shed"}
    assert len(S.UNITS) == 21


@pytest.mark.parametrize("key", sorted(S.UNITS))
def test_units_equal_the_reference(key):
    got = both(S.UNITS, key, atol=0.0)
    checks = {
        "queue_bounded": lambda r: r["err"] == ["RejectedByAdmission",
                                                "queue_full"]
        and r["depth"] == 4 and r["peak"] == 4,
        "queue_fifo": lambda r: r["got"] == [0, 1] and r["depth"] == 3,
        "queue_oversized": lambda r: r["got"] == [True],
        "queue_closed": lambda r: r["err"][1] == "stopped"
        and r["drained"] == 1,
        "queue_unknown_reason": lambda r: r["err"][0] == "ValueError",
        "deadline_checkpoint": lambda r: r["err"] == ["featurize", True]
        and r["counter"] == 0 and r["events"],
        "deadline_no_history": lambda r: r["first"] is None
        and r["second"][0] == "DeadlineExceeded",
        "deadline_thread_local": lambda r: all(r["seq"])
        and r["other_thread"] == [True],
        "batcher_expired": lambda r: r["expired"] == 1
        and r["budget_is_live"],
        "batcher_tightest": lambda r: r["budget_is_tight"]
        and r["rows"] == 3,
        "shed_tiers": lambda r: r["tiers"] == [0, 1, 2, 3, 4] and r["reject"],
        "shed_hysteresis": lambda r: r["seq"] == [4, 4, 3, 0]
        and not r["flapped"],
        "shed_breakers": lambda r: r["tiers"] == [0, 2],
        "shed_reset": lambda r: r["tier"] == 0,
    }
    if key in checks:
        assert checks[key](got), got


# ------------------------------------------------------ service scenarios
SERVICE_CHECKS = {
    "pump_mode": lambda r: r["stats"]["completed"] == 20
    and r["stats"]["outstanding"] == 0,
    "map_back": lambda r: r["h2_is_solo"] and r["h1_is_solo"],
    "worker_mode": lambda r: r["stats"]["completed"] == 40
    and not r["threads"],
    "submit_after_stop": lambda r: r["err"][1] == "stopped"
    and r["rejected"]["stopped"] == 1,
    "stop_drains": lambda r: r["stats"]["completed"] == 10,
    "stop_resets_gauges": lambda r: r["before"] > 0 and r["queue_zero"]
    and r["in_flight_zero"],
    "empty_request": lambda r: r["err"][0] == "ValueError",
    # a model loaded from disk carries no vectorizer meta cache in either
    # package, so start() cannot make its planner ready (the reference's
    # in-process model can): ready after the first batch, the primed
    # batch EQUAL an unprimed closure's
    "primes_fusion": lambda r: r["before"] == [False, False]
    and not r["ready"] and r["ready_after_batch"] and r["equals_fresh"],
    "prime_disabled": lambda r: r["disabled"] and r["prime"] is False,
    "unhealthy_batch": lambda r: r["handle"]["outcome"] == "error"
    and r["stats"]["errors"] == 1,
    "queued_expiry": lambda r: r["h"]["outcome"] == "deadline_exceeded"
    and r["h2"]["outcome"] == "completed",
    "admission_p95": lambda r: r["err"][0] == "DeadlineExceeded"
    and r["stats"]["rejected"]["deadline"] == 1,
    "slow_stage_burns": lambda r: r["handle"]["outcome"]
    == "deadline_exceeded",
    "mid_execution_deadline": lambda r: r["tight"]["outcome"]
    == "deadline_exceeded" and r["loose"]["outcome"] == "completed",
    "queue_full": lambda r: r["err"][1] == "queue_full"
    and r["stats"]["completed"] == 4,
    "reject_tier": lambda r: r["err"][1] == "shedding" and r["tier"] == 4
    and r["tier_after"] == 0 and r["handle"]["outcome"] == "completed",
    "drift_shed": lambda r: r["enabled"] and r["shed"] == 0
    and r["restored"] == 1,
    "service_source": lambda r: any(
        ln.startswith("tptpu_service_admitted") for ln in r["lines"]),
    "render_no_deadlock": lambda r: not r["hung"] and not r["errors"],
    "serve_queue_span": lambda r: len(r["queue_spans"]) >= 1,
    "shed_reject_reconcile": lambda r: r["stats"]["shed"][
        "deadline_exceeded"] == 1 and r["stats"]["rejected"][
        "queue_full"] == 1,
    "hammer_schema_sentinel": lambda r: not r["errs"]
    and r["stats"]["rowsSeen"] == 1600,
    "hammer_quarantine_log": lambda r: not r["errs"] and not r["bad"]
    and r["rows"] == 800 and r["ring"] == 50,
    "hammer_score_guard": lambda r: r["stats"]["guardedRows"] == 800,
    "hammer_breaker_transitions": lambda r: r["state"] == "open"
    and r["transitions"] == {"closed->open": 1}
    and r["short_plus_failures"] == 800,
    "hammer_half_open_probe": lambda r: r["probes"] == 1
    and r["after"] == ["closed", True],
    "hammer_release_probe": lambda r: r["seq"] == [True, False, True],
    "hammer_failed_probe": lambda r: r["state"] == "closed",
    "hammer_concurrent_scoring": lambda r: not r["errs"]
    and r["quarantined"] == 200 and r["rowsSeen"] == 400,
    "hammer_metadata_while_scoring": lambda r: not r["errs"]
    and not r["bad"],
    "loadtest_seed_deterministic": lambda r: r["same"]
    and r["a"]["reconciled"] and r["a"]["completed"] > 0,
    "loadtest_burst_windows": lambda r: ["burst", "t=0.5"] in r["fired"],
    "loadtest_overload": lambda r: r["reconciled"] and r["shed_rate"] > 0
    and r["goodput_rows_per_s"] > 0,
    "loadtest_soak_twice": lambda r: r["same"],
}


@pytest.mark.parametrize("key", sorted(S.SERVICE))
def test_service_scenarios_equal_the_reference(key):
    got = both(S.SERVICE, key)
    if key in SERVICE_CHECKS:
        assert SERVICE_CHECKS[key](got), got


def test_every_service_scenario_is_checked():
    unchecked = set(S.SERVICE) - set(SERVICE_CHECKS) - {
        "context_manager", "loadtest_full_chaos_soak",
        "loadtest_no_real_sleeps"}
    assert unchecked == set()


def test_full_chaos_soak_holds_the_reference_bounds():
    """The acceptance soak (``test_full_chaos_soak``) on the port: EQUAL the
    JAX package's report, EQUAL itself when rerun with the same seed,
    goodput positive, p99 bounded by the deadline ceiling, every shed
    typed, the storms fired, no service thread left."""
    got = both(S.SERVICE, "loadtest_full_chaos_soak")
    assert got["rerun_equal"]
    rep = got["first"]["report"]
    assert rep["completed"] > 0 and rep["goodput_rows_per_s"] > 0
    assert rep["reconciled"]
    assert rep["latency_ms"]["p99"] <= 250.0 + 10.0 + 4 * 20.0 + 1.0
    assert {"slow", "burst", "transform"} <= set(got["first"]["fired"])
    degraded = (rep["shed_total"] + rep["rejected_total"]
                + rep["quarantined"] + rep["errors"])
    assert degraded > 0
    assert not got["first"]["threads"]
    assert rep["max_queue_depth_rows"] <= 48


def test_loadtest_uses_no_real_sleeps():
    want = S.run(JAX, S.SERVICE, "loadtest_no_real_sleeps")
    got = S.run(PORT, S.SERVICE, "loadtest_no_real_sleeps")
    wall = got.pop("_wall")
    want.pop("_wall")
    S.same(got, want, 0.0, "no_real_sleeps")
    assert got["report"]["virtual_end_s"] >= 5.0
    assert wall < 4.0


def test_context_manager_quiesces():
    got = both(S.SERVICE, "context_manager")
    assert got["outstanding"] == 0
    assert got["handle"]["outcome"] == "completed"


def test_tree_model_through_the_service_equals_the_reference():
    """The ``xgb`` serving fixture's rows through a pump-mode service in
    batches of 8: stats and every result EQUAL the JAX closure's."""
    S.reset(JAX)
    S.reset(PORT)
    want = S.plain(S.tree_service(JAX))
    got = S.plain(S.tree_service(PORT))
    S.same(got, want, 0.0, "xgb")
    assert got["stats"]["completed"] == 48 and got["stats"]["batches"] == 6


# ---------------------------------------------------------- port-only rules
def test_explain_is_refused_at_admission():
    """``explain=k`` raises the closure's ``NotImplementedError`` (A10) at
    ``submit``, before queuing: nothing is admitted, nothing is queued,
    and a plain request still scores."""
    S.reset(PORT)
    svc = PORT.serving.ScoringService(
        S.score_fn(PORT), PORT.serving.ServiceConfig(workers=0))
    svc.start()
    with pytest.raises(NotImplementedError, match="A10"):
        svc.submit(dict(S.service_rows()[0]), explain=2)
    s = svc.stats()
    assert s["admitted"] == 0 and s["queueDepthRows"] == 0
    h = svc.submit(dict(S.service_rows()[0]))
    svc.pump()
    svc.stop()
    assert h.outcome == "completed"
    with pytest.raises(ValueError):
        svc.submit(dict(S.service_rows()[0]), explain=-1)


def test_explain_passes_a_closure_that_can_explain():
    """A score function without ``check_explain`` (the fleet suite's stub)
    takes ``explain=k`` through to its batch, as the reference's does."""
    S.reset(PORT)
    seen = []

    class Fn:
        def batch(self, rows, explain=0):
            seen.append(explain)
            return [{"p": 1.0} for _ in rows]

    svc = PORT.serving.ScoringService(
        Fn(), PORT.serving.ServiceConfig(workers=0))
    svc.start()
    h = svc.submit({"x1": 0.0}, explain=3)
    svc.pump()
    svc.stop()
    assert seen == [3] and h.outcome == "completed"


@pytest.mark.parametrize("workers", [0, 2], ids=["pump", "workers"])
def test_a_kernel_fault_fails_the_service(workers):
    """A ``KernelLaunchError`` in K1's launch: every request met or queued
    settles ``error`` with the fault, the ledger reconciles, ``submit``
    re-raises the fault (not a rejection), ``pump`` (pump mode) and
    ``stop`` (after joining the workers) re-raise it, no thread is left."""
    S.reset(PORT)
    fn = S.score_fn(PORT, "xgb")
    rows = S.fixture_rows("xgb")
    got = S.kernel_fault_service(PORT, fn, rows, S.k1_fault(ST), workers)
    fault = ["KernelLaunchError", None]
    if workers == 0:
        assert got["pump"] == fault and got["pump_again"] == fault
    assert got["handles"] == [{"outcome": "error", "error": fault}] * 5
    assert got["submit"] == fault and got["stop"] == fault
    assert got["fault"] == fault
    assert got["reconciled"] and got["stats"]["errors"] == 5
    assert got["stats"]["admitted"] == 5
    assert got["stats"]["rejected"] == {"queue_full": 0, "shedding": 0,
                                        "stopped": 0, "deadline": 0}
    assert not got["threads"]
    md = fn.metadata()
    assert md["quarantine"]["quarantinedRows"] == 0
    assert all(b["consecutiveFailures"] == 0 for b in md["breakers"].values())


def test_other_batch_errors_stay_contained():
    """The reference's containment holds for every other exception: a
    plain ``RuntimeError`` settles its batch ``error`` and the service
    keeps serving."""
    S.reset(PORT)

    class Fn:
        calls = 0

        def batch(self, rows, explain=0):
            Fn.calls += 1
            if Fn.calls == 1:
                raise RuntimeError("not a kernel fault")
            return [{"p": 1.0} for _ in rows]

    svc = PORT.serving.ScoringService(
        Fn(), PORT.serving.ServiceConfig(workers=0, max_batch_rows=1))
    svc.start()
    h1 = svc.submit({"x1": 0.0})
    h2 = svc.submit({"x1": 1.0})
    assert svc.pump() == 1 and svc.pump() == 1
    svc.stop()
    assert (h1.outcome, h2.outcome) == ("error", "completed")
    assert svc.fault is None


def test_start_builds_the_closures_libraries_and_nothing_on_the_cpu(
        monkeypatch):
    """``start`` builds what the closure's predictors load on the card
    (synchronously with ``wait_warmup=True``, else on one thread ``stop``
    joins); a CPU closure lists no library, so nothing is built."""
    built = []
    monkeypatch.setattr(cuda_build, "build",
                        lambda names: built.append(list(names)) or {})
    S.reset(PORT)
    fn = S.score_fn(PORT, "xgb")
    assert fn.kernel_libraries() == []
    for wait in (True, False):
        svc = PORT.serving.ScoringService(
            fn, PORT.serving.ServiceConfig(workers=0))
        svc.start(wait_warmup=wait)
        assert svc._warmup is None
        svc.stop()
    assert built == []

    class OnCard:
        def batch(self, rows, explain=0):
            return [{} for _ in rows]

        def kernel_libraries(self):
            return ["serve_trees", "tree_sum"]

    svc = PORT.serving.ScoringService(
        OnCard(), PORT.serving.ServiceConfig(workers=0))
    svc.start(wait_warmup=True)
    assert built == [["serve_trees", "tree_sum"]]
    svc.stop()
    svc = PORT.serving.ScoringService(
        OnCard(), PORT.serving.ServiceConfig(workers=0))
    svc.start()
    svc.stop()
    assert built == [["serve_trees", "tree_sum"]] * 2
    assert not [t for t in threading.enumerate()
                if t.name == "tptpu-serve-warmup"]


def test_a_tree_closure_names_its_kernels():
    """On the card a tree model's closure lists K1's and the tree sum's
    libraries, a logistic one none (its core is torch alone)."""
    S.reset(PORT)
    model = S.model(PORT, "xgb")
    assert [lib for t in model.stage_plan()
            for lib in getattr(t, "kernel_libraries", ())] == [
        "serve_trees", "tree_sum"]
    lr = S.model(PORT, "trained")
    assert [lib for t in lr.stage_plan()
            for lib in getattr(t, "kernel_libraries", ())] == []


def test_worker_mode_scenario_of_the_card_on_the_cpu():
    """``chip_smoke.py``'s (a) at a small size: single-row requests from
    four client threads through a two-worker service, every result EQUAL
    ``fn.batch`` of its row called directly, reconciled, no thread left."""
    S.reset(PORT)
    fn = S.score_fn(PORT, "xgb")
    rows = S.fixture_rows("xgb")
    got = S.worker_mode(PORT, fn, rows, requests=96, clients=4, seed=3)
    assert got["errors"] == [] and got["outcomes"] == ["completed"]
    assert got["reconciled"] and not got["threads"]
    assert got["stats"]["completed"] == 96 and got["batch_cap"] == 256
    assert S.direct_mismatches(fn, rows, got["_results"], got["_idx"]) == {
        "mismatched": 0, "max_abs_err": 0.0}


def test_bench_mode_loadtest_reconciles():
    """``run_loadtest`` with ``service_time=None`` (the card's (b)): the
    measured batch time advances the virtual clock, every request gets a
    typed outcome."""
    S.reset(PORT)
    rep = PORT.serving.run_loadtest(S.score_fn(PORT), S.service_rows(),
                                    rate=200.0, duration=0.2, seed=1,
                                    deadline=0.5)
    assert rep["reconciled"] and rep["completed"] > 0
    assert rep["virtual_end_s"] >= 0.19
    assert rep["latency_ms"]["p50"] > 0.0
