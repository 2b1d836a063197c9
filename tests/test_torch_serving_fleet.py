"""The port's fleet serving (``serving/{fleet,router,registry}.py`` and
``run_fleet_loadtest``) with the run diff, the attribution ledger, the
exposition and the heartbeat sentinel they need
(``telemetry/{runlog,export}.py``, ``insights/ledger.py``,
``resilience/distributed.py``).

Every case of ``tests/test_serving_fleet.py`` is a scenario of
``tests/torch_fixtures/serving_plane.py`` run with the suite's stub score
function through the JAX package and the port: ``stats()``,
``reconcile()``, each request's outcome, the event sequences, the fault
plan's firings, the registry's decisions with their codes and the
deterministic fleet load-test reports (the chaos soak, its twin, the
one- and two-replica runs) must be EQUAL, and the reference suite's own
assertions hold on the port's. The card's canary (``chip_smoke.py``
``serving_plane (d)``) runs here on the CPU too and must EQUAL the JAX
package's stored decision. A kernel fault in a two-replica fleet closes
the file: it is never hedged, adopted or counted as a lost replica.
"""
import os
import sys

import pytest
import torch

from transmogrifai_tpu_torch.analysis import findings
from transmogrifai_tpu_torch.models import serve_trees as ST
from transmogrifai_tpu_torch.resilience import distributed
from transmogrifai_tpu_torch.telemetry import runlog
from transmogrifai_tpu_torch.utils.cuda_build import KernelLaunchError

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_fixtures"))
import serving_plane as S  # noqa: E402

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

JAX = S.package("jax")
PORT = S.package("port")


def both(key):
    want = S.run(JAX, S.FLEET, key)
    got = S.run(PORT, S.FLEET, key)
    S.same(got, want, 0.0, key)
    return got


def _lines(r):
    return {ln.split(" ")[0]: float(ln.split(" ")[1]) for ln in r["lines"]
            if not ln.startswith("#")}


CHECKS = {
    "slow_keyed": lambda r: r["durations"] == [0.0, 0.5, 0.0]
    and ["slow", "fakeStage"] in r["fired"],
    "slow_replica": lambda r: r["durations"] == [0.25, 0.0],
    "scope_nesting": lambda r: r["seq"] == [None, 0, 1, 0, None],
    "burst_pinning": lambda r: r["pins"] == [1, None, None]
    and r["mult"] == [4.0, 1.0],
    "kill_once": lambda r: r["due"] == [[], [1], []]
    and ["kill_replica", "1@t=2"] in r["fired"],
    "partition_window": lambda r: r["in"] == [False, True, False]
    and not r["other"] and ["partition", "0@t=1"] in r["fired"],
    "partition_duration": lambda r: r["err"][0] == "ValueError",
    "stop_unknown_mode": lambda r: r["err"][0] == "ValueError",
    "reject_then_drain": lambda r: r["orphans"] == 3
    and all(h["outcome"] == "stopped" for h in r["handles"])
    and r["stats"]["outstanding"] == 0,
    "default_drain": lambda r: r["orphans"] == []
    and r["stats"]["completed"] == 3,
    "stop_vs_submit": lambda r: not r["errors"] and r["settled_stopped"]
    and r["admitted_is_handles"] and r["outstanding"] == 0
    and r["rejected_is_rejects"] and r["total"] == 350,
    "router_tie_break": lambda r: r["idle"] == [0, 1, 2]
    and r["order"] == [1, 2, 0],
    "router_unroutable": lambda r: not r["routable1"] and not r["routable2"]
    and r["order"] == [0] and r["pick"] == 0,
    "exactly_once": lambda r: r["stats"]["completed"] == 9
    and r["reconcile"]["reconciled"],
    "queue_full_falls_through": lambda r: r["dispatched"].get("1") == 1
    and r["handle"]["outcome"] == "completed",
    "every_replica_full": lambda r: r["err"][1] == "queue_full"
    and r["before"]["admitted"] == 2,
    "no_routable": lambda r: r["err"][1] == "stopped",
    "fleet_source": lambda r: _lines(r)["tptpu_fleet_fleets"] >= 1
    and _lines(r)["tptpu_fleet_completed"] >= 4
    and "tptpu_fleet_hedges_fired" in _lines(r),
    "partition_hedge": lambda r: r["hedges"] == 1 and r["duplicates"] == 1
    and r["stats"]["completed"] == 1 and r["reconcile"]["reconciled"],
    "no_hedge_margin": lambda r: r["hedges"] == 0,
    "hedge_once": lambda r: r["hedges"] == 1,
    "kill_adopts": lambda r: r["adopted"] == 3 and r["again"] == 0
    and r["stats"]["perReplica"][0]["shed"]["stopped"] == 3
    and r["reconcile"]["reconciled"],
    "scripted_kill": lambda r: r["lost"] == [[], [1]],
    "heartbeat_loss": lambda r: r["lost"] == [[], [1]],
    "adoption_dead_end": lambda r: r["h0"]["outcome"] == "stopped"
    and r["h1"]["outcome"] == "completed"
    and r["stats"]["shed"]["stopped"] == 1,
    "two_replicas": lambda r: r["two"]["goodput_rows_per_s"]
    > 1.5 * r["one"]["goodput_rows_per_s"],
    "shadow": lambda r: r["report"]["seen"] == 5
    and r["report"]["agreement"] == 0.0,
    "canary_quality": lambda r: r["decision"]["decision"] == "rollback"
    and "TPR004" in r["decision"]["codes"] and r["rollbacks"] == 1
    and r["after"]["results"][0]["pred"]["prediction"] == 0.0,
    "canary_promotes": lambda r: r["decision"]["decision"] == "promote"
    and r["decision"]["codes"] == [] and r["all_good"],
    "canary_latency": lambda r: r["decision"]["decision"] == "rollback"
    and "TPR001" in r["decision"]["codes"],
    "attribution_drift": lambda r: r["decision"]["decision"] == "rollback"
    and "attribution_drift" in r["decision"]["codes"],
}


@pytest.mark.parametrize("key", sorted(S.FLEET))
def test_fleet_scenarios_equal_the_reference(key):
    got = both(key)
    if key in CHECKS:
        assert CHECKS[key](got), got


def test_every_fleet_scenario_is_checked():
    assert set(S.FLEET) - set(CHECKS) == {"chaos_soak", "twin"}


@pytest.mark.parametrize("key", ["chaos_soak", "twin"])
def test_fleet_soak_reconciles_at_every_instant(key):
    """The fleet suite's chaos soak (a kill, a slow replica, a pinned
    burst): EQUAL the JAX package's report and itself rerun with the same
    seed, zero dropped, reconciled at every instant, replica 1 lost."""
    got = both(key)
    rep = got["report"]
    assert got["rerun_equal"]
    assert rep["dropped"] == 0 and rep["reconciled"]
    assert rep["reconciled_every_instant"]
    assert rep["replicas_lost"] == 1 and rep["lost_replicas"] == [1]
    assert rep["completed"] > 0
    assert rep["admitted"] == (rep["completed"] + rep["quarantined"]
                               + rep["errors"] + rep["shed_total"])


def test_the_fleet_faults_fire_in_the_port():
    """The fleet and load-test faults that were recorded without a
    consumer now fire in a fleet load test: a kill, a pinned burst, a
    slow replica (replica 0, which the router's tie-break feeds) and a
    dropped heartbeat all land in ``fired``."""
    plan = PORT.faults.FaultPlan(seed=0)
    plan.kill_replica(1, at=0.4)
    plan.slow_replica(0, delay=0.002)
    plan.burst_arrivals(0.2, 0.2, multiplier=2.0, replica=0)
    plan.drop_heartbeat(0)
    S.reset(PORT)
    with PORT.faults.installed(plan):
        PORT.serving.run_fleet_loadtest(
            S.stub(PORT), rows=S._rows(32), rate=300.0, duration=1.0,
            replicas=3, seed=0, deadline=0.25, service_time=lambda n: 0.002,
            plan=plan)
    kinds = {k for k, _ in plan.fired}
    assert {"kill_replica", "burst", "slow", "heartbeat"} <= kinds


def test_canary_on_the_serving_fixtures_equals_the_stored_decision():
    """``chip_smoke.py``'s (d) on the CPU: xgb the control, rf the canary,
    the deterministic fleet load test; the decision record (codes,
    agreement, per-side latency) EQUAL the JAX package's, live and as the
    generator stored it."""
    S.reset(PORT)
    got = S.canary(PORT)
    S.reset(JAX)
    want = S.canary(JAX)
    S.same(got, want, 0.0, "canary")
    S.same(got, S.load_results()["canary"], 0.0, "stored canary")
    assert got["decision"]["codes"] == ["TPR004"]
    assert got["decision"]["canaryServed"] and got["decision"]["controlServed"]


# ----------------------------------------------- the run diff and its parts
def test_run_diff_flags_each_code_as_the_reference_does():
    from transmogrifai_tpu.telemetry import runlog as jrun

    base = {"run": {"phases": {"fit": {"seconds": 1.0}},
                    "compileStats": {"programsCompiled": 2},
                    "transferCensus": {"hostToDevice": {"bytes": 1 << 20},
                                       "deviceToHost": {"bytes": 0}},
                    "quality": {"auPR": 0.9, "rmse": 0.1}, "runId": "a"}}
    cur = {"run": {"phases": {"fit": {"seconds": 2.0}},
                   "compileStats": {"programsCompiled": 9},
                   "transferCensus": {"hostToDevice": {"bytes": 8 << 20},
                                      "deviceToHost": {"bytes": 0}},
                   "quality": {"auPR": 0.8, "rmse": 0.2}, "runId": "b"}}
    got = [f.to_json() for f in runlog.diff_runs(base, cur, emit_events=False)]
    want = [f.to_json() for f in jrun.diff_runs(base, cur, emit_events=False)]
    for g, w in zip(got, want):
        g.pop("message")
        w.pop("message")
    assert got == want
    assert [f["code"] for f in got] == ["TPR001", "TPR002", "TPR003",
                                        "TPR004", "TPR004"]
    sentinel = runlog.RegressionSentinel(base)
    assert len(sentinel.check(base)) == 0
    assert runlog.validate_run_report({"schema_version": 1}) == \
        jrun.validate_run_report({"schema_version": 1})


def test_findings_refuse_unregistered_codes():
    with pytest.raises(ValueError):
        findings.Finding("TPX001", "not a code of the port")
    report = findings.Report()
    report.add("TPR004", "quality", severity=findings.Severity.WARNING)
    assert report.ok and len(report.warnings()) == 1
    assert report.to_json()["warnings"] == 1


def test_heartbeat_sentinel_equals_the_reference():
    from transmogrifai_tpu.resilience import distributed as jdist

    def run(mod, faults_mod):
        clock = S.FakeClock()
        s = mod.HostSentinel([0, 1], mod.HeartbeatConfig(timeout=5.0,
                                                         clock=clock))
        plan = faults_mod.FaultPlan().drop_heartbeat(1)
        with faults_mod.installed(plan):
            beats = [s.beat(0), s.beat(1)]
            clock.now = 6.0
            s.beat(0)
            dead = s.dead_hosts()
        s.declare_lost(1)
        for d in (0.1, 0.2, 0.3):
            s.record_duration("psum", d)
        return [beats, dead, s.live_hosts(), s.deadline_for("psum"),
                s.stats(), plan.fired]

    assert run(distributed, PORT.faults) == run(jdist, JAX.faults)


def test_the_distributed_plane_names_its_item():
    with pytest.raises(NotImplementedError, match="A13"):
        distributed.FailoverController  # noqa: B018
    with pytest.raises(NotImplementedError, match="A13"):
        distributed.CollectiveGuard  # noqa: B018
    assert issubclass(distributed.HostLostError, BaseException)
    assert not issubclass(distributed.HostLostError, Exception)


def test_the_attribution_ledger_equals_the_reference():
    from transmogrifai_tpu.insights import ledger as jled

    import numpy as np

    def run(mod):
        before = mod.snapshot()
        st = mod.stats()
        st.record_explain(rows=8, seconds=0.5, lanes=4, deduped=1, padded=2)
        st.record_groups(["a", "b"], np.array([[1.0, -2.0], [0.5, 0.0]]),
                         np.array([2, 1]))
        st.count_drift_alert()
        st.count_shed(3)
        out = mod.delta(before)
        st.reset()
        return out

    assert run(PORT.ledger) == run(jled)


# ------------------------------------------------------ the port's fault rule
def test_a_kernel_fault_in_a_fleet_is_never_hedged_or_adopted():
    """A ``KernelLaunchError`` in K1's launch on replica 0 of a two-replica
    fleet: ``pump_all``, ``tick``, ``submit`` and ``stop`` re-raise it;
    no hedge fires though replica 1 is partitioned past the checkpoint, no
    orphan is adopted, no replica is lost; every request settles ``error``
    and the fleet's and each replica's ledgers reconcile."""
    S.reset(PORT)
    fn = S.score_fn(PORT, "xgb")

    got = S.kernel_fault_fleet(PORT, fn, S.fixture_rows("xgb"),
                               S.k1_fault(ST))
    fault = ["KernelLaunchError", None]
    assert got["pump_all"] == fault and got["tick"] == fault
    assert got["submit"] == fault and got["stop"] == fault
    assert got["handles"] == [{"outcome": "error", "error": fault}] * 4
    assert (got["hedges"], got["adopted"], got["lost"]) == (0, 0, [])
    assert got["errors"] == 4 and got["outstanding"] == 0
    assert got["reconciled"]
    assert got["replica_faults"] == [fault, fault]


def test_a_kernel_fault_in_a_worker_fleet_reaches_stop():
    """Worker-mode replicas fail on their own threads; the fleet takes the
    fault up at its next ``tick`` or ``stop``."""
    S.reset(PORT)
    fn = S.score_fn(PORT, "xgb")
    rows = S.fixture_rows("xgb")
    fleet = PORT.serving.FleetService(fn, PORT.serving.FleetConfig(
        replicas=2, service=PORT.serving.ServiceConfig(workers=1)))
    fleet.start()
    with S.k1_fault(ST)():
        hs = [fleet.submit(dict(r)) for r in rows[:6]]
        for h in hs:
            h._event.wait(60)
        with pytest.raises(KernelLaunchError):
            fleet.tick()
        with pytest.raises(KernelLaunchError):
            fleet.stop()
    assert all(h.outcome == "error" for h in hs)
    s = fleet.stats()
    assert s["hedgesFired"] == 0 and s["orphansAdopted"] == 0
    assert s["lostReplicas"] == [] and s["errors"] == 6
    assert fleet.reconcile()["reconciled"]


@pytest.mark.parametrize("mode", ["shadow", "canary"])
def test_a_kernel_fault_in_mirror_scoring_fails_the_fleet(mode):
    """A ``KernelLaunchError`` in K1's launch while the registry mirrors
    served traffic through a tree closure (the shadow, or the canary's
    control): the served requests complete, but the fault reaches the
    caller from ``pump_all``, the registry's reports and gate and every
    fleet entry point; it is no mirror error, and the canary is neither
    promoted nor rolled back."""
    S.reset(PORT)
    fn = S.score_fn(PORT, "xgb")
    got = S.mirror_kernel_fault(PORT, fn, S.fixture_rows("xgb"),
                                S.k1_fault(ST), mode)
    fault = ["KernelLaunchError", None]
    assert got["handles"] == ["completed", "completed"]
    assert got["pump_all"] == fault and got["report"] == fault
    if mode == "shadow":
        assert got["stop_shadow"] == fault
    else:
        assert got["evaluate"] == fault and got["promote"] == fault
        assert got["unchanged"] == [True, True]
    assert (got["submit"], got["tick"], got["stop"]) == (fault,) * 3
    assert got["mirror_errors"] == 0
    assert (got["promotions"], got["rollbacks"]) == (0, 0)
    assert got["fleet_fault"] == fault
    assert got["replica_faults"] == [None, None]
    assert (got["hedges"], got["lost"]) == (0, [])
    assert got["reconciled"]
