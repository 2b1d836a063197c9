"""The serving plane's scenarios (``serving/{queue,batcher,service,router,
fleet,registry,loadtest}.py``), run the same way through either package:
the port's tests (``tests/test_torch_serving_service.py``,
``tests/test_torch_serving_fleet.py``) run each one through the JAX
package and the port on the same seeded rows and compare the results,
the fixture generator (``make_serving_plane_fixtures.py``) trains and
saves the service suite's models with the JAX package and stores its
canary decision, and ``chip_smoke.py``'s ``serving_plane`` phase runs the
card's scenarios through the port alone.

``package(name, device)`` gathers one package's entry points into a
namespace (``"jax"`` or ``"port"``; the port's closures on ``device``).
This module imports no package at import time, so ``chip_smoke.py``
loads it without JAX. Every scenario returns plain JSON values.

The scenarios mirror the reference suites case by case
(``tests/test_serving_service.py``, ``tests/test_serving_fleet.py``):
the same calls, clocks, fault plans and rows. Two changes keep them
comparable between the packages, and each leaves the reference's own
assertions true:

* a scenario on a virtual clock also runs the telemetry clock on it
  (``spans.set_clock``), as the reference's deterministic load test does:
  the serve-family histograms then hold the fault plan's simulated
  seconds and no host time, so ``stats()``'s ``pipelineP95Ms`` and every
  deadline verdict are the same in both packages;
* a scenario with worker threads compares what the threads cannot
  reorder (outcomes, results, the reconciliation counters), not the
  batch count or the queue's peak.

The models: ``trained`` is the service suite's ``trained`` fixture (a
``BinaryClassificationModelSelector`` over ``LogisticRegression``,
``reg_param=0.01``, 2 folds, on ``x1``, ``x2`` of ``binary_ds(120, 3)``),
``trained_fused`` its ``trained_fused`` (``x1`` and a ``city`` pick list,
96 rows of seed 5), both trained and saved by the JAX package under
``tests/fixtures/torch_serving_plane/``; the tree models are the serving
fixtures ``xgb`` and ``rf`` (``tests/fixtures/torch_serving/``).
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import threading
import time
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
PLANE = os.path.join(ROOT, "tests", "fixtures", "torch_serving_plane")
SERVING = os.path.join(ROOT, "tests", "fixtures", "torch_serving")
RESULTS = os.path.join(PLANE, "jax_results.json")

#: logistic results: within this of the JAX closure's; trees EQUAL
GLM_ATOL = 1e-6

#: (d) on the card and in the generator: the canary's deterministic run
CANARY = {"rate": 1000.0, "duration": 0.5, "seed": 5, "service_time": 0.002,
          "replicas": 2}


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def package(name: str, device: str = "cpu"):
    """One package's entry points: the serving plane, the fault plan, the
    telemetry modules, the sentinels, ``load(path)`` and
    ``score(model, **kw)``."""
    ns = types.SimpleNamespace(name=name, device=device)
    if name == "jax":
        import transmogrifai_tpu.serving as serving
        import transmogrifai_tpu.types as T
        from transmogrifai_tpu.dataset import Dataset
        from transmogrifai_tpu.features import from_dataset
        from transmogrifai_tpu.insights import ledger
        from transmogrifai_tpu.local import scoring
        from transmogrifai_tpu.resilience import faults, guards, sentinel
        from transmogrifai_tpu.serving import (
            deadline, fleet, loadtest, queue, router, service, shedding,
        )
        from transmogrifai_tpu.telemetry import (
            events, export, metrics, runlog, spans,
        )
        from transmogrifai_tpu.types import columns
        from transmogrifai_tpu.workflow.persistence import load_workflow_model

        ns.load = load_workflow_model
        ns.score = scoring.score_function
    else:
        import transmogrifai_tpu_torch.serving as serving
        import transmogrifai_tpu_torch.types as T
        from transmogrifai_tpu_torch.dataset import Dataset
        from transmogrifai_tpu_torch.features import from_dataset
        from transmogrifai_tpu_torch.insights import ledger
        from transmogrifai_tpu_torch.local import scoring
        from transmogrifai_tpu_torch.resilience import faults, guards, sentinel
        from transmogrifai_tpu_torch.serving import (
            deadline, fleet, loadtest, queue, router, service, shedding,
        )
        from transmogrifai_tpu_torch.telemetry import (
            events, export, metrics, runlog, spans,
        )
        from transmogrifai_tpu_torch.types import columns
        from transmogrifai_tpu_torch.workflow.persistence import (
            load_workflow_model,
        )

        ns.load = lambda path: load_workflow_model(path, device=device)
        ns.score = lambda model, **kw: scoring.score_function(
            model, device=device, **kw)
    ns.serving, ns.T, ns.Dataset, ns.columns = serving, T, Dataset, columns
    ns.from_dataset, ns.ledger = from_dataset, ledger
    ns.faults, ns.guards, ns.sentinel = faults, guards, sentinel
    ns.deadline, ns.fleet, ns.loadtest = deadline, fleet, loadtest
    ns.queue, ns.router, ns.service, ns.shedding = queue, router, service, shedding
    ns.events, ns.export, ns.metrics = events, export, metrics
    ns.runlog, ns.spans = runlog, spans
    return ns


def reset(P) -> None:
    """Fresh process state of one package: no fault plan, the real
    telemetry clock, empty metrics / spans / events, no shed flag, and
    no service or fleet of an earlier scenario left in the exposition."""
    P.faults.uninstall()
    P.spans.set_clock(None)
    P.spans.set_enabled(True)
    P.spans.reset_for_tests()
    P.events.reset_for_tests()
    P.metrics.REGISTRY.reset_metrics_for_tests()
    P.shedding.reset_process_flags_for_tests()
    gc.collect()


@contextlib.contextmanager
def virtual_telemetry(P, clock):
    """The telemetry clock on ``clock`` for the block (see the module
    docstring)."""
    P.spans.set_clock(clock)
    try:
        yield
    finally:
        P.spans.set_clock(None)


# --------------------------------------------------------------- the data
def binary_ds(P, n: int = 160, seed: int = 0):
    """The service suite's two-feature binary table."""
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n)
    x2 = rng.normal(size=n)
    label = (x1 + 0.5 * x2 + 0.3 * rng.normal(size=n) > 0).astype(float)
    cfv = P.columns.column_from_values
    return P.Dataset.of({
        "label": cfv(P.T.RealNN, label),
        "x1": cfv(P.T.Real, x1),
        "x2": cfv(P.T.Real, x2),
    })


def fused_ds(P):
    """The service suite's ``trained_fused`` table."""
    rng = np.random.default_rng(5)
    n = 96
    x1 = rng.normal(size=n)
    city = [["a", "b", "c"][i % 3] for i in range(n)]
    label = (x1 > 0).astype(float)
    cfv = P.columns.column_from_values
    return P.Dataset.of({
        "label": cfv(P.T.RealNN, label),
        "x1": cfv(P.T.Real, x1),
        "city": cfv(P.T.PickList, city),
    })


def service_rows() -> list[dict]:
    """The service suite's ``rows`` fixture."""
    rng = np.random.default_rng(11)
    return [
        {"x1": float(a), "x2": float(b)}
        for a, b in zip(rng.normal(size=64), rng.normal(size=64))
    ]


def model_path(name: str) -> str:
    if name in ("xgb", "rf", "lr"):
        return os.path.join(SERVING, name)
    return os.path.join(PLANE, name)


def fixture_rows(name: str) -> list[dict]:
    with open(os.path.join(SERVING, name, "rows.json")) as fh:
        return json.load(fh)


_MODELS: dict = {}


def model(P, name: str):
    """The named model, loaded once per package and device."""
    key = (P.name, P.device, name)
    if key not in _MODELS:
        _MODELS[key] = P.load(model_path(name))
    return _MODELS[key]


def score_fn(P, name: str = "trained", **kw):
    """A fresh closure over the named model (the suite's ``score_fn``)."""
    return P.score(model(P, name), **kw)


# ------------------------------------------------------- normalization
def plain(v):
    """A JSON-able form of a value (NaN as the string ``"nan"``)."""
    if isinstance(v, dict):
        return {str(k): plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    if isinstance(v, (np.floating, float)):
        return "nan" if math.isnan(v) else float(v)
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, np.ndarray):
        return plain(v.tolist())
    return v


def error_of(e: BaseException | None):
    """A typed error as ``[class name, reason or family]``."""
    if e is None:
        return None
    return [type(e).__name__, getattr(e, "reason", None)
            or getattr(e, "family", None)]


def handle(h, latency: bool = True) -> dict:
    """One request handle's outcome, results, typed error and latency."""
    out = {"outcome": h.outcome, "results": plain(h.results),
           "error": error_of(h.error), "done": h.done()}
    if latency:
        out["latency"] = plain(h.latency())
    return out


def raised(call) -> list | None:
    """``call()``'s typed exception, or None when it returned."""
    try:
        call()
    except BaseException as e:  # noqa: BLE001 - the scenario records it
        return error_of(e)
    return None


def events(P, kinds=None) -> list:
    """The event log in order, without its wall-clock stamps."""
    out = []
    for e in P.events.recent():
        if kinds is not None and e["kind"] not in kinds:
            continue
        out.append(plain({k: v for k, v in e.items()
                          if k not in ("seq", "ts", "unix")}))
    return out


def threaded_stats(s: dict) -> dict:
    """``stats()`` without what worker threads may reorder: the batch
    count, the queue's peak and the shedder's and batcher's views."""
    return {k: v for k, v in s.items()
            if k not in ("batches", "queuePeakRows", "shedding", "batcher")}


def same(got, want, atol: float = 0.0, path: str = "") -> None:
    """``got`` EQUAL ``want``, floats within ``atol`` (plus ``atol`` of
    their size) where ``atol`` is given; raises AssertionError naming the
    first difference."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise AssertionError(f"{path}: keys {got!r} != {want!r}")
        for k in want:
            same(got[k], want[k], atol, f"{path}.{k}")
        return
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise AssertionError(f"{path}: {got!r} != {want!r}")
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, atol, f"{path}[{i}]")
        return
    if (atol and isinstance(want, float) and isinstance(got, float)
            and not isinstance(want, bool)):
        if abs(got - want) > atol + atol * abs(want):
            raise AssertionError(f"{path}: {got!r} != {want!r} (atol {atol})")
        return
    if got != want:
        raise AssertionError(f"{path}: {got!r} != {want!r}")


# ================================================================ units
class _Req:
    """A minimal queue item: anything with .rows / .budget / .enqueued_at."""


def mkreq(n_rows: int = 1, budget=None, enq: float = 0.0):
    r = _Req()
    r.rows = [{"x1": 0.0}] * n_rows
    r.budget = budget
    r.enqueued_at = enq
    return r


def u_queue_bounded(P):
    q = P.serving.AdmissionQueue(max_rows=4)
    q.offer(mkreq(3))
    err = raised(lambda: q.offer(mkreq(2)))
    q.offer(mkreq(1))
    return {"err": err, "depth": q.depth_rows(), "peak": q.peak_rows}


def u_queue_fifo(P):
    q = P.serving.AdmissionQueue(max_rows=64)
    items = [mkreq(3), mkreq(3), mkreq(3)]
    for it in items:
        q.offer(it)
    got = q.pop_many(max_rows=6)
    return {"got": [items.index(g) for g in got], "depth": q.depth_rows()}


def u_queue_oversized(P):
    q = P.serving.AdmissionQueue(max_rows=64)
    big = mkreq(32)
    q.offer(big)
    got = q.pop_many(max_rows=8)
    return {"got": [g is big for g in got], "depth": q.depth_rows()}


def u_queue_closed(P):
    q = P.serving.AdmissionQueue(max_rows=8)
    q.offer(mkreq(1))
    q.close()
    err = raised(lambda: q.offer(mkreq(1)))
    return {"err": err, "drained": len(q.drain()), "depth": q.depth_rows(),
            "closed": q.closed}


def u_queue_unknown_reason(P):
    return {"err": raised(lambda: P.serving.RejectedByAdmission("nope"))}


def u_deadline_remaining(P):
    clk = FakeClock()
    b = P.serving.DeadlineBudget(0.100, clock=clk)
    clk.now = 0.040
    out = {"remaining": b.remaining(), "expired": b.expired()}
    clk.now = 0.120
    out["expired_later"] = b.expired()
    return out


def u_deadline_consume(P):
    clk = FakeClock()
    b = P.serving.DeadlineBudget(0.100, clock=clk)
    b.consume(0.075)
    out = {"remaining": b.remaining()}
    b.consume(0.050)
    out["expired"] = b.expired()
    return out


def u_deadline_covers(P):
    clk = FakeClock()
    h = P.metrics.REGISTRY.histogram(
        "tptpu_serve_seconds", labels={"stage": "dispatch"})
    for _ in range(50):
        h.observe(0.050)
    tight = P.serving.DeadlineBudget(0.010, clock=clk)
    roomy = P.serving.DeadlineBudget(1.0, clock=clk)
    return {"p95": P.deadline.family_p95("dispatch"),
            "tight": tight.covers(), "roomy": roomy.covers()}


def u_deadline_checkpoint(P):
    clk = FakeClock()
    h = P.metrics.REGISTRY.histogram(
        "tptpu_serve_seconds", labels={"stage": "featurize"})
    for _ in range(50):
        h.observe(0.080)
    b = P.serving.DeadlineBudget(0.020, clock=clk)
    with P.deadline.active(b):
        P.deadline.checkpoint("sentinel")
        try:
            P.deadline.checkpoint("featurize")
            err = None
        except P.serving.DeadlineExceeded as e:
            err = [e.family, e.required > e.remaining]
    return {"err": err, "events": events(P, ("deadline_exceeded",)),
            "counter": P.metrics.REGISTRY.counter(
                "tptpu_serve_deadline_exceeded_total").value}


def u_deadline_no_history(P):
    clk = FakeClock()
    b = P.serving.DeadlineBudget(0.010, clock=clk)
    with P.deadline.active(b):
        first = raised(lambda: P.deadline.checkpoint("dispatch"))
        clk.now = 0.020
        second = raised(lambda: P.deadline.checkpoint("dispatch"))
    return {"first": first, "second": second}


def u_deadline_thread_local(P):
    b1 = P.serving.DeadlineBudget(1.0, clock=FakeClock())
    b2 = P.serving.DeadlineBudget(2.0, clock=FakeClock())
    seq = [P.deadline.current() is None]
    with P.deadline.active(b1):
        seq.append(P.deadline.current() is b1)
        with P.deadline.active(b2):
            seq.append(P.deadline.current() is b2)
        seq.append(P.deadline.current() is b1)
    seq.append(P.deadline.current() is None)
    seen = []
    with P.deadline.active(b1):
        th = threading.Thread(target=lambda: seen.append(P.deadline.current()))
        th.start()
        th.join()
    return {"seq": seq, "other_thread": [s is None for s in seen]}


def u_batcher_assembles(P):
    q = P.serving.AdmissionQueue(max_rows=64)
    mb = P.serving.MicroBatcher(q, max_rows=4, clock=FakeClock())
    for _ in range(3):
        q.offer(mkreq(2))
    plan = mb.next_batch()
    return {"requests": len(plan.requests), "rows": len(plan.rows),
            "stats": mb.stats()}


def u_batcher_expired(P):
    q = P.serving.AdmissionQueue(max_rows=64)
    clk = FakeClock()
    mb = P.serving.MicroBatcher(q, max_rows=16, clock=clk)
    dead = P.serving.DeadlineBudget(0.010, clock=clk)
    live = P.serving.DeadlineBudget(10.0, clock=clk)
    q.offer(mkreq(1, budget=dead))
    q.offer(mkreq(1, budget=live))
    clk.now = 0.020
    plan = mb.next_batch()
    return {"expired": len(plan.expired), "requests": len(plan.requests),
            "budget_is_live": plan.budget is live,
            "max_wait_s": plan.max_wait_s, "stats": mb.stats()}


def u_batcher_tightest(P):
    q = P.serving.AdmissionQueue(max_rows=64)
    clk = FakeClock()
    mb = P.serving.MicroBatcher(q, max_rows=16, clock=clk)
    loose = P.serving.DeadlineBudget(10.0, clock=clk)
    tight = P.serving.DeadlineBudget(1.0, clock=clk)
    q.offer(mkreq(1, budget=loose))
    q.offer(mkreq(1, budget=tight))
    q.offer(mkreq(1))
    plan = mb.next_batch()
    return {"budget_is_tight": plan.budget is tight, "rows": len(plan.rows)}


def _shed_flags(P) -> dict:
    return {"detail": P.spans.stage_detail(1000),
            "drift": P.shedding.drift_shed(),
            "explain": P.shedding.explain_shed()}


def u_shed_tiers(P):
    sh = P.serving.LoadShedder(P.serving.ShedConfig(), capacity=100)
    tiers = [sh.update(d, 0, 0.0) for d in (10, 40, 55, 75, 95)]
    return {"tiers": tiers, "reject": sh.reject_admissions,
            "stats": sh.stats()}


def u_shed_hysteresis(P):
    sh = P.serving.LoadShedder(P.serving.ShedConfig(), capacity=100)
    sh.update(95, 0, 0.0)
    seq = [sh.tier]
    sh.update(80, 0, 0.0)
    seq.append(sh.tier)
    transitions = sh.transitions
    for _ in range(10):
        sh.update(80, 0, 0.0)
    flapped = sh.transitions != transitions
    sh.update(60, 0, 0.0)
    seq.append(sh.tier)
    sh.update(10, 0, 0.0)
    seq.append(sh.tier)
    return {"seq": seq, "flapped": flapped, "stats": sh.stats()}


def u_shed_side_effects(P):
    sh = P.serving.LoadShedder(P.serving.ShedConfig(), capacity=100)
    seq = [_shed_flags(P)]
    for d in (40, 55, 75, 5):
        sh.update(d, 0, 0.0)
        seq.append(_shed_flags(P))
    return {"seq": seq}


def u_shed_breakers(P):
    sh = P.serving.LoadShedder(
        P.serving.ShedConfig(breaker_weight=0.5), capacity=100)
    return {"tiers": [sh.update(30, 0, 0.0), sh.update(30, 0, 0.5)]}


def u_shed_events(P):
    sh = P.serving.LoadShedder(P.serving.ShedConfig(), capacity=100)
    sh.update(95, 0, 0.0)
    return {"events": events(P, ("load_shed",)),
            "transitions": P.metrics.REGISTRY.counter(
                "tptpu_serve_shed_transitions_total").value}


def u_shed_invalid(P):
    return {"err": raised(lambda: P.serving.ShedConfig(
        detail_enter=0.3, detail_exit=0.5))}


def u_shed_reset(P):
    sh = P.serving.LoadShedder(P.serving.ShedConfig(), capacity=100)
    sh.update(95, 0, 0.0)
    sh.reset()
    return {"tier": sh.tier, "flags": _shed_flags(P)}


UNITS = {
    "queue_bounded": u_queue_bounded,
    "queue_fifo": u_queue_fifo,
    "queue_oversized": u_queue_oversized,
    "queue_closed": u_queue_closed,
    "queue_unknown_reason": u_queue_unknown_reason,
    "deadline_remaining": u_deadline_remaining,
    "deadline_consume": u_deadline_consume,
    "deadline_covers": u_deadline_covers,
    "deadline_checkpoint": u_deadline_checkpoint,
    "deadline_no_history": u_deadline_no_history,
    "deadline_thread_local": u_deadline_thread_local,
    "batcher_assembles": u_batcher_assembles,
    "batcher_expired": u_batcher_expired,
    "batcher_tightest": u_batcher_tightest,
    "shed_tiers": u_shed_tiers,
    "shed_hysteresis": u_shed_hysteresis,
    "shed_side_effects": u_shed_side_effects,
    "shed_breakers": u_shed_breakers,
    "shed_events": u_shed_events,
    "shed_invalid": u_shed_invalid,
    "shed_reset": u_shed_reset,
}


# ==================================================== service scenarios
def _svc(P, fn, clock=None, **cfg):
    return P.serving.ScoringService(
        fn, P.serving.ServiceConfig(**cfg), clock=clock)


def _drain(svc) -> None:
    while svc.pump():
        pass


def s_pump_mode(P):
    rows = service_rows()
    clk = P.serving.VirtualClock()
    with virtual_telemetry(P, clk):
        svc = _svc(P, score_fn(P), clk, workers=0, max_queue_rows=64,
                   max_batch_rows=8)
        svc.start()
        hs = [svc.submit(dict(r)) for r in rows[:20]]
        _drain(svc)
        svc.stop()
    return {"stats": svc.stats(), "handles": [handle(h) for h in hs]}


def s_map_back(P):
    rows = service_rows()
    fn = score_fn(P)
    clk = P.serving.VirtualClock()
    with virtual_telemetry(P, clk):
        svc = _svc(P, fn, clk, workers=0, max_queue_rows=64,
                   max_batch_rows=16)
        svc.start()
        h2 = svc.submit([dict(rows[0]), dict(rows[1])])
        h1 = svc.submit(dict(rows[2]))
        _drain(svc)
        svc.stop()
        solo = fn.batch([dict(rows[0]), dict(rows[1]), dict(rows[2])])
    return {"h2": handle(h2), "h1": handle(h1), "solo": plain(solo),
            "h2_is_solo": h2.result(timeout=1) == solo[:2],
            "h1_is_solo": h1.result(timeout=1) == solo[2:],
            "stats": svc.stats()}


def _serve_threads_alive() -> list[str]:
    return [t.name for t in threading.enumerate()
            if t.name.startswith("tptpu-serve-") and t.is_alive()]


def s_worker_mode(P):
    rows = service_rows()
    svc = _svc(P, score_fn(P), workers=2, max_queue_rows=128,
               max_batch_rows=16)
    svc.start()
    hs = [svc.submit(dict(rows[i % len(rows)])) for i in range(40)]
    for h in hs:
        h.result(timeout=60)
    svc.stop()
    return {"stats": threaded_stats(svc.stats()),
            "handles": [handle(h, latency=False) for h in hs],
            "threads": _serve_threads_alive()}


def s_submit_after_stop(P):
    svc = _svc(P, score_fn(P), workers=0)
    svc.start()
    svc.stop()
    err = raised(lambda: svc.submit(dict(service_rows()[0])))
    return {"err": err, "rejected": svc.stats()["rejected"]}


def s_stop_drains(P):
    rows = service_rows()
    clk = P.serving.VirtualClock()
    with virtual_telemetry(P, clk):
        svc = _svc(P, score_fn(P), clk, workers=0, max_queue_rows=64,
                   max_batch_rows=8)
        svc.start()
        hs = [svc.submit(dict(r)) for r in rows[:10]]
        svc.stop(drain=True)
    return {"stats": svc.stats(), "handles": [handle(h) for h in hs]}


def s_stop_resets_gauges(P):
    rows = service_rows()
    clk = P.serving.VirtualClock()
    with virtual_telemetry(P, clk):
        svc = _svc(P, score_fn(P), clk, workers=0, max_queue_rows=64,
                   max_batch_rows=8)
        svc.start()
        for r in rows[:6]:
            svc.submit(dict(r))
        before = P.metrics.REGISTRY.gauge("tptpu_serve_queue_depth").value
        svc.stop(drain=True)
        text = P.export.render_prometheus()
    return {"before": before,
            "queue_zero": "tptpu_serve_queue_depth 0" in text,
            "in_flight_zero": "tptpu_serve_in_flight_rows 0" in text,
            "outstanding": svc.stats()["outstanding"]}


def s_context_manager(P):
    with _svc(P, score_fn(P), workers=1) as svc:
        h = svc.submit(dict(service_rows()[0]))
        h.result(timeout=30)
    return {"outstanding": svc.stats()["outstanding"],
            "handle": handle(h, latency=False)}


def s_empty_request(P):
    svc = _svc(P, score_fn(P), workers=0)
    svc.start()
    err = raised(lambda: svc.submit([]))
    svc.stop()
    return {"err": err}


def s_primes_fusion(P):
    fn = score_fn(P, "trained_fused")
    before = [fn.fusion.disabled, fn.fusion.ready()]
    clk = P.serving.VirtualClock()
    with virtual_telemetry(P, clk):
        svc = _svc(P, fn, clk, workers=0)
        svc.start()
        ready = fn.fusion.ready()
        h = svc.submit({"x1": 0.1, "city": "a"})
        svc.pump()
        svc.stop()
        fresh = score_fn(P, "trained_fused").batch([{"x1": 0.1, "city": "a"}])
    return {"before": before, "ready": ready, "handle": handle(h),
            "ready_after_batch": fn.fusion.ready(),
            "equals_fresh": h.result(timeout=1) == fresh}


def s_prime_disabled(P):
    fn = score_fn(P)
    return {"disabled": fn.fusion.disabled, "prime": fn.fusion.prime()}


def s_unhealthy_batch(P):
    fn = score_fn(P, isolation="raise", breaker=False)
    clk = P.serving.VirtualClock()
    with virtual_telemetry(P, clk):
        svc = _svc(P, fn, clk, workers=0, max_batch_rows=8)
        svc.start()
        plan = P.faults.FaultPlan(seed=1).fail_stage_transform(
            target="modelSelector", times=1)
        with P.faults.installed(plan):
            h = svc.submit(dict(service_rows()[0]))
            svc.pump()
        svc.stop()
    return {"handle": handle(h), "stats": svc.stats(), "fired": plan.fired}


def s_queued_expiry(P):
    rows = service_rows()
    clk = P.serving.VirtualClock()
    with virtual_telemetry(P, clk):
        svc = _svc(P, score_fn(P), clk, workers=0, max_queue_rows=64,
                   max_batch_rows=8, default_deadline=0.050)
        svc.start()
        h = svc.submit(dict(rows[0]))
        clk.advance(0.100)
        h2 = svc.submit(dict(rows[1]))
        _drain(svc)
        svc.stop()
    return {"h": handle(h), "h2": handle(h2), "stats": svc.stats()}


def s_admission_p95(P):
    h = P.metrics.REGISTRY.histogram(
        "tptpu_serve_seconds", labels={"stage": "dispatch"})
    for _ in range(50):
        h.observe(0.200)
    clk = P.serving.VirtualClock()
    with virtual_telemetry(P, clk):
        svc = _svc(P, score_fn(P), clk, workers=0, default_deadline=0.010)
        svc.start()
        err = raised(lambda: svc.submit(dict(service_rows()[0])))
        svc.stop()
    return {"err": err, "stats": svc.stats()}


def s_slow_stage_burns(P):
    clk = P.serving.VirtualClock()
    with virtual_telemetry(P, clk):
        svc = _svc(P, score_fn(P), clk, workers=0, max_batch_rows=8,
                   default_deadline=0.100)
        svc.start()
        plan = P.faults.FaultPlan(seed=2).slow_stage(delay=0.500)
        with P.faults.installed(plan):
            hd = svc.submit(dict(service_rows()[0]))
            svc.pump()
        svc.stop()
    return {"handle": handle(hd), "stats": svc.stats(), "fired": plan.fired}


def s_mid_execution_deadline(P):
    rows = service_rows()
    clk = P.serving.VirtualClock()
    with virtual_telemetry(P, clk):
        svc = _svc(P, score_fn(P), clk, workers=0, max_batch_rows=8)
        svc.start()
        plan = P.faults.FaultPlan(seed=7).slow_stage(delay=0.500)
        with P.faults.installed(plan):
            tight = svc.submit(dict(rows[0]), deadline=0.100)
            loose = svc.submit(dict(rows[1]))
            svc.pump()
            _drain(svc)
        svc.stop()
    return {"tight": handle(tight), "loose": handle(loose),
            "stats": svc.stats()}


#: thresholds pushed above any reachable load (the suite's ``NO_SHED``)
def no_shed(P):
    return P.serving.ShedConfig(
        explain_enter=2.0, explain_exit=1.0,
        detail_enter=3.0, detail_exit=2.0, drift_enter=5.0, drift_exit=4.0,
        reject_enter=9.0, reject_exit=8.0,
    )


def s_queue_full(P):
    rows = service_rows()
    clk = P.serving.VirtualClock()
    with virtual_telemetry(P, clk):
        svc = _svc(P, score_fn(P), clk, workers=0, max_queue_rows=4,
                   max_batch_rows=4, shed=no_shed(P))
        svc.start()
        hs = [svc.submit(dict(rows[i])) for i in range(4)]
        err = raised(lambda: svc.submit(dict(rows[4])))
        _drain(svc)
        svc.stop()
    return {"err": err, "stats": svc.stats(),
            "handles": [handle(h) for h in hs]}


def s_reject_tier(P):
    rows = service_rows()
    clk = P.serving.VirtualClock()
    with virtual_telemetry(P, clk):
        svc = _svc(P, score_fn(P), clk, workers=0, max_queue_rows=10,
                   max_batch_rows=4, shed=P.serving.ShedConfig(
                       explain_enter=0.25, explain_exit=0.15,
                       detail_enter=0.30, detail_exit=0.20,
                       drift_enter=0.50, drift_exit=0.35,
                       reject_enter=0.85, reject_exit=0.50))
        svc.start()
        for i in range(9):
            svc.submit(dict(rows[i]))
        err = raised(lambda: svc.submit(dict(rows[9])))
        tier = svc.shedder.tier
        _drain(svc)
        tier_after = svc.shedder.tier
        h = svc.submit(dict(rows[9]))
        _drain(svc)
        svc.stop()
    return {"err": err, "tier": tier, "tier_after": tier_after,
            "handle": handle(h), "stats": svc.stats()}


def s_drift_shed(P):
    fn = score_fn(P)
    row = dict(service_rows()[0])
    out = {"enabled": fn.drift.enabled}
    before = fn.drift.rows_observed
    sh = P.serving.LoadShedder(P.serving.ShedConfig(), capacity=100)
    sh.update(75, 0, 0.0)
    try:
        fn.batch([dict(row)])
        out["shed"] = fn.drift.rows_observed - before
    finally:
        sh.reset()
    fn.batch([dict(row)])
    out["restored"] = fn.drift.rows_observed - before
    return out


def s_service_source(P):
    clk = P.serving.VirtualClock()
    with virtual_telemetry(P, clk):
        svc = _svc(P, score_fn(P), clk, workers=0, max_batch_rows=8)
        svc.start()
        for r in service_rows()[:4]:
            svc.submit(dict(r))
        _drain(svc)
        text = P.export.render_prometheus()
        svc.stop()
    return {"lines": exposition(text, ("tptpu_service_",
                                       "tptpu_serve_queue_depth",
                                       "tptpu_serve_in_flight_rows",
                                       "tptpu_serve_admitted_total",
                                       "tptpu_serve_completed_total"))}


def exposition(text: str, prefixes) -> list[str]:
    """The exposition's lines (with their ``# TYPE`` lines) of the metric
    names that start with one of ``prefixes``."""
    out = []
    for ln in text.splitlines():
        name = ln.split(" ")[2] if ln.startswith("# TYPE ") else ln
        if name.startswith(tuple(prefixes)):
            out.append(ln)
    return out


def s_render_no_deadlock(P):
    clk = P.serving.VirtualClock()
    svc = _svc(P, score_fn(P), clk, workers=0, max_queue_rows=100_000)
    svc.start()
    barrier = threading.Barrier(2)
    errors: list = []
    row = dict(service_rows()[0])

    def _submit():
        barrier.wait()
        for _ in range(300):
            try:
                svc.submit(dict(row))
            except BaseException as e:  # noqa: BLE001 - recorded
                errors.append(error_of(e))

    def _render():
        barrier.wait()
        for _ in range(300):
            P.export.render_prometheus()

    threads = [threading.Thread(target=_submit, daemon=True),
               threading.Thread(target=_render, daemon=True)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30.0)
    hung = [th.name for th in threads if th.is_alive()]
    svc.stop()
    return {"hung": hung, "errors": errors,
            "admitted": svc.stats()["admitted"]}


def s_serve_queue_span(P):
    P.spans.reset_for_tests()
    clk = P.serving.VirtualClock()
    with virtual_telemetry(P, clk):
        svc = _svc(P, score_fn(P), clk, workers=0, max_batch_rows=8)
        svc.start()
        for r in service_rows()[:4]:
            svc.submit(dict(r))
        clk.advance(0.005)
        _drain(svc)
        svc.stop()
    queue_spans = [plain({k: v for k, v in e.items() if k != "tid"})
                   for e in P.spans.snapshot_events()
                   if e["name"] == "serve/queue"]
    return {"queue_spans": queue_spans}


def s_shed_reject_reconcile(P):
    rows = service_rows()
    clk = P.serving.VirtualClock()
    with virtual_telemetry(P, clk):
        svc = _svc(P, score_fn(P), clk, workers=0, max_queue_rows=4,
                   max_batch_rows=4, default_deadline=0.050,
                   shed=no_shed(P))
        svc.start()
        svc.submit(dict(rows[0]))
        clk.advance(0.100)
        for i in range(1, 4):
            svc.submit(dict(rows[i]))
        err = raised(lambda: svc.submit(dict(rows[4])))
        _drain(svc)
        svc.stop()
    return {"err": err, "stats": svc.stats(),
            "events": events(P, ("deadline_exceeded",))}


# ---------------------------------------------------- thread-safety hammers
N_THREADS = 8


def hammer(fn, per_thread: int = 200) -> list:
    errs = []
    barrier = threading.Barrier(N_THREADS)

    def run():
        barrier.wait()
        try:
            for _ in range(per_thread):
                fn()
        except Exception as e:  # noqa: BLE001 - recorded
            errs.append(error_of(e))

    threads = [threading.Thread(target=run) for _ in range(N_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return errs


def h_schema_sentinel(P):
    ds = binary_ds(P, 8)
    resp, preds = P.from_dataset(ds, response="label")
    s = P.sentinel.SchemaSentinel([resp, *preds])
    errs = hammer(lambda: s.check_row({"x1": "zzz", "x2": 1.0}))
    return {"errs": errs, "stats": plain(s.stats())}


def h_quarantine_log(P):
    qlog = P.sentinel.QuarantineLog(keep=50)
    counter = {"i": 0}
    lock = threading.Lock()
    bad = []

    def add():
        with lock:
            counter["i"] += 1
            i = counter["i"]
        qlog.start_batch()
        qlog.add(P.sentinel.QuarantineRecord(i, "x1", "stage", "boom"))
        qlog.add(P.sentinel.QuarantineRecord(i, "x2", "stage", "boom"))
        if qlog.batch_rows() != {i} or len(qlog.last) != 2:
            bad.append(i)

    errs = hammer(add, per_thread=100)
    st = qlog.stats()
    return {"errs": errs, "bad": bad, "rows": st["quarantinedRows"],
            "records": st["records"], "byKind": st["byKind"],
            "ring": len(qlog.records)}


def h_score_guard(P):
    guard = P.guards.ScoreGuard()

    class Stage:
        output_name = "out"
        uid = "Stage_000000000001"

    stage = Stage()
    col = P.columns.NumericColumn(
        P.T.Real, np.array([np.nan, 1.0]), np.array([True, True]))
    errs = hammer(lambda: guard.apply(stage, col, is_result=True, num_rows=2),
                  per_thread=100)
    return {"errs": errs, "stats": plain(guard.stats())}


def h_breaker_transitions(P):
    clk = FakeClock()
    br = P.sentinel.CircuitBreaker(
        "s", P.sentinel.BreakerConfig(failure_threshold=3, clock=clk))

    def step():
        if br.allow():
            br.record_failure()

    errs = hammer(step, per_thread=100)
    st = br.stats()
    return {"errs": errs, "state": st["state"],
            "transitions": st["transitions"],
            "short_plus_failures": st["shortCircuits"]
            + st["consecutiveFailures"]}


def h_half_open_probe(P):
    clk = FakeClock()
    br = P.sentinel.CircuitBreaker("s", P.sentinel.BreakerConfig(
        failure_threshold=1, recovery_time=1.0, clock=clk))
    br.allow()
    br.record_failure()
    state0 = br.state
    clk.now = 2.0
    results = []
    barrier = threading.Barrier(N_THREADS)

    def probe():
        barrier.wait()
        results.append(br.allow())

    threads = [threading.Thread(target=probe) for _ in range(N_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out = {"state0": state0, "probes": results.count(True),
           "state": br.state,
           "short_circuits_ok": br.short_circuits >= N_THREADS - 1}
    br.record_success()
    out["after"] = [br.state, all(br.allow() for _ in range(4))]
    return out


def h_release_probe(P):
    clk = FakeClock()
    br = P.sentinel.CircuitBreaker("s", P.sentinel.BreakerConfig(
        failure_threshold=1, recovery_time=1.0, clock=clk))
    br.allow()
    br.record_failure()
    clk.now = 2.0
    seq = [br.allow(), br.allow()]
    br.release_probe()
    seq.append(br.allow())
    br.record_success()
    return {"seq": seq, "state": br.state}


def h_failed_probe(P):
    clk = FakeClock()
    br = P.sentinel.CircuitBreaker("s", P.sentinel.BreakerConfig(
        failure_threshold=1, recovery_time=1.0, clock=clk))
    br.allow()
    br.record_failure()
    clk.now = 1.5
    seq = [br.allow(), br.allow()]
    br.record_failure()
    seq += [br.state, br.allow()]
    clk.now = 3.0
    seq.append(br.allow())
    br.record_success()
    return {"seq": seq, "state": br.state}


def h_concurrent_scoring(P):
    fn = score_fn(P)
    row = dict(service_rows()[0])
    errs = hammer(lambda: fn.batch([dict(row), {"x1": "zzz"}]), per_thread=25)
    md = fn.metadata()
    return {"errs": errs,
            "quarantined": fn.quarantine.stats()["quarantinedRows"],
            "rowsSeen": fn.sentinel.stats()["rowsSeen"],
            "metadata_quarantined": md["quarantine"]["quarantinedRows"]}


def h_metadata_while_scoring(P):
    fn = score_fn(P)
    row = dict(service_rows()[0])
    stop = threading.Event()
    bad = []

    def reader():
        while not stop.is_set():
            drift = fn.metadata()["drift"]
            if drift["enabled"]:
                for f in drift["features"].values():
                    rows_ = f.get("rows")
                    if rows_ is not None and rows_ < 0:
                        bad.append("negative rows")

    th = threading.Thread(target=reader)
    th.start()
    try:
        errs = hammer(lambda: fn.batch([dict(row)]), per_thread=30)
    finally:
        stop.set()
        th.join()
    return {"errs": errs, "bad": bad,
            "observed": fn.drift.rows_observed}


# ------------------------------------------------------ chaos load tests
def l_seed_deterministic(P):
    rows = service_rows()
    kw = dict(rate=100.0, duration=1.0, seed=9,
              service_time=lambda n: 0.004,
              config=P.serving.ServiceConfig(max_queue_rows=64,
                                             max_batch_rows=16))
    fn = score_fn(P)
    a = P.serving.run_loadtest(fn, rows, **kw)
    b = P.serving.run_loadtest(fn, rows, **kw)
    return {"a": a, "same": a == b}


def l_burst_windows(P):
    plan = P.faults.FaultPlan(seed=0).burst_arrivals(
        start=0.5, duration=0.5, multiplier=4.0)
    flat = P.serving.LoadSchedule(rate=100.0, duration=1.0, seed=0).arrivals()
    burst = P.serving.LoadSchedule(
        rate=100.0, duration=1.0, seed=0).arrivals(plan)
    return {"flat": flat, "burst": burst, "fired": plan.fired}


def l_overload(P):
    return P.serving.run_loadtest(
        score_fn(P), service_rows(), rate=400.0, duration=1.5, seed=4,
        deadline=0.100, service_time=lambda n: 0.030,
        config=P.serving.ServiceConfig(max_queue_rows=32, max_batch_rows=8))


def chaos_soak(P, fn=None):
    """The service suite's ``test_full_chaos_soak``: slow stages, a burst
    and stage-failure storms; the report, the plan's firings and the
    service threads alive after it."""
    plan = (
        P.faults.FaultPlan(seed=13)
        .slow_stage(delay=0.020, times=40)
        .burst_arrivals(start=0.3, duration=0.4, multiplier=6.0)
        .fail_stage_transform(target="modelSelector", times=5)
    )
    with P.faults.installed(plan):
        rep = P.serving.run_loadtest(
            fn or score_fn(P), service_rows(), rate=150.0, duration=1.5,
            seed=13, deadline=0.250, service_time=lambda n: 0.010,
            config=P.serving.ServiceConfig(max_queue_rows=48,
                                           max_batch_rows=8),
            plan=plan,
        )
    return {"report": rep, "fired": sorted({k for k, _ in plan.fired}),
            "threads": _serve_threads_alive()}


def l_full_chaos_soak(P):
    first = chaos_soak(P)
    return {"first": first, "rerun_equal": chaos_soak(P) == first}


def l_soak_twice(P):
    def once():
        plan = (
            P.faults.FaultPlan(seed=21)
            .slow_stage(delay=0.015, times=20)
            .burst_arrivals(start=0.2, duration=0.3, multiplier=5.0)
            .fail_stage_transform(target="modelSelector", times=3)
        )
        with P.faults.installed(plan):
            return P.serving.run_loadtest(
                score_fn(P), service_rows(), rate=120.0, duration=1.0,
                seed=21, deadline=0.200, service_time=lambda n: 0.008,
                config=P.serving.ServiceConfig(max_queue_rows=32,
                                               max_batch_rows=8),
                plan=plan,
            )

    a = once()
    return {"report": a, "same": once() == a}


def l_no_real_sleeps(P):
    t0 = time.perf_counter()
    rep = P.serving.run_loadtest(
        score_fn(P), service_rows(), rate=200.0, duration=5.0, seed=3,
        service_time=lambda n: 0.004,
        config=P.serving.ServiceConfig(max_queue_rows=64, max_batch_rows=32))
    return {"report": rep, "_wall": time.perf_counter() - t0}


SERVICE = {
    "pump_mode": s_pump_mode,
    "map_back": s_map_back,
    "worker_mode": s_worker_mode,
    "submit_after_stop": s_submit_after_stop,
    "stop_drains": s_stop_drains,
    "stop_resets_gauges": s_stop_resets_gauges,
    "context_manager": s_context_manager,
    "empty_request": s_empty_request,
    "primes_fusion": s_primes_fusion,
    "prime_disabled": s_prime_disabled,
    "unhealthy_batch": s_unhealthy_batch,
    "queued_expiry": s_queued_expiry,
    "admission_p95": s_admission_p95,
    "slow_stage_burns": s_slow_stage_burns,
    "mid_execution_deadline": s_mid_execution_deadline,
    "queue_full": s_queue_full,
    "reject_tier": s_reject_tier,
    "drift_shed": s_drift_shed,
    "service_source": s_service_source,
    "render_no_deadlock": s_render_no_deadlock,
    "serve_queue_span": s_serve_queue_span,
    "shed_reject_reconcile": s_shed_reject_reconcile,
    "hammer_schema_sentinel": h_schema_sentinel,
    "hammer_quarantine_log": h_quarantine_log,
    "hammer_score_guard": h_score_guard,
    "hammer_breaker_transitions": h_breaker_transitions,
    "hammer_half_open_probe": h_half_open_probe,
    "hammer_release_probe": h_release_probe,
    "hammer_failed_probe": h_failed_probe,
    "hammer_concurrent_scoring": h_concurrent_scoring,
    "hammer_metadata_while_scoring": h_metadata_while_scoring,
    "loadtest_seed_deterministic": l_seed_deterministic,
    "loadtest_burst_windows": l_burst_windows,
    "loadtest_overload": l_overload,
    "loadtest_full_chaos_soak": l_full_chaos_soak,
    "loadtest_soak_twice": l_soak_twice,
    "loadtest_no_real_sleeps": l_no_real_sleeps,
}


def tree_service(P, name: str = "xgb", n: int = 48) -> dict:
    """A tree model's rows through a pump-mode service (batches of 8):
    every result EQUAL the JAX closure's."""
    rows = (fixture_rows(name) * -(-n // len(fixture_rows(name))))[:n]
    clk = P.serving.VirtualClock()
    with virtual_telemetry(P, clk):
        svc = _svc(P, score_fn(P, name), clk, workers=0, max_batch_rows=8)
        svc.start()
        hs = [svc.submit(dict(r)) for r in rows]
        _drain(svc)
        svc.stop()
    return {"stats": svc.stats(), "handles": [handle(h) for h in hs]}


# ====================================================== fleet scenarios
class _Stage:
    """The minimal stage shape the fault plan's duration seam matches."""

    uid = "FakeStage_000000000001"
    operation_name = "fakeOp"
    output_name = "fakeStage"


STAGE = _Stage()


def stub(P, offset: float = 0.0):
    """The fleet suite's ``Fn``: one result row per input row with a
    ``prediction`` of ``offset + x1``, and the stage-duration seam (so
    ``slow_stage`` / ``slow_replica`` charge simulated seconds), over
    ``P``'s fault plan."""

    class Fn:
        def __init__(self):
            self.offset = float(offset)
            self.calls = 0
            self.rows_seen = 0

        def batch(self, rows, explain=0):
            plan = P.faults.active()
            if plan is not None:
                plan.on_stage_duration(STAGE)
            self.calls += 1
            self.rows_seen += len(rows)
            return [{"pred": {"prediction": self.offset
                              + float(r.get("x1", 0.0))}} for r in rows]

    return Fn()


def _cfg(P, **kw):
    kw.setdefault("workers", 0)
    kw.setdefault("max_queue_rows", 64)
    return P.serving.ServiceConfig(**kw)


def _fleet(P, n=2, clock=None, fn=None, service=None, **fleet_kw):
    fc = P.serving.FleetConfig(replicas=n, service=service or _cfg(P),
                               **fleet_kw)
    fleet = P.serving.FleetService(fn or stub(P), config=fc,
                                   clock=clock or FakeClock())
    return fleet.start()


def _rows(n):
    return [{"x1": float(i)} for i in range(n)]


@contextlib.contextmanager
def _plan(P):
    """An installed, empty fault plan (the suite's ``fault_plan``)."""
    plan = P.faults.FaultPlan()
    with P.faults.installed(plan):
        yield plan


def fleet_state(fleet) -> dict:
    return {"stats": plain(fleet.stats()), "reconcile": fleet.reconcile()}


def f_slow_keyed(P):
    with _plan(P) as plan:
        plan.slow_stage(delay=0.5, replica=1)
        with P.faults.replica_scope(0):
            a = plan.on_stage_duration(STAGE)
        with P.faults.replica_scope(1):
            b = plan.on_stage_duration(STAGE)
        c = plan.on_stage_duration(STAGE)
        return {"durations": [a, b, c], "fired": plan.fired}


def f_slow_replica(P):
    with _plan(P) as plan:
        plan.slow_replica(2, delay=0.25)
        with P.faults.replica_scope(2):
            a = plan.on_stage_duration(STAGE)
        with P.faults.replica_scope(0):
            b = plan.on_stage_duration(STAGE)
        return {"durations": [a, b]}


def f_scope_nesting(P):
    seq = [P.faults.current_replica()]
    with P.faults.replica_scope(0):
        seq.append(P.faults.current_replica())
        with P.faults.replica_scope(1):
            seq.append(P.faults.current_replica())
        seq.append(P.faults.current_replica())
    seq.append(P.faults.current_replica())
    return {"seq": seq}


def f_burst_pinning(P):
    with _plan(P) as plan:
        plan.burst_arrivals(1.0, 0.5, multiplier=4.0, replica=1)
        return {"pins": [plan.burst_replica(t) for t in (1.2, 0.5, 1.5)],
                "mult": [plan.arrival_multiplier(t) for t in (1.2, 0.5)],
                "fired": plan.fired}


def f_kill_once(P):
    with _plan(P) as plan:
        plan.kill_replica(1, at=2.0)
        return {"due": [plan.replicas_to_kill(t) for t in (1.0, 2.0, 3.0)],
                "fired": plan.fired}


def f_partition_window(P):
    with _plan(P) as plan:
        plan.partition_replica(0, start=1.0, duration=2.0)
        return {"in": [plan.replica_partitioned(0, t) for t in (0.5, 1.5, 3.0)],
                "other": plan.replica_partitioned(1, 1.5),
                "fired": plan.fired}


def f_partition_duration(P):
    with _plan(P) as plan:
        return {"err": raised(lambda: plan.partition_replica(0, duration=0.0))}


def f_stop_unknown_mode(P):
    svc = P.serving.ScoringService(stub(P), config=_cfg(P),
                                   clock=FakeClock()).start()
    err = raised(lambda: svc.stop(mode="bogus"))
    svc.stop()
    return {"err": err}


def f_reject_then_drain(P):
    svc = P.serving.ScoringService(stub(P), config=_cfg(P),
                                   clock=FakeClock()).start()
    hs = [svc.submit({"x1": float(i)}) for i in range(3)]
    orphans = svc.stop(mode="reject_new_then_drain")
    return {"orphans": len(orphans), "handles": [handle(h) for h in hs],
            "stats": plain(svc.stats())}


def f_default_drain(P):
    svc = P.serving.ScoringService(stub(P), config=_cfg(P),
                                   clock=FakeClock()).start()
    hs = [svc.submit({"x1": float(i)}) for i in range(3)]
    orphans = svc.stop()
    return {"orphans": orphans, "handles": [handle(h) for h in hs],
            "stats": plain(svc.stats())}


def f_stop_vs_submit(P):
    svc = P.serving.ScoringService(
        stub(P), config=_cfg(P, max_queue_rows=10_000),
        clock=FakeClock()).start()
    barrier = threading.Barrier(8)
    handles, rejects, errors = [], [], []
    lock = threading.Lock()

    def submitter():
        barrier.wait()
        for i in range(50):
            try:
                h = svc.submit({"x1": float(i)})
                with lock:
                    handles.append(h)
            except P.serving.RejectedByAdmission as e:
                with lock:
                    rejects.append(e.reason)
            except BaseException as e:  # noqa: BLE001 - the trap
                with lock:
                    errors.append(error_of(e))

    def stopper():
        barrier.wait()
        svc.stop(mode="reject_new_then_drain")

    threads = [threading.Thread(target=submitter) for _ in range(7)]
    threads.append(threading.Thread(target=stopper))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    s = svc.stats()
    return {"errors": errors,
            "settled_stopped": all(h.done() and h.outcome == "stopped"
                                   for h in handles),
            "reject_reasons": sorted(set(rejects)),
            "admitted_is_handles": s["admitted"] == len(handles),
            "outstanding": s["outstanding"],
            "rejected_is_rejects":
                s["rejected"].get("stopped", 0) == len(rejects),
            "total": len(handles) + len(rejects)}


def f_router_tie_break(P):
    fleet = _fleet(P, n=3, clock=FakeClock())
    try:
        r = fleet.router
        idle = r.order()
        for _ in range(3):
            fleet.submit({"x1": 1.0}, pin=0)
        loads = [r.load(i) for i in range(3)]
        order = r.order()
        fleet.pump_until_quiet()
    finally:
        fleet.stop()
    return {"idle": idle, "loads": loads, "order": order,
            **fleet_state(fleet)}


def f_router_unroutable(P):
    clock = FakeClock()
    with _plan(P) as plan:
        fleet = _fleet(P, n=3, clock=clock)
        try:
            fleet.lose_replica(1)
            out = {"routable1": fleet.router.routable(1)}
            plan.partition_replica(2, start=0.0, duration=10.0)
            clock.now = 1.0
            out.update(routable2=fleet.router.routable(2),
                       score2=str(fleet.router.score(2)),
                       order=fleet.router.order(), pick=fleet.router.pick())
        finally:
            fleet.stop()
    return {**out, **fleet_state(fleet)}


def f_exactly_once(P):
    fleet = _fleet(P, n=3)
    try:
        hs = [fleet.submit(r) for r in _rows(9)]
        fleet.pump_until_quiet()
    finally:
        fleet.stop()
    return {"handles": [handle(h) for h in hs], **fleet_state(fleet)}


def f_queue_full_falls_through(P):
    fleet = _fleet(P, n=2, service=_cfg(P, max_queue_rows=2))
    try:
        fleet.submit({"x1": 0.0}, pin=0)
        fleet.submit({"x1": 1.0}, pin=0)
        h = fleet.submit({"x1": 2.0}, pin=0)
        dispatched = dict(fleet.router.stats()["dispatched"])
        fleet.pump_until_quiet()
    finally:
        fleet.stop()
    return {"dispatched": plain(dispatched), "handle": handle(h),
            **fleet_state(fleet)}


def f_every_replica_full(P):
    shed = P.serving.ShedConfig(reject_enter=9.0, reject_exit=8.0)
    fleet = _fleet(P, n=2, service=_cfg(P, max_queue_rows=1, shed=shed))
    try:
        fleet.submit({"x1": 0.0})
        fleet.submit({"x1": 1.0})
        err = raised(lambda: fleet.submit({"x1": 2.0}))
        before = plain(fleet.stats())
        fleet.pump_until_quiet()
    finally:
        fleet.stop()
    return {"err": err, "before": before, **fleet_state(fleet)}


def f_no_routable(P):
    fleet = _fleet(P, n=2)
    fleet.lose_replica(0)
    fleet.lose_replica(1)
    err = raised(lambda: fleet.submit({"x1": 0.0}))
    fleet.stop()
    return {"err": err, **fleet_state(fleet)}


def f_fleet_source(P):
    fleet = _fleet(P, n=2)
    try:
        for r in _rows(4):
            fleet.submit(r)
        fleet.pump_until_quiet()
        text = P.export.render_prometheus()
    finally:
        fleet.stop()
    return {"lines": exposition(text, ("tptpu_fleet_", "tptpu_service_"))}


def f_partition_hedge(P):
    clock = FakeClock()
    with _plan(P) as plan:
        fleet = _fleet(P, n=2, clock=clock, heartbeat_timeout=1e9)
        try:
            P.events.reset_for_tests()
            plan.partition_replica(0, start=5.0, duration=100.0)
            h = fleet.submit({"x1": 3.0}, deadline=10.0, pin=0)
            clock.now = 6.0
            fleet.tick()
            hedges = fleet.hedges_fired
            fleet.pump_until_quiet()
        finally:
            fleet.stop()
    return {"hedges": hedges, "handle": handle(h),
            "duplicates": fleet.hedge_duplicates,
            "events": events(P), **fleet_state(fleet)}


def f_no_hedge_margin(P):
    clock = FakeClock()
    fleet = _fleet(P, n=2, clock=clock)
    try:
        fleet.submit({"x1": 0.0}, deadline=10.0, pin=0)
        clock.now = 6.0
        fleet.tick()
        hedges = fleet.hedges_fired
        fleet.pump_until_quiet()
    finally:
        fleet.stop()
    return {"hedges": hedges, **fleet_state(fleet)}


def f_hedge_once(P):
    clock = FakeClock()
    with _plan(P) as plan:
        fleet = _fleet(P, n=3, clock=clock, heartbeat_timeout=1e9)
        try:
            plan.partition_replica(0, start=1.0, duration=100.0)
            fleet.submit({"x1": 0.0}, deadline=10.0, pin=0)
            clock.now = 6.0
            fleet.tick()
            clock.now = 7.0
            fleet.tick()
            hedges = fleet.hedges_fired
            fleet.pump_until_quiet()
        finally:
            fleet.stop()
    return {"hedges": hedges, **fleet_state(fleet)}


def f_kill_adopts(P):
    fleet = _fleet(P, n=2)
    try:
        P.events.reset_for_tests()
        hs = [fleet.submit(r, pin=0) for r in _rows(3)]
        adopted = fleet.lose_replica(0, reason="killed")
        fleet.pump_until_quiet()
        again = fleet.lose_replica(0)
    finally:
        fleet.stop()
    return {"adopted": adopted, "again": again,
            "handles": [handle(h) for h in hs], "events": events(P),
            **fleet_state(fleet)}


def f_scripted_kill(P):
    clock = FakeClock()
    with _plan(P) as plan:
        fleet = _fleet(P, n=2, clock=clock)
        try:
            plan.kill_replica(1, at=2.0)
            fleet.tick()
            lost0 = sorted(fleet.lost)
            clock.now = 2.5
            fleet.tick()
            lost1 = sorted(fleet.lost)
        finally:
            fleet.stop()
        return {"lost": [lost0, lost1], "fired": plan.fired,
                **fleet_state(fleet)}


def f_heartbeat_loss(P):
    clock = FakeClock()
    with _plan(P) as plan:
        fleet = _fleet(P, n=2, clock=clock, heartbeat_timeout=5.0)
        try:
            fleet.tick()
            plan.partition_replica(1, start=0.5, duration=100.0)
            clock.now = 1.0
            fleet.tick()
            lost0 = sorted(fleet.lost)
            clock.now = 7.0
            fleet.tick()
            lost1 = sorted(fleet.lost)
        finally:
            fleet.stop()
    return {"lost": [lost0, lost1], **fleet_state(fleet)}


def f_adoption_dead_end(P):
    fleet = _fleet(P, n=2, service=_cfg(P, max_queue_rows=1))
    try:
        h0 = fleet.submit({"x1": 0.0}, pin=0)
        h1 = fleet.submit({"x1": 1.0}, pin=1)
        fleet.lose_replica(0)
        h0_state = handle(h0)
        fleet.pump_until_quiet()
    finally:
        fleet.stop()
    return {"h0": h0_state, "h1": handle(h1), **fleet_state(fleet)}


def fleet_soak(P, seed: int = 0) -> dict:
    """The fleet suite's ``_soak``: a kill, a slow replica, a burst."""
    plan = P.faults.FaultPlan(seed=seed)
    plan.kill_replica(1, at=0.4)
    plan.slow_replica(2, delay=0.002)
    plan.burst_arrivals(0.2, 0.2, multiplier=2.0, replica=0)
    with P.faults.installed(plan):
        report = P.serving.run_fleet_loadtest(
            stub(P), rows=_rows(32), rate=300.0, duration=1.0, replicas=3,
            seed=seed, deadline=0.25, service_time=lambda n: 0.002,
            plan=plan, reconcile_every=1,
        )
    return plain(report)


def f_chaos_soak(P):
    first = fleet_soak(P)
    return {"report": first, "rerun_equal": fleet_soak(P) == first}


def f_twin(P):
    first = fleet_soak(P, seed=7)
    return {"report": first, "rerun_equal": fleet_soak(P, seed=7) == first}


def f_two_replicas(P):
    def run(n):
        plan = P.faults.FaultPlan()
        with P.faults.installed(plan):
            return plain(P.serving.run_fleet_loadtest(
                stub(P), rows=_rows(16), rate=200.0 * n, duration=1.0,
                replicas=n, seed=3, deadline=0.5,
                service_time=lambda k: 0.004, plan=plan))

    return {"one": run(1), "two": run(2)}


def f_shadow(P):
    fleet = _fleet(P, n=2)
    try:
        reg = P.serving.ModelRegistry(fleet).register("v2", stub(P, 0.6))
        reg.start_shadow("v2")
        hs = [fleet.submit({"x1": 0.0}) for _ in range(5)]
        fleet.pump_until_quiet()
        rep = reg.stop_shadow()
    finally:
        fleet.stop()
    return {"report": plain(rep), "handles": [handle(h) for h in hs],
            **fleet_state(fleet)}


def f_canary_quality(P):
    fleet = _fleet(P, n=2)
    try:
        P.events.reset_for_tests()
        reg = P.serving.ModelRegistry(fleet).register("bad", stub(P, 0.6))
        reg.start_canary("bad", replicas=(0,))
        hs = []
        for i in range(8):
            hs.append(fleet.submit({"x1": 0.0}, pin=i % 2))
            fleet.pump_until_quiet()
        decision = reg.evaluate_canary()
        h = fleet.submit({"x1": 0.0}, pin=0)
        fleet.pump_until_quiet()
    finally:
        fleet.stop()
    return {"decision": plain(decision), "rollbacks": reg.rollbacks,
            "handles": [handle(x) for x in hs], "after": handle(h),
            "events": events(P), **fleet_state(fleet)}


def f_canary_promotes(P):
    fleet = _fleet(P, n=2)
    try:
        P.events.reset_for_tests()
        good = stub(P)
        reg = P.serving.ModelRegistry(fleet).register("v2", good)
        reg.start_canary("v2", replicas=(0,))
        for i in range(8):
            fleet.submit({"x1": 0.0}, pin=i % 2)
            fleet.pump_until_quiet()
        decision = reg.evaluate_canary()
    finally:
        fleet.stop()
    return {"decision": plain(decision), "serving": reg.serving,
            "promotions": reg.promotions,
            "all_good": all(svc.score_fn is good for svc in fleet.services),
            "events": events(P), **fleet_state(fleet)}


def f_canary_latency(P):
    clock = FakeClock()
    with _plan(P) as plan:
        fleet = _fleet(P, n=2, clock=clock)
        try:
            plan.slow_replica(0, delay=0.3)
            for svc in fleet.services:
                svc.on_batch_cost = (
                    lambda real, sim, n: setattr(
                        clock, "now", clock.now + 0.01 + sim))
            reg = P.serving.ModelRegistry(fleet).register("slow", stub(P))
            reg.start_canary("slow", replicas=(0,),
                             tolerances=P.runlog.RunTolerances(
                                 phase_min_seconds=0.01))
            for i in range(8):
                fleet.submit({"x1": 0.0}, pin=i % 2)
                fleet.pump_until_quiet()
            decision = reg.evaluate_canary()
        finally:
            fleet.stop()
    return {"decision": plain(decision), **fleet_state(fleet)}


def f_attribution_drift(P):
    fleet = _fleet(P, n=2)
    try:
        reg = P.serving.ModelRegistry(fleet).register("v2", stub(P))
        reg.start_canary("v2", replicas=(0,))
        for i in range(4):
            fleet.submit({"x1": 0.0}, pin=i % 2)
            fleet.pump_until_quiet()
        P.ledger.stats().count_drift_alert()
        decision = reg.evaluate_canary()
    finally:
        fleet.stop()
    return {"decision": plain(decision), **fleet_state(fleet)}


FLEET = {
    "slow_keyed": f_slow_keyed,
    "slow_replica": f_slow_replica,
    "scope_nesting": f_scope_nesting,
    "burst_pinning": f_burst_pinning,
    "kill_once": f_kill_once,
    "partition_window": f_partition_window,
    "partition_duration": f_partition_duration,
    "stop_unknown_mode": f_stop_unknown_mode,
    "reject_then_drain": f_reject_then_drain,
    "default_drain": f_default_drain,
    "stop_vs_submit": f_stop_vs_submit,
    "router_tie_break": f_router_tie_break,
    "router_unroutable": f_router_unroutable,
    "exactly_once": f_exactly_once,
    "queue_full_falls_through": f_queue_full_falls_through,
    "every_replica_full": f_every_replica_full,
    "no_routable": f_no_routable,
    "fleet_source": f_fleet_source,
    "partition_hedge": f_partition_hedge,
    "no_hedge_margin": f_no_hedge_margin,
    "hedge_once": f_hedge_once,
    "kill_adopts": f_kill_adopts,
    "scripted_kill": f_scripted_kill,
    "heartbeat_loss": f_heartbeat_loss,
    "adoption_dead_end": f_adoption_dead_end,
    "chaos_soak": f_chaos_soak,
    "twin": f_twin,
    "two_replicas": f_two_replicas,
    "shadow": f_shadow,
    "canary_quality": f_canary_quality,
    "canary_promotes": f_canary_promotes,
    "canary_latency": f_canary_latency,
    "attribution_drift": f_attribution_drift,
}


def run(P, table: dict, key: str) -> dict:
    """One scenario on fresh process state."""
    reset(P)
    try:
        return plain(table[key](P))
    finally:
        reset(P)


# ================================================= the card's scenarios
def canary(P, control: str = "xgb", candidate: str = "rf") -> dict:
    """(d): ``control`` serves a two-replica fleet in the deterministic
    load test (``CANARY``), ``candidate`` takes replica 0 as a canary, and
    ``evaluate_canary`` decides; the decision record with its codes."""
    rows = fixture_rows(control)
    fns = {name: score_fn(P, name) for name in (control, candidate)}
    holder = {}

    def on_fleet(fleet):
        reg = P.serving.ModelRegistry(fleet).register(candidate,
                                                      fns[candidate])
        reg.start_canary(candidate, replicas=(0,))
        holder["registry"] = reg
        return None

    c = CANARY
    report = P.serving.run_fleet_loadtest(
        fns[control], rows, rate=c["rate"], duration=c["duration"],
        replicas=c["replicas"], seed=c["seed"],
        service_time=lambda n: c["service_time"], on_fleet=on_fleet)
    decision = holder["registry"].evaluate_canary()
    return plain({"decision": decision, "report": report})


def worker_mode(P, fn, rows: list[dict], requests: int, clients: int,
                seed: int = 0, workers: int = 2) -> dict:
    """(a): ``clients`` threads submit ``requests`` single-row requests
    (drawn with ``seed`` from ``rows``) to a worker-mode service started
    with ``wait_warmup=True``, and wait for them; a client whose request
    the service refuses (queue full, shedding) backs off 1 ms and submits
    it again, as a client honouring backpressure does. The service's
    state after ``stop(drain=True)``, the refusals by reason, the results
    (``_results``) and the drawn row indices (``_idx``)."""
    idx = np.random.default_rng(seed).integers(0, len(rows), size=requests)
    svc = P.serving.ScoringService(
        fn, P.serving.ServiceConfig(workers=workers))
    t0 = time.perf_counter()
    svc.start(wait_warmup=True)
    start_s = time.perf_counter() - t0
    handles: list = [None] * requests
    errors: list = []
    refused: dict = {}
    lock = threading.Lock()
    share = -(-requests // clients)

    def client(c):
        for k in range(c * share, min(requests, (c + 1) * share)):
            while handles[k] is None:
                try:
                    handles[k] = svc.submit(dict(rows[int(idx[k])]))
                except P.serving.RejectedByAdmission as e:
                    with lock:
                        refused[e.reason] = refused.get(e.reason, 0) + 1
                    time.sleep(0.001)
                except BaseException as e:  # noqa: BLE001 - recorded
                    errors.append(error_of(e))
                    break

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for h in handles:
        if h is not None:
            h._event.wait(600)
    serve_s = time.perf_counter() - t0
    svc.stop(drain=True)
    s = svc.stats()
    return {
        "errors": errors,
        "refused": refused,
        "outcomes": sorted({str(h.outcome) for h in handles
                            if h is not None}),
        "stats": threaded_stats(s),
        "batches": s["batches"],
        "batch_cap": s["batcher"]["maxBatchRows"],
        "rows_per_batch": s["batcher"]["rowsAssembled"] / max(s["batches"], 1),
        "threads": _serve_threads_alive(),
        "reconciled": s["admitted"] == (s["completed"] + s["quarantined"]
                                        + s["errors"] + sum(s["shed"].values()))
        and s["outstanding"] == 0,
        "start_seconds": start_s,
        "serve_seconds": serve_s,
        "rows_per_s": requests / serve_s,
        "_results": [None if h is None or h.results is None else h.results[0]
                     for h in handles],
        "_idx": [int(i) for i in idx],
    }


def direct_mismatches(fn, rows: list[dict], got: list, idx: list[int],
                      atol: float = 0.0) -> dict:
    """Each result of ``got`` against ``fn.batch`` of its row (``rows[i]``
    for ``i`` in ``idx``) called directly in one batch: the count that
    differ beyond ``atol`` and the largest difference of a float."""
    direct = fn.batch([dict(rows[i]) for i in idx])
    worst = 0.0
    bad = 0
    for g, d in zip(got, direct):
        try:
            same(plain(g), plain(d), atol)
        except AssertionError:
            bad += 1
        worst = max(worst, _max_diff(plain(g), plain(d)))
    return {"mismatched": bad, "max_abs_err": worst}


def _max_diff(a, b) -> float:
    if isinstance(a, dict) and isinstance(b, dict):
        return max([_max_diff(a[k], b[k]) for k in a if k in b] or [0.0])
    if isinstance(a, list) and isinstance(b, list):
        return max([_max_diff(x, y) for x, y in zip(a, b)] or [0.0])
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b)
    return 0.0 if a == b else float("inf")


def k1_fault(ST, attr: str = "serve_trees_packed"):
    """A context-manager factory under which K1's launch (``ST.<attr>``:
    the wrapper on the CPU, ``_walk`` on the card) raises the port's
    ``KernelLaunchError``."""
    from transmogrifai_tpu_torch.utils.cuda_build import KernelLaunchError

    def fault(*a, **kw):
        raise KernelLaunchError("serve_trees kernel launch failed: injected")

    @contextlib.contextmanager
    def inject():
        real = getattr(ST, attr)
        setattr(ST, attr, fault)
        try:
            yield
        finally:
            setattr(ST, attr, real)

    return inject


def kernel_fault_service(P, fn, rows: list[dict], inject, workers: int) -> dict:
    """A kernel fault inside a service batch: ``inject()`` is a context
    manager under which K1's launch raises ``KernelLaunchError``. Pump
    mode (``workers=0``): ``pump()`` raises it, every request met or
    queued settles ``error`` with it, ``submit`` and ``stop`` re-raise it.
    Worker mode: the requests settle ``error``, ``stop()`` re-raises it
    after joining the workers."""
    svc = P.serving.ScoringService(fn, P.serving.ServiceConfig(
        workers=workers, max_batch_rows=2, max_queue_rows=64))
    svc.start(wait_warmup=True)
    out: dict = {}
    with inject():
        hs = [svc.submit(dict(r)) for r in rows[:5]]
        if workers == 0:
            out["pump"] = raised(svc.pump)
            out["pump_again"] = raised(svc.pump)
        for h in hs:
            h._event.wait(60)
    out["handles"] = [{"outcome": h.outcome, "error": error_of(h.error)}
                      for h in hs]
    out["submit"] = raised(lambda: svc.submit(dict(rows[0])))
    out["stop"] = raised(svc.stop)
    s = svc.stats()
    out["stats"] = threaded_stats(s)
    out["reconciled"] = s["admitted"] == (
        s["completed"] + s["quarantined"] + s["errors"]
        + sum(s["shed"].values())) and s["outstanding"] == 0
    out["fault"] = error_of(svc.fault)
    out["threads"] = _serve_threads_alive()
    return out


def kernel_fault_fleet(P, fn, rows: list[dict], inject) -> dict:
    """A kernel fault in a two-replica pump-mode fleet: requests on both
    replicas with a deadline; the fault's ``pump_all`` raises; replica 1
    is then partitioned past the hedge checkpoint, where a healthy fleet
    would hedge, but ``tick`` re-raises the fault first; ``stop`` drains
    replica 1 (its batch meets the fault too) and re-raises. Nothing is
    hedged, adopted or lost, and the ledgers reconcile."""
    clock = FakeClock()
    plan = P.faults.FaultPlan()
    with P.faults.installed(plan):
        fleet = P.serving.FleetService(fn, P.serving.FleetConfig(
            replicas=2, heartbeat_timeout=1e9,
            service=P.serving.ServiceConfig(workers=0, max_batch_rows=2)),
            clock=clock).start(wait_warmup=True)
        out: dict = {}
        with inject():
            hs = [fleet.submit(dict(r), deadline=10.0, pin=i % 2)
                  for i, r in enumerate(rows[:4])]
            out["pump_all"] = raised(fleet.pump_all)
            plan.partition_replica(1, start=5.0, duration=100.0)
            clock.now = 6.0
            out["tick"] = raised(fleet.tick)
            out["submit"] = raised(lambda: fleet.submit(dict(rows[0])))
            out["stop"] = raised(fleet.stop)
    s = fleet.stats()
    out["handles"] = [{"outcome": h.outcome, "error": error_of(h.error)}
                      for h in hs]
    out["hedges"] = s["hedgesFired"]
    out["adopted"] = s["orphansAdopted"]
    out["lost"] = s["lostReplicas"]
    out["errors"] = s["errors"]
    out["outstanding"] = s["outstanding"]
    out["reconciled"] = fleet.reconcile()["reconciled"]
    out["replica_faults"] = [error_of(svc.fault) for svc in fleet.services]
    return out


def mirror_kernel_fault(P, fn, rows: list[dict], inject, mode: str) -> dict:
    """A kernel fault in the registry's mirror scoring, not in serving: a
    two-replica pump-mode fleet serves the stub score function while
    ``fn`` mirrors (``mode="shadow"``: ``fn`` is the shadow; ``"canary"``:
    ``fn`` serves both replicas and is the control that re-scores the stub
    canary's requests on replica 0, where every request is pinned). The
    served request completes; ``pump_all``, the reports, ``evaluate_canary``,
    ``promote``, ``submit``, ``tick`` and ``stop`` re-raise the fault; no
    mirror error is counted and nothing is promoted or rolled back."""
    out: dict = {}
    if mode == "shadow":
        fleet = _fleet(P, n=2)
        reg = P.serving.ModelRegistry(fleet).register("v2", fn)
        reg.start_shadow("v2")
        state = reg._shadow
    else:
        fleet = _fleet(P, n=2, fn=fn)
        reg = P.serving.ModelRegistry(fleet).register("v2", stub(P, 0.5))
        reg.start_canary("v2", replicas=(0,))
        state = reg._canary
    with inject():
        hs = [fleet.submit(dict(r), pin=0) for r in rows[:2]]
        out["pump_all"] = raised(fleet.pump_all)
        if mode == "shadow":
            out["report"] = raised(reg.shadow_report)
            out["stop_shadow"] = raised(reg.stop_shadow)
        else:
            out["report"] = raised(reg.canary_report)
            out["evaluate"] = raised(reg.evaluate_canary)
            out["promote"] = raised(reg.promote)
        out["submit"] = raised(lambda: fleet.submit(dict(rows[0])))
        out["tick"] = raised(fleet.tick)
        out["stop"] = raised(fleet.stop)
    s = fleet.stats()
    out["handles"] = [h.outcome for h in hs]
    out["mirror_errors"] = state["mirrorErrors"]
    out["promotions"], out["rollbacks"] = reg.promotions, reg.rollbacks
    if mode == "canary":
        out["unchanged"] = [fleet.services[0].score_fn is not fn,
                            fleet.services[1].score_fn is fn]
    out["fleet_fault"] = error_of(fleet.fault)
    out["replica_faults"] = [error_of(svc.fault) for svc in fleet.services]
    out["hedges"] = s["hedgesFired"]
    out["lost"] = s["lostReplicas"]
    out["reconciled"] = fleet.reconcile()["reconciled"]
    return out


def load_results() -> dict:
    with open(RESULTS) as fh:
        return json.load(fh)
