"""The port's telemetry plane (``telemetry/{metrics,spans,events,runlog}.py``)
and the serving modules the scoring closure consults
(``serving/{deadline,shedding}.py``), each unit case of the reference's
``tests/test_telemetry.py`` for metrics, spans and events run through both
packages on a fake clock, with the results EQUAL (every duration, count,
quantile and record; no tolerance: both packages run the same float
arithmetic on the same clock readings).

The metrics registry, the event log, the span buffers and the shed flags
are process state of each package: a process that imports both has two of
each, and neither reaches the other. Each test resets both packages'.
"""
import json
import threading
import types

import numpy as np
import pytest
import torch

import transmogrifai_tpu.telemetry.events as jev
import transmogrifai_tpu.telemetry.metrics as jme
import transmogrifai_tpu.telemetry.spans as jsp
import transmogrifai_tpu_torch.telemetry.events as pev
import transmogrifai_tpu_torch.telemetry.metrics as pme
import transmogrifai_tpu_torch.telemetry.spans as psp
from transmogrifai_tpu.resilience import sentinel as jsent
from transmogrifai_tpu.serving import deadline as jdl
from transmogrifai_tpu.serving import shedding as jshed
from transmogrifai_tpu_torch.resilience import sentinel as psent
from transmogrifai_tpu_torch.serving import deadline as pdl
from transmogrifai_tpu_torch.serving import shedding as pshed
from transmogrifai_tpu_torch.telemetry import runlog as prun

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

PACKAGES = {
    "jax": types.SimpleNamespace(spans=jsp, metrics=jme, events=jev,
                                 deadline=jdl, shedding=jshed,
                                 sentinel=jsent),
    "port": types.SimpleNamespace(spans=psp, metrics=pme, events=pev,
                                  deadline=pdl, shedding=pshed,
                                  sentinel=psent),
}


def _reset(P):
    P.spans.set_clock(None)
    P.spans.set_enabled(True)
    P.spans.configure_buffers(trace_buffer=65536, serve_ring=64)
    P.spans.reset_for_tests()
    P.events.reset_for_tests()
    P.metrics.REGISTRY.reset_metrics_for_tests()
    P.shedding.reset_process_flags_for_tests()


@pytest.fixture(autouse=True)
def _restore_telemetry():
    """Tests swap the clock / enabled-state / buffer bounds; every one of
    those is restored in both packages."""
    for P in PACKAGES.values():
        _reset(P)
    yield
    for P in PACKAGES.values():
        _reset(P)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def both(fn):
    """``fn(P)`` in each package; asserts the results EQUAL, returns the
    port's."""
    got = {name: fn(P) for name, P in PACKAGES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


# ------------------------------------------------------------------- spans
def test_span_nesting_builds_serve_trace_tree():
    def run(P):
        clock = FakeClock()
        P.spans.set_clock(clock)
        with P.spans.span("serve/request", rows=3):
            with P.spans.span("serve/stage/a"):
                clock.advance(0.010)
            with P.spans.span("serve/stage/b"):
                clock.advance(0.020)
            clock.advance(0.005)
        return P.spans.recent_serve_traces()[-1]

    t = both(run)
    assert t["name"] == "serve/request" and t["attrs"] == {"rows": 3}
    assert [c["name"] for c in t["children"]] == [
        "serve/stage/a", "serve/stage/b"]
    assert [c["durMs"] for c in t["children"]] == [10.0, 20.0]
    assert t["durMs"] == 35.0


def test_span_records_have_monotonic_ts_and_duration():
    def run(P):
        clock = FakeClock()
        P.spans.set_clock(clock)
        with P.spans.span("train/fit", stage="X"):
            clock.advance(1.5)
        rec = dict(P.spans.snapshot_events()[-1])
        rec.pop("tid")
        return rec

    rec = both(run)
    assert rec == {"name": "train/fit", "ts": 100.0, "dur": 1.5,
                   "args": {"stage": "X"}}


def test_spans_are_thread_isolated():
    def run(P):
        barrier = threading.Barrier(4)

        def work(i):
            barrier.wait()
            for _ in range(20):
                with P.spans.span(f"train/thread{i}"):
                    with P.spans.span(f"train/thread{i}/inner"):
                        pass

        threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        tids = {}
        for r in P.spans.snapshot_events():
            name = r["name"].split("/")[1].removesuffix("inner").rstrip("/")
            tids.setdefault(name, set()).add(r["tid"])
        return (sorted(len(s) for s in tids.values()),
                len({next(iter(s)) for s in tids.values()}),
                len(P.spans.snapshot_events()))

    assert both(run) == ([1, 1, 1, 1], 4, 160)


def test_disabled_telemetry_records_nothing():
    def run(P):
        P.spans.set_enabled(False)
        with P.spans.span("train/layer", index=0):
            pass
        P.spans.record_serve_batch("batch", 4, 0.0, {"featurize": 0.1})
        P.spans.record_span("train/fit", 0.0, 1.0)
        return P.spans.snapshot_events(), P.spans.recent_serve_traces()

    assert both(run) == ([], [])


def test_disabled_telemetry_drops_events_too(tmp_path, monkeypatch):
    def run(P):
        log = tmp_path / f"{P.spans.__name__}.jsonl"
        monkeypatch.setenv("TPTPU_EVENT_LOG", str(log))
        P.spans.set_enabled(False)
        rec = P.events.emit("breaker_transition", stage="X", to="open")
        off = (rec["seq"], rec["kind"], P.events.count(), P.events.recent(),
               log.exists())
        P.spans.set_enabled(True)
        on = P.events.emit("breaker_transition", stage="X", to="open")["seq"]
        return off, on, log.exists()

    assert both(run) == ((0, "breaker_transition", 0, [], False), 1, True)


def test_histogram_snapshot_is_not_torn_under_concurrent_observes():
    h = pme.Histogram("tptpu_test_torn_seconds")
    stop = threading.Event()
    bad: list[dict] = []

    def writer():
        while not stop.is_set():
            h.observe(0.01)

    def reader():
        for _ in range(2000):
            s = h.snapshot()
            quants = (s["p50"], s["p95"], s["p99"])
            if (s["count"] == 0) != all(q is None for q in quants):
                bad.append(s)

    w = threading.Thread(target=writer)
    r = threading.Thread(target=reader)
    w.start()
    r.start()
    r.join()
    stop.set()
    w.join()
    assert not bad, f"torn snapshots: {bad[:3]}"


def test_ring_buffer_bounds_hold():
    def run(P):
        clock = FakeClock()
        P.spans.set_clock(clock)
        P.spans.configure_buffers(trace_buffer=16, serve_ring=4)
        for i in range(50):
            with P.spans.span("train/bound_probe", i=i):
                clock.advance(0.001)
            P.spans.record_serve_batch("batch", 1, P.spans.clock(), {})
        events = P.spans.snapshot_events()
        return (len(events), events[-1]["args"],
                len(P.spans.recent_serve_traces()), P.spans.buffer_bounds())

    assert both(run) == (16, {"rows": 1, "entry": "batch"}, 4, (16, 4))


def test_injectable_clock():
    def run(P):
        clock = FakeClock()
        P.spans.set_clock(clock)
        first = P.spans.clock()
        clock.advance(5.0)
        second = P.spans.clock()
        P.spans.set_clock(None)
        return first, second, P.spans.clock() != 105.0

    assert both(run) == (100.0, 105.0, True)


def test_serve_batch_feeds_the_family_histograms():
    """``record_serve_batch`` (the scoring closure's one call a batch)
    observes the total and every family's seconds and counts the batch and
    its rows; ``stage_detail`` engages at 16 rows."""
    def run(P):
        clock = FakeClock()
        P.spans.set_clock(clock)
        started = P.spans.clock()
        clock.advance(0.25)
        P.spans.record_serve_batch(
            "columns", 64, started,
            {"sentinel": 0.01, "featurize": 0.1, "dispatch": 0.12,
             "download": 0.02})
        reg = P.metrics.REGISTRY
        return ({h.labels["stage"]: h.snapshot()
                 for h in reg.histograms_named("tptpu_serve_seconds")},
                reg.counter("tptpu_serve_rows_total").value,
                reg.counter("tptpu_serve_batches_total").value,
                P.spans.recent_serve_traces()[-1],
                P.spans.stage_detail(15), P.spans.stage_detail(16))

    hists, rows, batches, trace, below, at = both(run)
    assert set(hists) == {"total", "sentinel", "featurize", "dispatch",
                          "download"}
    assert (rows, batches, below, at) == (64, 1, False, True)
    assert trace["stagesMs"]["dispatch"] == 120.0


# -------------------------------------------------------------- histograms
def test_histogram_quantiles_track_numpy():
    samples = np.random.default_rng(3).lognormal(-6.0, 1.2, size=20_000)

    def run(P):
        h = P.metrics.Histogram("t_q")
        for v in samples:
            h.observe(float(v))
        return [h.quantile(q) for q in (0.50, 0.95, 0.99)], h.count, h.sum

    quants, count, total = both(run)
    for q, est in zip((0.50, 0.95, 0.99), quants):
        ref = float(np.quantile(samples, q))
        assert abs(est - ref) / ref < 0.35, (q, est, ref)
    assert count == 20_000
    assert abs(total - samples.sum()) < 1e-6 * samples.sum()


def test_histogram_empty_and_bucket_counts():
    def run(P):
        h = P.metrics.Histogram("t_e", bounds=(0.1, 1.0))
        empty = h.quantile(0.5)
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        return empty, h.bucket_counts(), h.snapshot()

    empty, (cum, count, total), _ = both(run)
    assert empty is None and cum == [1, 2, 3] and count == 3
    assert total == pytest.approx(5.55)


def test_exponential_buckets_shape():
    assert both(lambda P: P.metrics.exponential_buckets(1e-3, 2.0, 4)) == (
        1e-3, 2e-3, 4e-3, 8e-3)
    assert both(lambda P: P.metrics.DEFAULT_BUCKETS)[0] == 1e-5
    with pytest.raises(ValueError):
        pme.exponential_buckets(0.0, 2.0, 4)


# ---------------------------------------------------------------- registry
def test_registry_dedupes_by_name_and_labels():
    reg = pme.MetricsRegistry()
    assert reg.counter("c") is reg.counter("c")
    assert reg.gauge("g") is reg.gauge("g")
    h1 = reg.histogram("h", labels={"stage": "a"})
    h2 = reg.histogram("h", labels={"stage": "b"})
    assert h1 is not h2
    assert reg.histogram("h", labels={"stage": "a"}) is h1
    assert set(reg.histograms_named("h")) == {h1, h2}


def test_snapshot_all_equals_the_reference():
    def run(P):
        reg = P.metrics.MetricsRegistry()
        reg.counter("tptpu_c").inc(3)
        reg.gauge("tptpu_g").set(2.5)
        for v in (0.001, 0.002, 0.5):
            reg.histogram("tptpu_h", labels={"stage": "x"}).observe(v)
        reg.register_source("probe", lambda: {"n": 1})
        reg.register_source("dead", lambda: 1 / 0)
        return reg.snapshot_all()

    snap = both(run)
    assert snap["sources"] == {"probe": {"n": 1}, "dead": {}}
    assert snap["counters"] == {"tptpu_c": 3}


def test_the_two_registries_never_reach_each_other():
    """Each package's process state is its own: a counter, a source, an
    event or a span in one package does not appear in the other's."""
    pme.REGISTRY.counter("tptpu_port_only_total").inc()
    pme.REGISTRY.register_source("port_probe", lambda: {"x": 1})
    pev.emit("port_probe")
    with psp.span("serve/port_probe"):
        pass
    assert pme.REGISTRY is not jme.REGISTRY
    jsnap = jme.REGISTRY.snapshot_all()
    assert "tptpu_port_only_total" not in jsnap["counters"]
    assert "port_probe" not in jsnap["sources"]
    assert jev.recent() == [] and jsp.snapshot_events() == []
    assert "serving" in pme.REGISTRY.source_snapshots()
    assert "run" in pme.REGISTRY.source_snapshots()


def test_ledger_core_snapshot_is_consistent_under_writers():
    """Ledgers built on the registry share its re-entrant lock, so a reader
    holding ``snapshot_lock()`` sees paired writes together."""
    a, b = pme.LedgerCore(("n",)), pme.LedgerCore(("n",))
    stop = threading.Event()

    def writer():
        while not stop.is_set():
            with pme.snapshot_lock():
                a.bump("n")
                b.bump("n")

    threads = [threading.Thread(target=writer) for _ in range(3)]
    for th in threads:
        th.start()
    try:
        for _ in range(200):
            with pme.snapshot_lock():
                assert a._counts["n"] == b._counts["n"]
    finally:
        stop.set()
        for th in threads:
            th.join()


def test_delta_helpers_equal_the_reference():
    def run(P):
        m = P.metrics
        return (m.counter_delta({"a": 5, "b": 2}, {"a": 1}, ("a", "b")),
                m.float_delta({"s": 1.23456}, {"s": 0.1}, "s"),
                m.named_delta({"x": 3, "y": 1}, {"x": 3}),
                m.ratio(1, 3), m.ratio(1, 0))

    assert both(run) == ({"a": 4, "b": 2}, 1.135, {"y": 1}, 0.3333, None)


def test_run_ledger_records_transfers():
    before = prun.snapshot()
    prun.record_upload(1024, 0.5)
    prun.record_download(24, 0.25)
    d = prun.delta(before)
    assert (d["h2dTransfers"], d["h2dBytes"], d["d2hTransfers"],
            d["d2hBytes"]) == (1, 1024, 1, 24)
    assert d["h2dSeconds"] == 0.5 and d["d2hSeconds"] == 0.25


def test_a_fused_batch_records_one_upload_and_one_download(monkeypatch):
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__),
                                    "torch_fixtures"))
    import hardening as H

    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    P = H.package("port")
    fn = P.score(P.load(H.model_path("rf")))
    rows = H.tiled(H.fixture_rows("rf"), 48)
    fn.batch(rows)
    before = prun.snapshot()
    fn.batch(rows)
    d = prun.delta(before)
    prog = fn.fused_state["program"]
    assert (d["h2dTransfers"], d["d2hTransfers"]) == (1, 1)
    assert d["d2hBytes"] == prog.down_bytes_per_row * 48
    assert d["h2dBytes"] >= prog.up_bytes_per_row * 64


# -------------------------------------------------------------- event log
def test_event_log_sequence_is_strictly_monotonic_under_threads():
    def run(P):
        barrier = threading.Barrier(8)

        def emitter(i):
            barrier.wait()
            for j in range(50):
                P.events.emit("probe", worker=i, j=j)

        threads = [threading.Thread(target=emitter, args=(i,))
                   for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        return [r["seq"] for r in P.events.recent()], P.events.count()

    assert both(run) == (list(range(1, 401)), 400)


def test_event_log_jsonl_roundtrip(tmp_path):
    def run(P):
        P.spans.set_clock(FakeClock())
        P.events.emit("failover", host="h1", reason="heartbeat")
        P.events.emit("breaker_transition", stage="s",
                      transition="closed->open")
        path = str(tmp_path / f"{P.events.__name__}.jsonl")
        n = P.events.write(path)
        lines = [json.loads(ln) for ln in open(path).read().splitlines()]
        for ln in lines:
            ln.pop("unix")
        return n, lines, P.events.to_jsonl().count("\n")

    n, lines, newlines = both(run)
    assert n == 2 and newlines == 1
    assert [ln["kind"] for ln in lines] == ["failover", "breaker_transition"]
    assert [ln["seq"] for ln in lines] == [1, 2]


def test_event_log_disk_append_via_env(tmp_path, monkeypatch):
    path = str(tmp_path / "live.jsonl")
    monkeypatch.setenv("TPTPU_EVENT_LOG", path)
    pev.emit("drift_alert", feature="age")
    pev.emit("checkpoint_save", layer=0)
    lines = open(path).read().splitlines()
    assert len(lines) == 2
    assert json.loads(lines[1])["kind"] == "checkpoint_save"


def test_subscribers_see_every_event_after_the_lock():
    seen = []
    pev.subscribe(seen.append)
    pev.subscribe(lambda rec: 1 / 0)  # a broken subscriber is contained
    pev.emit("probe", n=1)
    pev.unsubscribe(seen.append)
    pev.emit("probe", n=2)
    assert [r["n"] for r in seen] == [1]


def test_breaker_transition_emits_event():
    def run(P):
        P.spans.set_clock(FakeClock())
        clock = FakeClock()
        br = P.sentinel.CircuitBreaker(
            "stage_x", P.sentinel.BreakerConfig(failure_threshold=2,
                                                clock=clock))
        br.record_failure()
        br.record_failure()  # -> open
        clock.advance(60.0)
        allowed = br.allow()  # -> half_open
        br.record_success()  # -> closed
        return allowed, [(r["stage"], r["transition"])
                         for r in P.events.recent()
                         if r["kind"] == "breaker_transition"]

    allowed, transitions = both(run)
    assert allowed
    assert transitions == [("stage_x", "closed->open"),
                           ("stage_x", "open->half_open"),
                           ("stage_x", "half_open->closed")]


# -------------------------------------------------- deadlines and shedding
def test_deadline_checkpoints_equal_the_reference():
    """A budget on a fake clock: with no history only a spent budget
    rejects; with the dispatch family's p95 recorded, a budget that cannot
    cover it rejects before ``dispatch``; simulated seconds burn it."""
    def run(P):
        dl = P.deadline
        clock = FakeClock()
        out = []
        budget = dl.DeadlineBudget(0.5, clock=clock)
        with dl.active(budget):
            dl.checkpoint("sentinel")
            out.append(dl.current() is budget)
            P.metrics.REGISTRY.histogram(
                "tptpu_serve_seconds", labels={"stage": "dispatch"}
            ).observe(0.4)
            out.append(round(dl.family_p95("dispatch"), 9))
            clock.advance(0.2)
            try:
                dl.checkpoint("dispatch")
            except dl.DeadlineExceeded as e:
                out.append((e.family, round(e.remaining, 9), str(e)))
            dl.consume(0.4)
            out.append(budget.expired())
            out.append(budget.covers())
        out.append(dl.current() is None)
        dl.checkpoint("dispatch")  # no budget: a no-op
        out.append([r["kind"] for r in P.events.recent()])
        return out

    got = both(run)
    assert got[0] is True
    assert got[2][0] == "dispatch" and got[3] is True and got[4] is False
    assert got[6] == ["deadline_exceeded"]


def test_shed_flags_and_tiers_equal_the_reference():
    """The process's explain and drift flags follow the shedder's tiers with
    hysteresis; two shedders' contributions are refcounted."""
    def run(P):
        sh = P.shedding
        a = sh.LoadShedder(capacity=100)
        b = sh.LoadShedder(capacity=100)
        trace = []
        for queued in (10, 36, 55, 75, 95, 70, 60, 40, 10):
            tier = a.update(queued, 0, 0.0)
            trace.append((tier, sh.explain_shed(), sh.drift_shed(),
                          P.spans.stage_detail(64), a.reject_admissions))
        a.update(80, 0, 0.0)
        b.update(80, 0, 0.0)
        a.reset()
        trace.append(("b holds", sh.drift_shed()))
        b.reset()
        trace.append(("none", sh.drift_shed(), sh.explain_shed()))
        trace.append(a.stats())
        with pytest.raises(ValueError):
            sh.ShedConfig(explain_enter=0.2, explain_exit=0.3)
        return trace

    trace = both(run)
    assert [t[0] for t in trace[:9]] == [0, 1, 2, 3, 4, 4, 3, 2, 0]
    assert trace[3][2] is True and trace[4][4] is True
    assert trace[9] == ("b holds", True)
    assert trace[10] == ("none", False, False)
