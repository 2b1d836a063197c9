"""Open-loop serve load testing on a virtual clock — seeded, sleepless.

Closed-loop benchmarks (issue the next request when the last returns)
cannot see overload: arrival pressure collapses to service capacity and
latency looks flat right up to the cliff. This harness is OPEN-LOOP: a
seeded arrival schedule at a fixed rate (optionally multiplied through
``FaultPlan.burst_arrivals`` windows) submits requests regardless of how
the service is doing, so queue growth, deadline sheds, and admission
rejections appear exactly as they would under real traffic.

Nothing sleeps. Time is a :class:`VirtualClock` the service runs on:

* arrivals advance the clock to their scheduled instant;
* each pumped batch advances it by the batch's measured REAL execution
  seconds (bench mode) or an injected ``service_time`` (tests) plus any
  ``slow_stage`` SIMULATED seconds the fault plan charged — so chaos
  latency shows up in the percentiles without ever sleeping;
* per-request latency = completion − arrival, both virtual.

The emitted report carries p50/p95/p99 latency, shed rate, goodput
(healthy completions per virtual second), the typed outcome taxonomy,
and the reconciliation verdict. ``chip_smoke.py``'s ``serving_plane``
phase runs the bench mode on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from ..resilience import faults as _faults
from ..telemetry import spans as _tspans
from . import deadline as _deadline
from .queue import RejectedByAdmission
from .service import ScoringService, ServiceConfig

__all__ = [
    "VirtualClock", "LoadSchedule", "run_loadtest", "run_fleet_loadtest",
]


class VirtualClock:
    """Monotonic virtual time; advanced explicitly by the harness."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("virtual time cannot go backwards")
        self.now += dt
        return self.now


@dataclasses.dataclass
class LoadSchedule:
    """Seeded open-loop arrival schedule."""

    rate: float                 # nominal arrivals per virtual second
    duration: float             # virtual seconds of arrivals
    seed: int = 0

    def arrivals(self, plan: "_faults.FaultPlan | None" = None) -> list[float]:
        """Arrival instants: inter-arrival 1/(rate*mult) where ``mult`` is
        the fault plan's burst multiplier at the current instant — the
        same plan replays the same burst every run."""
        if self.rate <= 0 or self.duration <= 0:
            raise ValueError("need rate > 0 and duration > 0")
        out: list[float] = []
        t = 0.0
        while True:
            mult = plan.arrival_multiplier(t) if plan is not None else 1.0
            t += 1.0 / (self.rate * mult)
            if t >= self.duration:
                return out
            out.append(t)


def run_loadtest(
    score_fn: Callable,
    rows: list[dict],
    rate: float,
    duration: float,
    seed: int = 0,
    deadline: float | None = None,
    config: ServiceConfig | None = None,
    service_time: Callable[[int], float] | None = None,
    plan: "_faults.FaultPlan | None" = None,
) -> dict[str, Any]:
    """One open-loop run; returns the metrics report (see module
    docstring). ``rows`` is the pool the seeded rng draws request payloads
    from; ``service_time`` (a callable invoked once per executed batch)
    replaces measured real execution time with deterministic virtual
    seconds — tests and regression benches use a constant; ``plan`` is an
    ALREADY INSTALLED FaultPlan whose bursts/slow stages drive the
    chaos."""
    rng = np.random.default_rng(seed)
    clock = VirtualClock()
    # deterministic mode (injected service_time) must virtualize the
    # TELEMETRY clock too: the serve-family histograms feed the deadline
    # checkpoints' p95s, and left on the real clock they record host
    # execution speed — a loaded machine would shed requests a fast one
    # completes, making the "machine-independent" report host-dependent.
    # On the virtual clock the family seconds are exactly the slow_stage
    # simulated charges. Bench mode (service_time=None) keeps real time.
    prev_spans_clock = _tspans.get_clock()
    if service_time is not None:
        _tspans.set_clock(clock)
    cfg = config or ServiceConfig()
    cfg = dataclasses.replace(cfg, workers=0)
    if deadline is not None:
        cfg = dataclasses.replace(cfg, default_deadline=deadline)
    service = ScoringService(score_fn, cfg, clock=clock)

    def _advance(real: float, sim: float, rows_executed: int) -> None:
        base = (
            service_time(rows_executed) if service_time is not None else real
        )
        clock.advance(base + sim)

    service.on_batch_cost = _advance
    service.start()
    schedule = LoadSchedule(rate=rate, duration=duration, seed=seed)
    arrivals = schedule.arrivals(plan)
    idx = rng.integers(0, len(rows), size=max(1, len(arrivals)))
    handles = []
    max_depth = 0
    # discrete-event engine: ONE worker whose busy/free timeline is
    # ``free_at``. A batch starts the moment the worker is free and work
    # is queued; arrivals scheduled DURING a batch enqueue behind it
    # (that is what makes the loop open: queue depth, deadline burn, and
    # shed tiers grow exactly as they would under real sustained traffic,
    # instead of the worker magically draining between every arrival).
    free_at = 0.0

    def _serve_until(horizon: float | None) -> float:
        """Run batches whose start instant lands before ``horizon``
        (None = run until the queue drains); returns the updated
        ``free_at``."""
        busy = free_at
        while service.queue.depth_requests() > 0:
            start = max(busy, clock.now)
            if horizon is not None and start >= horizon:
                break
            clock.advance(start - clock.now)
            if not service.pump():  # everything left expired/settled
                break
            busy = clock.now  # pump advanced by the batch's cost
        return busy

    try:
        for i, t in enumerate(arrivals):
            free_at = _serve_until(t)
            clock.advance(max(0.0, t - clock.now))
            try:
                handles.append(service.submit(dict(rows[int(idx[i])])))
            except (RejectedByAdmission, _deadline.DeadlineExceeded):
                pass  # counted in the service's typed rejection taxonomy
            max_depth = max(max_depth, service.queue.depth_rows())
        # arrivals over: drain whatever is still queued
        _serve_until(None)
        while service.pump():
            pass
        service.stop(drain=True)
    finally:
        _tspans.set_clock(prev_spans_clock)
    end = clock.now

    stats = service.stats()
    latencies = sorted(
        h.latency() for h in handles
        if h.outcome in ("completed", "quarantined") and h.latency() is not None
    )

    def _pct(q: float) -> float | None:
        if not latencies:
            return None
        return round(
            float(np.percentile(latencies, q, method="nearest")) * 1e3, 3
        )

    shed_total = sum(stats["shed"].values())
    rejected_total = sum(stats["rejected"].values())
    settled = (
        stats["completed"] + stats["quarantined"] + stats["errors"] + shed_total
    )
    offered = len(arrivals)
    return {
        "rate": rate,
        "duration_s": duration,
        "seed": seed,
        "offered": offered,
        "admitted": stats["admitted"],
        "completed": stats["completed"],
        "quarantined": stats["quarantined"],
        "errors": stats["errors"],
        "shed": dict(stats["shed"]),
        "rejected": dict(stats["rejected"]),
        "shed_total": shed_total,
        "rejected_total": rejected_total,
        "shed_rate": (
            round((shed_total + rejected_total) / offered, 4) if offered else 0.0
        ),
        "latency_ms": {"p50": _pct(50), "p95": _pct(95), "p99": _pct(99)},
        "goodput_rows_per_s": (
            round(stats["completed"] / end, 2) if end > 0 else 0.0
        ),
        "max_queue_depth_rows": max(max_depth, stats["queuePeakRows"]),
        "batches": stats["batches"],
        "shed_tier_entries": stats["shedding"]["tierEntries"],
        "virtual_end_s": round(end, 4),
        # the hard invariant the chaos suite pins: every admitted request
        # settled with exactly one typed outcome, nothing leaked
        "reconciled": (
            stats["admitted"] == settled and stats["outstanding"] == 0
        ),
    }


def run_fleet_loadtest(
    score_fn: Callable,
    rows: list[dict],
    rate: float,
    duration: float,
    replicas: int = 2,
    seed: int = 0,
    deadline: float | None = None,
    config: ServiceConfig | None = None,
    service_time: Callable[[int], float] | None = None,
    plan: "_faults.FaultPlan | None" = None,
    fleet_config: "FleetConfig | None" = None,
    reconcile_every: int = 1,
    on_fleet: Callable[[Any], Callable[[float], None] | None] | None = None,
) -> dict[str, Any]:
    """Open-loop loadtest over a :class:`~.fleet.FleetService`: the same
    seeded arrival schedule, dispatched through the router onto
    ``replicas`` workers, each on its OWN virtual clock (a replica's
    clock is its busy timeline; the shared fleet clock is arrival time).
    Every arrival instant also ticks the fleet control plane, so scripted
    ``kill_replica`` / ``partition_replica`` faults, heartbeat aging, and
    hedge checkpoints all fire in virtual time. ``reconcile_every=k``
    checks the fleet-level typed invariant at every k-th arrival
    (``reconciled_every_instant`` in the report); ``dropped`` counts
    logical requests that finished with NO typed outcome and must be 0.

    ``on_fleet`` is the control-plane integration seam: called once with
    the started fleet (build a ModelRegistry, attach a
    RetrainController, ...); its optional return value is a per-instant
    callback invoked right after every ``fleet.tick(t)`` — in the
    arrival loop AND the drain loop — so a supervised control loop (the
    retrain state machine) advances at every virtual instant the fleet
    does."""
    from .fleet import FleetConfig, FleetService

    if replicas < 1:
        raise ValueError("need replicas >= 1")
    rng = np.random.default_rng(seed)
    gclock = VirtualClock()
    rclocks = [VirtualClock() for _ in range(replicas)]
    # deterministic mode virtualizes the telemetry clock onto the FLEET
    # clock (see run_loadtest) — family seconds then reflect only the
    # plan's simulated charges, never host speed
    prev_spans_clock = _tspans.get_clock()
    if service_time is not None:
        _tspans.set_clock(gclock)
    cfg = config or ServiceConfig()
    cfg = dataclasses.replace(cfg, workers=0)
    if deadline is not None:
        cfg = dataclasses.replace(cfg, default_deadline=deadline)
    fc = dataclasses.replace(
        fleet_config or FleetConfig(), replicas=replicas, service=cfg
    )
    fleet = FleetService(
        score_fn, fc, clock=gclock, replica_clocks=rclocks
    )
    for i, svc in enumerate(fleet.services):
        def _advance(real: float, sim: float, n: int, _c=rclocks[i]) -> None:
            base = service_time(n) if service_time is not None else real
            _c.advance(base + sim)

        svc.on_batch_cost = _advance
    fleet.start()
    tick_hook = on_fleet(fleet) if on_fleet is not None else None
    schedule = LoadSchedule(rate=rate, duration=duration, seed=seed)
    arrivals = schedule.arrivals(plan)
    idx = rng.integers(0, len(rows), size=max(1, len(arrivals)))
    handles = []
    max_depth = 0
    reconciled_every_instant = True

    def _serve_replica_until(i: int, horizon: float | None) -> None:
        """Run replica ``i``'s batches whose start lands before
        ``horizon`` (None = one pump pass only happens in the drain
        loop; here we drain until the horizon)."""
        svc = fleet.services[i]
        c = rclocks[i]
        while svc.queue.depth_requests() > 0:
            if horizon is not None and c.now >= horizon:
                break
            if not svc.pump():  # everything left expired/settled
                break

    try:
        for k, t in enumerate(arrivals):
            for i in fleet.live_replicas():
                _serve_replica_until(i, t)
            gclock.advance(max(0.0, t - gclock.now))
            # idle time passes for replicas with an empty queue
            for i in fleet.live_replicas():
                c = rclocks[i]
                if (
                    fleet.services[i].queue.depth_requests() == 0
                    and c.now < t
                ):
                    c.advance(t - c.now)
            fleet.tick(t)
            if tick_hook is not None:
                tick_hook(t)
            pin = plan.burst_replica(t) if plan is not None else None
            try:
                handles.append(
                    fleet.submit(dict(rows[int(idx[k])]), pin=pin)
                )
            except (RejectedByAdmission, _deadline.DeadlineExceeded):
                pass  # counted in the fleet's typed rejection taxonomy
            max_depth = max(
                max_depth,
                sum(s.queue.depth_rows() for s in fleet.services),
            )
            if reconcile_every and k % reconcile_every == 0:
                if not fleet.reconcile()["reconciled"]:
                    reconciled_every_instant = False
        # arrivals over: drain, still ticking (hedges and scripted kills
        # keep firing in virtual time until the fleet is quiet)
        while True:
            settled = 0
            for i in fleet.live_replicas():
                settled += fleet.services[i].pump()
            t = max([gclock.now] + [c.now for c in rclocks])
            gclock.advance(t - gclock.now)
            fleet.tick(t)
            if tick_hook is not None:
                tick_hook(t)
            if settled == 0 and all(
                fleet.services[i].queue.depth_requests() == 0
                for i in fleet.live_replicas()
            ):
                break
        fleet.stop()
    finally:
        _tspans.set_clock(prev_spans_clock)
    end = max([gclock.now] + [c.now for c in rclocks])

    stats = fleet.stats()
    recon = fleet.reconcile()
    latencies = sorted(
        h.latency() for h in handles
        if h.outcome in ("completed", "quarantined")
        and h.latency() is not None
    )

    def _pct(q: float) -> float | None:
        if not latencies:
            return None
        return round(
            float(np.percentile(latencies, q, method="nearest")) * 1e3, 3
        )

    shed_total = sum(stats["shed"].values())
    rejected_total = sum(stats["rejected"].values())
    settled_total = (
        stats["completed"] + stats["quarantined"] + stats["errors"]
        + shed_total
    )
    offered = len(arrivals)
    dropped = sum(1 for h in handles if h.outcome is None)
    return {
        "rate": rate,
        "duration_s": duration,
        "seed": seed,
        "replicas": replicas,
        "offered": offered,
        "admitted": stats["admitted"],
        "completed": stats["completed"],
        "quarantined": stats["quarantined"],
        "errors": stats["errors"],
        "shed": dict(stats["shed"]),
        "rejected": dict(stats["rejected"]),
        "shed_total": shed_total,
        "rejected_total": rejected_total,
        "shed_rate": (
            round((shed_total + rejected_total) / offered, 4)
            if offered else 0.0
        ),
        "latency_ms": {"p50": _pct(50), "p95": _pct(95), "p99": _pct(99)},
        "goodput_rows_per_s": (
            round(stats["completed"] / end, 2) if end > 0 else 0.0
        ),
        "max_queue_depth_rows": max_depth,
        "virtual_end_s": round(end, 4),
        "hedges_fired": stats["hedgesFired"],
        "hedge_duplicates": stats["hedgeDuplicates"],
        "orphans_adopted": stats["orphansAdopted"],
        "replicas_lost": stats["replicasLost"],
        "lost_replicas": stats["lostReplicas"],
        "router_dispatched": stats["router"]["dispatched"],
        "per_replica": [
            {
                "admitted": s["admitted"],
                "completed": s["completed"],
                "shed": dict(s["shed"]),
                "rejected": dict(s["rejected"]),
                "outstanding": s["outstanding"],
                "batches": s["batches"],
            }
            for s in stats["perReplica"]
        ],
        # exactly-once accounting: no logical request may end silent
        "dropped": dropped,
        "reconciled": (
            stats["admitted"] == settled_total
            and stats["outstanding"] == 0
            and recon["reconciled"]
            and dropped == 0
        ),
        "reconciled_every_instant": reconciled_every_instant,
    }
