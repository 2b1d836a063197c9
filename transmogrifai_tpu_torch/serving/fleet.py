"""Replicated scoring fleet — N ``ScoringService`` workers behind a
health-checked router, with hedged retries and replica-loss drain.

``FleetService`` is the horizontal tier over the single-worker serving
plane: each replica keeps its own :class:`~.queue.AdmissionQueue`,
:class:`~.batcher.MicroBatcher`, and shed tiers, while the
:class:`~.router.Router` picks a replica per request off the live
queue-depth / in-flight / breaker gauges and the fleet's heartbeat view
(``HostSentinel`` on an injectable clock). Replicas are in-process
services over closures on the one card: they share its default stream
and the process's built CUDA libraries, so replica #2's first batch pays
no build.

Correctness under failure is the contract, not just throughput:

* **Exactly-once outcomes.** A logical request may own several replica
  attempts (a hedge, an adoption after replica loss); the FIRST settled
  attempt wins, later ones count as ``hedge_duplicates`` and are never
  re-stamped onto the caller's handle.
* **Hedged retries.** A request that misses its deadline-budget
  checkpoint (``hedge_after_fraction`` of its budget elapsed, still
  unsettled) is re-dispatched ONCE to the healthiest peer — and only
  when that peer's router score beats the original replica's by
  ``hedge_score_margin``, so symmetric overload cannot start a hedge
  storm.
* **Replica-loss drain.** ``lose_replica`` decommissions a worker via
  ``ScoringService.stop(mode="reject_new_then_drain")``: the dying
  replica settles its own ledger (queued work sheds as ``stopped``),
  and every orphan whose logical request is still unsettled is adopted
  by a survivor with its REMAINING deadline budget. The fleet-level
  typed invariant

      admitted == completed + quarantined + shed + errors + outstanding

  holds at every instant across re-dispatch (pinned by the chaos soak).

Synchronous mode (``workers=0`` per replica + :meth:`pump_all` /
:meth:`tick`) runs everything on the caller's thread with injectable
clocks — the fleet loadtest drives kills, partitions, and hedges
without a single real sleep.

A kernel fault (``utils.cuda_build.is_kernel_fault``) fails its replica
(``ScoringService``'s rule: the requests it met settle ``error`` with the
fault) and with it the fleet. A failed replica is not a lost one: the
fleet neither hedges nor adopts a request that met the fault onto another
replica, since on one card the same kernel would run again. A kernel fault
that the ``on_served`` observer meets (the registry's mirror scoring) fails
the fleet the same way. :meth:`submit`, :meth:`tick`, :meth:`pump_all` and
:meth:`stop` re-raise the fault.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
import weakref
from typing import Any, Callable, Sequence

from ..analysis import schedule as _schedule
from ..resilience import faults as _faults
from ..resilience.distributed import HeartbeatConfig, HostSentinel
from ..telemetry import events as _tevents
from ..telemetry import metrics as _tm
from ..utils.cuda_build import is_kernel_fault
from . import deadline as _deadline
from .queue import RejectedByAdmission
from .router import Router, RouterConfig
from .service import PendingScore, ScoreRequest, ScoringService, ServiceConfig

log = logging.getLogger(__name__)

__all__ = ["FleetConfig", "FleetRequest", "FleetService"]

#: weakrefs to live fleets — the ``fleet`` exposition source
_LIVE_FLEETS: list = []
_LIVE_LOCK = threading.Lock()


@dataclasses.dataclass
class FleetConfig:
    """Fleet-level knobs; ``service`` is the per-replica template."""

    replicas: int = 2
    service: ServiceConfig = dataclasses.field(default_factory=ServiceConfig)
    router: RouterConfig = dataclasses.field(default_factory=RouterConfig)
    #: seconds without a heartbeat before a replica is declared lost
    heartbeat_timeout: float = 5.0
    #: hedge when this fraction of the deadline budget elapsed unsettled
    hedge_after_fraction: float = 0.5
    #: the healthiest peer must beat the original replica's router score
    #: by this much before a hedge fires (anti-storm guard: symmetric
    #: overload leaves every score equal, so no hedge helps)
    hedge_score_margin: float = 0.15


class _Attempt:
    """One replica-level submission of a logical request."""

    __slots__ = ("replica", "hedge", "superseded")

    def __init__(self, replica: int, hedge: bool = False):
        self.replica = replica
        self.hedge = hedge
        # True once decommission settled this attempt as ``stopped`` on
        # the dying replica — the logical request lives on via adoption
        self.superseded = False


class FleetRequest:
    """One logical request: the caller's handle plus its attempts."""

    __slots__ = (
        "rows", "deadline", "explain", "handle", "submitted_at",
        "attempts", "hedged", "settled",
    )

    def __init__(
        self,
        rows: list[dict],
        deadline: float | None,
        explain: int,
        handle: PendingScore,
        submitted_at: float,
    ):
        self.rows = rows
        self.deadline = deadline
        self.explain = explain
        self.handle = handle
        self.submitted_at = submitted_at
        self.attempts: list[_Attempt] = []
        self.hedged = False
        self.settled = False

    def remaining(self, now: float) -> float | None:
        if self.deadline is None:
            return None
        return self.deadline - (now - self.submitted_at)


class FleetService:
    """N scoring replicas behind load-aware, health-aware dispatch."""

    def __init__(
        self,
        score_fn: Callable | Sequence[Callable],
        config: FleetConfig | None = None,
        clock: Callable[[], float] | None = None,
        replica_clocks: Sequence[Callable[[], float]] | None = None,
    ):
        self.config = config or FleetConfig()
        n = self.config.replicas
        if n < 1:
            raise ValueError("a fleet needs at least one replica")
        self.clock = clock if clock is not None else time.monotonic
        if isinstance(score_fn, (list, tuple)):
            if len(score_fn) != n:
                raise ValueError(
                    f"{len(score_fn)} score_fns for {n} replicas"
                )
            fns = list(score_fn)
        else:
            fns = [score_fn] * n
        clocks = (
            list(replica_clocks) if replica_clocks is not None
            else [self.clock] * n
        )
        if len(clocks) != n:
            raise ValueError(f"{len(clocks)} replica clocks for {n} replicas")
        self.services = [
            ScoringService(
                fns[i], config=self.config.service, clock=clocks[i],
                replica=i,
            )
            for i in range(n)
        ]
        self.sentinel = HostSentinel(
            list(range(n)),
            HeartbeatConfig(
                timeout=self.config.heartbeat_timeout, clock=self.clock
            ),
        )
        self.router = Router(self, self.config.router)
        # the literal is the lock's canonical key (analysis/schedule.py).
        # Lock order: the fleet lock is only ever taken from code holding NO
        # service/queue lock (on_settled fires outside them), and nothing
        # under it calls back into a replica.
        self._lock = _schedule.make_lock("serving/fleet.py:FleetService._lock")
        self.lost: set[int] = set()
        #: the first kernel fault a replica met (None while healthy)
        self._fault: BaseException | None = None
        self._decommissioning: set[int] = set()
        #: id(logical) -> logical for every admitted-unsettled request
        self._pending: dict[int, FleetRequest] = {}
        #: logicals whose attempt died with a decommissioned replica and
        #: await adoption (filled by _attempt_settled during stop())
        self._adoptable: list[FleetRequest] = []
        # fleet-level typed counters (mutations under self._lock)
        self.admitted = 0
        self.completed = 0
        self.quarantined = 0
        self.errors = 0
        self.shed: dict[str, int] = {"deadline_exceeded": 0, "stopped": 0}
        self.rejected: dict[str, int] = {
            "queue_full": 0, "shedding": 0, "stopped": 0, "deadline": 0,
        }
        self.hedges_fired = 0
        self.hedge_duplicates = 0
        self.orphans_adopted = 0
        self.replicas_lost = 0
        #: registry seam: called with (rows, results, replica, latency)
        #: after a completed/quarantined settle, outside every lock
        self.on_served: Callable[..., None] | None = None
        with _LIVE_LOCK:
            # r is a weakref deref — runs no user code, takes no locks
            _LIVE_FLEETS[:] = [
                r for r in _LIVE_FLEETS if r() is not None
            ]
            _LIVE_FLEETS.append(weakref.ref(self))

    # ---------------------------------------------------------- lifecycle
    @property
    def decommissioning(self) -> set[int]:
        return self._decommissioning

    def live_replicas(self) -> list[int]:
        return [
            i for i in range(len(self.services))
            if i not in self.lost and i not in self._decommissioning
        ]

    @property
    def fault(self) -> BaseException | None:
        """The first kernel fault a replica met, or None."""
        self._observe_fault()
        return self._fault

    def _observe_fault(self) -> None:
        """Take up the first failed replica's fault (worker-mode replicas
        fail on their own threads)."""
        if self._fault is not None:
            return
        for svc in self.services:
            fault = svc.fault
            if fault is not None:
                with self._lock:
                    if self._fault is None:
                        self._fault = fault
                return

    def _check_fault(self) -> None:
        """Re-raise the fleet's kernel fault, if a replica met one."""
        self._observe_fault()
        if self._fault is not None:
            raise self._fault

    def start(self, wait_warmup: bool = False) -> "FleetService":
        for svc in self.services:
            svc.start(wait_warmup=wait_warmup)
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Quiesce every live replica (drain mode — queued work executes).
        After stop() every admitted logical request has a typed outcome;
        a kernel fault a replica met is re-raised last."""
        for i in self.live_replicas():
            try:
                self.services[i].stop(drain=True, timeout=timeout)
            except Exception as e:  # every replica still quiesces
                if not is_kernel_fault(e):
                    raise
        # belt and braces: a logical request with no live attempt left
        # (all its replicas died and adoption found no survivor) must
        # still settle — silence is never an outcome
        with self._lock:
            leftovers = list(self._pending.values())
        for logical in leftovers:
            self._settle_logical(
                logical, "stopped",
                error=RejectedByAdmission("stopped", "fleet stopped"),
            )
        self._check_fault()

    def __enter__(self) -> "FleetService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---------------------------------------------------------- admission
    def submit(
        self,
        rows: dict | list[dict],
        deadline: float | None = None,
        explain: int = 0,
        pin: int | None = None,
    ) -> PendingScore:
        """Admit one logical request and dispatch it to the router's best
        replica (falling through the order on per-replica rejection —
        queue-full on one worker is not queue-full on the fleet). ``pin``
        forces the first try onto one replica (the loadtest harness pins
        burst hot-spots). Raises the LAST replica's typed rejection when
        every replica refuses, or :class:`~.deadline.DeadlineExceeded`
        when the budget cannot cover admission anywhere. A failed fleet
        re-raises its kernel fault."""
        self._check_fault()
        if isinstance(rows, dict):
            rows = [rows]
        if not rows:
            raise ValueError("empty request")
        now = self.clock()
        secs = (
            deadline if deadline is not None
            else self.config.service.default_deadline
        )
        handle = PendingScore(submitted_at=now)
        logical = FleetRequest(
            list(rows), secs, int(explain or 0), handle, submitted_at=now
        )
        order = self.router.order()
        if pin is not None and pin in order:
            order = [pin] + [i for i in order if i != pin]
        if not order:
            with self._lock:
                self.rejected["stopped"] += 1
            raise RejectedByAdmission("stopped", "no routable replicas")
        # admitted + pending registered BEFORE the replica offer: a worker
        # thread may settle the attempt the instant submit publishes it,
        # and the fleet invariant (admitted >= settled at every instant)
        # must never observe the settle before the admission
        with self._lock:
            self.admitted += 1
            self._pending[id(logical)] = logical
        last: RejectedByAdmission | None = None
        for i in order:
            try:
                self._dispatch(logical, i)
                return handle
            except RejectedByAdmission as e:
                last = e
            except _deadline.DeadlineExceeded:
                with self._lock:
                    self.admitted -= 1
                    self._pending.pop(id(logical), None)
                    self.rejected["deadline"] += 1
                raise
            except Exception as e:  # a replica failed since the check
                if not is_kernel_fault(e):
                    raise
                with self._lock:
                    self.admitted -= 1
                    self._pending.pop(id(logical), None)
                self._check_fault()
        with self._lock:
            self.admitted -= 1
            self._pending.pop(id(logical), None)
            assert last is not None
            self.rejected[last.reason] = self.rejected.get(last.reason, 0) + 1
        raise last

    # ----------------------------------------------------------- dispatch
    def _dispatch(
        self, logical: FleetRequest, replica: int, hedge: bool = False
    ) -> _Attempt:
        """One replica-level attempt with the REMAINING deadline budget.
        Raises the replica's typed rejection or DeadlineExceeded."""
        remaining = logical.remaining(self.clock())
        if remaining is not None and remaining <= 0:
            raise _deadline.DeadlineExceeded("fleet", remaining, 0.0)
        attempt = _Attempt(replica, hedge=hedge)
        with self._lock:
            logical.attempts.append(attempt)
        svc = self.services[replica]
        try:
            svc.submit(
                logical.rows,
                deadline=remaining,
                explain=logical.explain,
                on_settled=lambda req, L=logical, a=attempt: (
                    self._attempt_settled(L, a, req)
                ),
            )
        except BaseException:
            with self._lock:
                logical.attempts.remove(attempt)
            raise
        self.router.record_dispatch(replica, hedge=hedge)
        return attempt

    def _count_outcome_locked(self, outcome: str) -> None:
        if outcome == "completed":
            self.completed += 1
        elif outcome == "quarantined":
            self.quarantined += 1
        elif outcome == "error":
            self.errors += 1
        else:
            self.shed[outcome] = self.shed.get(outcome, 0) + 1

    def _attempt_settled(
        self, logical: FleetRequest, attempt: _Attempt, req: ScoreRequest
    ) -> None:
        """ScoreRequest.on_settled seam — idempotent de-dup: the first
        attempt to settle stamps the logical handle, later ones count as
        hedge duplicates; a decommission-``stopped`` attempt defers the
        logical to adoption instead of settling it."""
        h = req.handle
        with self._lock:
            if attempt.superseded:
                return
            if (
                h.outcome == "stopped"
                and attempt.replica in self._decommissioning
            ):
                attempt.superseded = True
                if not logical.settled:
                    self._adoptable.append(logical)
                return
            if logical.settled:
                self.hedge_duplicates += 1
                return
            logical.settled = True
            self._pending.pop(id(logical), None)
            self._count_outcome_locked(h.outcome or "error")
        lh = logical.handle
        lh.results = h.results
        lh.error = h.error
        lh.outcome = h.outcome
        # carry the REPLICA clock's completion stamp: on the virtual-time
        # harness the fleet clock lags a replica mid-drain, and latency
        # must be completion-on-the-worker minus fleet arrival
        lh.completed_at = (
            h.completed_at if h.completed_at is not None else self.clock()
        )
        lh._event.set()
        hook = self.on_served
        if hook is not None and h.outcome in ("completed", "quarantined"):
            try:
                hook(
                    logical.rows, h.results, attempt.replica,
                    (lh.completed_at or 0.0) - lh.submitted_at,
                )
            except Exception as e:  # a broken observer must not kill serving
                if not is_kernel_fault(e):
                    log.exception("on_served hook failed")
                    return
                # a kernel fault in the observer's own scoring (the
                # registry's mirror) fails the fleet: the next submit,
                # tick, pump_all or stop re-raises it
                with self._lock:
                    if self._fault is None:
                        self._fault = e

    def _settle_logical(
        self,
        logical: FleetRequest,
        outcome: str,
        results: list[dict] | None = None,
        error: BaseException | None = None,
    ) -> None:
        """Settle a logical request directly (adoption dead-ends) —
        first-wins like the attempt path."""
        with self._lock:
            if logical.settled:
                return
            logical.settled = True
            self._pending.pop(id(logical), None)
            self._count_outcome_locked(outcome)
        h = logical.handle
        h.results = results
        h.error = error
        h.outcome = outcome
        h.completed_at = self.clock()
        h._event.set()

    # -------------------------------------------------------- replica loss
    def lose_replica(self, replica: int, reason: str = "killed") -> int:
        """Decommission one replica: reject-new-then-drain stop (its own
        ledger reconciles — queued work sheds as ``stopped``), then adopt
        every orphan whose logical request is still unsettled onto the
        healthiest survivors with the remaining deadline budget. Returns
        the adopted count. Idempotent per replica."""
        with self._lock:
            if replica in self.lost or replica in self._decommissioning:
                return 0
            self._decommissioning.add(replica)
        self.sentinel.declare_lost(replica)
        try:
            self.services[replica].stop(mode="reject_new_then_drain")
        finally:
            with self._lock:
                self.lost.add(replica)
                self._decommissioning.discard(replica)
                orphans = list(self._adoptable)
                self._adoptable.clear()
                self.replicas_lost += 1
        _tm.REGISTRY.counter("tptpu_fleet_replicas_lost_total").inc()
        _tevents.emit(
            "replica_lost", replica=replica, reason=reason,
            orphans=len(orphans),
        )
        adopted = 0
        for logical in orphans:
            if logical.settled:
                continue
            try:
                placed = False
                last: RejectedByAdmission | None = None
                for i in self.router.order():
                    try:
                        self._dispatch(logical, i)
                        placed = True
                        break
                    except RejectedByAdmission as e:
                        last = e
                if placed:
                    adopted += 1
                else:
                    # no survivor took it — a TYPED outcome, never silence
                    self._settle_logical(
                        logical, "stopped",
                        error=last or RejectedByAdmission(
                            "stopped", "no adoptive replica"
                        ),
                    )
            except _deadline.DeadlineExceeded as e:
                self._settle_logical(logical, "deadline_exceeded", error=e)
            except Exception as e:  # an adoptive replica is failed
                if not is_kernel_fault(e):
                    raise
                self._settle_logical(logical, "error", error=e)
        with self._lock:
            self.orphans_adopted += adopted
        return adopted

    # -------------------------------------------------------------- ticking
    def tick(self, now: float | None = None) -> None:
        """One control-plane heartbeat on the fleet clock: fire scripted
        replica kills, beat un-partitioned replicas, declare
        heartbeat-stale replicas lost (adopting their work), then check
        every pending request's hedge checkpoint. A failed fleet
        re-raises its kernel fault first."""
        self._check_fault()
        t = now if now is not None else self.clock()
        plan = _faults.active()
        if plan is not None:
            for r in plan.replicas_to_kill(t):
                if isinstance(r, int) and 0 <= r < len(self.services):
                    self.lose_replica(r, reason="kill_replica")
        for i in self.live_replicas():
            if plan is not None and plan.replica_partitioned(i, t):
                continue  # partitioned: beats never arrive
            self.sentinel.beat(i)
        for h in list(self.sentinel.dead_hosts()):
            if isinstance(h, int):
                self.lose_replica(h, reason="heartbeat_timeout")
        self._maybe_hedge(t)

    def _maybe_hedge(self, now: float) -> None:
        with self._lock:
            candidates = [
                L for L in self._pending.values()
                if not L.settled and not L.hedged and L.deadline is not None
                and (now - L.submitted_at)
                > self.config.hedge_after_fraction * L.deadline
                and L.attempts
            ]
        for logical in candidates:
            origin = logical.attempts[-1].replica
            exclude = {a.replica for a in logical.attempts}
            target = self.router.pick(exclude=exclude)
            if target is None:
                continue
            gain = self.router.score(target) - self.router.score(origin)
            if not gain > self.config.hedge_score_margin:
                continue
            with self._lock:
                if logical.settled or logical.hedged:
                    continue
                logical.hedged = True
            try:
                self._dispatch(logical, target, hedge=True)
            except (RejectedByAdmission, _deadline.DeadlineExceeded):
                # the original attempt is still in flight; let it race
                # its own deadline rather than force an early outcome
                continue
            with self._lock:
                self.hedges_fired += 1
            _tm.REGISTRY.counter("tptpu_fleet_hedges_fired_total").inc()
            _tevents.emit(
                "hedge_fired", fromReplica=origin, toReplica=target,
                elapsedMs=round((now - logical.submitted_at) * 1e3, 3),
            )

    # ------------------------------------------------------------- pumping
    def pump_all(self) -> int:
        """One synchronous pump round across live replicas (workers=0
        mode); returns settled request count. A kernel fault re-raises."""
        self._check_fault()
        total = 0
        for i in self.live_replicas():
            total += self.services[i].pump()
        self._check_fault()
        return total

    def pump_until_quiet(self, max_rounds: int = 10_000) -> int:
        total = 0
        for _ in range(max_rounds):
            n = self.pump_all()
            if n == 0:
                return total
            total += n
        return total  # pragma: no cover - bounded-loop backstop

    # --------------------------------------------------------------- state
    def stats(self) -> dict[str, Any]:
        with self._lock:
            settled = (
                self.completed + self.quarantined + self.errors
                + sum(self.shed.values())
            )
            out = {
                "replicas": len(self.services),
                "liveReplicas": len(self.services) - len(self.lost),
                "lostReplicas": sorted(self.lost),
                "admitted": self.admitted,
                "completed": self.completed,
                "quarantined": self.quarantined,
                "errors": self.errors,
                "shed": dict(self.shed),
                "rejected": dict(self.rejected),
                "outstanding": self.admitted - settled,
                "hedgesFired": self.hedges_fired,
                "hedgeDuplicates": self.hedge_duplicates,
                "orphansAdopted": self.orphans_adopted,
                "replicasLost": self.replicas_lost,
            }
        out["router"] = self.router.stats()
        out["sentinel"] = self.sentinel.stats()
        out["perReplica"] = [svc.stats() for svc in self.services]
        return out

    def reconcile(self) -> dict[str, Any]:
        """The fleet-level typed invariant plus every replica's own:
        ``reconciled`` is True only when the fleet ledger matches its
        pending set AND each replica's outstanding equals its queued +
        in-flight requests (exact at pump boundaries)."""
        with self._lock:
            settled = (
                self.completed + self.quarantined + self.errors
                + sum(self.shed.values())
            )
            outstanding = self.admitted - settled
            ok = outstanding == len(self._pending) and outstanding >= 0
            pending = len(self._pending)
        per = []
        for i, svc in enumerate(self.services):
            s = svc.stats()
            backlog = svc.queue.depth_requests() + svc._in_flight_requests
            replica_ok = s["outstanding"] == backlog
            ok = ok and replica_ok
            per.append(
                {"replica": i, "outstanding": s["outstanding"],
                 "backlog": backlog, "reconciled": replica_ok}
            )
        return {
            "outstanding": outstanding,
            "pending": pending,
            "perReplica": per,
            "reconciled": ok,
        }


def _fleet_source() -> dict[str, Any]:
    """Aggregate fleet counters across live fleets — the ``fleet`` ledger
    source of ``telemetry.render_prometheus()``."""
    out = {
        "fleets": 0, "replicas": 0, "liveReplicas": 0, "admitted": 0,
        "completed": 0, "shedTotal": 0, "rejectedTotal": 0, "errors": 0,
        "hedgesFired": 0, "hedgeDuplicates": 0, "orphansAdopted": 0,
        "replicasLost": 0,
    }
    with _LIVE_LOCK:
        refs = list(_LIVE_FLEETS)
    for ref in refs:
        fleet = ref()
        if fleet is None:
            continue
        try:
            s = fleet.stats()
        except Exception:  # a half-built fleet must not kill exposition
            continue
        out["fleets"] += 1
        out["replicas"] += s["replicas"]
        out["liveReplicas"] += s["liveReplicas"]
        out["admitted"] += s["admitted"]
        out["completed"] += s["completed"]
        out["shedTotal"] += sum(s["shed"].values())
        out["rejectedTotal"] += sum(s["rejected"].values())
        out["errors"] += s["errors"]
        out["hedgesFired"] += s["hedgesFired"]
        out["hedgeDuplicates"] += s["hedgeDuplicates"]
        out["orphansAdopted"] += s["orphansAdopted"]
        out["replicasLost"] += s["replicasLost"]
    return out


_tm.REGISTRY.register_source("fleet", _fleet_source)
