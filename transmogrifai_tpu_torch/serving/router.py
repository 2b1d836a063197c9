"""Load-aware, health-aware dispatch across fleet replicas.

The ``Router`` turns the gauges every replica already exports — queue
depth in rows, in-flight rows, breaker-open fraction — plus the fleet's
heartbeat view into one scalar ``score`` per replica:

    score(i) = health(i) - load_weight * load(i)

``health`` is 0.0 for a replica that is lost, stopped, partitioned, or
heartbeat-stale (unroutable), else ``1 - breaker_weight *
breaker_open_fraction``; ``load`` is the replica's occupied capacity
fraction (queued + in-flight rows over its admission bound). Dispatch
``order()`` sorts by descending score with the replica index as the
deterministic tie-break, so the same fleet state always routes the same
way — the loadtest twin runs depend on it.

The router holds no request state; its only mutable fields are dispatch
counters (under its own instrumented lock, a leaf in the lock order —
nothing is acquired while holding it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable

from ..analysis import schedule as _schedule
from ..resilience import faults as _faults

__all__ = ["Router", "RouterConfig"]


@dataclasses.dataclass
class RouterConfig:
    """Scoring weights. Defaults keep health dominant: a half-open-breaker
    replica (health 0.5) still beats an idle dead one (health 0)."""

    #: how hard open breakers depress health (1.0 = all-open means 0)
    breaker_weight: float = 1.0
    #: how hard occupancy depresses the dispatch score
    load_weight: float = 0.5


class Router:
    """Health × load dispatch policy over a fleet's replicas."""

    def __init__(self, fleet: Any, config: RouterConfig | None = None):
        self.fleet = fleet
        self.config = config or RouterConfig()
        # the literal is the lock's canonical key (analysis/schedule.py)
        self._lock = _schedule.make_lock("serving/router.py:Router._lock")
        #: per-replica dispatch counts (mutations under self._lock)
        self.dispatched: dict[Any, int] = {}
        self.hedge_dispatched: dict[Any, int] = {}

    # ------------------------------------------------------------- signals
    def routable(self, i: int) -> bool:
        """A replica the router may dispatch to: alive, started, not
        scripted into a partition, heartbeat fresh."""
        fleet = self.fleet
        if i in fleet.lost or i in fleet.decommissioning:
            return False
        plan = _faults.active()
        if plan is not None and plan.replica_partitioned(i, fleet.clock()):
            return False
        return i not in fleet.sentinel.dead_hosts()

    def health(self, i: int) -> float:
        """0.0 = unroutable; else 1 minus the breaker-open penalty."""
        if not self.routable(i):
            return 0.0
        svc = self.fleet.services[i]
        frac = svc._breaker_open_fraction()
        return max(0.0, 1.0 - self.config.breaker_weight * frac)

    def load(self, i: int) -> float:
        """Occupied capacity fraction: queued + in-flight rows over the
        replica's admission bound."""
        svc = self.fleet.services[i]
        cap = max(1, svc.config.max_queue_rows)
        return (svc.queue.depth_rows() + svc._in_flight_rows) / cap

    def score(self, i: int) -> float:
        h = self.health(i)
        if h <= 0.0:
            return float("-inf")
        return h - self.config.load_weight * self.load(i)

    # ------------------------------------------------------------ dispatch
    def order(self, exclude: Iterable[int] = ()) -> list[int]:
        """Routable replicas, best score first, index tie-broken —
        deterministic for identical fleet state."""
        skip = set(exclude)
        scored = [
            (i, self.score(i))
            for i in range(len(self.fleet.services))
            if i not in skip
        ]
        live = [(i, s) for i, s in scored if s != float("-inf")]
        live.sort(key=lambda t: (-t[1], t[0]))
        return [i for i, _ in live]

    def pick(self, exclude: Iterable[int] = ()) -> int | None:
        """Best routable replica, or None when the whole fleet is down."""
        order = self.order(exclude)
        return order[0] if order else None

    def record_dispatch(self, i: int, hedge: bool = False) -> None:
        with self._lock:
            self.dispatched[i] = self.dispatched.get(i, 0) + 1
            if hedge:
                self.hedge_dispatched[i] = (
                    self.hedge_dispatched.get(i, 0) + 1
                )

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "dispatched": dict(self.dispatched),
                "hedgeDispatched": dict(self.hedge_dispatched),
            }
