"""Heartbeat tracking for the serving fleet: the three names of the
reference's distributed-resilience module that ``serving/fleet.py``
needs.

* :class:`HostLostError` — a participant is gone (``BaseException``, like
  ``SimulatedCrash``: infrastructure loss sails through every
  ``except Exception`` isolation layer);
* :class:`HeartbeatConfig` / :class:`HostSentinel` — injectable-clock
  heartbeat tracking per participant (the fleet beats on behalf of its
  live replicas at every tick; ``FaultPlan.drop_heartbeat`` swallows
  beats) plus the per-collective duration history behind a p99-based
  straggler deadline.

The rest of the module — ``CollectiveGuard``, ``FailoverController``, the
row re-slicing (``host_blocks``, ``adopt_orphans``), ``mesh_fingerprint``,
the installed controller and the ``resilience`` ledger source — wraps
the sharded reductions and the streamed fit, which are not ported yet
(``ROADMAP.md`` A13). Referring to any of them raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Any, Callable, Sequence

import numpy as np

from ..telemetry import events as _tevents

log = logging.getLogger(__name__)

__all__ = ["HeartbeatConfig", "HostLostError", "HostSentinel"]

#: the reference module's names that wait for the distributed plane
NOT_PORTED = (
    "CollectiveGuard", "FailoverController", "simulated_host_count",
    "host_blocks", "adopt_orphans", "mesh_fingerprint", "install_controller",
    "uninstall_controller", "active_controller", "active_collective_guard",
    "installed_controller",
)


def __getattr__(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"resilience.distributed.{name} needs the distributed plane, not "
            "ported yet (ROADMAP.md A13)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class HostLostError(BaseException):
    """A mesh participant is gone: heartbeat timeout, exhausted collective
    retries, or an injected ``fail_host`` fault. Derives from
    ``BaseException`` like ``SimulatedCrash``: infrastructure loss must
    sail through candidate isolation and retry layers (which catch
    ``Exception``) — only the workflow failover loop may handle it."""

    def __init__(self, host: Any = None, reason: str = "host lost"):
        self.host = host
        self.reason = reason
        super().__init__(f"host {host!r} lost: {reason}")



# ----------------------------------------------------------------- sentinel
@dataclasses.dataclass
class HeartbeatConfig:
    """Knobs for heartbeat + straggler detection. Defaults are deliberately
    conservative (no deadline under 30s, 10x the p99) so healthy runs never
    trip; tests inject a FakeClock and tighter thresholds (the fleet passes
    its own clock and ``heartbeat_timeout``)."""

    #: seconds without a heartbeat before a host is declared dead
    timeout: float = 300.0
    #: straggler deadline = max(min_deadline, multiplier * p99(history))
    straggler_multiplier: float = 10.0
    #: deadline floor, and the cold-start deadline before history exists
    min_deadline: float = 30.0
    #: per-collective duration window feeding the p99
    history: int = 128
    #: observations of a collective required before its deadline is
    #: ENFORCED (cold-start grace): with no history the floor deadline is
    #: only a guess, and a healthy-but-slow first call (a kernel build, a
    #: genuinely large reduction) must seed the history, not get a host
    #: killed. 0 enforces the floor from the very first call (tests).
    min_samples: int = 1
    #: bounded retries of a timed-out collective before HostLostError
    max_collective_retries: int = 2
    clock: Callable[[], float] = time.monotonic


class HostSentinel:
    """Heartbeat + collective-duration tracking per mesh participant.

    ``beat`` consults the installed FaultPlan (``drop_heartbeat``) so lost
    heartbeats are injectable; ``dead_hosts`` compares last beats against
    the injectable clock; ``deadline_for`` derives the per-collective
    straggler deadline from the p99 of observed durations.

    Beat source: in the CPU simulation the driving process beats on
    behalf of every live simulated host at layer/fold boundaries, so only
    ``drop_heartbeat`` (or an externally wired beat feed) makes a host go
    silent. A real multi-host deployment must wire each process's
    liveness into ``beat`` (control-plane RPC) — the sentinel is the
    bookkeeping, not the transport."""

    def __init__(
        self, hosts: Sequence[Any], config: HeartbeatConfig | None = None
    ):
        self.config = config or HeartbeatConfig()
        self.hosts = list(hosts)
        now = self.config.clock()
        self._last_beat = {h: now for h in self.hosts}
        self.lost: list[Any] = []
        self._durations: dict[str, deque] = {}
        self.counters = {"heartbeatsDropped": 0, "stragglersDetected": 0}

    def beat(self, host: Any) -> bool:
        """Record a heartbeat; returns False when the FaultPlan dropped it."""
        from . import faults

        plan = faults.active()
        if plan is not None and plan.on_heartbeat(host):
            self.counters["heartbeatsDropped"] += 1
            return False
        self._last_beat[host] = self.config.clock()
        return True

    def beat_all(self) -> None:
        for h in self.live_hosts():
            self.beat(h)

    def live_hosts(self) -> list[Any]:
        return [h for h in self.hosts if h not in self.lost]

    def dead_hosts(self) -> list[Any]:
        """Live hosts whose last heartbeat is older than the timeout."""
        now = self.config.clock()
        return [
            h
            for h in self.live_hosts()
            if now - self._last_beat[h] > self.config.timeout
        ]

    def declare_lost(self, host: Any) -> None:
        if host not in self.lost:
            self.lost.append(host)

    # ------------------------------------------------- straggler detection
    def record_duration(self, name: str, seconds: float) -> None:
        self._durations.setdefault(
            name, deque(maxlen=self.config.history)
        ).append(float(seconds))

    def observations(self, name: str) -> int:
        return len(self._durations.get(name, ()))

    def deadline_for(self, name: str) -> float:
        """p99-adaptive per-collective deadline (floored at min_deadline —
        the cold-start value until history accumulates)."""
        hist = self._durations.get(name)
        if not hist:
            return self.config.min_deadline
        p99 = float(np.percentile(np.asarray(hist), 99.0))
        return max(
            self.config.min_deadline, self.config.straggler_multiplier * p99
        )

    def note_straggler(self, name: str, seconds: float) -> None:
        self.counters["stragglersDetected"] += 1
        deadline = self.deadline_for(name)
        _tevents.emit(
            "straggler", collective=name, seconds=round(seconds, 3),
            deadline=round(deadline, 3),
        )
        log.warning(
            "straggler: collective %s took %.3fs (deadline %.3fs)",
            name, seconds, deadline,
        )

    def stats(self) -> dict[str, Any]:
        return {
            "hosts": len(self.hosts),
            "lostHosts": list(self.lost),
            **self.counters,
        }
