"""Backpressure + tiered load shedding with hysteresis.

Under sustained overload a scorer must degrade in ORDER — cheapest
observability first, admissions last — and re-admit smoothly instead of
flapping. The :class:`LoadShedder` computes a load signal from queue
depth, in-flight rows, and the fraction of open circuit breakers, and
maps it onto four cumulative tiers:

====  ================  ============================================
tier  name              sheds
====  ================  ============================================
1     ``shed_explain``  LOCO attribution sweeps (``explain=k`` work)
2     ``shed_detail``   per-stage detail spans (telemetry only)
3     ``shed_drift``    drift-window observation (monitoring only)
4     ``reject``        new admissions (typed ``RejectedByAdmission``)
====  ================  ============================================

Explain sweeps are the first casualty: they multiply the predict cost by
the lane count, and a late explanation is worth strictly less than an
on-time score — so attribution work yields before any other
observability does (rows shed this way are counted per row on
``tptpu_serve_explain_shed_total`` and the attribution ledger).

Each tier has an ENTER threshold and a strictly lower EXIT threshold
(hysteresis): a tier engages when load rises to its enter point and only
disengages once load falls below its exit point, so a service hovering
at a boundary does not oscillate between shedding and re-admitting on
every batch. Every transition increments the tier-transition counter and
emits a ``load_shed`` event.

Tier 1 raises the process-wide explain-shed flag ``local/scoring.py``
checks before an attribution sweep; tier 2 suppresses detail spans
through ``telemetry.spans.set_detail_suppressed`` (the scoring loop
already consults ``stage_detail``); tier 3 raises the drift-shed flag
checked before drift-window observation. All are restored the moment the
shedder drops back below the exit threshold.
"""
from __future__ import annotations

import dataclasses

from ..analysis import schedule as _schedule
from ..telemetry import events as _tevents
from ..telemetry import metrics as _tm
from ..telemetry import spans as _tspans

__all__ = [
    "LoadShedder", "ShedConfig", "TIER_NAMES", "drift_shed", "explain_shed",
]

TIER_NAMES = ("normal", "shed_explain", "shed_detail", "shed_drift", "reject")

# process-wide shed flags are REFCOUNTS of shedder contributions, not
# booleans (mutations hold the lock): two standing services in
# one process each contribute while at/above the tier, so an idle
# service's transition (or reset) can never clear the suppression an
# overloaded one still needs. Reads go through the lock-free accessors —
# a stale read during a transition costs one extra/missing drift
# observation or explain sweep, never correctness.
_LOCK = _schedule.make_lock("serving/shedding.py:_LOCK")
_STATE = {"explain": 0, "detail": 0, "drift": 0}


def explain_shed() -> bool:
    """True while ANY shedder is at tier >= 1 (scoring skips the
    attribution sweep for the batch — explain is the first casualty)."""
    return _STATE["explain"] > 0


def drift_shed() -> bool:
    """True while ANY shedder is at tier >= 3 (scoring skips the drift
    window observe for the batch)."""
    return _STATE["drift"] > 0


def reset_process_flags_for_tests() -> None:
    """Zero the process-wide shed refcounts and lift span suppression.

    Test isolation only: a shedder abandoned mid-tier (no ``reset()``)
    leaks its contribution into ``_STATE``; production code must use
    :meth:`LoadShedder.reset` so co-resident services keep theirs."""
    with _LOCK:
        _STATE["explain"] = 0
        _STATE["detail"] = 0
        _STATE["drift"] = 0
    _tspans.set_detail_suppressed(False)


def _shift(kind: str, delta: int) -> None:
    """Move one shedder's contribution to a process flag; applies the
    boolean to the spans plane when the count crosses zero. Caller holds
    the shedder's own lock; this takes _LOCK then (for detail) the spans
    lock — both leaves, no cycle."""
    if not delta:
        return
    with _LOCK:
        _STATE[kind] = max(0, _STATE[kind] + delta)
        active = _STATE[kind] > 0
    if kind == "detail":
        _tspans.set_detail_suppressed(active)


@dataclasses.dataclass
class ShedConfig:
    """Tier thresholds as fractions of queue capacity (load = (queued +
    in-flight rows) / capacity + breaker_weight * fraction of breakers
    open). Enter > exit per tier = the hysteresis band."""

    explain_enter: float = 0.35
    explain_exit: float = 0.20
    detail_enter: float = 0.50
    detail_exit: float = 0.35
    drift_enter: float = 0.70
    drift_exit: float = 0.50
    reject_enter: float = 0.90
    reject_exit: float = 0.65
    breaker_weight: float = 0.5

    def __post_init__(self) -> None:
        pairs = (
            ("explain", self.explain_enter, self.explain_exit),
            ("detail", self.detail_enter, self.detail_exit),
            ("drift", self.drift_enter, self.drift_exit),
            ("reject", self.reject_enter, self.reject_exit),
        )
        for name, enter, exit_ in pairs:
            if not 0.0 < exit_ < enter:
                raise ValueError(
                    f"{name}: need 0 < exit ({exit_}) < enter ({enter})"
                )

    def enter_for(self, tier: int) -> float:
        return (
            self.explain_enter, self.detail_enter, self.drift_enter,
            self.reject_enter,
        )[tier - 1]

    def exit_for(self, tier: int) -> float:
        return (
            self.explain_exit, self.detail_exit, self.drift_exit,
            self.reject_exit,
        )[tier - 1]


class LoadShedder:
    """Hysteretic tier controller for one service (thread-safe)."""

    def __init__(self, config: ShedConfig | None = None, capacity: int = 2048):
        self.config = config or ShedConfig()
        self.capacity = max(1, capacity)
        self._lock = _schedule.make_lock(
            "serving/shedding.py:LoadShedder._lock"
        )
        self.tier = 0
        self.load = 0.0
        self.transitions = 0
        self.tier_entries = {name: 0 for name in TIER_NAMES[1:]}

    # ------------------------------------------------------------- update
    def update(
        self, queued_rows: int, in_flight_rows: int, breakers_open_frac: float
    ) -> int:
        """Recompute the tier from the current load signal; applies the
        side effects (span suppression, drift flag, event) on change and
        returns the new tier."""
        load = (
            (queued_rows + in_flight_rows) / self.capacity
            + self.config.breaker_weight * breakers_open_frac
        )
        with self._lock:
            self.load = load
            tier = self.tier
            # climb through every tier whose ENTER threshold load reached
            while tier < 4 and load >= self.config.enter_for(tier + 1):
                tier += 1
            # descend only below the EXIT threshold (hysteresis)
            while tier > 0 and load < self.config.exit_for(tier):
                tier -= 1
            if tier == self.tier:
                return tier
            prev, self.tier = self.tier, tier
            self.transitions += 1
            if tier > prev:
                for t in range(prev + 1, tier + 1):
                    self.tier_entries[TIER_NAMES[t]] += 1
            # side effects INSIDE the lock: two concurrent updates must
            # apply their contribution shifts in transition order, or a
            # 0→2 racing a 2→0 would leave the process flags wrong.
            # Safe: the shift/metrics/event locks taken below never wrap
            # an acquisition of this shedder's lock
            _shift("explain", int(tier >= 1) - int(prev >= 1))
            _shift("detail", int(tier >= 2) - int(prev >= 2))
            _shift("drift", int(tier >= 3) - int(prev >= 3))
            _tm.REGISTRY.counter("tptpu_serve_shed_transitions_total").inc()
            _tm.REGISTRY.gauge("tptpu_serve_shed_tier").set(tier)
            _tevents.emit(
                "load_shed", tier=TIER_NAMES[tier], previous=TIER_NAMES[prev],
                load=round(load, 4),
            )
        return tier

    # ------------------------------------------------------------- state
    @property
    def reject_admissions(self) -> bool:
        return self.tier >= 4

    def reset(self) -> None:
        """Back to normal (service shutdown) — withdraws THIS shedder's
        contribution to the process flags (another service still past its
        thresholds keeps its suppression)."""
        with self._lock:
            prev, self.tier = self.tier, 0
            self.load = 0.0
            _shift("explain", -int(prev >= 1))
            _shift("detail", -int(prev >= 2))
            _shift("drift", -int(prev >= 3))
        _tm.REGISTRY.gauge("tptpu_serve_shed_tier").set(0)

    def stats(self) -> dict:
        with self._lock:
            return {
                "tier": self.tier,
                "tierName": TIER_NAMES[self.tier],
                "load": round(self.load, 4),
                "transitions": self.transitions,
                "tierEntries": dict(self.tier_entries),
            }
