"""Versioned model rollout over a fleet: shadow scoring and
sentinel-gated canary promotion.

The ``ModelRegistry`` owns the mapping ``version -> score_function`` and
two rollout modes that never bet the fleet on an unproven model:

* **Shadow** — the candidate scores a MIRROR of served traffic (the
  fleet's ``on_served`` seam hands it every completed request's rows),
  its predictions are compared against what was actually served, and
  nothing it produces ever reaches a caller. Zero risk, full-traffic
  evidence.
* **Canary** — the candidate takes over a SUBSET of replicas (an atomic
  ``score_fn`` swap between batches, so no request is ever dropped by
  the rollout itself) while the registry re-scores every canary-served
  request with the control model. :meth:`evaluate_canary` feeds the
  per-side latency and the agreement / score-delta quality metrics to a
  :class:`~..telemetry.runlog.RegressionSentinel` diff and checks the
  attribution-drift alert counter; any finding rolls the subset back to
  the control model (``canary_rollback`` event, typed taxonomy in the
  event's ``codes``), a clean run promotes fleet-wide.

Rollback taxonomy (the event's ``codes`` field): ``TPR001`` canary-side
latency regression, ``TPR004`` quality regression (agreement drop /
score-error growth), ``attribution_drift`` fresh drift alerts during
the canary window.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Iterable

from ..analysis import schedule as _schedule
from ..insights import ledger as _iledger
from ..telemetry import events as _tevents
from ..telemetry import metrics as _tm
from ..telemetry.runlog import RegressionSentinel, RunTolerances
from ..utils.cuda_build import is_kernel_fault

log = logging.getLogger(__name__)

__all__ = ["ModelRegistry"]


def _scalar(row: dict) -> float | None:
    """A comparable scalar from one served result row: the ``prediction``
    inside the first rendered prediction map, else the first numeric
    value. None when the row carries nothing comparable."""
    if not isinstance(row, dict):
        return None
    for v in row.values():
        if isinstance(v, dict) and "prediction" in v:
            try:
                return float(v["prediction"])
            except (TypeError, ValueError):
                continue
    for v in row.values():
        if isinstance(v, (int, float)):
            return float(v)
    return None


def _compare(served: list[dict], mirror: list[dict]) -> tuple[int, int, float]:
    """(compared, agreements, abs-delta sum) over paired result rows."""
    compared = agree = 0
    delta = 0.0
    for a, b in zip(served, mirror):
        x, y = _scalar(a), _scalar(b)
        if x is None or y is None:
            continue
        compared += 1
        d = abs(x - y)
        delta += d
        if d < 1e-9 or round(x) == round(y):
            agree += 1
    return compared, agree, delta


class ModelRegistry:
    """Versioned score-function rollout over one :class:`FleetService`."""

    def __init__(self, fleet: Any, tolerances: RunTolerances | None = None):
        self.fleet = fleet
        self.tolerances = tolerances or RunTolerances()
        # the literal is the lock's canonical key (analysis/schedule.py);
        # LEAF lock — nothing else is acquired under it
        # and no foreign callable runs while it is held
        self._lock = _schedule.make_lock(
            "serving/registry.py:ModelRegistry._lock"
        )
        self._versions: dict[str, Callable] = {}
        self.serving: str | None = None
        self._shadow: dict[str, Any] | None = None
        self._canary: dict[str, Any] | None = None
        self.rollbacks = 0
        self.promotions = 0
        fleet.on_served = self._on_served

    # ------------------------------------------------------------ versions
    def register(self, version: str, score_fn: Callable) -> "ModelRegistry":
        with self._lock:
            self._versions[version] = score_fn
        return self

    def deploy(self, version: str) -> None:
        """Serve ``version`` fleet-wide — an atomic per-replica
        ``score_fn`` swap between batches; in-flight batches finish on
        the model they started with, queued requests score on the new
        one, nothing is dropped."""
        with self._lock:
            fn = self._versions[version]
        for svc in self.fleet.services:
            svc.score_fn = fn
        with self._lock:
            self.serving = version

    # -------------------------------------------------------------- shadow
    def start_shadow(self, version: str, sample_every: int = 1) -> None:
        """Mirror every ``sample_every``-th served request through the
        candidate; its output is compared, never served."""
        if sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        with self._lock:
            if self._shadow is not None:
                raise RuntimeError("a shadow is already running")
            self._shadow = {
                "version": version, "fn": self._versions[version],
                "sample_every": sample_every, "seen": 0, "compared": 0,
                "agreements": 0, "absDelta": 0.0, "mirrorErrors": 0,
                "fault": None,
            }

    def shadow_report(self) -> dict[str, Any]:
        with self._lock:
            if self._shadow is None:
                raise RuntimeError("no shadow running")
            s = self._shadow
            _raise_fault(s)
            compared = s["compared"]
            return {
                "version": s["version"],
                "seen": s["seen"],
                "compared": compared,
                "agreement": (
                    s["agreements"] / compared if compared else None
                ),
                "meanAbsDelta": (
                    s["absDelta"] / compared if compared else None
                ),
                "mirrorErrors": s["mirrorErrors"],
            }

    def stop_shadow(self) -> dict[str, Any]:
        report = self.shadow_report()
        with self._lock:
            self._shadow = None
        return report

    # -------------------------------------------------------------- canary
    def start_canary(
        self,
        version: str,
        replicas: Iterable[int] = (0,),
        tolerances: RunTolerances | None = None,
    ) -> None:
        """Promote ``version`` onto a replica subset; every request those
        replicas serve is re-scored by the control model for the gate."""
        subset = sorted(set(replicas))
        with self._lock:
            if self._canary is not None:
                raise RuntimeError("a canary is already running")
            fn = self._versions[version]
            if not subset:
                raise ValueError("canary needs at least one replica")
            for i in subset:
                if not 0 <= i < len(self.fleet.services):
                    raise ValueError(f"no replica {i}")
            self._canary = {
                "version": version, "fn": fn, "replicas": set(subset),
                "tolerances": tolerances or self.tolerances,
                "controlFns": {
                    i: self.fleet.services[i].score_fn for i in subset
                },
                "compared": 0, "agreements": 0, "absDelta": 0.0,
                "canaryLatency": 0.0, "canaryServed": 0,
                "controlLatency": 0.0, "controlServed": 0,
                "mirrorErrors": 0, "fault": None,
                "driftAlertsAt": _iledger.snapshot()["attributionDriftAlerts"],
            }
        for i in subset:
            self.fleet.services[i].score_fn = fn

    def _canary_metrics_locked(self) -> dict[str, Any]:
        c = self._canary
        assert c is not None
        _raise_fault(c)
        compared = c["compared"]
        return {
            "version": c["version"],
            "replicas": sorted(c["replicas"]),
            "compared": compared,
            "agreement": c["agreements"] / compared if compared else None,
            "scoreError": c["absDelta"] / compared if compared else None,
            "canaryServed": c["canaryServed"],
            "controlServed": c["controlServed"],
            "canaryLatency": (
                c["canaryLatency"] / c["canaryServed"]
                if c["canaryServed"] else None
            ),
            "controlLatency": (
                c["controlLatency"] / c["controlServed"]
                if c["controlServed"] else None
            ),
            "mirrorErrors": c["mirrorErrors"],
        }

    def canary_report(self) -> dict[str, Any]:
        with self._lock:
            if self._canary is None:
                raise RuntimeError("no canary running")
            return self._canary_metrics_locked()

    def evaluate_canary(self) -> dict[str, Any]:
        """Gate the canary: sentinel-diff the canary window against the
        control side (latency phase + agreement / score-error quality),
        add any fresh attribution-drift alerts, then roll back on ANY
        finding or promote on none. Returns the decision record."""
        with self._lock:
            if self._canary is None:
                raise RuntimeError("no canary running")
            c = self._canary
            m = self._canary_metrics_locked()
            tol = c["tolerances"]
            drift_before = c["driftAlertsAt"]
        codes: list[str] = []
        if m["compared"]:
            baseline = {
                "run": {
                    "phases": {
                        "serve": {"seconds": m["controlLatency"] or 0.0}
                    },
                    "quality": {"agreement": 1.0, "score_error": 0.0},
                }
            }
            current = {
                "run": {
                    "phases": {
                        "serve": {"seconds": m["canaryLatency"] or 0.0}
                    },
                    "quality": {
                        "agreement": m["agreement"],
                        "score_error": m["scoreError"],
                    },
                }
            }
            report = RegressionSentinel(baseline, tol).check(current)
            codes.extend(sorted({f.code for f in report.findings}))
        drift_now = _iledger.snapshot()["attributionDriftAlerts"]
        if drift_now > drift_before:
            codes.append("attribution_drift")
        decision = dict(m)
        decision["codes"] = codes
        if codes:
            self.rollback(codes=codes)
            decision["decision"] = "rollback"
        else:
            self.promote()
            decision["decision"] = "promote"
        return decision

    def rollback(self, codes: Iterable[str] = ()) -> None:
        """Restore the control model on every canary replica (atomic swap
        again — zero dropped requests) and record the typed reason."""
        with self._lock:
            if self._canary is None:
                raise RuntimeError("no canary running")
            c = self._canary
            self._canary = None
            self.rollbacks += 1
        for i, fn in c["controlFns"].items():
            self.fleet.services[i].score_fn = fn
        _tm.REGISTRY.counter("tptpu_canary_rollbacks_total").inc()
        _tevents.emit(
            "canary_rollback", version=c["version"],
            replicas=sorted(c["replicas"]), codes=list(codes),
        )

    def promote(self) -> None:
        """Fleet-wide promotion of a clean canary. A window whose mirror
        met a kernel fault re-raises it and promotes nothing."""
        with self._lock:
            if self._canary is None:
                raise RuntimeError("no canary running")
            c = self._canary
            _raise_fault(c)
            self._canary = None
            self.promotions += 1
            self._versions.setdefault(c["version"], c["fn"])
        for svc in self.fleet.services:
            svc.score_fn = c["fn"]
        with self._lock:
            self.serving = c["version"]
        _tevents.emit(
            "canary_promoted", version=c["version"],
            replicas=sorted(c["replicas"]),
        )

    # ------------------------------------------------------------ observer
    def _on_served(
        self, rows: list[dict], results: list[dict] | None,
        replica: int, latency: float,
    ) -> None:
        """The fleet's ``on_served`` seam (called outside every fleet /
        service lock). Mirror scoring runs HERE, on the settling thread —
        never under the registry lock."""
        if results is None:
            return
        with self._lock:
            shadow = self._shadow
            canary = self._canary
            run_shadow = False
            if shadow is not None:
                shadow["seen"] += 1
                run_shadow = shadow["seen"] % shadow["sample_every"] == 0
            if canary is not None:
                if replica in canary["replicas"]:
                    canary["canaryServed"] += 1
                    canary["canaryLatency"] += latency
                else:
                    canary["controlServed"] += 1
                    canary["controlLatency"] += latency
        if shadow is not None and run_shadow:
            self._mirror(shadow, shadow["fn"], rows, results)
        if canary is not None and replica in canary["replicas"]:
            # re-score the canary-served rows with the CONTROL model; the
            # quality gate compares what the canary said against what the
            # control would have said on identical traffic
            control = next(iter(canary["controlFns"].values()))
            self._mirror(canary, control, rows, results)

    def _mirror(
        self, state: dict, fn: Callable, rows: list[dict],
        served: list[dict],
    ) -> None:
        try:
            mirror = fn.batch([dict(r) for r in rows])
        except Exception as e:
            with self._lock:
                if is_kernel_fault(e):
                    if state["fault"] is None:
                        state["fault"] = e
                else:
                    state["mirrorErrors"] += 1
            if is_kernel_fault(e):
                raise
            log.debug("mirror scoring failed", exc_info=True)
            return
        compared, agree, delta = _compare(served, mirror)
        with self._lock:
            state["compared"] += compared
            state["agreements"] += agree
            state["absDelta"] += delta


def _raise_fault(state: dict) -> None:
    """Re-raise the kernel fault a shadow's or canary's mirror met."""
    if state["fault"] is not None:
        raise state["fault"]
