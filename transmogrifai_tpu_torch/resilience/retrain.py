"""Continuous-retraining control loop — drift-triggered warm-start
retrain, run-ledger gating, and zero-drop hot swap into the live fleet.

Drift detection (:class:`~.sentinel.DriftSentinel`, the attribution-drift
monitor), checkpointed training (:mod:`.checkpoint`), the run-ledger gate
(:func:`~..telemetry.runlog.diff_runs`) and the atomic model swap under
traffic (:class:`~..serving.registry.ModelRegistry`) each exist on their
own; :class:`RetrainController` connects them as a supervised state
machine

    idle -> collecting -> retraining -> validating -> canarying
                                            |-> promoted | rolled_back

driven ENTIRELY by :meth:`RetrainController.tick` on an injectable
clock — no thread of its own, no wall-clock reads, so the whole loop
replays deterministically inside the virtual-time fleet loadtest.

* **idle** — ``drift_alert`` / ``attribution_drift`` events (delivered
  through the :mod:`~..telemetry.events` subscriber seam) accumulate in
  a debounce window. A retrain triggers only when a QUORUM of distinct
  features alert inside ``quorum_window`` seconds, none of them is in
  its per-feature ``cooldown``, the ``max_retrains`` lifetime bound has
  room, and any backoff from a previous failure has expired — one noisy
  feature cannot thrash the loop, and a pathological
  detect→retrain→regress cycle is provably bounded by ``max_retrains``
  plus the :class:`~.retry.RetryPolicy`-shaped backoff schedule.
* **collecting** — the fleet's ``on_served`` seam (chained behind the
  registry's mirror-scoring hook) buffers recently served rows into
  sealed chunks of ``chunk_rows``; each sealed chunk folds its numeric
  fields into monoid-merged :class:`~..utils.streaming_histogram.
  StreamingHistogram` fit stats (one chunk materialized at a time — the
  stats plane never holds the window), and a chunk the fault plan marks
  torn (``corrupt_new_chunk``) is quarantined, never trained on.
* **retraining** — the injectable ``trainer`` runs a warm-start
  ``Workflow.train(checkpoint_dir=..., resume=...)`` over the chunked
  window. A :class:`~.faults.SimulatedCrash` (``crash_retrain``) leaves
  the machine IN ``retraining``: the next tick re-enters the trainer
  with ``resume=True`` and the fit restores from its own layer
  checkpoints. Any other trainer failure is a failed attempt — backoff
  escalates and the machine returns to idle.
* **validating** — ``diff_runs(baseline, refreshed)`` gates the
  refreshed model BEFORE it sees traffic: any TPR finding refuses the
  ship (``retrain_gated``) and the canary never starts.
* **canarying** — the refreshed model rides the existing
  :class:`~..serving.registry.ModelRegistry` canary (atomic per-replica
  ``score_fn`` swap — zero dropped requests); once ``min_canary_served``
  requests have been compared, ``evaluate_canary()`` promotes fleet-wide
  or rolls the subset back. A canary that cannot gather evidence before
  ``canary_timeout`` virtual seconds rolls back instead of promoting on
  silence.

Every decision is observable: ``retrain_triggered`` / ``retrain_gated``
/ ``retrain_promoted`` / ``retrain_rolled_back`` events, the ``retrain``
ledger source in the Prometheus exposition, and the ``retrainLedger``
block in ``Workflow.summary_json()`` / ``score_fn.metadata()``.

One departure from the reference: a kernel fault
(``utils.cuda_build.is_kernel_fault``) in the trainer, in the drift
source's sweep or in the canary's scoring (which fails the fleet and
voids the canary window, ``serving/registry.py``) is no failed attempt:
it propagates out of :meth:`RetrainController.tick` with no backoff, no
rollback and no state change, so a fault of the card is never retried
behind a slower path.
"""
from __future__ import annotations

import dataclasses
import logging
import random
import threading
import weakref
from typing import Any, Callable, Iterable

from ..analysis import schedule as _schedule
from ..telemetry import events as _tevents
from ..telemetry import metrics as _tm
from ..telemetry import spans as _tspans
from ..telemetry.runlog import RunTolerances, diff_runs
from ..utils.cuda_build import is_kernel_fault
from ..utils.streaming_histogram import StreamingHistogram
from . import faults as _faults
from .faults import SimulatedCrash
from .retry import RetryPolicy

log = logging.getLogger(__name__)

__all__ = [
    "RetrainConfig",
    "RetrainController",
    "chunk_fit_stats",
    "warm_start_workflow_trainer",
    "ledger_snapshot",
]

#: alert kinds that count toward the trigger quorum
_ALERT_KINDS = frozenset({"drift_alert", "attribution_drift"})

#: machine states (promoted/rolled_back are terminal OUTCOMES of a loop
#: pass, recorded in the history/counters — the machine itself re-arms
#: to idle)
STATES = ("idle", "collecting", "retraining", "validating", "canarying")


@dataclasses.dataclass
class RetrainConfig:
    """Knobs of the control loop (all times in controller-clock
    seconds)."""

    #: distinct alerting features required inside ``quorum_window``
    quorum: int = 1
    quorum_window: float = 30.0
    #: per-feature refractory period: a feature that already contributed
    #: to a trigger cannot contribute again until this expires
    cooldown: float = 120.0
    #: recent-traffic window: rows to collect before retraining
    collect_rows: int = 128
    #: rows per sealed chunk (the materialization unit of the window)
    chunk_rows: int = 32
    #: bins of the per-field monoid fit-stat histograms
    stat_bins: int = 64
    #: compared requests the canary must gather before evaluation
    min_canary_served: int = 4
    #: replica subset the canary takes over
    canary_replicas: tuple[int, ...] = (0,)
    #: virtual seconds a canary may starve before rolling back on
    #: "no evidence" (replica loss, drained traffic)
    canary_timeout: float = 60.0
    #: lifetime bound on retrain attempts — the hard stop of a
    #: pathological detect→retrain→regress cycle
    max_retrains: int = 3
    #: backoff schedule between failed attempts (a RetryPolicy's shape;
    #: only ``delay_for`` is used — the controller never sleeps, it
    #: refuses to re-trigger before ``now + delay``). jitter=0 keeps the
    #: seeded twin bit-identical.
    backoff: RetryPolicy = dataclasses.field(
        default_factory=lambda: RetryPolicy(
            max_attempts=6, base_delay=30.0, max_delay=600.0, jitter=0.0
        )
    )
    #: run-ledger gate tolerances (None = RunTolerances defaults)
    tolerances: RunTolerances | None = None
    #: poll cadence for ``drift_source.report()`` (None = never — the
    #: caller runs the sentinel reports itself)
    drift_check_every: float | None = None
    seed: int = 0


class RetrainStats(_tm.LedgerCore):
    """Counter ledger of the control loop (shared metrics lock)."""

    KEYS = (
        "retrainsTriggered",
        "retrainsPromoted",
        "retrainsRolledBack",
        "retrainsGated",
        "retrainCrashes",
        "retrainResumes",
        "retrainFailures",
        "alertsSeen",
        "driftCleared",
        "triggersSuppressed",
        "chunksCollected",
        "chunksCorrupted",
        "rowsCollected",
    )

    def __init__(self) -> None:
        super().__init__(self.KEYS)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)


#: the full counter catalogue at zero, so a fresh process exposes every
#: retrain metric before any controller exists (mirrors the resilience
#: source's _ZERO_LEDGER)
_ZERO_LEDGER: dict[str, Any] = {k: 0 for k in RetrainStats.KEYS}
_ZERO_LEDGER.update({
    "state": "idle",
    "retrainsStarted": 0,
    "consecutiveFailures": 0,
    "backoffUntil": 0.0,
    "chunksBuffered": 0,
    "fitStatsFeatures": 0,
    "maxChunkRows": 0,
    "deviceMemoryHighWater": 0,
})

#: weakref to the most recently constructed controller — the ``retrain``
#: exposition source keeps reporting after the owning harness drops it
_ACTIVE: Callable[[], "RetrainController | None"] | None = None


def _retrain_source() -> dict[str, Any]:
    c = _ACTIVE() if _ACTIVE is not None else None
    if c is None:
        return dict(_ZERO_LEDGER)
    return {**_ZERO_LEDGER, **c.ledger()}


_tm.REGISTRY.register_source("retrain", _retrain_source)


def ledger_snapshot() -> dict[str, Any]:
    """The ``retrain`` ledger as surfaced to ``score_fn.metadata()`` and
    ``Workflow.summary_json()`` — active controller's counters merged
    over the zero catalogue."""
    return _retrain_source()


def chunk_fit_stats(
    chunks: Iterable[list[dict]], max_bins: int = 64
) -> dict[str, StreamingHistogram]:
    """Monoid-merged per-field :class:`StreamingHistogram` fit stats over
    a chunked row window — one chunk's values in flight at a time, so the
    stats plane never materializes the window."""
    merged: dict[str, StreamingHistogram] = {}
    for chunk in chunks:
        for name, hist in _chunk_histograms(chunk, max_bins).items():
            got = merged.get(name)
            merged[name] = hist if got is None else got.merge(hist)
    return merged


def _chunk_histograms(
    chunk: list[dict], max_bins: int
) -> dict[str, StreamingHistogram]:
    from ..utils.streaming_histogram import histogram_from_values

    by_field: dict[str, list[float]] = {}
    for row in chunk:
        for name, value in row.items():
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                continue
            by_field.setdefault(name, []).append(float(value))
    return {
        name: histogram_from_values(vals, max_bins=max_bins)
        for name, vals in by_field.items()
    }


def warm_start_workflow_trainer(
    build_workflow: Callable[[list[list[dict]], dict], Any],
    checkpoint_dir: str,
    score_fn_of: Callable[[Any], Callable] | None = None,
    version_prefix: str = "retrain",
) -> Callable:
    """The standard trainer seam: ``build_workflow(chunks, ctx)`` returns
    a ready :class:`~..workflow.workflow.Workflow` over the chunked
    window; this wrapper runs the warm-start
    ``train(checkpoint_dir=..., resume=ctx["resume"])`` (a resumed
    attempt restores the crashed attempt's layer-checkpoint prefix),
    derives the serving closure via ``local.scoring.score_function``, and
    hands the controller the RUN_ document for the run-ledger gate."""

    def trainer(chunks: list[list[dict]], ctx: dict) -> tuple:
        from ..local.scoring import score_function

        wf = build_workflow(chunks, ctx)
        model = wf.train(
            checkpoint_dir=checkpoint_dir,
            resume=bool(ctx.get("resume")),
            run_dir="",
        )
        version = f"{version_prefix}-{int(ctx.get('retrainIndex', 0)):03d}"
        fn = (score_fn_of or score_function)(model)
        run_doc = {"run": getattr(model, "run_report", None) or {}}
        return version, fn, run_doc

    return trainer


class RetrainController:
    """The supervised retrain state machine over one fleet + registry.

    ``trainer(chunks, ctx) -> (version, score_fn, run_doc)`` is the
    injectable retraining seam (see :func:`warm_start_workflow_trainer`);
    ``ctx`` carries ``resume`` (a crashed attempt restores from its layer
    checkpoints), ``retrainIndex``, ``now``, and the monoid ``fitStats``.
    ``baseline_run`` is the pinned RUN_ document the run-ledger gate
    diffs each refreshed model against (a promotion re-pins it to the
    promoted run). ``clock`` is the injectable time source — the
    controller NEVER reads wall time and NEVER sleeps.

    Lock discipline: ``_lock`` is a LEAF (re-entrant) lock guarding the
    machine state, alert buffer, and chunk window. Foreign code — the
    trainer, the registry, the drift source, event emission — always
    runs OUTSIDE it; the event subscriber and the chained ``on_served``
    hook only record under it and return.
    """

    def __init__(
        self,
        fleet: Any,
        registry: Any,
        trainer: Callable[[list[list[dict]], dict], tuple],
        config: RetrainConfig | None = None,
        clock: Callable[[], float] | None = None,
        baseline_run: dict[str, Any] | None = None,
        drift_source: Any = None,
    ):
        self.fleet = fleet
        self.registry = registry
        self.trainer = trainer
        self.config = config or RetrainConfig()
        self._clock = clock if clock is not None else _tspans.clock
        self.baseline_run = baseline_run
        #: optional object with a ``report()`` that runs the drift
        #: sweep (a DriftSentinel); polled every ``drift_check_every``
        self.drift_source = drift_source
        # instrumented-lock seam: the literal is the static analyzer's
        # canonical key. Re-entrant: the events subscriber may fire on
        # the ticking thread (a tick-driven sentinel report emits
        # drift_alert synchronously).
        self._lock = _schedule.make_lock(
            "resilience/retrain.py:RetrainController._lock", threading.RLock
        )
        self.stats = RetrainStats()
        self.state: str = "idle"
        self.history: list[dict[str, Any]] = []
        self._rng = random.Random(self.config.seed)
        self._alerts: list[tuple[float, str]] = []
        self._drifting: set[str] = set()
        self._last_trigger: dict[str, float] = {}
        self._not_before = 0.0
        self._consecutive_failures = 0
        self._retrains_started = 0
        self._trigger_features: list[str] = []
        self._buffer: list[dict] = []
        self._chunks: list[list[dict]] = []
        self._chunk_seq = 0
        self._rows_collected = 0
        self._max_chunk_rows = 0
        self._fit_stats: dict[str, StreamingHistogram] = {}
        self._pending: tuple[str, Callable, dict] | None = None
        self._resume = False
        self._canary_started: float | None = None
        self._last_drift_check: float | None = None
        self._memory_high_water = 0
        self._closed = False
        # integration seams: chain the fleet's on_served hook (the
        # registry installed its mirror-scoring hook first — keep it),
        # and subscribe to the structured event stream
        self._prev_on_served = getattr(fleet, "on_served", None)
        fleet.on_served = self._on_served
        _tevents.subscribe(self._on_event)
        global _ACTIVE
        _ACTIVE = weakref.ref(self)

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Detach from the fleet and the event stream (idempotent)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        _tevents.unsubscribe(self._on_event)
        # bound-method equality, not identity: each attribute access
        # creates a fresh bound method object
        if getattr(self.fleet, "on_served", None) == self._on_served:
            self.fleet.on_served = self._prev_on_served

    # ---------------------------------------------------------------- intake
    def _on_event(self, rec: dict[str, Any]) -> None:
        """Events subscriber: record-and-return (decisions happen only in
        tick). Runs on the emitting thread, after the events lock is
        released."""
        kind = rec.get("kind")
        if kind == "drift_cleared":
            feature = str(rec.get("feature", ""))
            with self._lock:
                self._drifting.discard(feature)
            self.stats.bump("driftCleared")
            return
        if kind not in _ALERT_KINDS:
            return
        feature = str(rec.get("feature", kind))
        now = self._clock()
        with self._lock:
            self._alerts.append((now, feature))
            self._drifting.add(feature)
        self.stats.bump("alertsSeen")

    def _on_served(
        self,
        rows: list[dict],
        results: list[dict] | None,
        replica: int,
        latency: float,
    ) -> None:
        """Chained fleet ``on_served`` hook (called outside every fleet /
        service lock): forward to the registry's mirror-scoring hook,
        then buffer the served rows while collecting."""
        prev = self._prev_on_served
        if prev is not None:
            prev(rows, results, replica, latency)
        if results is None:
            return
        sealed: list[dict] | None = None
        with self._lock:
            if self.state != "collecting":
                return
            room = self.config.collect_rows - self._rows_collected
            if room <= 0:
                return
            self._buffer.extend(dict(r) for r in rows[:room])
            self._rows_collected += min(len(rows), room)
            if len(self._buffer) >= self.config.chunk_rows:
                sealed = self._buffer[: self.config.chunk_rows]
                del self._buffer[: self.config.chunk_rows]
        if sealed is not None:
            self._seal_chunk(sealed)

    def _seal_chunk(self, chunk: list[dict]) -> None:
        """Seal one chunk: consult the fault plan's torn-chunk script,
        fold the chunk's numeric fields into the monoid fit stats, and
        commit. Fault hooks and histogram building run OUTSIDE the
        controller lock."""
        with self._lock:
            self._chunk_seq += 1
            seq = self._chunk_seq
        plan = _faults.active()
        if plan is not None and plan.corrupts_new_chunk(seq):
            self.stats.bump("chunksCorrupted")
            log.warning(
                "retrain: quarantined torn chunk %d (%d rows)",
                seq, len(chunk),
            )
            with self._lock:
                # the quarantined rows do not count toward the window —
                # collection keeps going until clean rows fill it
                self._rows_collected = max(
                    0, self._rows_collected - len(chunk)
                )
            return
        hists = _chunk_histograms(chunk, self.config.stat_bins)
        with self._lock:
            self._chunks.append(chunk)
            self._max_chunk_rows = max(self._max_chunk_rows, len(chunk))
            for name, hist in hists.items():
                got = self._fit_stats.get(name)
                self._fit_stats[name] = (
                    hist if got is None else got.merge(hist)
                )
        self.stats.bump("chunksCollected")

    # ------------------------------------------------------------------ tick
    def tick(self, now: float | None = None) -> str:
        """Advance the machine one step at virtual instant ``now``;
        returns the (possibly new) state. Call it wherever the fleet
        control plane ticks — every loadtest arrival, every drain pass."""
        t = self._clock() if now is None else float(now)
        self._maybe_poll_drift(t)
        with self._lock:
            state = self.state
        if state == "idle":
            self._tick_idle(t)
        elif state == "collecting":
            self._tick_collecting(t)
        elif state == "retraining":
            self._tick_retraining(t)
        elif state == "validating":
            self._tick_validating(t)
        elif state == "canarying":
            self._tick_canarying(t)
        with self._lock:
            return self.state

    def _maybe_poll_drift(self, now: float) -> None:
        """Run the drift source's report sweep on the configured cadence —
        the sweep's hysteresis emits drift_alert / drift_cleared, which
        re-enter through the events subscriber."""
        every = self.config.drift_check_every
        src = self.drift_source
        if every is None or src is None:
            return
        with self._lock:
            due = (
                self._last_drift_check is None
                or now - self._last_drift_check >= every
            )
            if due:
                self._last_drift_check = now
        if due:
            try:
                src.report()
            except Exception as e:
                if is_kernel_fault(e):
                    raise
                log.debug("drift source report failed", exc_info=True)

    # ------------------------------------------------------------ idle state
    def _tick_idle(self, now: float) -> None:
        cfg = self.config
        with self._lock:
            self._alerts = [
                (ts, f) for ts, f in self._alerts
                if now - ts < cfg.quorum_window
            ]
            eligible = sorted({
                f for _, f in self._alerts
                if now - self._last_trigger.get(f, -float("inf"))
                >= cfg.cooldown
            })
            if len(eligible) < cfg.quorum:
                return
            if self._retrains_started >= cfg.max_retrains:
                # the lifetime bound: drop the quorum so the suppression
                # is counted once per formed quorum, not once per tick
                self._alerts = []
                suppressed = True
            elif now < self._not_before:
                return  # backing off — the quorum may re-form later
            else:
                suppressed = False
                self._retrains_started += 1
                index = self._retrains_started
                for f in eligible:
                    self._last_trigger[f] = now
                self._alerts = []
                self._trigger_features = eligible
                self._buffer = []
                self._chunks = []
                self._rows_collected = 0
                self._fit_stats = {}
                self.state = "collecting"
        if suppressed:
            self.stats.bump("triggersSuppressed")
            log.warning(
                "retrain: quorum %s suppressed — max_retrains=%d reached",
                eligible, cfg.max_retrains,
            )
            return
        self.stats.bump("retrainsTriggered")
        _tevents.emit(
            "retrain_triggered",
            features=eligible,
            retrainIndex=index,
            quorum=cfg.quorum,
        )
        log.info(
            "retrain %d triggered by drift quorum %s", index, eligible
        )

    # ------------------------------------------------------ collecting state
    def _tick_collecting(self, now: float) -> None:
        sealed: list[dict] | None = None
        done = False
        with self._lock:
            if self._rows_collected >= self.config.collect_rows:
                if self._buffer:
                    sealed = self._buffer
                    self._buffer = []
                else:
                    done = True
                    self.state = "retraining"
        if sealed is not None:
            self._seal_chunk(sealed)
            with self._lock:
                if (
                    self.state == "collecting"
                    and self._rows_collected >= self.config.collect_rows
                    and not self._buffer
                ):
                    self.state = "retraining"
            return
        if done:
            log.info(
                "retrain: window collected (%d rows, %d chunks)",
                self._rows_collected, len(self._chunks),
            )

    # ------------------------------------------------------ retraining state
    def _tick_retraining(self, now: float) -> None:
        with self._lock:
            chunks = list(self._chunks)
            resume = self._resume
            index = self._retrains_started
            ctx = {
                "resume": resume,
                "retrainIndex": index,
                "now": now,
                "features": list(self._trigger_features),
                "fitStats": dict(self._fit_stats),
                "rows": self._rows_collected,
            }
        if resume:
            self.stats.bump("retrainResumes")
        plan = _faults.active()
        try:
            if plan is not None:
                plan.on_retrain_start()
                plan.begin_retrain()
            try:
                version, fn, run_doc = self.trainer(chunks, ctx)
            finally:
                if plan is not None:
                    plan.end_retrain()
        except SimulatedCrash as e:
            # the mid-retrain kill: layer checkpoints survive; stay in
            # retraining and resume from the prefix on the next tick
            self.stats.bump("retrainCrashes")
            with self._lock:
                self._resume = True
            log.warning("retrain %d crashed (%s); will resume", index, e)
            return
        except Exception as e:
            if is_kernel_fault(e):
                raise
            self._fail(
                now, stage="retraining",
                codes=[type(e).__name__], detail=str(e),
            )
            return
        high_water = _memory_high_water(run_doc)
        with self._lock:
            self._resume = False
            self._pending = (version, fn, run_doc)
            self._memory_high_water = max(
                self._memory_high_water, high_water
            )
            self.state = "validating"
        log.info("retrain %d produced %s; validating", index, version)

    # ------------------------------------------------------ validating state
    def _tick_validating(self, now: float) -> None:
        cfg = self.config
        with self._lock:
            pending = self._pending
            baseline = self.baseline_run
            index = self._retrains_started
        if pending is None:  # defensive: nothing to validate
            with self._lock:
                self.state = "idle"
            return
        version, fn, run_doc = pending
        codes: list[str] = []
        if baseline is not None:
            report = diff_runs(
                baseline, run_doc, cfg.tolerances, emit_events=False
            )
            codes = sorted({f.code for f in report.findings})
        if codes:
            # the run-ledger gate: a provably-worse model never reaches
            # the canary, let alone traffic
            self.stats.bump("retrainsGated")
            _tevents.emit(
                "retrain_gated", version=version,
                retrainIndex=index, codes=codes,
            )
            self._fail(
                now, stage="validating", codes=codes,
                detail=f"{version} refused by run-ledger gate",
                counted=False,
            )
            return
        try:
            self.registry.register(version, fn)
            self.registry.start_canary(
                version,
                replicas=cfg.canary_replicas,
                tolerances=cfg.tolerances,
            )
        except RuntimeError as e:
            if is_kernel_fault(e):
                raise
            # another canary is still in flight — re-check next tick
            log.debug("retrain: canary slot busy; retrying next tick")
            return
        with self._lock:
            self._canary_started = now
            self.state = "canarying"
        log.info("retrain %d: %s canarying on %s",
                 index, version, list(cfg.canary_replicas))

    # ------------------------------------------------------- canarying state
    def _tick_canarying(self, now: float) -> None:
        cfg = self.config
        with self._lock:
            pending = self._pending
            started = self._canary_started
            index = self._retrains_started
        if pending is None:
            with self._lock:
                self.state = "idle"
            return
        version, _fn, run_doc = pending
        try:
            report = self.registry.canary_report()
        except RuntimeError as e:
            if is_kernel_fault(e):
                raise
            # the canary vanished under us (external rollback) — treat
            # as a rolled-back attempt
            self._record_rollback(now, version, index, ["canary_vanished"])
            return
        timed_out = (
            started is not None and now - started >= cfg.canary_timeout
        )
        if report["compared"] < cfg.min_canary_served and not timed_out:
            return  # still gathering evidence
        if report["compared"] == 0 and timed_out:
            # no evidence at all: never promote on silence
            try:
                self.registry.rollback(codes=["canary_timeout"])
            except RuntimeError as e:
                if is_kernel_fault(e):
                    raise
            self._record_rollback(now, version, index, ["canary_timeout"])
            return
        decision = self.registry.evaluate_canary()
        if decision["decision"] == "promote":
            self.stats.bump("retrainsPromoted")
            with self._lock:
                self.baseline_run = run_doc  # re-pin the gate baseline
                self._consecutive_failures = 0
                self._pending = None
                self._canary_started = None
                self.state = "idle"
                self.history.append({
                    "retrainIndex": index, "version": version,
                    "outcome": "promoted", "at": now,
                    "compared": decision["compared"],
                })
            _tevents.emit(
                "retrain_promoted", version=version, retrainIndex=index,
                compared=decision["compared"],
                agreement=decision["agreement"],
            )
            log.info("retrain %d: %s promoted fleet-wide", index, version)
        else:
            self._record_rollback(
                now, version, index, list(decision.get("codes", []))
            )

    # -------------------------------------------------------------- failures
    def _record_rollback(
        self, now: float, version: str, index: int, codes: list[str]
    ) -> None:
        self.stats.bump("retrainsRolledBack")
        self._backoff(now)
        with self._lock:
            self._pending = None
            self._canary_started = None
            self.state = "idle"
            self.history.append({
                "retrainIndex": index, "version": version,
                "outcome": "rolled_back", "at": now, "codes": codes,
            })
        _tevents.emit(
            "retrain_rolled_back", version=version,
            retrainIndex=index, codes=codes,
        )
        log.warning(
            "retrain %d: %s rolled back (%s)", index, version, codes
        )

    def _fail(
        self,
        now: float,
        stage: str,
        codes: list[str],
        detail: str = "",
        counted: bool = True,
    ) -> None:
        """A failed attempt (trainer error or gate refusal): back off,
        re-arm to idle. ``counted=False`` skips the generic failure
        counter (gate refusals have their own)."""
        if counted:
            self.stats.bump("retrainFailures")
        self._backoff(now)
        with self._lock:
            index = self._retrains_started
            version = self._pending[0] if self._pending else None
            self._pending = None
            self._resume = False
            self._canary_started = None
            self.state = "idle"
            self.history.append({
                "retrainIndex": index, "version": version,
                "outcome": "gated" if stage == "validating" else "failed",
                "stage": stage, "at": now, "codes": codes,
                "detail": detail,
            })
        if stage != "validating":  # retrain_gated already emitted
            _tevents.emit(
                "retrain_rolled_back", version=version,
                retrainIndex=index, codes=codes, stage=stage,
            )
        log.warning(
            "retrain %d failed in %s: %s %s", index, stage, codes, detail
        )

    def _backoff(self, now: float) -> None:
        cfg = self.config
        with self._lock:
            self._consecutive_failures += 1
            attempt = min(
                self._consecutive_failures, cfg.backoff.max_attempts
            )
            delay = cfg.backoff.delay_for(attempt, self._rng)
            self._not_before = max(self._not_before, now + delay)

    # ---------------------------------------------------------------- ledger
    def ledger(self) -> dict[str, Any]:
        """Counters + machine gauges, the ``retrain`` source payload."""
        out: dict[str, Any] = self.stats.snapshot()
        with self._lock:
            out.update({
                "state": self.state,
                "retrainsStarted": self._retrains_started,
                "consecutiveFailures": self._consecutive_failures,
                "backoffUntil": round(self._not_before, 6),
                "chunksBuffered": len(self._chunks),
                "fitStatsFeatures": len(self._fit_stats),
                "maxChunkRows": self._max_chunk_rows,
                "deviceMemoryHighWater": self._memory_high_water,
            })
            out["rowsCollected"] = self._rows_collected
        return out


def _memory_high_water(run_doc: dict[str, Any]) -> int:
    """The RUN_ document's bounded device-memory high-water (the
    out-of-core evidence the retrain ledger records)."""
    run = (run_doc or {}).get("run") or {}
    mem = run.get("deviceMemory") or {}
    vals = [
        int(v) for v in mem.values()
        if isinstance(v, (int, float)) and not isinstance(v, bool)
    ]
    return max(vals) if vals else 0
