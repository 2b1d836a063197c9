"""Per-row local scoring: ``row dict -> result dict``, hardened for serving.

The fitted DAG is walked once, when the closure is built, into a flat stage
plan; each call builds the raw columns from the rows and runs the plan's
columnar transforms over them. Result keys are the result-feature names;
a Prediction result expands to the reference's map keys (``prediction``,
``probability_<j>``, ``rawPrediction_<j>``). ``.batch(rows)`` scores a list
of rows as one columnar batch and ``.columns(dataset)`` a dataset's columns
(``{result name: column}`` back); the predictor runs on the closure's
device.

Serving sentinels (``resilience/sentinel.py``), as the reference's closure
has them: every incoming row passes a **SchemaSentinel** (missing,
wrong-type, non-finite and unparseable values handled per a configurable
policy); rows that fail validation or poison a stage are **quarantined**
(recorded with row index, feature and reason, and answered with the
default prediction), so one bad row never kills a batch. Quarantined rows
are compacted out before the plan runs. Each stage runs behind a per-stage
**circuit breaker** (K consecutive failures open it; the affected result
features degrade to default predictions until a half-open probe
recovers), and a **drift sentinel** compares the live stream's fill rate
and value distribution per raw feature with the training profiles
``Workflow.train()`` stored. Result outputs pass the ``ScoreGuard``
NaN/Inf containment. A stage failure is bisected down to the rows that
poison it. Deadline budgets (``serving/deadline.py``) are checked at the
``sentinel``, ``featurize`` and ``dispatch`` boundaries, and the drift
window yields to the load shedder's drift flag (``serving/shedding.py``).
Every counter surfaces on ``.metadata()``.

A kernel fault (``utils.cuda_build.is_kernel_fault``: a kernel that did
not build, load or launch, the card's memory running out, a CUDA error
surfacing at a sync) is a fault of the program, never of a row or a
stage: it propagates out of ``.batch`` and ``.columns``, quarantines no
row, moves no breaker and counts no fallback. The reference isolates every
exception; the port isolates every exception but these.

A batch whose bucketed row count (``bucket``: powers of two up to 8192,
then multiples of 8192) exceeds ``TPTPU_HOST_PREDICT_MAX`` (default
16384, read per batch) takes the fused scoring graph
(``compiler/fused.py``): its rows padded to the bucket with copies of row
0, one upload of the members' ingest arrays, the whole plan from the
members to the predictor's core on the device, one download of the core's
real rows. It does so only when no fault plan is installed and every
breaker of a stage the program covers is closed: an open breaker must
never be bypassed, and a half-open one needs the staged loop to run its
probe. Every other batch, a batch of a plan that cannot be fused, and
every batch under ``TPTPU_FUSED=0`` take the staged loop over its own
rows. A batch the fused graph refuses at ingest (text over the token cap)
goes staged and is counted (``dispatch_error``), and so is a batch whose
host prefix degraded (``prefix_degraded``); any other error in a fused
dispatch propagates (the reference degrades on any error).

``explain=k`` adds top-k LOCO attributions (``insights/loco.py``) to each
row: staged, one batched sweep over the batch's assembled feature plane
(padded to the bucket with copies of row 0, as the reference pads every
batch); fused, the lanes ride the batch's own run of launches
(``FusedServingProgram.run_explain``: one upload, one download). Explain
work is the load shedder's first casualty (tier 1) and is skipped when a
request's remaining deadline budget cannot cover the ``explain`` family's
p95, or (fused) when the lanes exceed ``TPTPU_EXPLAIN_LANE_BUDGET``; each
skip is counted on the attribution ledger, and every sweep feeds the
attribution drift monitor (``insights/drift.py``, over the model's
``attribution_profiles``). The reference degrades attributions to None on
any explain error; the port does so on every error but a kernel fault,
which propagates like any other.

``metadata()["retrainLedger"]`` is the retrain loop's ledger
(``resilience/retrain.ledger_snapshot``) and ``metadata()["telemetry"]``
the serving snapshot (``telemetry/export.serving_snapshot``). Not ported
yet: the static plan audit (``audit``) and the compile-plane ledger
(A14), the distributed-resilience summary (A13b); their ``metadata()``
keys hold ``None``.
"""
from __future__ import annotations

import logging
import os
import threading
import weakref
from typing import Any, Callable

import numpy as np

from ..featurize import stats as fstats
from ..featurize.engine import FusionPlanner
from ..insights import ledger as _attr_ledger
from ..insights import loco as _loco
from ..insights.drift import AttributionDriftMonitor
from ..models.base import PredictorModel
from ..resilience import faults
from ..resilience.guards import ScoreGuard, ScoreGuardError
from ..resilience.sentinel import (
    BreakerConfig,
    CircuitBreaker,
    DriftConfig,
    DriftSentinel,
    QuarantineLog,
    QuarantineRecord,
    SchemaSentinel,
    SchemaViolationError,
)
from ..serving import deadline as _sdl
from ..serving import shedding as _sshed
from ..stages.base import Estimator
from ..telemetry import events as _tevents
from ..telemetry import metrics as _tm
from ..telemetry import runlog as _runlog
from ..telemetry import spans as _tspans
from ..telemetry.export import serving_snapshot
from ..types import Prediction
from ..types.columns import (
    PredictionColumn,
    column_from_values,
    concat_columns,
    empty_like,
)
from ..utils.cuda_build import is_kernel_fault
from ..utils.device import resolve_device
from ..workflow.workflow import WorkflowModel

log = logging.getLogger(__name__)

#: the reference's scoring bucket cap
BUCKET_CAP = 8192

#: weakrefs to every live score function in the process: the ``serving``
#: source of the metrics registry aggregates their quarantine / guard /
#: drift / breaker counters. The lock brackets the prune+append so
#: concurrent score_function() builds cannot drop one.
_LIVE_SCORE_FNS: list = []
_LIVE_LOCK = threading.Lock()


def _serving_source() -> dict[str, Any]:
    """Aggregate serve-side health counters across live score functions
    (reads instance counters only — never runs the drift report, which
    mutates alert bookkeeping)."""
    out = {
        "scoreFunctions": 0,
        "quarantinedRows": 0,
        "guardedRows": 0,
        "driftAlerts": 0,
        "breakerTrips": 0,
        "breakerShortCircuits": 0,
    }
    with _LIVE_LOCK:
        refs = list(_LIVE_SCORE_FNS)
    for ref in refs:
        fn = ref()
        if fn is None:
            continue
        try:
            quarantined = fn.quarantine.stats()["quarantinedRows"]
            guarded = fn.guard.stats()["guardedRows"]
            drift_alerts = getattr(fn.drift, "alerts_total", 0)
            trips = circuits = 0
            for br in fn.breakers.values():
                circuits += br.short_circuits
                trips += br.transitions.get("closed->open", 0)
                trips += br.transitions.get("half_open->open", 0)
        except Exception:  # a half-built closure must not kill exposition
            continue
        out["scoreFunctions"] += 1
        out["quarantinedRows"] += quarantined
        out["guardedRows"] += guarded
        out["driftAlerts"] += drift_alerts
        out["breakerTrips"] += trips
        out["breakerShortCircuits"] += circuits
    return out


_tm.REGISTRY.register_source("serving", _serving_source)


def _retrain_ledger() -> dict[str, Any]:
    """The retrain loop's ledger (``resilience/retrain.py``)."""
    from ..resilience.retrain import ledger_snapshot

    return ledger_snapshot()


def bucket(n: int) -> int:
    """The smallest power of two >= n up to the cap, else the next multiple
    of the cap."""
    if n >= BUCKET_CAP:
        return -(-n // BUCKET_CAP) * BUCKET_CAP
    b = 1
    while b < n:
        b *= 2
    return b


def _host_predict_max() -> int:
    return int(os.environ.get("TPTPU_HOST_PREDICT_MAX", "16384"))


def score_function(
    model: WorkflowModel,
    guard: ScoreGuard | None = None,
    sentinel: SchemaSentinel | bool | None = None,
    breaker: BreakerConfig | bool | None = None,
    drift: DriftConfig | bool | None = None,
    isolation: str = "degrade",
    quantized: bool | None = None,
    device=None,
) -> Callable[[dict[str, Any]], dict[str, Any]]:
    """The scoring closure for ``model`` on ``device`` (``None`` means
    ``cuda``, which must be present; the model is moved there).

    ``guard`` configures NaN/Inf containment per stage (default: replace
    bad rows with defaults and count them); ``sentinel`` the schema
    validation (default policy coerces what it can and quarantines
    unparseable rows; ``False`` disables); ``breaker`` the per-stage
    circuit breaker config (``False`` disables); ``drift`` the drift
    sentinel config (active when the model carries training profiles;
    ``False`` disables). ``isolation="degrade"`` (the default) contains a
    stage exception to quarantined rows / degraded result features;
    ``"raise"`` propagates it. The installed components are exposed as
    ``.guard`` / ``.sentinel`` / ``.breakers`` / ``.drift`` /
    ``.quarantine`` and their counters via ``.metadata()``.
    ``quantized=True`` builds the fused program over the quantized plane
    (``featurize/quantize.py``); ``None`` defers to ``TPTPU_FUSED_QUANT``."""
    if isolation not in ("degrade", "raise"):
        raise ValueError(f"unknown isolation mode {isolation!r}")
    dev = resolve_device(device)
    model.to(dev)
    plan = model.stage_plan()
    for t in plan:
        if isinstance(t, Estimator):
            # fail at closure-build time, not deep inside the first call
            raise ValueError(f"Stage {t} was never fitted")
    # one fusion planner per closure: after the first batch learns each
    # vectorizer's width (or ``prime_fused`` reads them from the fit),
    # later batches assemble the whole plane into ONE [N, width] buffer
    fusion = FusionPlanner(plan)
    raw_features = list(model.raw_features)
    result_names = [f.name for f in model.result_features]
    result_ftypes = {f.name: f.ftype for f in model.result_features}
    produced = {f.name for f in raw_features}
    produced.update(t.output_name for t in plan)
    missing = [nm for nm in result_names if nm not in produced]
    if missing:
        raise ValueError(
            f"stage plan does not produce result feature(s) {missing}"
        )
    #: predictor-produced outputs: the columns whose render is a
    #: device->host crossing on the transfer census when a staged batch
    #: predicted on the device (24 download bytes per prediction row)
    predictor_outputs = frozenset(
        t.output_name for t in plan if isinstance(t, PredictorModel)
    )
    guard = guard if guard is not None else ScoreGuard()
    result_name_set = set(result_names)

    # ---- serving sentinels (None or True = defaults, False = off)
    if sentinel is None or sentinel is True:
        sentinel = SchemaSentinel(raw_features)
    elif sentinel is False:
        sentinel = None
    if breaker is None or breaker is True:
        breaker = BreakerConfig()
    elif breaker is False:
        breaker = None
    breakers: dict[str, CircuitBreaker] = {}
    profiles = getattr(model, "serving_profiles", None)
    if drift is False:
        profiles, drift = None, None
    drift_sentinel = DriftSentinel(
        profiles, drift if isinstance(drift, DriftConfig) else None
    )
    qlog = QuarantineLog()
    raise_on_stage_error = isolation == "raise"

    # ---- the explain plane: LOCO attributions of ``explain=k`` ride the
    # last fitted predictor's feature plane; the column groups resolve once
    # from the fit-static vector metadata at the first sweep
    explain_model = next(
        (t for t in reversed(plan) if isinstance(t, PredictorModel)), None
    )
    explain_vec = (
        explain_model.input_names[-1] if explain_model is not None else None
    )
    explain_state: dict[str, Any] = {}
    attribution_drift = AttributionDriftMonitor(
        getattr(model, "attribution_profiles", None)
    )

    # ---- the fused scoring graph
    fused_quantized = (
        quantized if quantized is not None
        else os.environ.get("TPTPU_FUSED_QUANT", "0") == "1"
    )
    #: ``reason`` holds the build's obstruction only; the TPTPU_FUSED=0
    #: opt-out is read per batch, so lifting it erases nothing. The lock
    #: brackets build-once and the counters' read-modify-writes: service
    #: workers share ONE closure
    fused_holder: dict[str, Any] = {
        "program": None, "built": False, "reason": None,
    }
    fused_counters: dict[str, Any] = {
        "dispatches": 0, "fallbacks": 0, "lastFallback": None,
        "fallbackReasons": {},
    }
    fused_lock = threading.Lock()

    def fused_reason() -> str | None:
        if os.environ.get("TPTPU_FUSED", "1") == "0":
            return "TPTPU_FUSED=0"
        return fused_holder["reason"]

    def fused_program():
        """The fused program, built once, or None (opted out, or the plan
        cannot be fused: ``fused_reason``)."""
        if os.environ.get("TPTPU_FUSED", "1") == "0":
            return None
        with fused_lock:
            if not fused_holder["built"]:
                from ..compiler import fused

                try:
                    fused_holder["program"] = fused.build_fused_plan(
                        plan, result_names, quantize=fused_quantized,
                        device=dev, fusion=fusion,
                    )
                except fused.Unfuseable as e:
                    fused_holder["reason"] = str(e)
                    log.info("fused scoring graph unavailable: %s", e)
                fused_holder["built"] = True
            return fused_holder["program"]

    def count_unfuseable() -> None:
        why = fused_reason()
        if why is not None and why != "TPTPU_FUSED=0":
            with fused_lock:
                reasons = fused_counters["fallbackReasons"]
                reasons["unfuseable"] = reasons.get("unfuseable", 0) + 1

    def count_dispatch() -> None:
        with fused_lock:
            fused_counters["dispatches"] += 1

    def count_fallback(reason: str, exc: Exception | None = None) -> None:
        with fused_lock:
            fused_counters["fallbacks"] += 1
            fused_counters["lastFallback"] = reason
            reasons = fused_counters["fallbackReasons"]
            reasons[reason] = reasons.get(reason, 0) + 1
        _tevents.emit("fused_fallback", reason=reason)
        log.warning(
            "fused dispatch went to the staged loop (%s%s)", reason,
            "" if exc is None else f": {type(exc).__name__}: {exc}",
        )

    def fused_route(n: int):
        """The fused program a primary batch of ``n`` rows takes, or None:
        no fault plan installed, the bucket above the cutoff, a program
        built, and every breaker of a covered stage closed (an open one
        must never be bypassed, and a recovery-due one needs the staged
        loop to run its half-open probe: the fused path never calls
        allow()/record_success, so dispatching over it would wedge the
        breaker open)."""
        if faults.active() is not None or bucket(n) <= _host_predict_max():
            return None
        prog = fused_program()
        if prog is None:
            if fused_holder["built"]:
                count_unfuseable()
            return None
        if any(
            br.state != "closed"
            for nm, br in list(breakers.items()) if nm in prog.covered
        ):
            return None
        return prog

    def census_downloads(m: int, degraded: list[str], seconds: float) -> None:
        """The staged path's download census: one crossing per rendered
        predictor output of a batch above the host-predict cutoff, 24
        bytes a row (float64 prediction, probability and raw: the
        reference's ``downBytesPerRow``)."""
        if bucket(m) <= _host_predict_max():
            return  # host-predict regime: nothing crossed the boundary
        names = [
            nm for nm in result_names
            if nm in predictor_outputs and nm not in degraded
        ]
        for _ in names:
            _runlog.record_download(24 * m, seconds / len(names))

    def guarded(t, col, num_rows, count=True):
        """Per-stage output: fault-injection hook, then the NaN/Inf guard
        (default scope guards result-feature outputs only, so intermediate
        columns match batch ``WorkflowModel.score`` bit for bit;
        ``num_rows`` keeps padding replicas out of the degradation
        counters; ``count=False`` for isolation re-runs, whose degradation
        the primary run already counted)."""
        fault_plan = faults.active()
        if fault_plan is not None:
            corrupted = fault_plan.on_stage_output(t, col)
            if corrupted is not None:
                col = corrupted
        return guard.apply(
            t, col,
            is_result=t.output_name in result_name_set,
            num_rows=num_rows,
            count=count,
        )

    def explain_gate(m: int, led) -> bool:
        """The shed and deadline gates shared by the staged sweep and the
        fused lanes; False: the attributions degrade for this batch (typed
        and counted; scores are never affected)."""
        # shed tier 1: explain work is the first casualty of overload
        if _sshed.explain_shed():
            led.count_shed(m)
            _tm.REGISTRY.counter("tptpu_serve_explain_shed_total").inc(m)
            return False
        # the explain family's own p95: a request whose remaining budget
        # cannot cover it keeps its scores and drops the explanations
        bgt = _sdl.current()
        if bgt is not None:
            required = _sdl.family_p95("explain")
            remaining = bgt.remaining()
            if remaining <= 0.0 or remaining < required:
                led.count_deadline_skip()
                _tm.REGISTRY.counter(
                    "tptpu_serve_explain_deadline_skips_total").inc()
                _tevents.emit(
                    "explain_deadline_skip",
                    remainingMs=round(remaining * 1e3, 3),
                    requiredMs=round(required * 1e3, 3),
                )
                return False
        return True

    def resolve_groups(meta, width: int):
        """(groups, names), published once and atomically: service workers
        racing the first sweep never see the pair half-built."""
        resolved = explain_state.get("resolved")
        if resolved is None:
            groups = _loco.column_groups(meta, width)
            resolved = explain_state["resolved"] = (
                groups, [name for name, _ in groups])
        return resolved

    def explain_degraded(e: Exception, what: str) -> None:
        """An explain error that is not a kernel fault: counted, and the
        batch's attributions degrade to None (its scores stand)."""
        _attr_ledger.stats().count_error()
        _tm.REGISTRY.counter("tptpu_serve_explain_errors_total").inc()
        log.warning(
            "%s failed (%s: %s): scores kept, attributions degraded to None",
            what, type(e).__name__, e,
        )

    def finish_explain(names, diffs, m: int, k: int, lanes: int,
                       deduped: int, padded: int, seconds: float, ts: float,
                       fam) -> list[dict[str, float]]:
        """The sweep's tail shared by both routes: top-k maps, the ledger,
        the drift monitor and the explain family's latency."""
        maps, hits = _loco.top_k_maps(diffs, names, k)
        led = _attr_ledger.stats()
        led.record_explain(m, seconds, lanes=lanes, deduped=deduped,
                           padded=padded)
        led.record_groups(names, diffs, hits)
        _tm.REGISTRY.counter("tptpu_serve_explain_rows_total").inc(m)
        # the drift window yields to the drift shed tier
        if attribution_drift.enabled and not _sshed.drift_shed():
            attribution_drift.observe(names, diffs)
        if fam is not None:
            fam["explain"] = fam.get("explain", 0.0) + seconds
            _tspans.record_span("serve/explain", ts, seconds, rows=m,
                                lanes=len(names))
        return maps

    def run_explain(cols: dict[str, Any], m: int, k: int, dead: set,
                    fam) -> list[dict[str, float]] | None:
        """The staged sweep over the batch's assembled feature plane: top-k
        maps for the ``m`` rows, or None where explain degraded (shed,
        deadline, a dead plane or prediction, or an error that is not a
        kernel fault)."""
        if explain_model is None:
            raise ValueError(
                "explain=k requires a fitted predictor stage in the "
                "scoring plan"
            )
        if (explain_model.output_name in dead or explain_vec in dead
                or explain_vec not in cols):
            return None
        if not explain_gate(m, _attr_ledger.stats()):
            return None
        try:
            ts = _tspans.clock()
            vec = cols[explain_vec]
            x = np.asarray(vec.values, dtype=np.float32)[:m]
            groups, names = resolve_groups(
                getattr(vec, "metadata", None), x.shape[1])
            pcol = cols[explain_model.output_name]
            prob = getattr(pcol, "probability", None)
            base_prob = None if prob is None else np.asarray(prob)[:m]
            base_pred = (np.asarray(pcol.prediction)[:m]
                         if base_prob is None else None)
            # the reference sweeps the batch padded to its bucket with
            # copies of row 0: the lanes' row count picks the device
            # route's summation order, so the port pads the same way
            b = bucket(m)
            if b > m:
                pad = np.zeros(b - m, dtype=np.int64)
                x = np.concatenate([x, x[pad]])
                if base_prob is not None:
                    base_prob = np.concatenate([base_prob, base_prob[pad]])
                else:
                    base_pred = np.concatenate([base_pred, base_pred[pad]])
            diffs, info = _loco.explain_batch(
                explain_model, x, groups,
                base_prob=base_prob, base_pred=base_pred,
            )
            return finish_explain(
                names, diffs[:m], m, k, info["lanes"], info["deduped"],
                info["padded"], _tspans.clock() - ts, ts, fam)
        except Exception as e:
            if is_kernel_fault(e):
                raise
            explain_degraded(e, "explain sweep")
            return None

    def fused_explain_request(prog, b: int, n: int) -> dict | None:
        """The lane masks of a fused ``explain=k`` batch, or None where the
        shared gates or the lane budget (the fused sweep is one run over
        ``(lanes + 1) x b x width``) skip the attributions."""
        led = _attr_ledger.stats()
        if not explain_gate(n, led):
            return None
        groups, names = resolve_groups(prog.predictor_input_meta, prog.width)
        from ..compiler.bucketing import lane_bucket

        kb = lane_bucket(len(groups))
        if (kb + 1) * b * max(1, prog.width) > _loco._lane_budget():
            led.count_budget_skip()
            _tevents.emit("explain_budget_skip", lanes=kb, rows=b,
                          width=prog.width)
            return None
        return {
            "masks": _loco.group_masks(groups, prog.width, lanes=kb),
            "groups": groups, "names": names,
            "kb": kb, "pad": kb - len(groups),
        }

    def finish_fused_explain(runinfo: dict, m: int, k: int,
                             fam) -> list[dict[str, float]] | None:
        """The tail of a sweep whose lanes rode the fused run."""
        state = runinfo.get("fused_lane_state")
        if state is None:
            return None
        try:
            ts = _tspans.clock()
            lane_pred, lane_prob, _ = runinfo["prog"].epilogue(
                runinfo["lane_core"])
            base, base_class = _loco.base_from_arrays(
                runinfo["prob"], runinfo["pred"])
            scores = _loco.scores_from_outputs(
                lane_pred, lane_prob, base_class, state["kb"], m)
            diffs = np.ascontiguousarray(
                (base[None, :] - scores).T[:, : len(state["groups"])])
            return finish_explain(
                state["names"], diffs, m, k, state["kb"], 0, state["pad"],
                _tspans.clock() - ts, ts, fam)
        except Exception as e:
            if is_kernel_fault(e):
                raise
            explain_degraded(e, "fused explain lanes")
            return None

    def dispatch_fused(prog, cols, b: int, n: int, fam_seconds,
                       explain_k: int = 0, runinfo: dict | None = None) -> None:
        """The fused segment: ingest codecs up, the predictor's core (and,
        for ``explain_k``, every LOCO lane's core) down, the host epilogue
        shared with the staged path, the guard over the ``n`` real rows."""
        lane_state = (fused_explain_request(prog, b, n)
                      if explain_k else None)
        ts = _tspans.clock()
        if lane_state is None:
            core, info = prog.run(cols, b, n)
        else:
            core, lane_core, info = prog.run_explain(
                cols, b, n, lane_state["masks"])
        pred, prob, raw = prog.epilogue(core)
        pcol = PredictionColumn(
            Prediction,
            np.asarray(pred, dtype=np.float64),
            None if prob is None else np.asarray(prob, dtype=np.float64),
            None if raw is None else np.asarray(raw, dtype=np.float64),
        )
        cols[prog.predictor.output_name] = guarded(prog.predictor, pcol, n)
        count_dispatch()
        if lane_state is not None and runinfo is not None:
            runinfo.update(fused_lane_state=lane_state, lane_core=lane_core,
                           prog=prog, pred=pred, prob=prob)
        if fam_seconds is not None:
            dur = _tspans.clock() - ts
            fam_seconds["dispatch"] = fam_seconds.get("dispatch", 0.0) + dur
            if _tspans.stage_detail(n):
                _tspans.record_span(
                    "serve/fused", ts, dur, rows=n, uploads=info["uploads"]
                )

    def run_plan(
        cols: dict[str, Any],
        prog,
        b: int,
        n: int,
        row_indices: tuple[int, ...] | None,
        breaker_mode: str = "active",
        skip: frozenset = frozenset(),
        fam_seconds: dict[str, float] | None = None,
        runinfo: dict | None = None,
        explain_k: int = 0,
    ) -> tuple[set, list, dict]:
        """The stage plan over raw columns of ``b`` rows (``n`` real; the
        fused route pads, the staged loop runs its own rows), with
        per-stage fault isolation. Returns ``(dead, failures, cause)``:
        ``dead`` holds output names not produced (failed, short-circuited
        by an open breaker, or downstream of either), ``failures`` the
        ``(stage, exception)`` pairs from this run, and ``cause`` maps each
        dead name to ``"failure"`` or ``"short_circuit"`` (short-circuit
        wins on mixed ancestry so recovery re-runs never bypass an open
        breaker). ``breaker_mode="active"`` gates and records;
        ``"observe"`` (the isolation re-runs) touches no breaker — it skips
        the stages in ``skip``, the snapshot of breakers already open
        BEFORE the primary run. ``prog`` (from ``fused_route``) runs the
        host prefix staged and the rest as one fused dispatch."""
        fp = faults.active()
        dead: set[str] = set()
        failures: list[tuple[Any, Exception]] = []
        cause: dict[str, str] = {}
        with fusion.batch(b):
            if prog is None:
                plan_loop(cols, b, n, row_indices, breaker_mode, skip,
                          dead, failures, cause, fp, fam_seconds)
                return dead, failures, cause
            from ..compiler.fused import Unfuseable

            plan_loop(cols, b, n, row_indices, breaker_mode, skip,
                      dead, failures, cause, fp, fam_seconds,
                      stages=prog.prefix)
            if not dead and not failures:
                # the deadline gate of the predictor boundary, OUTSIDE the
                # fallback try: a DeadlineExceeded propagates typed
                _sdl.checkpoint("dispatch")
                try:
                    dispatch_fused(prog, cols, b, n, fam_seconds, explain_k,
                                   runinfo)
                except Unfuseable as e:  # the text cap: the batch's own
                    count_fallback("dispatch_error", e)
                else:
                    if runinfo is not None:
                        runinfo["fused"] = True
                    return dead, failures, cause
            else:
                count_fallback("prefix_degraded")
            # the counted fall-back: the fused segment's stages staged
            plan_loop(cols, b, n, row_indices, breaker_mode, skip,
                      dead, failures, cause, fp, fam_seconds,
                      stages=prog.fused_stages)
        return dead, failures, cause

    def plan_loop(
        cols, b, n, row_indices, breaker_mode, skip,
        dead, failures, cause, fp, fam_seconds=None, stages=None,
    ) -> None:
        """The stage loop of ``run_plan``. ``fam_seconds`` (primary runs
        only) accumulates per-stage-family seconds — ``featurize`` for
        host transform stages, ``dispatch`` for fitted predictors —
        feeding the serve-latency histograms; per-stage detail spans
        engage above the TPTPU_TRACE_STAGE_ROWS floor. ``stages``
        restricts the walk to a sub-plan (the fused path's host prefix,
        or its staged continuation after a fallback)."""
        detail = fam_seconds is not None and _tspans.stage_detail(n)
        for t in (plan if stages is None else stages):
            if any(nm in dead for nm in t.input_names):
                dead.add(t.output_name)
                up = {cause.get(nm) for nm in t.input_names if nm in dead}
                cause[t.output_name] = (
                    "short_circuit" if "short_circuit" in up else "failure"
                )
                continue
            # deadline gate at the dispatch family boundary, before the
            # breaker's allow(): a half-open probe claimed by allow() and
            # then abandoned by a raise would wedge the breaker
            if isinstance(t, PredictorModel):
                _sdl.checkpoint("dispatch")
            br = None
            if breaker is not None:
                if breaker_mode == "active":
                    br = breakers.get(t.output_name)
                    if br is None:
                        # setdefault: two workers racing the first run of a
                        # stage must share ONE breaker
                        br = breakers.setdefault(
                            t.output_name,
                            CircuitBreaker(t.output_name, breaker),
                        )
                    if not br.allow():
                        dead.add(t.output_name)
                        cause[t.output_name] = "short_circuit"
                        continue
                elif t.output_name in skip:
                    dead.add(t.output_name)
                    cause[t.output_name] = "short_circuit"
                    continue
            try:
                if fp is not None:
                    fp.on_stage_transform(t, row_indices)
                t0 = breaker.clock() if br is not None else 0.0
                ts = _tspans.clock() if fam_seconds is not None else 0.0
                col = t.transform_columns(
                    *[cols[nm] for nm in t.input_names], num_rows=b
                )
                # slow-stage chaos: simulated extra seconds ride the
                # breaker-deadline elapsed time, the stage-family latency
                # and the active request budget — no real sleep anywhere
                extra = fp.on_stage_duration(t) if fp is not None else 0.0
                if extra:
                    _sdl.consume(extra)
                elapsed = (
                    breaker.clock() - t0 + extra if br is not None else 0.0
                )
                if fam_seconds is not None:
                    tdur = _tspans.clock() - ts + extra
                    fam = (
                        "dispatch" if isinstance(t, PredictorModel)
                        else "featurize"
                    )
                    fam_seconds[fam] = fam_seconds.get(fam, 0.0) + tdur
                    if detail:
                        _tspans.record_span(
                            f"serve/stage/{type(t).__name__}", ts, tdur,
                            rows=n,
                        )
                cols[t.output_name] = guarded(
                    t, col, n, count=breaker_mode == "active"
                )
            except (ScoreGuardError, SchemaViolationError):
                # explicit escalations propagate — releasing a claimed
                # half-open probe on the way out
                if br is not None:
                    br.release_probe()
                raise
            except Exception as e:
                if is_kernel_fault(e):
                    # a fault of the kernels or the card, never of the
                    # stage: the breaker records nothing, no row is
                    # quarantined, nothing degrades
                    if br is not None:
                        br.release_probe()
                    raise
                if br is not None:
                    br.record_failure()
                if raise_on_stage_error:
                    raise  # isolation="raise": fail-fast, breaker recorded
                dead.add(t.output_name)
                cause[t.output_name] = "failure"
                failures.append((t, e))
                log.warning(
                    "stage %s failed at score time (%s: %s)",
                    t.output_name, type(e).__name__, e,
                )
                continue
            if br is not None:
                if breaker.deadline is not None and elapsed > breaker.deadline:
                    br.record_failure(overrun=True)
                else:
                    br.record_success()

    def raw_columns(rows: list[dict[str, Any]], b: int) -> dict[str, Any]:
        """Raw columns of the (validated) rows, padded to ``b`` with copies
        of row 0 (valid for every column type, RealNN included; padded
        outputs are sliced off)."""
        cols = {}
        for f in raw_features:
            vals = [row.get(f.name) for row in rows]
            if f.is_response and all(v is None for v in vals):
                vals = [0] * len(rows)  # score-time null labels
            vals += [vals[0]] * (b - len(rows))
            cols[f.name] = column_from_values(f.ftype, vals)
        return cols

    # ---- default predictions: the all-missing row scored once, plainly
    # (no fault hooks, guards counting, or breakers — defaults must stay
    # deterministic even under an installed FaultPlan)
    neutral: dict[str, Any] = {}
    neutral_lock = threading.Lock()

    def neutral_columns() -> dict[str, Any]:
        with neutral_lock:
            return neutral_columns_locked()

    def neutral_columns_locked() -> dict[str, Any]:
        if "cols" not in neutral:
            cols = {
                f.name: column_from_values(
                    f.ftype, [0] if f.is_response else [None]
                )
                for f in raw_features
            }
            dead: set[str] = set()
            for t in plan:
                if any(nm in dead for nm in t.input_names):
                    dead.add(t.output_name)
                    continue
                try:
                    col = t.transform_columns(
                        *[cols[nm] for nm in t.input_names], num_rows=1
                    )
                    # the default prediction honors the guard too: a NaN
                    # neutral score would otherwise fan out to every
                    # quarantined row unsanitized
                    cols[t.output_name] = guard.apply(
                        t, col,
                        is_result=t.output_name in result_name_set,
                        num_rows=1, count=False,
                    )
                except Exception as e:
                    if is_kernel_fault(e):
                        raise
                    dead.add(t.output_name)
            neutral["cols"] = {
                name: None if name in dead or name not in cols else cols[name]
                for name in result_names
            }
        return neutral["cols"]

    def default_value(name: str) -> Any:
        with neutral_lock:
            vals = neutral.get("values")
            if vals is None:
                vals = neutral["values"] = {
                    nm: None if col is None else col.to_list()[0]
                    for nm, col in neutral_columns_locked().items()
                }
        v = vals[name]
        # rows must not alias one shared mutable default (Prediction maps)
        if isinstance(v, dict):
            return dict(v)
        if isinstance(v, list):
            return list(v)
        return v

    def default_column(name: str, n: int) -> Any:
        col = neutral_columns()[name]
        if col is not None:
            return col.take(np.zeros(n, dtype=np.int64))
        return empty_like(result_ftypes[name], n)

    def prepare_rows(
        rows: list[dict[str, Any]],
    ) -> tuple[list[dict[str, Any] | None], dict[int, list]]:
        """Fault hook, then schema validation, per row. Returns the
        sanitized rows (None = quarantined) and the quarantine reasons by
        row index."""
        fp = faults.active()
        if fp is not None:
            rows = list(rows)
            for i, row in enumerate(rows):
                corrupted = fp.on_score_row(row, i)
                if corrupted is not None:
                    rows[i] = corrupted
        prepared: list[dict[str, Any] | None] = []
        invalid: dict[int, list] = {}
        if sentinel is None:
            return list(rows), invalid
        for i, (clean, reasons) in enumerate(sentinel.check_rows(rows)):
            if reasons:
                invalid[i] = reasons
                prepared.append(None)
            else:
                prepared.append(clean)
        return prepared, invalid

    def pre_open_snapshot() -> frozenset:
        """Output names whose breaker is short-circuiting RIGHT NOW — taken
        before a primary run so the isolation pass honors pre-existing
        open breakers without being blinded by ones the failure under
        isolation just opened."""
        return frozenset(
            nm for nm, br in list(breakers.items())
            if br.would_short_circuit()
        )

    def bisect_rows(
        indices, build_cols, on_ok, on_poisoned, skip, budget=None
    ) -> None:
        """Binary-search the poisoning rows after a batch-level stage
        failure: the plan on half-batches, splitting only the failing
        halves, down to single rows. Subsets are visited left to right, so
        callbacks fire in row order. Breakers are never touched; stages in
        ``skip`` stay skipped. The re-run ``budget`` bounds the blowup when
        a stage fails for every row: once spent, the remaining failing
        subsets are quarantined wholesale."""
        if budget is None:
            budget = {"left": 16 + 4 * max(1, len(indices)).bit_length()}
        m = len(indices)
        cols2 = build_cols(indices)
        budget["left"] -= 1
        _, fails2, _ = run_plan(
            cols2, None, m, m, tuple(indices), breaker_mode="observe",
            skip=skip,
        )
        if not fails2:
            on_ok(indices, cols2, m)
            return
        t, e = fails2[0]
        if m == 1:
            on_poisoned(indices[0], t, e)
            return
        if budget["left"] <= 0:
            log.warning(
                "isolation budget exhausted: quarantining %d rows "
                "wholesale after persistent failure of '%s'",
                m, t.output_name,
            )
            for i in indices:
                on_poisoned(i, t, e)
            return
        mid = m // 2
        bisect_rows(indices[:mid], build_cols, on_ok, on_poisoned, skip,
                    budget)
        bisect_rows(indices[mid:], build_cols, on_ok, on_poisoned, skip,
                    budget)

    def check_explain(explain) -> int:
        explain = int(explain or 0)
        if explain < 0:
            raise ValueError(f"explain must be >= 0, got {explain}")
        return explain

    def attributions(runinfo: dict, cols, m: int, k: int, dead: set,
                     fam) -> list[dict[str, float]] | None:
        """The batch's top-k maps, after its scores are rendered: a fused
        batch finishes the lanes its run carried, a staged one sweeps its
        assembled plane."""
        if runinfo.get("fused"):
            return finish_fused_explain(runinfo, m, k, fam)
        return run_explain(cols, m, k, dead, fam)

    def result_column(cols: dict[str, Any], name: str, n: int):
        col = cols[name]
        return col if len(col) == n else col.take(np.arange(n))

    def score_batch(
        rows: list[dict[str, Any]], explain: int = 0
    ) -> list[dict[str, Any]]:
        n = len(rows)
        explain = check_explain(explain)
        if n == 0:
            return []
        tel = _tspans.enabled()
        started = _tspans.clock() if tel else 0.0
        fam: dict[str, float] = {}
        qlog.start_batch()
        _sdl.checkpoint("sentinel")
        prepared, invalid = prepare_rows(rows)
        if tel:
            fam["sentinel"] = _tspans.clock() - started
        _sdl.checkpoint("featurize")
        # quarantined rows are COMPACTED OUT before the plan runs: a bad
        # row never reaches a stage, so only survivors score
        survivors = [i for i in range(n) if i not in invalid]
        out: list[dict[str, Any]] = [{} for _ in range(n)]
        m = len(survivors)
        degraded: list[str] = []
        poisoned: dict[int, tuple[str, Exception]] = {}
        attr_maps: list[dict[str, float]] | None = None
        if m:
            prog = fused_route(m)
            b = bucket(m) if prog is not None else m
            tc = _tspans.clock() if tel else 0.0
            cols = raw_columns([prepared[i] for i in survivors], b)
            if drift_sentinel.enabled and not _sshed.drift_shed():
                # observed post codec (typed, coerced values); skipped
                # while the load shedder holds the drift flag
                drift_sentinel.observe_columns(cols, m)
            if tel:
                fam["featurize"] = _tspans.clock() - tc
            pre_open = pre_open_snapshot()
            runinfo: dict[str, Any] = {}
            dead, failures, cause = run_plan(
                cols, prog, b, m, tuple(survivors),
                fam_seconds=fam if tel else None, runinfo=runinfo,
                explain_k=explain,
            )
            degraded = [nm for nm in result_names if nm in dead]
            td = _tspans.clock() if tel else 0.0
            for name in result_names:
                if name in degraded:
                    continue
                rendered = result_column(cols, name, m).to_list()
                for j, i in enumerate(survivors):
                    out[i][name] = rendered[j]
            if tel:
                fam["download"] = _tspans.clock() - td
            if not runinfo.get("fused"):
                census_downloads(m, degraded, fam.get("download", 0.0))
            if explain:
                # attributions ride the batch after its scores render: the
                # sweep reuses the assembled plane and the batch's own
                # prediction as the base
                attr_maps = attributions(runinfo, cols, m, explain, dead,
                                         fam if tel else None)
            # per-row isolation: a fresh stage failure bisects the
            # survivors so only the poisoning row(s) are quarantined;
            # results dead from an OPEN breaker are not recovered
            fail_names = [
                nm for nm in degraded if cause.get(nm) == "failure"
            ]
            if failures and fail_names:
                if m == 1:
                    # the batch WAS the row: a transiently-injected fault
                    # counts exactly once
                    t, e = failures[0]
                    poisoned[survivors[0]] = (t.output_name, e)
                else:
                    def build(idxs):
                        return raw_columns([prepared[i] for i in idxs],
                                           len(idxs))

                    def ok(idxs, cols2, mm):
                        for nm in fail_names:
                            if nm not in cols2:
                                continue  # downstream of an open breaker
                            rendered = cols2[nm].to_list()
                            for j, i in enumerate(idxs):
                                out[i][nm] = rendered[j]

                    def poison(i, t, e):
                        poisoned[i] = (t.output_name, e)

                    bisect_rows(survivors, build, ok, poison, pre_open)
        # whatever is still missing degrades to the default prediction
        for nm in degraded:
            for i in survivors:
                if nm not in out[i]:
                    out[i][nm] = default_value(nm)
        for i, reasons in invalid.items():
            for feat, kind, reason in reasons:
                qlog.add(QuarantineRecord(i, feat, kind, reason))
            for nm in result_names:
                out[i][nm] = default_value(nm)
        for i, (stage_name, e) in poisoned.items():
            qlog.add(QuarantineRecord(
                i, stage_name, "stage", f"{type(e).__name__}: {e}"
            ))
            for nm in result_names:
                out[i][nm] = default_value(nm)
        if explain:
            # every row answers the explain request: its top-k map, or None
            # for a quarantined or poisoned row and for a batch whose
            # explain work was shed or skipped
            for j, i in enumerate(survivors):
                out[i]["attributions"] = (
                    None if attr_maps is None or i in poisoned
                    else attr_maps[j])
            for i in invalid:
                out[i]["attributions"] = None
        if tel:
            _tspans.record_serve_batch("batch", n, started, fam)
        return out

    def score_columns(dataset, explain: int = 0) -> dict[str, Any]:
        """Columnar scoring: a dataset in, ``{result name: column}`` out,
        with no row-dict codec either way — and with it no row-dict
        schema validation (typed columns carry no wrong-typed values; the
        drift sentinel, breakers and stage isolation still apply). Raw
        features absent from the dataset score as all-null (an absent or
        all-null response as the null label 0). A stage failure isolates
        per row: poisoning rows get default values in the AFFECTED result
        columns only (the row-dict path quarantines the whole row)."""
        n = len(dataset)
        explain = check_explain(explain)
        if n == 0:
            return {}
        tel = _tspans.enabled()
        started = _tspans.clock() if tel else 0.0
        fam: dict[str, float] = {}
        qlog.start_batch()
        prog = fused_route(n)
        b = bucket(n) if prog is not None else n
        pad = (np.concatenate([np.arange(n), np.zeros(b - n, np.int64)])
               if b > n else None)
        cols: dict[str, Any] = {}
        for f in raw_features:
            c = dataset[f.name] if f.name in dataset else None
            if c is None or (f.is_response and _all_null(c)):
                fill = 0 if f.is_response else None
                cols[f.name] = column_from_values(f.ftype, [fill] * b)
            else:
                cols[f.name] = c if pad is None else c.take(pad)
        if drift_sentinel.enabled and not _sshed.drift_shed():
            drift_sentinel.observe_columns(cols, n)
        if tel:
            fam["featurize"] = _tspans.clock() - started
        pre_open = pre_open_snapshot()
        runinfo: dict[str, Any] = {}
        dead, failures, cause = run_plan(
            cols, prog, b, n, tuple(range(n)),
            fam_seconds=fam if tel else None, runinfo=runinfo,
            explain_k=explain,
        )
        td = _tspans.clock() if tel else 0.0
        degraded = [nm for nm in result_names if nm in dead]
        out = {
            name: result_column(cols, name, n)
            for name in result_names if name not in degraded
        }
        if tel:
            fam["download"] = _tspans.clock() - td
        if not runinfo.get("fused"):
            census_downloads(n, degraded, fam.get("download", 0.0))
        attr_maps = (attributions(runinfo, cols, n, explain, dead,
                                  fam if tel else None)
                     if explain else None)
        fail_names = [nm for nm in degraded if cause.get(nm) == "failure"]
        if failures and fail_names and n > 1:
            segments: dict[str, list] = {nm: [] for nm in fail_names}

            def build(idxs):
                arr = np.asarray(idxs, dtype=np.int64)
                return {f.name: cols[f.name].take(arr) for f in raw_features}

            def ok(idxs, cols2, m):
                for nm in fail_names:
                    if nm not in cols2:  # downstream of an open breaker
                        segments[nm].append(default_column(nm, m))
                        continue
                    segments[nm].append(result_column(cols2, nm, m))

            def poison(i, t, e):
                qlog.add(QuarantineRecord(
                    i, t.output_name, "stage", f"{type(e).__name__}: {e}"
                ))
                for nm in fail_names:
                    segments[nm].append(default_column(nm, 1))

            # callbacks fire in index order, so the segments concatenate
            # back into the original row order
            bisect_rows(list(range(n)), build, ok, poison, pre_open)
            for nm in fail_names:
                try:
                    out[nm] = concat_columns(segments[nm])
                except Exception:  # mixed shapes: degrade the whole column
                    out[nm] = default_column(nm, n)
        elif failures and fail_names:  # n == 1
            t, e = failures[0]
            qlog.add(QuarantineRecord(
                0, t.output_name, "stage", f"{type(e).__name__}: {e}"
            ))
        for nm in degraded:
            if nm not in out:
                out[nm] = default_column(nm, n)
        if explain:
            out["attributions"] = attr_maps
        if tel:
            _tspans.record_serve_batch("columns", n, started, fam)
        return out

    def score_one(row: dict[str, Any], explain: int = 0) -> dict[str, Any]:
        # single-row scoring IS batch scoring: one shared quarantine /
        # guard / breaker / drift path
        return score_batch([row], explain=explain)[0]

    def kernel_libraries() -> list[str]:
        """The CUDA libraries the plan's predictors load on this closure's
        device (none on the CPU): what a serving service builds at start
        so its first batch pays no ``nvcc``."""
        if dev.type != "cuda":
            return []
        return sorted({lib for t in plan if isinstance(t, PredictorModel)
                       for lib in t.kernel_libraries})

    def prime_fused() -> bool:
        """Learn the fusion planner's widths from the fit and build the
        fused program now rather than at the first eligible batch; whether
        one is available."""
        fusion.prime()
        return fused_program() is not None

    def metadata() -> dict[str, Any]:
        """Score-path health under the reference's keys: the fused graph's
        state and counters (with ``hostPrefixStages``, the program's host
        prefix, or ``None`` without a program), the featurize plane's
        process-wide ledger, and the guard, sentinel, quarantine, breaker
        and drift counters. Keys of planes not ported yet hold ``None``."""
        # the slow, lock-free parts first (the drift report walks every
        # feature's histogram and may emit events)
        drift_report = drift_sentinel.report()
        attribution_drift_report = attribution_drift.report()
        breaker_stats = {nm: br.stats() for nm, br in list(breakers.items())}
        with fused_lock:
            prog = fused_holder["program"]
            snap = dict(fused_counters)
            snap["fallbackReasons"] = dict(fused_counters["fallbackReasons"])
        return {
            "analysis": None,
            "fused": {
                "active": prog is not None,
                "reason": fused_reason(),
                "fingerprint": None if prog is None else prog.fingerprint,
                "quantized": prog is not None and prog.quantized,
                "hostPrefixStages": None if prog is None
                else [t.output_name for t in prog.prefix],
                **snap,
            },
            "compileStats": None,
            "featurizeStats": fstats.snapshot(),
            "scoreGuard": guard.stats(),
            "sentinel": None if sentinel is None else sentinel.stats(),
            "quarantine": qlog.stats(),
            "breakers": breaker_stats,
            "drift": drift_report,
            "attributions": {
                "available": explain_model is not None,
                "groups": (None if explain_state.get("resolved") is None
                           else explain_state["resolved"][1]),
                "ledger": _attr_ledger.snapshot(),
                "drift": attribution_drift_report,
            },
            "distributed": None,
            "retrainLedger": _retrain_ledger(),
            "telemetry": serving_snapshot(),
        }

    score_one.batch = score_batch
    score_one.columns = score_columns
    score_one.prime_fused = prime_fused
    score_one.kernel_libraries = kernel_libraries
    score_one.metadata = metadata
    score_one.fused_state = fused_holder
    score_one.fusion = fusion
    score_one.guard = guard
    score_one.sentinel = sentinel
    score_one.breakers = breakers
    score_one.drift = drift_sentinel
    score_one.attribution_drift = attribution_drift
    score_one.quarantine = qlog
    # the model keeps weak references to its live score functions so
    # summary_pretty() reports serve-side resilience counters
    monitors = getattr(model, "_serving_monitors", None)
    if monitors is None:
        monitors = model._serving_monitors = []
    monitors[:] = [r for r in monitors if r() is not None]
    monitors.append(weakref.ref(score_one))
    with _LIVE_LOCK:
        _LIVE_SCORE_FNS[:] = [r for r in _LIVE_SCORE_FNS if r() is not None]
        _LIVE_SCORE_FNS.append(weakref.ref(score_one))
    return score_one


def _all_null(col) -> bool:
    """Whether every row of the column is missing."""
    mask = getattr(col, "mask", None)
    if mask is not None:
        return not np.asarray(mask, dtype=bool).any()
    return all(v is None for v in col.to_list())
