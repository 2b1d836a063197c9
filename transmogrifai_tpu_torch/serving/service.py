"""The standing scoring service — admission, micro-batching, deadlines,
shedding, and graceful degradation over one ``score_function`` closure.

``ScoringService`` is the long-lived path over the hardened closure:
requests enter through a bounded :class:`~.queue.AdmissionQueue`,
assemble into micro-batches on the :class:`~.batcher.MicroBatcher`
(riding the closure's ``FusionPlanner`` buffer — :meth:`start` builds the
CUDA libraries the closure's predictors load, so batch 1 pays no
``nvcc``, and primes fusion), execute under the tightest member's
:class:`~.deadline.DeadlineBudget` (stage-family checkpoints inside
``local/scoring.py`` reject late requests early), and degrade through
the :class:`~.shedding.LoadShedder` tiers when queue depth, in-flight
rows, or open breakers say the service is past capacity.

Every outcome is TYPED and COUNTED — the reconciliation invariant

    admitted == completed + quarantined + shed + errors + outstanding

holds at every instant (pinned by the chaos soak tests), and
``stop(drain=True)`` quiesces cleanly: admissions close, the queue
drains, workers join, no threads leak.

Synchronous mode (``workers=0`` + :meth:`pump`) runs the whole loop on
the caller's thread with an injectable clock — the loadtest harness and
the chaos suite drive overload scenarios without a single real sleep.

The service takes its closure's device and never picks one: on a closure
built with ``device="cpu"`` it runs on the CPU, else on the card.

A kernel fault (``utils.cuda_build.is_kernel_fault``: a kernel that did
not build, load or launch, the card's memory running out, a CUDA error)
is the one batch exception the service does not contain, where the
reference contains every one. It settles the batch's requests, and every
request still queued, with outcome ``error`` carrying the fault (so the
reconciliation invariant still holds), and marks the service failed:
admissions close and :meth:`submit` re-raises the fault itself;
:meth:`pump` re-raises it, and so does :meth:`stop` once it has joined
the workers. ``explain=k`` rides the micro-batcher like any request: the
batch explains at its largest member's k and each member keeps its own
top-k; admission budgets the ``explain`` family's p95 beside the
pipeline's for an explain request with a deadline.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
import weakref
from typing import Any, Callable

from ..analysis import schedule as _schedule
from ..resilience import faults as _faults
from ..telemetry import metrics as _tm
from ..utils import cuda_build as _cuda_build
from . import deadline as _deadline
from .batcher import BatchPlan, MicroBatcher
from .queue import AdmissionQueue, RejectedByAdmission
from .shedding import LoadShedder, ShedConfig

log = logging.getLogger(__name__)

__all__ = ["PendingScore", "ScoreRequest", "ScoringService", "ServiceConfig"]

#: outcome labels a finished request can carry
OUTCOMES = ("completed", "quarantined", "deadline_exceeded", "stopped", "error")

#: weakrefs to live services — the ``service`` exposition source
_LIVE_SERVICES: list = []
_LIVE_LOCK = threading.Lock()


@dataclasses.dataclass
class ServiceConfig:
    """Tuning knobs."""

    max_queue_rows: int = 2048      # admission queue bound
    max_batch_rows: int = 256       # micro-batch assembly cap
    max_wait: float = 0.005         # worker-mode assembly wait (real s)
    workers: int = 1                # 0 = synchronous pump mode
    default_deadline: float | None = None   # per-request budget seconds
    shed: ShedConfig = dataclasses.field(default_factory=ShedConfig)


class PendingScore:
    """Future-like handle for one submitted request."""

    __slots__ = (
        "_event", "results", "error", "outcome",
        "submitted_at", "completed_at",
    )

    def __init__(self, submitted_at: float):
        self._event = threading.Event()
        self.results: list[dict] | None = None
        self.error: BaseException | None = None
        self.outcome: str | None = None
        self.submitted_at = submitted_at
        self.completed_at: float | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> list[dict]:
        """The per-row results; raises the typed rejection on a shed
        request (quarantined requests RETURN — their rows carry default
        predictions, which is the graceful-degradation contract)."""
        if not self._event.wait(timeout):
            raise TimeoutError("request not finished")
        if self.error is not None:
            raise self.error
        return self.results  # type: ignore[return-value]

    def latency(self) -> float | None:
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at


class ScoreRequest:
    __slots__ = (
        "rows", "budget", "handle", "enqueued_at", "explain", "on_settled",
    )

    def __init__(
        self,
        rows: list[dict],
        budget: _deadline.DeadlineBudget | None,
        handle: PendingScore,
        enqueued_at: float,
        explain: int = 0,
        on_settled: Callable[["ScoreRequest"], None] | None = None,
    ):
        self.rows = rows
        self.budget = budget
        self.handle = handle
        self.enqueued_at = enqueued_at
        self.explain = explain
        # fleet seam: called with the settled request AFTER its outcome is
        # stamped and its event set, outside every service lock
        self.on_settled = on_settled


class ScoringService:
    """Long-lived async scoring over one score-function closure."""

    def __init__(
        self,
        score_fn: Callable,
        config: ServiceConfig | None = None,
        clock: Callable[[], float] | None = None,
        replica: Any = None,
    ):
        self.score_fn = score_fn
        self.config = config or ServiceConfig()
        self.clock = clock if clock is not None else time.monotonic
        # fleet identity: replica-keyed faults match against this via the
        # ambient replica_scope the batch loop installs (None = standalone)
        self.replica = replica
        self.queue = AdmissionQueue(self.config.max_queue_rows)
        self.batcher = MicroBatcher(
            self.queue, self.config.max_batch_rows, clock=self.clock
        )
        self.shedder = LoadShedder(
            self.config.shed, capacity=self.config.max_queue_rows
        )
        # the literal is the lock's canonical key (analysis/schedule.py)
        self._lock = _schedule.make_lock(
            "serving/service.py:ScoringService._lock"
        )
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        #: the background build of the closure's CUDA libraries, when
        #: ``start`` did not wait for it (``stop`` joins it)
        self._warmup: threading.Thread | None = None
        self._started = False
        #: the kernel fault that failed the service (None while healthy)
        self._fault: BaseException | None = None
        self._in_flight_rows = 0
        self._in_flight_requests = 0
        # harness hook: called with (real_seconds, simulated_seconds,
        # executed_rows) after each batch execution, BEFORE completions
        # are stamped — the loadtest harness advances its virtual clock
        # here so latencies include service time without any real sleeps
        self.on_batch_cost: Callable[[float, float, int], None] | None = None
        # typed outcome counters (mutations under self._lock)
        self.admitted = 0
        self.completed = 0
        self.quarantined = 0
        self.errors = 0
        self.batches = 0
        self.shed: dict[str, int] = {"deadline_exceeded": 0, "stopped": 0}
        self.rejected: dict[str, int] = {
            "queue_full": 0, "shedding": 0, "stopped": 0, "deadline": 0,
        }
        with _LIVE_LOCK:
            # r is a weakref deref — runs no user code, takes no locks
            _LIVE_SERVICES[:] = [
                r for r in _LIVE_SERVICES if r() is not None
            ]
            _LIVE_SERVICES.append(weakref.ref(self))

    # ------------------------------------------------------------ lifecycle
    @property
    def fault(self) -> BaseException | None:
        """The kernel fault that failed the service, or None."""
        return self._fault

    def start(self, wait_warmup: bool = False, timeout: float = 60.0) -> "ScoringService":
        """Idempotent: builds the CUDA libraries the closure's predictors
        load (``utils/cuda_build.build``, under its lock; nothing on a CPU
        closure) — before returning with ``wait_warmup=True``, else on one
        background thread :meth:`stop` joins — primes the closure's fusion
        planner from fit-static widths, builds the fused scoring graph so
        batch #1 pays no plan construction, and launches the worker
        threads. A failed build raises here with ``wait_warmup=True``;
        in the background it is logged, and the first batch's own load
        of the library raises it as a kernel fault. ``timeout`` is the
        reference's (its wait on the program bank); a build has none."""
        with self._lock:
            if self._started:
                return self
            self._started = True
        libs = getattr(self.score_fn, "kernel_libraries", None)
        libs = list(libs()) if callable(libs) else []
        if libs and wait_warmup:
            _cuda_build.build(libs)
        elif libs:
            self._warmup = threading.Thread(
                target=_build_in_background, args=(libs,), daemon=True,
                name="tptpu-serve-warmup",
            )
            self._warmup.start()
        fusion = getattr(self.score_fn, "fusion", None)
        if fusion is not None:
            try:
                fusion.prime()
            except Exception:  # priming is an optimization, never fatal
                log.debug("fusion prime failed", exc_info=True)
        prime_fused = getattr(self.score_fn, "prime_fused", None)
        if prime_fused is not None:
            try:
                prime_fused()
            except Exception:  # never fatal — the staged loop remains
                log.debug("fused prime failed", exc_info=True)
        for i in range(self.config.workers):
            th = threading.Thread(
                target=self._worker, daemon=True, name=f"tptpu-serve-{i}"
            )
            self._threads.append(th)
            th.start()
        return self

    def stop(
        self,
        drain: bool = True,
        timeout: float = 30.0,
        mode: str = "drain",
    ) -> list[ScoreRequest]:
        """Quiesce: close admissions, drain (or shed) the queue, join
        workers. After stop() the queue is empty, every admitted request
        has a typed outcome, and no service thread is alive. The
        queue-depth / in-flight gauges reset to zero on EVERY exit path
        (including the worker-leak alarm) — a stopped service must not
        freeze its last pre-quiesce value into the Prometheus exposition
        as if rows were still in flight.

        ``mode="reject_new_then_drain"`` is the fleet decommission path: a
        submit racing the stop gets the typed ``RejectedByAdmission
        ("stopped")`` the instant admissions close, queued requests are
        NOT executed here — each is settled ``stopped`` (so this replica's
        own ledger reconciles) and returned for the fleet to adopt onto
        survivors. The default mode returns ``[]``."""
        if mode not in ("drain", "reject_new_then_drain"):
            raise ValueError(f"unknown stop mode {mode!r}")
        orphans: list[ScoreRequest] = []
        try:
            self.queue.close()
            self._stop.set()
            threads = list(self._threads)
            if self._warmup is not None:
                threads.append(self._warmup)
            for th in threads:
                th.join(timeout=timeout)
                if th.is_alive():  # pragma: no cover - the deadlock alarm
                    raise RuntimeError(f"service worker {th.name} leaked")
            self._threads.clear()
            self._warmup = None
            if drain and mode == "drain" and self._fault is None:
                while self.pump():
                    pass
            for req in self.queue.drain():
                self._finish(
                    req, "stopped", error=RejectedByAdmission("stopped")
                )
                if mode == "reject_new_then_drain":
                    orphans.append(req)
            self.shedder.reset()
        finally:
            _tm.REGISTRY.gauge("tptpu_serve_queue_depth").set(0)
            _tm.REGISTRY.gauge("tptpu_serve_in_flight_rows").set(0)
        if self._fault is not None:
            raise self._fault
        return orphans

    def __enter__(self) -> "ScoringService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ admission
    def submit(
        self,
        rows: dict | list[dict],
        deadline: float | None = None,
        explain: int = 0,
        on_settled: Callable[[ScoreRequest], None] | None = None,
    ) -> PendingScore:
        """Admit one request (one row dict, or a small list scored as a
        unit). ``explain=k`` asks for top-k LOCO attributions beside each
        row's scores (carried through micro-batch assembly; under load the
        shedder drops explain work first, so the rows may come back with
        ``attributions: None``). Raises :class:`RejectedByAdmission`
        (queue full / shedding tier / stopped) or
        :class:`~.deadline.DeadlineExceeded` (the budget cannot cover the
        pipeline p95 — including the explain family's p95 for explain
        requests — even before queuing) — admission control rejects
        early, it never blocks. A failed service re-raises its kernel
        fault; a negative ``explain`` raises ``ValueError`` here, before
        queuing."""
        if self._fault is not None:
            raise self._fault
        if isinstance(rows, dict):
            rows = [rows]
        if not rows:
            raise ValueError("empty request")
        explain = int(explain or 0)
        if explain < 0:
            raise ValueError(f"explain must be >= 0, got {explain}")
        now = self.clock()
        if self._stop.is_set() or self.queue.closed:
            self._count_rejected("stopped")
            raise RejectedByAdmission("stopped")
        # backpressure: the tier reflects THIS request's world, not the
        # last batch's (bursts between pumps must start rejecting)
        self._update_shedder()
        if self.shedder.reject_admissions:
            self._count_rejected("shedding")
            raise RejectedByAdmission(
                "shedding", f"load {self.shedder.load:.3f}"
            )
        budget = None
        secs = deadline if deadline is not None else self.config.default_deadline
        if secs is not None:
            budget = _deadline.DeadlineBudget(secs, clock=self.clock, started=now)
            # explain requests must budget for the explain family too —
            # its p95 rides the same serve-latency histograms
            required = _deadline.pipeline_p95()
            if explain:
                required += _deadline.family_p95("explain")
            if not budget.covers(required=required):
                self._count_rejected("deadline")
                _tm.REGISTRY.counter(
                    "tptpu_serve_deadline_exceeded_total"
                ).inc()
                raise _deadline.DeadlineExceeded(
                    "admission", budget.remaining(), required
                )
        handle = PendingScore(submitted_at=now)
        req = ScoreRequest(
            list(rows), budget, handle, enqueued_at=now, explain=explain,
            on_settled=on_settled,
        )
        try:
            # offer + admitted count under ONE critical section: a worker
            # can pop and settle the request the instant offer() publishes
            # it, and the reconciliation invariant (admitted >= settled at
            # every instant) must never observe the settle before the
            # admission. Safe nesting: nothing acquires self._lock while
            # holding the queue lock.
            with self._lock:
                self.queue.offer(req)
                self.admitted += 1
        except RejectedByAdmission as e:
            self._count_rejected(e.reason)
            raise
        _tm.REGISTRY.counter("tptpu_serve_admitted_total").inc()
        return handle

    def _count_rejected(self, reason: str) -> None:
        with self._lock:
            self.rejected[reason] = self.rejected.get(reason, 0) + 1
        _tm.REGISTRY.counter("tptpu_serve_rejected_total").inc()

    # ------------------------------------------------------------ execution
    def pump(self) -> int:
        """Synchronously assemble and execute ONE micro-batch on the
        caller's thread; returns the number of requests it settled (0 when
        the queue was empty). The workerless twin of the service loop —
        the loadtest harness's whole engine. Re-raises the kernel fault of
        a failed service."""
        if self._fault is not None:
            raise self._fault
        plan = self.batcher.next_batch(wait=0.0)
        if plan is None or plan.empty:
            self._update_shedder()
            return 0
        return self._execute(plan)

    def _worker(self) -> None:
        cfg = self.config
        while self._fault is None:
            plan = self.batcher.next_batch(wait=max(cfg.max_wait, 1e-3))
            if plan is not None and not plan.empty:
                try:
                    self._execute(plan)
                except Exception as e:
                    if _cuda_build.is_kernel_fault(e):
                        return  # the service failed; stop() re-raises it
                    log.exception(  # pragma: no cover - belt and braces
                        "service batch execution failed")
            elif self._stop.is_set() and self.queue.depth_requests() == 0:
                return

    def _execute(self, plan: BatchPlan) -> int:
        for req in plan.expired:
            self._finish(
                req, "deadline_exceeded",
                error=_deadline.DeadlineExceeded(
                    "queue", -1.0 if req.budget is None
                    else req.budget.remaining(),
                    _deadline.pipeline_p95(),
                ),
            )
            _tm.REGISTRY.counter("tptpu_serve_deadline_exceeded_total").inc()
        if not plan.requests:
            self._update_shedder()
            return len(plan.expired)
        n_rows = len(plan.rows)
        with self._lock:
            self._in_flight_rows += n_rows
            self._in_flight_requests += len(plan.requests)
            self.batches += 1
        _tm.REGISTRY.gauge("tptpu_serve_in_flight_rows").set(
            self._in_flight_rows
        )
        self._update_shedder()
        # deadline outcomes are PER REQUEST, not per batch: the batch runs
        # under its tightest member's budget, and when that budget trips a
        # stage-family checkpoint mid-execution, only the members whose own
        # budget can no longer cover the pipeline are shed — the rest
        # (including members that never asked for a deadline) re-execute
        # without the tripped member. Each retry sheds at least the
        # tripping member, so the loop is bounded by the member count.
        pending = list(plan.requests)
        while pending:
            rows = [r for req in pending for r in req.rows]
            budget = None
            for req in pending:
                b = req.budget
                if b is not None and (
                    budget is None or b.remaining() < budget.remaining()
                ):
                    budget = b
            # the batch explains at the LARGEST member k (co-batched
            # members share one sweep); each member's slice is trimmed
            # back to its own k below
            explain_k = max((req.explain for req in pending), default=0)
            fault_plan = _faults.active()
            sim0 = (
                fault_plan.simulated_seconds if fault_plan is not None
                else 0.0
            )
            t0 = time.perf_counter()
            out: list[dict] | None = None
            error: BaseException | None = None
            try:
                with _faults.replica_scope(self.replica), \
                        _deadline.active(budget):
                    out = (
                        self.score_fn.batch(rows, explain=explain_k)
                        if explain_k
                        else self.score_fn.batch(rows)
                    )
            except _deadline.DeadlineExceeded as e:
                error = e
            except Exception as e:
                if _cuda_build.is_kernel_fault(e):
                    self._fail(pending, n_rows, len(plan.requests), e)
                    raise
                # contained: one batch, typed outcome
                error = e
                log.warning(
                    "service batch of %d rows failed (%s: %s)",
                    len(rows), type(e).__name__, e,
                )
            real = time.perf_counter() - t0
            sim = (
                fault_plan.simulated_seconds - sim0
                if fault_plan is not None else 0.0
            )
            if self.on_batch_cost is not None:
                self.on_batch_cost(real, sim, len(rows))
            if error is None:
                quarantined_rows = self._quarantined_rows()
                off = 0
                for req in pending:
                    k = len(req.rows)
                    req_out = out[off:off + k]
                    hit = any(
                        i in quarantined_rows for i in range(off, off + k)
                    )
                    off += k
                    if explain_k:
                        _fit_attributions(req_out, req.explain)
                    self._finish(
                        req, "quarantined" if hit else "completed",
                        results=req_out,
                    )
                break
            if not isinstance(error, _deadline.DeadlineExceeded):
                for req in pending:
                    self._finish(req, "error", error=error)
                break
            # shed exactly the members whose own budget is now spent (the
            # tripping tightest budget is always among them); guarantee
            # progress even if covers() flickers back true
            required = _deadline.pipeline_p95()
            spent = [
                req for req in pending
                if req.budget is not None
                and not req.budget.covers(required=required)
            ]
            if not spent:
                spent = [
                    req for req in pending if req.budget is budget
                ] or pending[:1]
            for req in spent:
                self._finish(req, "deadline_exceeded", error=error)
                _tm.REGISTRY.counter(
                    "tptpu_serve_deadline_exceeded_total"
                ).inc()
            pending = [req for req in pending if req.handle.outcome is None]
        with self._lock:
            self._in_flight_rows -= n_rows
            self._in_flight_requests -= len(plan.requests)
        _tm.REGISTRY.gauge("tptpu_serve_in_flight_rows").set(
            self._in_flight_rows
        )
        self._update_shedder()
        return len(plan.requests) + len(plan.expired)

    def _fail(
        self, pending: list[ScoreRequest], n_rows: int, n_requests: int,
        fault: BaseException,
    ) -> None:
        """A kernel fault in a batch: mark the service failed (admissions
        close), settle the batch's unsettled members and every queued
        request ``error`` with the fault, and release the batch's
        in-flight rows. The caller re-raises the fault."""
        with self._lock:
            if self._fault is None:
                self._fault = fault
        log.error(
            "service batch of %d rows met a kernel fault (%s: %s); the "
            "service is failed", n_rows, type(fault).__name__, fault,
        )
        self.queue.close()
        self._stop.set()
        for req in pending:
            if req.handle.outcome is None:
                self._finish(req, "error", error=fault)
        for req in self.queue.drain():
            self._finish(req, "error", error=fault)
        with self._lock:
            self._in_flight_rows -= n_rows
            self._in_flight_requests -= n_requests
        _tm.REGISTRY.gauge("tptpu_serve_in_flight_rows").set(
            self._in_flight_rows
        )
        self._update_shedder()

    def _quarantined_rows(self) -> set[int]:
        """Flat row indices the closure quarantined in the batch it just
        scored (thread-local per-batch view of the QuarantineLog)."""
        qlog = getattr(self.score_fn, "quarantine", None)
        if qlog is None:
            return set()
        try:
            return qlog.batch_rows()
        except Exception:
            return set()

    def _finish(
        self,
        req: ScoreRequest,
        outcome: str,
        results: list[dict] | None = None,
        error: BaseException | None = None,
    ) -> None:
        h = req.handle
        h.results = results
        h.error = error
        h.outcome = outcome
        h.completed_at = self.clock()
        with self._lock:
            if outcome == "completed":
                self.completed += 1
            elif outcome == "quarantined":
                self.quarantined += 1
            elif outcome == "error":
                self.errors += 1
            else:
                self.shed[outcome] = self.shed.get(outcome, 0) + 1
        if outcome == "completed":
            _tm.REGISTRY.counter("tptpu_serve_completed_total").inc()
        elif outcome in ("deadline_exceeded", "stopped"):
            _tm.REGISTRY.counter("tptpu_serve_shed_total").inc()
        h._event.set()
        cb = req.on_settled
        if cb is not None:
            # outside every service lock (the callback may take the fleet
            # lock; lock-order discipline forbids nesting it under ours)
            try:
                cb(req)
            except Exception:  # a broken observer must not kill the loop
                log.exception("on_settled callback failed")

    # -------------------------------------------------------------- signals
    def _breaker_open_fraction(self) -> float:
        breakers = getattr(self.score_fn, "breakers", None)
        if not breakers:
            return 0.0
        states = [br.state for br in list(breakers.values())]
        return states.count("open") / len(states) if states else 0.0

    def _update_shedder(self) -> None:
        self.shedder.update(
            self.queue.depth_rows(),
            self._in_flight_rows,
            self._breaker_open_fraction(),
        )

    # ---------------------------------------------------------------- state
    def stats(self) -> dict[str, Any]:
        """Typed counters + the reconciliation fields. ``outstanding`` is
        admitted-but-unfinished (queued or in flight); at quiesce it is 0
        and ``admitted == completed + quarantined + shed + errors``."""
        with self._lock:
            settled = (
                self.completed + self.quarantined + self.errors
                + sum(self.shed.values())
            )
            return {
                "admitted": self.admitted,
                "completed": self.completed,
                "quarantined": self.quarantined,
                "errors": self.errors,
                "batches": self.batches,
                "shed": dict(self.shed),
                "rejected": dict(self.rejected),
                "outstanding": self.admitted - settled,
                "queueDepthRows": self.queue.depth_rows(),
                "queuePeakRows": self.queue.peak_rows,
                "inFlightRows": self._in_flight_rows,
                "shedding": self.shedder.stats(),
                "batcher": self.batcher.stats(),
            }


def _build_in_background(libs: list[str]) -> None:
    """``start``'s background build of the closure's CUDA libraries."""
    try:
        _cuda_build.build(libs)
    except Exception:  # the first batch's load of the library raises it
        log.exception("background build of %s failed", libs)


def _fit_attributions(rows_out: list[dict], k: int) -> None:
    """Reconcile a member's slice of a shared explain sweep with its OWN
    request: members that never asked lose the key, members that asked
    for fewer than the batch's k keep their |contribution|-largest k
    (row dicts are per-row and slices are disjoint, so mutation is
    safe)."""
    for r in rows_out:
        if k <= 0:
            r.pop("attributions", None)
            continue
        a = r.get("attributions")
        if a and len(a) > k:
            r["attributions"] = dict(
                sorted(a.items(), key=lambda kv: -abs(kv[1]))[:k]
            )


def _service_source() -> dict[str, Any]:
    """Aggregate standing-service counters across live services — the
    ``service`` ledger source of ``telemetry.render_prometheus()``."""
    out = {
        "services": 0, "admitted": 0, "completed": 0, "quarantined": 0,
        "shedTotal": 0, "rejectedTotal": 0, "errors": 0,
        "queueDepthRows": 0, "inFlightRows": 0, "shedTier": 0,
    }
    with _LIVE_LOCK:
        refs = list(_LIVE_SERVICES)
    for ref in refs:
        svc = ref()
        if svc is None:
            continue
        try:
            s = svc.stats()
        except Exception:  # a half-built service must not kill exposition
            continue
        out["services"] += 1
        out["admitted"] += s["admitted"]
        out["completed"] += s["completed"]
        out["quarantined"] += s["quarantined"]
        out["shedTotal"] += sum(s["shed"].values())
        out["rejectedTotal"] += sum(s["rejected"].values())
        out["errors"] += s["errors"]
        out["queueDepthRows"] += s["queueDepthRows"]
        out["inFlightRows"] += s["inFlightRows"]
        out["shedTier"] = max(out["shedTier"], s["shedding"]["tier"])
    return out


_tm.REGISTRY.register_source("service", _service_source)
