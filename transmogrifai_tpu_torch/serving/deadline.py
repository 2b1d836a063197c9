"""Per-request deadline budgets, propagated through the scoring pipeline.

A standing service cannot afford to *execute* a request it has already
lost: a request that spent its latency budget queuing (or in a slow
upstream stage) must be rejected **early** — before the expensive stage
families run — not returned late. The mechanism:

* :class:`DeadlineBudget` — one request's remaining time, measured on an
  injectable clock (a loadtest harness can run budgets on
  a virtual clock, so deadline dynamics are testable without sleeps).
  ``consume()`` adds *simulated* seconds — ``FaultPlan.slow_stage`` chaos
  burns budgets deterministically through this path.
* :func:`active` — installs a budget thread-locally around one
  ``score_fn.batch`` execution (the service installs the tightest budget
  of the micro-batch's members).
* :func:`checkpoint` — called by ``local/scoring.py`` at each stage-family
  boundary (sentinel → featurize → dispatch): when the active budget's
  remaining time cannot cover that family's **p95** from the serving
  latency histograms (``tptpu_serve_seconds{stage=...}``), it raises
  :class:`DeadlineExceeded` instead of letting the family execute. With
  no recorded history the required time is 0 and only a fully-spent
  budget rejects — the service learns its own latency floor as it runs.

``DeadlineExceeded`` is a typed rejection: the service maps it to
per-request outcomes and counts it (``deadline_exceeded`` events,
``tptpu_serve_deadline_exceeded_total``).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Iterator

from ..telemetry import events as _tevents
from ..telemetry import metrics as _tm

__all__ = [
    "DeadlineBudget",
    "DeadlineExceeded",
    "PIPELINE_FAMILIES",
    "active",
    "checkpoint",
    "consume",
    "current",
    "family_p95",
    "pipeline_p95",
]

#: stage families in execution order — the serving pipeline the budget
#: crosses (matches the ``tptpu_serve_seconds`` histogram labels)
PIPELINE_FAMILIES = ("sentinel", "featurize", "dispatch")


class DeadlineExceeded(RuntimeError):
    """A request's remaining budget cannot cover the upcoming stage family
    (or is already spent). Typed so the service and callers can tell
    "rejected early by deadline" from every other failure."""

    def __init__(self, family: str, remaining: float, required: float):
        self.family = family
        self.remaining = remaining
        self.required = required
        super().__init__(
            f"deadline exceeded before {family}: "
            f"{remaining * 1e3:.3f} ms remaining < "
            f"{required * 1e3:.3f} ms required (family p95)"
        )


class DeadlineBudget:
    """One request's latency budget on an injectable clock.

    ``remaining()`` = budget − (clock elapsed since ``started``) −
    simulated seconds consumed via :meth:`consume` (slow-stage chaos)."""

    __slots__ = ("budget", "clock", "started", "simulated")

    def __init__(
        self,
        budget: float,
        clock: Callable[[], float] | None = None,
        started: float | None = None,
    ):
        self.budget = float(budget)
        self.clock = clock if clock is not None else time.monotonic
        self.started = self.clock() if started is None else started
        self.simulated = 0.0

    def elapsed(self) -> float:
        return (self.clock() - self.started) + self.simulated

    def remaining(self) -> float:
        return self.budget - self.elapsed()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def consume(self, seconds: float) -> None:
        """Burn ``seconds`` of SIMULATED time (no real sleep)."""
        self.simulated += seconds

    def covers(
        self,
        families: tuple[str, ...] = PIPELINE_FAMILIES,
        required: float | None = None,
    ) -> bool:
        """True when the remaining budget covers the summed p95 of the
        given stage families (the admission-time pre-check). Callers
        checking many budgets in one pass precompute ``required`` once —
        each ``pipeline_p95`` call is three locked histogram-quantile
        scans, invariant within a batch."""
        rem = self.remaining()
        if required is None:
            required = pipeline_p95(families)
        return rem > 0.0 and rem >= required


_TLS = threading.local()


def current() -> DeadlineBudget | None:
    return getattr(_TLS, "budget", None)


@contextlib.contextmanager
def active(budget: DeadlineBudget | None) -> Iterator[DeadlineBudget | None]:
    """Install ``budget`` for this thread's scoring checkpoints (None is a
    no-op installation, so callers need no branching)."""
    prev = getattr(_TLS, "budget", None)
    _TLS.budget = budget
    try:
        yield budget
    finally:
        _TLS.budget = prev


def family_p95(family: str) -> float:
    """The stage family's p95 seconds from the serving latency histograms
    (0.0 when that family has no recorded history yet)."""
    h = _tm.REGISTRY.histogram(
        "tptpu_serve_seconds", labels={"stage": family}
    )
    q = h.quantile(0.95)
    return 0.0 if q is None else float(q)


def pipeline_p95(families: tuple[str, ...] = PIPELINE_FAMILIES) -> float:
    return sum(family_p95(f) for f in families)


def checkpoint(family: str) -> None:
    """Stage-family boundary check (called from the scoring hot path —
    near-free with no active budget): reject early when the remaining
    budget can't cover the family's p95. Emits the ``deadline_exceeded``
    event; the ``tptpu_serve_deadline_exceeded_total`` counter is
    maintained by the SERVICE per shed request outcome (one trip here can
    shed several co-batched members — counting both would double-book)."""
    b = current()
    if b is None:
        return
    required = family_p95(family)
    remaining = b.remaining()
    if remaining <= 0.0 or remaining < required:
        _tevents.emit(
            "deadline_exceeded", family=family,
            remainingMs=round(remaining * 1e3, 3),
            requiredMs=round(required * 1e3, 3),
        )
        raise DeadlineExceeded(family, remaining, required)


def consume(seconds: float) -> None:
    """Burn simulated seconds from the active budget (slow-stage chaos);
    no-op without one."""
    b = current()
    if b is not None and seconds:
        b.consume(seconds)
