"""Fault tolerance for training and scoring: the scoring closure's
hardening and the training-side retries.

* :mod:`.retry` — ``RetryPolicy``: exponential backoff + seeded jitter +
  deadline over transient-classified errors, with an injectable clock; a
  kernel fault is never retried;
* :mod:`.faults` — ``FaultPlan``: deterministic seeded fault injection
  (fit and candidate failures, NaN corruption, malformed serving rows,
  stage failures and slow stages, torn profiles, drifted streams);
* :mod:`.guards` — ``ScoreGuard``: NaN/Inf containment at score time with
  per-stage fallback and degradation counters;
* :mod:`.sentinel` — serving sentinels: ``SchemaSentinel`` row validation,
  per-row quarantine, ``DriftSentinel`` train/serve skew detection, and a
  per-stage ``CircuitBreaker`` with deadline.

Checkpoints, the retrain loop and the distributed plane are not ported
yet (``ROADMAP.md`` A12, A13).
"""
from .faults import FaultPlan, SimulatedCrash, installed  # noqa: F401
from .guards import ScoreGuard, ScoreGuardError  # noqa: F401
from .retry import (  # noqa: F401
    FatalError,
    RetryPolicy,
    TransientError,
    default_io_policy,
    is_transient,
)
from .sentinel import (  # noqa: F401
    BreakerConfig,
    CircuitBreaker,
    DriftConfig,
    DriftSentinel,
    QuarantineLog,
    QuarantineRecord,
    SchemaSentinel,
    SchemaViolationError,
    SentinelPolicy,
    compute_serving_profiles,
)
