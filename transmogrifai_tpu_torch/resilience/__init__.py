"""Fault tolerance for training and scoring: the scoring closure's
hardening, the training-side retries, checkpoints and the retrain loop.

* :mod:`.retry` — ``RetryPolicy``: exponential backoff + seeded jitter +
  deadline over transient-classified errors, with an injectable clock; a
  kernel fault is never retried;
* :mod:`.checkpoint` — ``CheckpointManager``: atomic per-layer
  fitted-stage checkpoints, per-candidate CV checkpoints and the stream
  cursor (the manifest + npz format of ``workflow/persistence.py``);
* :mod:`.faults` — ``FaultPlan``: deterministic seeded fault injection
  (fit and candidate failures, crashes after a layer or a stream chunk,
  torn, corrupt and memory-pressured stream chunks, NaN corruption,
  malformed serving rows, stage failures and slow stages, torn profiles,
  drifted streams, failed and crashed retrains);
* :mod:`.guards` — ``ScoreGuard``: NaN/Inf containment at score time with
  per-stage fallback and degradation counters;
* :mod:`.sentinel` — serving sentinels: ``SchemaSentinel`` row validation,
  per-row quarantine, ``DriftSentinel`` train/serve skew detection, and a
  per-stage ``CircuitBreaker`` with deadline;
* :mod:`.retrain` — ``RetrainController``: the continuous-retraining
  loop (drift-alert quorum, chunked collection, warm-start retrain that
  resumes from its checkpoints, run-ledger gate, registry canary), driven
  by ``tick()`` on an injectable clock.

The distributed plane (the failover loop, the collective guard, the
sharded checkpoint layout) is not ported yet (``ROADMAP.md`` A13);
``distributed.py`` holds its serving-side part.
"""
from .checkpoint import (  # noqa: F401
    CheckpointError,
    CheckpointManager,
    CheckpointMeshMismatch,
    dag_signature,
)
from .faults import FaultPlan, SimulatedCrash, installed  # noqa: F401
from .guards import ScoreGuard, ScoreGuardError  # noqa: F401
from .retrain import (  # noqa: F401
    RetrainConfig,
    RetrainController,
    warm_start_workflow_trainer,
)
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
