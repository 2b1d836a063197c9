"""Serving plane of the port — the long-lived online path over one
``score_function`` closure, as the reference's.

* :mod:`.queue` — bounded admission (typed :class:`RejectedByAdmission`),
* :mod:`.batcher` — dynamic micro-batch assembly onto the fusion buffer,
* :mod:`.deadline` — per-request budgets propagated through the
  sentinel → featurize → dispatch stage families
  (:class:`DeadlineExceeded` rejects early, never late),
* :mod:`.shedding` — backpressure + tiered load shedding with hysteresis,
* :mod:`.service` — the service loop (:class:`ScoringService`),
* :mod:`.loadtest` — the seeded open-loop arrival harness on a virtual
  clock, deterministic (an injected service time) or in bench mode (the
  measured batch time),
* :mod:`.fleet` / :mod:`.router` — N replicas behind health × load
  dispatch with hedged retries and replica-loss drain
  (:class:`FleetService`),
* :mod:`.registry` — versioned rollout: shadow scoring and
  sentinel-gated canary promotion (:class:`ModelRegistry`).

The plane is host code: it takes its closure's device (``cuda`` unless
the closure was built with ``device="cpu"``) and never picks one. A
kernel fault is never contained by a service, a hedge, an adoption or a
retry: it fails the service (or fleet) and reaches the caller
(``service.py``, ``fleet.py``). ``explain=k`` is refused at admission
until the explain lanes are ported (``ROADMAP.md`` A10).
"""
from .batcher import BatchPlan, MicroBatcher
from .deadline import DeadlineBudget, DeadlineExceeded
from .fleet import FleetConfig, FleetRequest, FleetService
from .loadtest import (
    LoadSchedule,
    VirtualClock,
    run_fleet_loadtest,
    run_loadtest,
)
from .queue import AdmissionQueue, RejectedByAdmission
from .registry import ModelRegistry
from .router import Router, RouterConfig
from .service import PendingScore, ScoringService, ServiceConfig
from .shedding import LoadShedder, ShedConfig

__all__ = [
    "AdmissionQueue",
    "BatchPlan",
    "DeadlineBudget",
    "DeadlineExceeded",
    "FleetConfig",
    "FleetRequest",
    "FleetService",
    "LoadSchedule",
    "LoadShedder",
    "MicroBatcher",
    "ModelRegistry",
    "PendingScore",
    "RejectedByAdmission",
    "Router",
    "RouterConfig",
    "ScoringService",
    "ServiceConfig",
    "ShedConfig",
    "VirtualClock",
    "run_fleet_loadtest",
    "run_loadtest",
]
