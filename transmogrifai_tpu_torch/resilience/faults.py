"""Deterministic fault injection for the training and scoring stack.

A ``FaultPlan`` is a seeded, declarative script of failures — "raise on the
Nth estimator fit", "corrupt this stage's output with NaN", "malform row
3", "shift this feature's stream" — installed process-globally
(``installed(plan)``) and consulted from cheap hooks inside
``workflow/fit.py``, ``selector/validators.py``, ``local/scoring.py`` and
``resilience/sentinel.py``. Because every firing is counted, the same plan
replays the same failure sequence on every run: the recovery paths
(retry-with-backoff, quarantine, breakers, score-time guards) are
exercised deterministically, no flaky process killing required.

Every method of the reference's plan that scripts a fault is here. The
serving plane consumes the fleet and load-test faults as the reference
does: ``burst_arrivals`` through :meth:`FaultPlan.arrival_multiplier` and
:meth:`FaultPlan.burst_replica` (``serving/loadtest.py``), ``kill_replica``
and ``partition_replica`` through :meth:`FaultPlan.replicas_to_kill` and
:meth:`FaultPlan.replica_partitioned` (``serving/fleet.py``,
``serving/router.py``), ``drop_heartbeat`` through
:meth:`FaultPlan.on_heartbeat` (the fleet's ``HostSentinel``), and
``slow_replica`` through :func:`replica_scope`. The training stack
consumes the rest: ``crash_after_layer`` and the retrain-scoped
``fail_retrain`` / ``crash_retrain`` through :meth:`FaultPlan.on_layer_end`
(``workflow/fit.py``), the stream faults through
:meth:`FaultPlan.on_stream_chunk` (``readers/streaming.py``),
:meth:`FaultPlan.on_stream_fold` and :meth:`FaultPlan.on_stream_chunk_end`
(``workflow/stream.py``), and the retrain controller's through
:meth:`FaultPlan.begin_retrain`, :meth:`FaultPlan.on_retrain_start` and
:meth:`FaultPlan.corrupts_new_chunk` (``resilience/retrain.py``).
``fail_host`` and ``straggle_collective`` raise ``NotImplementedError``,
and so do the hooks of the distributed plane (:meth:`FaultPlan.
on_collective`, and :meth:`FaultPlan.on_shard_load`, through which a
sharded checkpoint's load reads ``corrupt_shard``): that plane is A13.

``SimulatedCrash`` derives from ``BaseException`` on purpose: it models a
process death (preemption, OOM-kill) and must sail through every
``except Exception`` failure-isolation layer the way a real SIGKILL would.
"""
from __future__ import annotations

import contextlib
import logging
import threading
from typing import Any, Iterator

import numpy as np

from .retry import FatalError, TransientError

log = logging.getLogger(__name__)


class SimulatedCrash(BaseException):
    """Process-equivalent death: not an Exception, so candidate isolation
    and other broad handlers cannot swallow it."""


class TornChunkError(RuntimeError):
    """A stream ingest chunk arrived torn (truncated mid-write) — the
    out-of-core fit quarantines it instead of folding partial rows."""


class CorruptChunkError(RuntimeError):
    """A stream ingest chunk decoded to garbage — quarantined, never
    folded into the streaming fit stats."""


class MemoryPressure(RuntimeError):
    """Seeded memory-pressure signal on a stream ingest chunk: the
    out-of-core fit must degrade (halve its in-flight window) instead of
    dying."""





# ------------------------------------------------------------ replica scope
# Replica-keyed faults (slow_stage(replica=...), partition_replica, ...)
# need to know WHICH fleet replica is executing the current stage. The
# fleet's ScoringService wraps each batch execution in replica_scope(i);
# the hooks below read the ambient value through current_replica(). Thread-
# local on purpose: replicas execute on arbitrary threads and the scope
# must not leak across concurrent batch executions.
_REPLICA_TLS = threading.local()


def current_replica() -> Any | None:
    """The replica executing on this thread, or None outside a fleet."""
    return getattr(_REPLICA_TLS, "replica", None)


@contextlib.contextmanager
def replica_scope(replica: Any | None) -> "Iterator[None]":
    """Declare the ambient replica for fault matching on this thread."""
    prev = getattr(_REPLICA_TLS, "replica", None)
    _REPLICA_TLS.replica = replica
    try:
        yield
    finally:
        _REPLICA_TLS.replica = prev


def _matches(stage: Any, target: str) -> bool:
    """A target names a stage by uid, class name, operation name, or output
    column name."""
    if target == stage.uid or target == type(stage).__name__:
        return True
    if target == getattr(stage, "operation_name", None):
        return True
    try:
        return target == stage.output_name
    except Exception:
        return False


class FaultPlan:
    """Seeded script of injectable failures; every fault fires a bounded
    number of ``times`` and every firing lands in ``self.fired`` for test
    assertions."""

    def __init__(self, seed: int = 42):
        self.seed = seed
        self._lock = threading.Lock()
        self._fit_count = 0
        self._stage_fit_faults: list[dict[str, Any]] = []
        self._candidate_faults: list[dict[str, Any]] = []
        self._crash_layers: list[dict[str, Any]] = []
        self._nan_faults: list[dict[str, Any]] = []
        self._transform_faults: list[dict[str, Any]] = []
        self._slow_faults: list[dict[str, Any]] = []
        self._burst_windows: list[dict[str, Any]] = []
        self._row_faults: list[dict[str, Any]] = []
        #: cumulative simulated seconds injected by ``slow_stage`` — the
        #: serve-loadtest harness reads deltas of this to advance its
        #: virtual clock (no real sleeps anywhere)
        self.simulated_seconds = 0.0
        self._profile_faults: list[dict[str, Any]] = []
        self._drift_faults: list[dict[str, Any]] = []
        self._chunk_faults: list[dict[str, Any]] = []
        self._heartbeat_faults: list[dict[str, Any]] = []
        self._shard_faults: list[dict[str, Any]] = []
        self._replica_kill_faults: list[dict[str, Any]] = []
        self._replica_partitions: list[dict[str, Any]] = []
        self._retrain_fail_faults: list[dict[str, Any]] = []
        self._retrain_crash_faults: list[dict[str, Any]] = []
        self._retrain_chunk_faults: list[dict[str, Any]] = []
        self._stream_fold_faults: list[dict[str, Any]] = []
        self._stream_crash_faults: list[dict[str, Any]] = []
        # >0 while a RetrainController drives a warm-start fit: retrain-
        # scoped layer faults only fire inside this window, so a plan can
        # script "the RETRAIN crashes" without touching the initial train
        self._retrain_depth = 0
        #: chronological record of fired faults: (kind, detail)
        self.fired: list[tuple[str, str]] = []

    # ------------------------------------------------------------ configure
    def fail_stage_fit(
        self,
        target: str | None = None,
        nth: int | None = None,
        times: int = 1,
        transient: bool = True,
    ) -> "FaultPlan":
        """Raise when a matching estimator fit starts: ``target`` selects by
        uid/class/operation/output name, ``nth`` by the global 1-based fit
        counter. Transient faults raise ``TransientError`` (retryable);
        fatal ones raise ``FatalError``."""
        self._stage_fit_faults.append(
            {"target": target, "nth": nth, "times": times, "count": 0,
             "transient": transient}
        )
        return self

    def crash_after_layer(self, layer_index: int, times: int = 1) -> "FaultPlan":
        """Raise ``SimulatedCrash`` after layer ``layer_index`` finished
        (and, when checkpointing, was persisted) — the mid-DAG kill."""
        self._crash_layers.append(
            {"layer": layer_index, "times": times, "count": 0}
        )
        return self

    def fail_candidate(
        self, model_name: str, times: int = 1, transient: bool = True
    ) -> "FaultPlan":
        """Raise when the named model family starts a CV sweep attempt."""
        self._candidate_faults.append(
            {"target": model_name, "times": times, "count": 0,
             "transient": transient}
        )
        return self

    def nan_output(
        self, target: str, rows: tuple[int, ...] = (0,), times: int = 1
    ) -> "FaultPlan":
        """Overwrite the given rows of a matching stage's output column with
        NaN (numeric / vector / prediction columns)."""
        self._nan_faults.append(
            {"target": target, "rows": tuple(rows), "times": times, "count": 0}
        )
        return self

    # ------------------------------------------------ serving-path faults
    def fail_stage_transform(
        self,
        target: str | None = None,
        rows: tuple[int, ...] | None = None,
        times: int | None = 1,
        transient: bool = True,
    ) -> "FaultPlan":
        """Raise when a matching stage executes on the scoring path.
        ``rows`` limits firing to executions covering any of those original
        row indices (so per-row isolation re-runs only re-fail for the
        poisoned rows); ``times=None`` means unlimited."""
        self._transform_faults.append(
            {"target": target, "rows": None if rows is None else set(rows),
             "times": times, "count": 0, "transient": transient}
        )
        return self

    def slow_stage(
        self,
        target: str | None = None,
        delay: float = 0.1,
        times: int | None = None,
        replica: Any | None = None,
    ) -> "FaultPlan":
        """Inflate a matching scoring stage's observed duration by
        ``delay`` SIMULATED seconds (no real sleep): the scoring loop adds
        the extra to the breaker-deadline elapsed time, to the per-family
        latency seconds, and consumes it from any active per-request
        deadline budget (serving/deadline.py), so slow-stage chaos drives
        deadline rejections and breaker overruns deterministically.
        Unlimited by default — a degraded stage stays slow. ``replica``
        keys the fault to one fleet replica (matched against the ambient
        :func:`replica_scope`); None hits every replica."""
        self._slow_faults.append(
            {"target": target, "delay": float(delay), "times": times,
             "count": 0, "replica": replica}
        )
        return self

    def slow_replica(
        self, replica: Any, delay: float = 0.1, times: int | None = None
    ) -> "FaultPlan":
        """Slow EVERY scoring stage on one fleet replica by ``delay``
        simulated seconds — sugar over :meth:`slow_stage` with a replica
        key and no stage target (the degraded-worker scenario the hedging
        tests script)."""
        return self.slow_stage(
            target=None, delay=delay, times=times, replica=replica
        )

    def burst_arrivals(
        self,
        start: float,
        duration: float,
        multiplier: float = 10.0,
        replica: Any | None = None,
    ) -> "FaultPlan":
        """Declare an arrival-rate burst window for the open-loop
        serve-loadtest harness: between ``start`` and ``start + duration``
        (harness virtual seconds) the nominal arrival rate multiplies by
        ``multiplier``. Queried via :meth:`arrival_multiplier` at EVERY
        arrival step (not just at schedule build), so windows compose with
        whatever the clock does at run time — the burst is part of the
        plan, and the same plan replays the same overload every run.
        ``replica`` additionally pins arrivals inside the window to one
        fleet replica (queried via :meth:`burst_replica` by the fleet
        harness) — a sticky hot-spot aimed at a single worker."""
        if duration <= 0 or multiplier <= 0:
            raise ValueError("burst_arrivals needs duration > 0, multiplier > 0")
        self._burst_windows.append(
            {"start": float(start), "end": float(start) + float(duration),
             "multiplier": float(multiplier), "fired": False,
             "replica": replica}
        )
        return self

    def kill_replica(self, replica: Any, at: float = 0.0) -> "FaultPlan":
        """Kill one fleet replica at harness-virtual time ``at``: the
        fleet's tick consults :meth:`replicas_to_kill` and decommissions
        the replica (stop + orphan adoption by survivors). Fires once."""
        self._replica_kill_faults.append(
            {"replica": replica, "at": float(at), "fired": False}
        )
        return self

    def partition_replica(
        self, replica: Any, start: float = 0.0, duration: float = 1e9
    ) -> "FaultPlan":
        """Network-partition one fleet replica for ``[start, start +
        duration)`` harness-virtual seconds: its heartbeats stop reaching
        the fleet sentinel and the router scores it unroutable, but the
        replica itself keeps executing (the gray-failure scenario)."""
        if duration <= 0:
            raise ValueError("partition_replica needs duration > 0")
        self._replica_partitions.append(
            {"replica": replica, "start": float(start),
             "end": float(start) + float(duration), "fired": False}
        )
        return self

    def malform_row(
        self,
        feature: str,
        rows: tuple[int, ...] = (0,),
        value: Any = "##not-a-number##",
        times: int | None = None,
    ) -> "FaultPlan":
        """Corrupt ``feature`` in the given incoming rows before schema
        validation (the malformed-producer scenario). Unlimited by default
        so score_one/score_batch parity tests replay the same corruption."""
        self._row_faults.append(
            {"feature": feature, "rows": set(rows), "value": value,
             "times": times, "count": 0}
        )
        return self

    def tear_profile(
        self, feature: str | None = None, times: int | None = None
    ) -> "FaultPlan":
        """Drop a matching training profile at drift-sentinel build time —
        the torn-artifact scenario (monitoring must degrade, not scoring)."""
        self._profile_faults.append(
            {"feature": feature, "times": times, "count": 0}
        )
        return self

    def shift_feature(
        self, feature: str, offset: float, times: int | None = None,
        ramp: float = 0.0,
    ) -> "FaultPlan":
        """Shift every observed value of ``feature`` at the drift sentinel's
        intake — a deterministic drifted stream without regenerating data.
        ``ramp`` adds ``ramp * (firings so far)`` on top of ``offset``, so a
        stream can KEEP drifting (e.g. while a retrain is in flight) instead
        of jumping once to a new plateau."""
        self._drift_faults.append(
            {"feature": feature, "offset": float(offset), "times": times,
             "ramp": float(ramp), "count": 0}
        )
        return self

    def fail_chunk_read(
        self, times: int = 1, transient: bool = True
    ) -> "FaultPlan":
        """Raise on streaming-reader chunk fetches (readers/streaming.py) —
        exercises the chunk-level RetryPolicy."""
        self._chunk_faults.append(
            {"times": times, "count": 0, "transient": transient}
        )
        return self

    def tear_stream_chunk(
        self, chunk_index: int | None = None, times: int = 1
    ) -> "FaultPlan":
        """Tear the ``chunk_index``-th (0-based) stream ingest chunk at
        fold time — the out-of-core fit must quarantine it (counted,
        never folded). ``None`` tears the next ``times`` chunks folded."""
        self._stream_fold_faults.append(
            {"kind": "torn", "chunk": chunk_index, "times": times, "count": 0}
        )
        return self

    def corrupt_chunk(
        self, chunk_index: int | None = None, times: int = 1
    ) -> "FaultPlan":
        """Corrupt the ``chunk_index``-th (0-based) stream ingest chunk at
        fold time — quarantined like a torn chunk, counted separately."""
        self._stream_fold_faults.append(
            {"kind": "corrupt", "chunk": chunk_index, "times": times,
             "count": 0}
        )
        return self

    def oom_chunk(
        self, chunk_index: int | None = None, times: int = 1
    ) -> "FaultPlan":
        """Signal memory pressure while folding the ``chunk_index``-th
        (0-based) stream ingest chunk — the out-of-core fit must halve its
        in-flight window and keep going, not die."""
        self._stream_fold_faults.append(
            {"kind": "oom", "chunk": chunk_index, "times": times, "count": 0}
        )
        return self

    def crash_after_chunk(
        self, chunk_index: int, times: int = 1
    ) -> "FaultPlan":
        """Raise ``SimulatedCrash`` after stream ingest chunk
        ``chunk_index`` (0-based) was folded AND its stream cursor was
        persisted — the mid-ingest kill whose resume must cost < 1 chunk
        of rework."""
        self._stream_crash_faults.append(
            {"chunk": chunk_index, "times": times, "count": 0}
        )
        return self

    # --------------------------------------------------- retrain faults
    def fail_retrain(
        self,
        after_layer: int | None = None,
        times: int = 1,
        transient: bool = True,
    ) -> "FaultPlan":
        """Fail a RetrainController warm-start fit: at retrain START
        (``after_layer=None``) or after DAG layer ``after_layer`` finished.
        Only fires inside a retrain scope — the initial train is untouched.
        The controller treats any such failure as a failed attempt
        (rolled_back + backoff), NOT a resumable crash."""
        self._retrain_fail_faults.append(
            {"layer": after_layer, "times": times, "count": 0,
             "transient": transient}
        )
        return self

    def crash_retrain(
        self, after_layer: int = 0, times: int = 1
    ) -> "FaultPlan":
        """Raise ``SimulatedCrash`` after retrain DAG layer ``after_layer``
        finished (and its layer checkpoint was persisted) — the mid-retrain
        kill. The controller stays in ``retraining`` and the next tick
        resumes the fit from its own layer checkpoints."""
        self._retrain_crash_faults.append(
            {"layer": after_layer, "times": times, "count": 0}
        )
        return self

    def corrupt_new_chunk(
        self, times: int = 1, nth: int | None = None
    ) -> "FaultPlan":
        """Corrupt a freshly-collected retrain data chunk at seal time
        (``nth`` selects by the 1-based global chunk counter). The
        controller must quarantine the chunk — drop it from the retrain
        window, count it — rather than train on torn rows."""
        self._retrain_chunk_faults.append(
            {"nth": nth, "times": times, "count": 0}
        )
        return self

    # ------------------------------------------------- distributed faults
    def fail_host(
        self,
        host: Any,
        after_layer: int | None = None,
        collective: str | None = None,
        times: int = 1,
    ) -> "FaultPlan":
        """Declare a simulated host dead at the end of a DAG layer or during
        a collective. Its consumer, the distributed plane and its
        ``HostLostError``, is not ported yet (``ROADMAP.md`` A13)."""
        raise NotImplementedError(
            "FaultPlan.fail_host needs the distributed plane, not ported "
            "yet (ROADMAP.md A13)"
        )

    def straggle_collective(
        self,
        name: str | None = None,
        delay: float = 1e6,
        host: Any = None,
        times: int = 1,
    ) -> "FaultPlan":
        """Inflate a collective's observed duration. Its consumer, the
        distributed plane's ``CollectiveGuard``, is not ported yet
        (``ROADMAP.md`` A13)."""
        raise NotImplementedError(
            "FaultPlan.straggle_collective needs the distributed plane, not "
            "ported yet (ROADMAP.md A13)"
        )

    def drop_heartbeat(
        self, host: Any, times: int | None = None
    ) -> "FaultPlan":
        """Swallow ``host``'s heartbeats (HostSentinel.beat) so the
        injectable clock can age it into a declared death. Unlimited by
        default — a dead host stays silent."""
        self._heartbeat_faults.append(
            {"host": host, "times": times, "count": 0}
        )
        return self

    def corrupt_shard(
        self, layer: int | None = None, times: int = 1
    ) -> "FaultPlan":
        """Corrupt a checkpointed layer's shard payload at load time
        (``layer=None`` matches any layer) — resume must truncate the
        restored prefix and refit, never crash or restore garbage."""
        self._shard_faults.append(
            {"layer": layer, "times": times, "count": 0}
        )
        return self

    @staticmethod
    def truncate_file(path: str, keep: int = 20) -> None:
        """Tear a checkpoint / AOT blob the way a killed writer would."""
        with open(path, "r+b") as fh:
            fh.truncate(keep)

    # ----------------------------------------------------------------- hooks
    # every check-then-increment of a fault's firing count holds the plan
    # lock: CV candidates run on a thread pool, and a times=1 fault racing
    # two threads must still fire exactly once (determinism is the product)

    def on_stage_fit(self, stage: Any) -> None:
        with self._lock:
            self._fit_count += 1
            n = self._fit_count
            for f in self._stage_fit_faults:
                if f["count"] >= f["times"]:
                    continue
                if f["nth"] is not None and f["nth"] != n:
                    continue
                if f["target"] is not None and not _matches(stage, f["target"]):
                    continue
                f["count"] += 1
                self.fired.append(("fit", stage.uid))
                exc = TransientError if f["transient"] else FatalError
                raise exc(
                    f"injected fit failure on {type(stage).__name__}({stage.uid})"
                )

    def on_layer_end(self, layer_index: int) -> None:
        with self._lock:
            for f in self._crash_layers:
                if f["count"] >= f["times"] or f["layer"] != layer_index:
                    continue
                f["count"] += 1
                self.fired.append(("crash", f"layer-{layer_index}"))
                raise SimulatedCrash(
                    f"injected crash after layer {layer_index}"
                )
            if self._retrain_depth > 0:
                for f in self._retrain_crash_faults:
                    if f["count"] >= f["times"] or f["layer"] != layer_index:
                        continue
                    f["count"] += 1
                    self.fired.append(
                        ("retrain_crash", f"layer-{layer_index}")
                    )
                    raise SimulatedCrash(
                        f"injected retrain crash after layer {layer_index}"
                    )
                for f in self._retrain_fail_faults:
                    if f["count"] >= f["times"] or f["layer"] != layer_index:
                        continue
                    f["count"] += 1
                    self.fired.append(
                        ("retrain_fail", f"layer-{layer_index}")
                    )
                    exc = TransientError if f["transient"] else FatalError
                    raise exc(
                        f"injected retrain failure after layer {layer_index}"
                    )

    def on_collective(self, name: str) -> tuple[float, Any]:
        """The distributed plane's collective hook (``CollectiveGuard``):
        not ported yet (``ROADMAP.md`` A13)."""
        raise NotImplementedError(
            "FaultPlan.on_collective needs the distributed plane, not ported "
            "yet (ROADMAP.md A13)"
        )

    def on_shard_load(self, layer_index: int) -> bool:
        """The sharded checkpoint's load hook (``corrupt_shard``): not
        ported yet (``ROADMAP.md`` A13). The port's layer checkpoints hold
        host arrays and never consult it."""
        raise NotImplementedError(
            "FaultPlan.on_shard_load needs the sharded checkpoint layout, "
            "not ported yet (ROADMAP.md A13)"
        )

    def on_candidate_fit(self, est: Any) -> None:
        name = type(est).__name__
        with self._lock:
            for f in self._candidate_faults:
                if f["count"] >= f["times"] or f["target"] != name:
                    continue
                f["count"] += 1
                self.fired.append(("candidate", name))
                exc = TransientError if f["transient"] else FatalError
                raise exc(f"injected candidate failure on {name}")

    def on_stage_transform(
        self, stage: Any, row_indices: tuple[int, ...] | None = None
    ) -> None:
        """Serving-path stage execution hook (local/scoring.py).
        ``row_indices`` are the ORIGINAL batch indices covered by this
        execution (per-row isolation re-runs pass a single index)."""
        with self._lock:
            for f in self._transform_faults:
                if f["times"] is not None and f["count"] >= f["times"]:
                    continue
                if f["target"] is not None and not _matches(stage, f["target"]):
                    continue
                if f["rows"] is not None and (
                    row_indices is None or not f["rows"].intersection(row_indices)
                ):
                    continue
                f["count"] += 1
                if f["count"] == 1:
                    self.fired.append(("transform", stage.output_name))
                exc = TransientError if f["transient"] else FatalError
                raise exc(
                    f"injected transform failure on "
                    f"{type(stage).__name__}({stage.uid})"
                )

    def on_stage_duration(self, stage: Any) -> float:
        """Extra SIMULATED seconds a matching stage execution took
        (``slow_stage``). Fires per execution; only the FIRST firing per
        fault lands in ``fired`` (a standing service executes thousands of
        batches)."""
        replica = current_replica()
        with self._lock:
            extra = 0.0
            for f in self._slow_faults:
                if f["times"] is not None and f["count"] >= f["times"]:
                    continue
                if f["target"] is not None and not _matches(stage, f["target"]):
                    continue
                if f.get("replica") is not None and f["replica"] != replica:
                    continue
                f["count"] += 1
                if f["count"] == 1:
                    self.fired.append(("slow", stage.output_name))
                extra += f["delay"]
            if extra:
                self.simulated_seconds += extra
            return extra

    def arrival_multiplier(self, t: float) -> float:
        """Product of every burst window covering harness-virtual time
        ``t`` (1.0 outside all windows). The first query inside a window
        lands in ``fired``."""
        with self._lock:
            mult = 1.0
            for f in self._burst_windows:
                if f["start"] <= t < f["end"]:
                    if not f["fired"]:
                        f["fired"] = True
                        self.fired.append(("burst", f"t={f['start']:g}"))
                    mult *= f["multiplier"]
            return mult

    def burst_replica(self, t: float) -> Any | None:
        """The replica a burst window covering ``t`` pins arrivals to
        (first keyed window wins), or None — the fleet loadtest harness
        bypasses the router for pinned arrivals so one replica takes the
        whole hot-spot."""
        with self._lock:
            for f in self._burst_windows:
                if f.get("replica") is None:
                    continue
                if f["start"] <= t < f["end"]:
                    return f["replica"]
            return None

    def replicas_to_kill(self, now: float) -> list[Any]:
        """Replica kills due at harness-virtual time ``now`` (each fires
        exactly once; firings land in ``fired``)."""
        with self._lock:
            due = []
            for f in self._replica_kill_faults:
                if f["fired"] or f["at"] > now:
                    continue
                f["fired"] = True
                due.append(f["replica"])
                self.fired.append(
                    ("kill_replica", f"{f['replica']}@t={f['at']:g}")
                )
            return due

    def replica_partitioned(self, replica: Any, now: float) -> bool:
        """True while ``replica`` sits inside a scripted partition window.
        The first positive query per fault lands in ``fired``."""
        with self._lock:
            for f in self._replica_partitions:
                if f["replica"] != replica:
                    continue
                if f["start"] <= now < f["end"]:
                    if not f["fired"]:
                        f["fired"] = True
                        self.fired.append(
                            ("partition", f"{replica}@t={f['start']:g}")
                        )
                    return True
            return False


    def on_heartbeat(self, host: Any) -> bool:
        """True = swallow this heartbeat (HostSentinel.beat). Fires per
        beat; only the FIRST firing per fault lands in ``fired``."""
        with self._lock:
            for f in self._heartbeat_faults:
                if f["times"] is not None and f["count"] >= f["times"]:
                    continue
                if f["host"] != host:
                    continue
                f["count"] += 1
                if f["count"] == 1:
                    self.fired.append(("heartbeat", str(host)))
                return True
        return False


    def on_score_row(self, row: dict, index: int) -> dict | None:
        """Return a corrupted copy of an incoming row, or None to keep it."""
        with self._lock:
            out = None
            for f in self._row_faults:
                if f["times"] is not None and f["count"] >= f["times"]:
                    continue
                if index not in f["rows"]:
                    continue
                f["count"] += 1
                if out is None:
                    out = dict(row)
                out[f["feature"]] = f["value"]
                self.fired.append(("malform", f"{f['feature']}@{index}"))
            return out

    def on_profile_load(self, name: str) -> bool:
        """True = tear this training profile (drift sentinel build time)."""
        with self._lock:
            for f in self._profile_faults:
                if f["times"] is not None and f["count"] >= f["times"]:
                    continue
                if f["feature"] is not None and f["feature"] != name:
                    continue
                f["count"] += 1
                self.fired.append(("profile", name))
                return True
        return False

    def wants_drift(self, name: str) -> bool:
        """Cheap pre-check so the drift sentinel only leaves its
        vectorized bulk path when a shift fault actually targets this
        feature (an installed plan with unrelated faults must not force a
        per-value Python loop over every serving batch)."""
        return any(f["feature"] == name for f in self._drift_faults)

    def on_drift_observe(self, name: str, value: Any) -> Any:
        """Possibly shift a value at the drift sentinel's intake. Fires per
        value; only the FIRST firing per fault lands in ``fired`` (a stream
        fires thousands of times)."""
        with self._lock:
            for f in self._drift_faults:
                if f["feature"] != name:
                    continue
                if f["times"] is not None and f["count"] >= f["times"]:
                    continue
                f["count"] += 1
                if f["count"] == 1:
                    self.fired.append(("drift", name))
                try:
                    # ramp grows per firing: a scripted stream that keeps
                    # moving instead of stepping once to a new plateau
                    value = (
                        float(value) + f["offset"]
                        + f.get("ramp", 0.0) * (f["count"] - 1)
                    )
                except (TypeError, ValueError):
                    pass
        return value

    # ---------------------------------------------- retrain-scoped hooks
    def begin_retrain(self) -> None:
        """Enter the retrain scope (RetrainController, around its
        warm-start fit): retrain-scoped layer faults fire only inside."""
        with self._lock:
            self._retrain_depth += 1

    def end_retrain(self) -> None:
        with self._lock:
            self._retrain_depth = max(0, self._retrain_depth - 1)

    def on_retrain_start(self) -> None:
        """Consulted by the RetrainController right before it invokes the
        warm-start trainer — ``fail_retrain(after_layer=None)`` fires
        here."""
        with self._lock:
            for f in self._retrain_fail_faults:
                if f["count"] >= f["times"] or f["layer"] is not None:
                    continue
                f["count"] += 1
                self.fired.append(("retrain_fail", "start"))
                exc = TransientError if f["transient"] else FatalError
                raise exc("injected retrain failure at start")

    def corrupts_new_chunk(self, chunk_index: int) -> bool:
        """True when the ``chunk_index``-th (1-based) freshly-collected
        retrain chunk should arrive torn — the controller quarantines it."""
        with self._lock:
            for f in self._retrain_chunk_faults:
                if f["count"] >= f["times"]:
                    continue
                if f["nth"] is not None and f["nth"] != chunk_index:
                    continue
                f["count"] += 1
                self.fired.append(("retrain_chunk", f"chunk-{chunk_index}"))
                return True
        return False

    def on_stream_chunk(self, path: str) -> None:
        """Streaming-reader chunk fetch hook (readers/streaming.py)."""
        with self._lock:
            for f in self._chunk_faults:
                if f["count"] >= f["times"]:
                    continue
                f["count"] += 1
                self.fired.append(("chunk", path))
                exc = TransientError if f["transient"] else FatalError
                raise exc(f"injected chunk-read failure on {path}")

    def on_stream_fold(self, chunk_index: int) -> None:
        """Stream ingest fold hook (workflow/stream.py), consulted before
        chunk ``chunk_index`` (0-based) is folded into the streaming fit
        stats: armed ``tear_stream_chunk`` / ``corrupt_chunk`` faults
        raise the typed quarantine errors, ``oom_chunk`` raises
        ``MemoryPressure`` (the engine halves its window and folds the
        chunk anyway)."""
        with self._lock:
            for f in self._stream_fold_faults:
                if f["count"] >= f["times"]:
                    continue
                if f["chunk"] is not None and f["chunk"] != chunk_index:
                    continue
                f["count"] += 1
                kind = f["kind"]
                self.fired.append(
                    (f"stream_{kind}", f"chunk-{chunk_index}")
                )
                if kind == "torn":
                    raise TornChunkError(
                        f"injected torn stream chunk {chunk_index}"
                    )
                if kind == "corrupt":
                    raise CorruptChunkError(
                        f"injected corrupt stream chunk {chunk_index}"
                    )
                raise MemoryPressure(
                    f"injected memory pressure on stream chunk {chunk_index}"
                )

    def on_stream_chunk_end(self, chunk_index: int) -> None:
        """Fires after chunk ``chunk_index`` was folded and its stream
        cursor persisted — ``crash_after_chunk`` raises here, so a resume
        restores everything up to and including this chunk."""
        with self._lock:
            for f in self._stream_crash_faults:
                if f["count"] >= f["times"] or f["chunk"] != chunk_index:
                    continue
                f["count"] += 1
                self.fired.append(
                    ("stream_crash", f"chunk-{chunk_index}")
                )
                raise SimulatedCrash(
                    f"injected crash after stream chunk {chunk_index}"
                )

    def on_stage_output(self, stage: Any, column: Any) -> Any | None:
        """Return a corrupted replacement column, or None to keep the
        original."""
        with self._lock:
            targets = [
                f for f in self._nan_faults
                if f["count"] < f["times"] and _matches(stage, f["target"])
            ]
            for f in targets:
                corrupted = _inject_nan(column, f["rows"])
                if corrupted is None:
                    continue  # column type has no float plane to corrupt
                f["count"] += 1
                self.fired.append(("nan", stage.output_name))
                return corrupted
        return None


def _inject_nan(column: Any, rows: tuple[int, ...]) -> Any | None:
    import dataclasses

    from ..types.columns import NumericColumn, PredictionColumn, VectorColumn

    idx = [r for r in rows if r < len(column)]
    if not idx:
        return None
    if isinstance(column, NumericColumn):
        if not np.issubdtype(column.values.dtype, np.floating):
            return None
        vals = np.array(column.values, copy=True)
        vals[idx] = np.nan
        return dataclasses.replace(column, values=vals)
    if isinstance(column, VectorColumn):
        if column.is_sparse:
            return None
        vals = np.array(np.asarray(column.values), copy=True)
        vals[idx, :] = np.nan
        return dataclasses.replace(column, values=vals)
    if isinstance(column, PredictionColumn):
        pred = np.array(column.prediction, copy=True)
        pred[idx] = np.nan
        prob = column.probability
        if prob is not None:
            prob = np.array(prob, copy=True)
            prob[idx, :] = np.nan
        return dataclasses.replace(column, prediction=pred, probability=prob)
    return None


# --------------------------------------------------------------- installation
_ACTIVE: FaultPlan | None = None


def install(plan: FaultPlan) -> None:
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a FaultPlan is already installed")
    _ACTIVE = plan


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> FaultPlan | None:
    return _ACTIVE


@contextlib.contextmanager
def installed(plan: FaultPlan) -> Iterator[FaultPlan]:
    install(plan)
    try:
        yield plan
    finally:
        uninstall()
