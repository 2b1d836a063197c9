"""The training run's flight recorder, its report files, the transfer
census and the cross-run diff.

* :class:`RunStats`, a process-wide :class:`~.metrics.LedgerCore` ledger
  (the ``run`` registry source) counting the host<->device copies at run
  time: the fused scoring graph records its one upload and its one
  download a batch (``compiler/fused.py``), a layer checkpoint records the
  bytes it downloads from the card (``resilience/checkpoint.py``).
* :class:`RunRecorder`, installed by ``Workflow.train()`` for the run
  (:func:`recording`, :func:`active_recorder`): per-phase seconds with the
  featurize ledger's deltas, per-layer, per-fold and per-candidate timings
  with rows/s, device-memory high-water marks polled at phase and layer
  boundaries and per ingest chunk (:func:`poll_device_memory`, the CUDA
  caching allocator's ``torch.cuda.memory_stats``, which does not
  synchronize; the reference's graceful zeros on the CPU), host RSS
  (:func:`poll_host_rss`), and a seconds-per-layer EWMA
  (:class:`EtaEstimator`) feeding ``train(progress=callback)``. Phase
  times are host-clock, as in the reference; the recorder adds no host
  sync.
* :func:`build_report`: the schema-versioned RUN report (the unified
  bench-report envelope with a nested ``run`` payload), written as
  ``RUN_*.json`` into ``train(run_dir=...)`` / ``$TPTPU_RUN_DIR``
  (:func:`save_run_report`, :func:`list_run_reports`,
  :func:`latest_run_report`) and carried by the model
  (``model.run_report``, ``summary_json()["run"]``, the manifest).
* :func:`load_run_report` / :func:`validate_run_report` and
  :func:`diff_runs` / :class:`RegressionSentinel`: the cross-run
  comparison flagging per-phase slowdowns (TPR001), compile-count
  blowups (TPR002), transfer-bytes growth (TPR003) and quality drops
  (TPR004) beyond :class:`RunTolerances`, emitting a ``run_regression``
  event. The model registry's canary gate diffs its two sides through
  them (``serving/registry.py``).

The compile plane (the program bank and its sweep-lane accounting) is
``ROADMAP.md`` A14: until it lands, a report's ``compileStats`` and
``sweeps`` blocks are the reference's for a run with no compile events,
and ``reconcile_transfer_census``, which squares the census against the
plan audit (``analysis/plan_audit``), waits for it too.

Everything here is observability: recorder failures are contained (a
broken poll never fails a train). The transfer census is a delta over one
process-global ledger and :func:`active_recorder` resolves to the
innermost installed recorder process-wide, as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import threading
import time
import uuid
from typing import Any, Callable, Iterator

from . import events as _tevents
from . import metrics as _tm
from . import spans as _tspans

log = logging.getLogger(__name__)

#: the schema version of a run report's ``run`` payload
RUN_SCHEMA_VERSION = 1
RUN_FILE_PREFIX = "RUN_"

_COUNTER_KEYS = (
    "h2dTransfers",     # host->device uploads through the dispatch seam
    "h2dBytes",         # bytes those uploads moved
    "d2hTransfers",     # device->host downloads at the scoring render seam
    "d2hBytes",         # bytes those downloads moved
    "runsRecorded",     # finalized RunReports this process
    "layersTimed",      # DAG-layer boundary pulses
    "foldsTimed",       # CV-fold boundary pulses
    "candidatesTimed",  # candidate-sweep timings (selector + workflow CV)
    "summaryDegraded",  # summary_pretty sections that failed and degraded
    "runRegressions",   # findings emitted by diff_runs/RegressionSentinel
)


class RunStats(_tm.LedgerCore):
    """Thread-safe counters; upload/download seconds ride along as
    floats. Shares the registry's re-entrant lock with the other ledgers,
    so a ``telemetry.snapshot_lock()`` read is consistent across all."""

    def __init__(self) -> None:
        super().__init__(_COUNTER_KEYS)
        self._h2d_s = 0.0
        self._d2h_s = 0.0

    # ------------------------------------------------------------ recording
    def record_upload(self, nbytes: int, seconds: float = 0.0) -> None:
        with self._lock:
            self._counts["h2dTransfers"] += 1
            self._counts["h2dBytes"] += int(nbytes)
            self._h2d_s += seconds

    def record_download(self, nbytes: int, seconds: float = 0.0) -> None:
        with self._lock:
            self._counts["d2hTransfers"] += 1
            self._counts["d2hBytes"] += int(nbytes)
            self._d2h_s += seconds

    # ------------------------------------------------------------ reporting
    def snapshot(self) -> dict:
        with self._lock:
            out: dict = dict(self._counts)
            out["h2dSeconds"] = round(self._h2d_s, 4)
            out["d2hSeconds"] = round(self._d2h_s, 4)
        return out

    def reset(self) -> None:
        with self._lock:
            self._reset_counts()
            self._h2d_s = 0.0
            self._d2h_s = 0.0


_STATS = RunStats()
_tm.REGISTRY.register_source("run", _STATS.snapshot)


def stats() -> RunStats:
    return _STATS


def snapshot() -> dict:
    return _STATS.snapshot()


def delta(before: dict) -> dict:
    """Per-run view: current snapshot minus an earlier ``snapshot()``."""
    now = _STATS.snapshot()
    out: dict = _tm.counter_delta(now, before, _COUNTER_KEYS)
    for k in ("h2dSeconds", "d2hSeconds"):
        out[k] = _tm.float_delta(now, before, k, ndigits=4)
    return out


def record_upload(nbytes: int, seconds: float = 0.0) -> None:
    """One host→device upload through the dispatch seam (prefetch_f32 /
    device_f32's fresh-upload path)."""
    _STATS.record_upload(nbytes, seconds)


def record_download(nbytes: int, seconds: float = 0.0) -> None:
    """One device→host download at a scoring render point."""
    _STATS.record_download(nbytes, seconds)


#: the compile plane's counters (``compiler/stats.py`` in the reference,
#: ``ROADMAP.md`` A14): every phase and run delta reads zero until it lands
_COMPILE_KEYS = (
    "programsCompiled", "cacheHitsMemory", "cacheHitsDisk", "dedupHits",
    "laneBucketPads", "bucketedSweeps", "corruptBlobsDropped",
    "versionInvalidations", "savesFailed", "warmupPrograms",
    "fusedDispatches", "fusedExplainLanes", "fusedFallbacks",
    "programsAudited", "programAuditRejected",
)


def no_compile_delta() -> dict[str, Any]:
    """The compile ledger's delta over a span with no compile events."""
    out: dict[str, Any] = {k: 0 for k in _COMPILE_KEYS}
    out["warmupOverlapSeconds"] = 0.0
    out["programsCompiledByName"] = {}
    out["fusedFallbackReasons"] = {}
    out["compileCacheHitRate"] = None
    return out


def poll_device_memory() -> dict[str, Any]:
    """Point-in-time device-memory gauges from the CUDA caching allocator
    (``torch.cuda.memory_stats``, summed over the cards): bytes held by live
    tensors now (``deviceBytesInUse``, ``liveArrayBytes``) and at their
    peak (``devicePeakBytes``). The allocator's counters are host-side, so
    the poll never synchronizes with the card. Where CUDA was never
    initialized (a CPU run) the backend is ``cpu`` and the gauges read
    zero, as the reference's do on its CPU. Never raises: a broken poll
    reports zeros."""
    out: dict[str, Any] = {
        "backend": "unknown",
        "deviceBytesInUse": 0,
        "devicePeakBytes": 0,
        "liveArrayBytes": 0,
    }
    try:
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            out["backend"] = "cpu"
            return out
        out["backend"] = "cuda"
        for d in range(torch.cuda.device_count()):
            ms = torch.cuda.memory_stats(d)
            in_use = int(ms.get("allocated_bytes.all.current", 0))
            out["deviceBytesInUse"] += in_use
            out["devicePeakBytes"] += int(
                ms.get("allocated_bytes.all.peak", in_use))
        out["liveArrayBytes"] = out["deviceBytesInUse"]
    except Exception as e:  # observability must never break a train
        log.debug("device memory poll failed: %s", e)
    return out


def poll_host_rss() -> int:
    """Current host resident-set size in bytes (the out-of-core ingest's
    bounded-memory evidence rides this gauge per chunk). Reads
    ``/proc/self/status`` VmRSS; falls back to ``resource.getrusage``
    (peak, in KiB on Linux) where /proc is unavailable. Never raises —
    a broken poll reports 0."""
    try:
        with open("/proc/self/status", encoding="ascii") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except Exception:
        pass
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception as e:
        log.debug("host rss poll failed: %s", e)
        return 0


# ------------------------------------------------------------------------ ETA
class EtaEstimator:
    """Seconds-per-unit EWMA → remaining-time estimate. With a constant
    true per-unit cost the estimate converges monotonically (each update
    shrinks the error by ``1 - alpha``)."""

    def __init__(self, alpha: float = 0.4):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self._per: float | None = None
        self.updates = 0

    def update(self, seconds: float) -> None:
        self.updates += 1
        if self._per is None:
            self._per = float(seconds)
        else:
            self._per = self.alpha * float(seconds) + (1 - self.alpha) * self._per

    @property
    def seconds_per_unit(self) -> float | None:
        return self._per

    def eta(self, remaining: int | None) -> float | None:
        """Estimated seconds to finish ``remaining`` more units (None
        before the first update or without a known total)."""
        if self._per is None or remaining is None:
            return None
        return max(0.0, self._per * remaining)


# -------------------------------------------------------------- the recorder
class RunRecorder:
    """Flight recorder for one ``Workflow.train()`` call.

    The workflow installs it via :func:`recording`; ``workflow/fit.py``,
    ``workflow/cv.py`` and ``selector/validators.py`` pulse layer/fold/
    candidate boundaries through :func:`active_recorder`. All pulse
    methods are thread-safe (candidate sweeps run on a pool) and
    exception-contained — a recorder bug degrades the report, never the
    train. The clock is the injectable telemetry clock
    (``telemetry.spans.set_clock``) unless one is passed explicitly."""

    def __init__(
        self,
        clock: Callable[[], float] | None = None,
        progress: Callable[[dict], None] | None = None,
        run_id: str | None = None,
        eta_alpha: float = 0.4,
    ):
        self._clock = clock
        self.progress = progress
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self.started_unix = time.time()
        self._lock = threading.Lock()
        self._t0: float | None = None
        self._wall: float | None = None
        self.phases: dict[str, dict[str, Any]] = {}
        self.layers: list[dict[str, Any]] = []
        self.folds: list[dict[str, Any]] = []
        self.candidates: list[dict[str, Any]] = []
        self.eta = EtaEstimator(alpha=eta_alpha)
        self.quality: dict[str, Any] | None = None
        self.train_rows: int | None = None
        self._layer_t0: dict[int, tuple[float, float]] = {}
        self._fold_t0: dict[int, tuple[float, float]] = {}
        #: cumulative SIMULATED seconds injected by slow_stage chaos
        #: (resilience/faults.py) — they ride the observed phase/layer
        #: durations exactly like the serving path's breaker-elapsed
        #: convention, so chaos drives the regression sentinel with no
        #: real sleeps
        self._sim_total = 0.0
        self._mem_polls = 0
        self._mem_high: dict[str, Any] = {
            "backend": "unknown",
            "deviceBytesInUse": 0,
            "devicePeakBytes": 0,
            "liveArrayBytes": 0,
            "hostRssBytes": 0,
        }
        #: per-ingest-chunk memory samples (out-of-core fit) — bounded:
        #: past _CHUNK_SERIES_CAP the series decimates by doubling the
        #: sampling stride, so a million-chunk ingest still reports a
        #: few hundred points
        self._chunk_mem: list[dict[str, Any]] = []
        self._chunk_stride = 1
        self.stream: dict[str, Any] | None = None
        self._run_before: dict | None = None
        self._featurize_before: dict | None = None
        self._progress_warned = False

    # ---------------------------------------------------------------- clock
    def _now(self) -> float:
        return self._clock() if self._clock is not None else _tspans.clock()

    def elapsed(self) -> float:
        base = 0.0 if self._t0 is None else self._now() - self._t0
        return base + self._sim_total

    def add_simulated(self, seconds: float) -> None:
        """Fold slow-stage chaos seconds into the in-flight phase/layer
        timings (``FaultPlan.slow_stage`` — simulated, no real sleep)."""
        with self._lock:
            self._sim_total += float(seconds)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "RunRecorder":
        from ..featurize import stats as _fstats

        self._t0 = self._now()
        self._run_before = _STATS.snapshot()
        self._featurize_before = _fstats.snapshot()
        self.poll_memory()
        return self

    def poll_memory(self) -> dict[str, Any] | None:
        """Fold one device-memory + host-RSS poll into the run's
        high-water marks; returns the point-in-time sample."""
        try:
            now = poll_device_memory()
            now["hostRssBytes"] = poll_host_rss()
            with self._lock:
                self._mem_polls += 1
                if now["backend"] != "unknown":
                    self._mem_high["backend"] = now["backend"]
                for k in (
                    "deviceBytesInUse", "devicePeakBytes",
                    "liveArrayBytes", "hostRssBytes",
                ):
                    self._mem_high[k] = max(self._mem_high[k], now[k])
            return now
        except Exception as e:
            log.debug("run recorder memory poll failed: %s", e)
            return None

    _CHUNK_SERIES_CAP = 512

    def poll_chunk_memory(self, chunk_index: int) -> None:
        """One memory sample per ingest CHUNK (not just per phase/layer):
        the per-chunk series is the flatness evidence for the out-of-core
        fit — high-water must not grow with chunk count. Bounded: when
        the series hits the cap it decimates (keep every 2nd point,
        double the stride), so memory for the memory log stays O(cap)."""
        try:
            with self._lock:
                stride = self._chunk_stride
            if chunk_index % stride:
                return
            now = self.poll_memory()
            if now is None:
                return
            with self._lock:
                self._chunk_mem.append({
                    "chunk": int(chunk_index),
                    "deviceBytesInUse": now["deviceBytesInUse"],
                    "liveArrayBytes": now["liveArrayBytes"],
                    "hostRssBytes": now["hostRssBytes"],
                })
                if len(self._chunk_mem) >= self._CHUNK_SERIES_CAP:
                    self._chunk_mem = self._chunk_mem[::2]
                    self._chunk_stride *= 2
        except Exception as e:
            log.debug("run recorder chunk memory poll failed: %s", e)

    def set_stream_summary(self, summary: dict[str, Any]) -> None:
        """Attach the out-of-core ingest summary (workflow/stream.py) —
        chunk/quarantine/window accounting, minus the bulky fitStats."""
        try:
            self.stream = {
                k: v for k, v in summary.items() if k != "fitStats"
            }
        except Exception as e:
            log.debug("run recorder stream summary failed: %s", e)

    def _emit_progress(self, event: dict[str, Any]) -> None:
        if self.progress is None:
            return
        try:
            self.progress(event)
        except Exception as e:  # a user callback must never break training
            if not self._progress_warned:
                self._progress_warned = True
                log.warning("train progress callback failed: %s", e)

    # --------------------------------------------------------------- phases
    @contextlib.contextmanager
    def phase(self, name: str, rows: int | None = None) -> Iterator[None]:
        """Bracket one train phase: seconds + the compileStats /
        featurizeStats deltas attributable to it, a memory poll at the
        boundary, and a progress pulse."""
        from ..featurize import stats as _fstats

        t0 = self._now()
        sim0 = self._sim_total
        fb = _fstats.snapshot()
        try:
            yield
        finally:
            try:
                secs = self._now() - t0 + (self._sim_total - sim0)
                cd = no_compile_delta()
                fd = _fstats.delta(fb)
                cell: dict[str, Any] = {
                    "seconds": round(secs, 4),
                    "rows": rows,
                    "rowsPerSec": (
                        round(rows / secs) if rows and secs > 0 else None
                    ),
                    "compile": {
                        "programsCompiled": cd["programsCompiled"],
                        "cacheHits": cd["cacheHitsMemory"] + cd["cacheHitsDisk"],
                        "dedupHits": cd["dedupHits"],
                    },
                    "featurize": {
                        "rowsFeaturized": fd["rowsFeaturized"],
                        "stagesExecuted": fd["stagesExecuted"],
                        "poolTasks": fd["poolTasks"],
                    },
                }
                with self._lock:
                    prev = self.phases.get(name)
                    if prev is None:
                        self.phases[name] = cell
                    else:  # a re-entered phase (failover loop) accumulates
                        prev["seconds"] = round(prev["seconds"] + secs, 4)
                        if rows is not None:
                            prev["rows"] = rows
                        # throughput must track the ACCUMULATED seconds —
                        # a stale first-entry rows/s would overstate a
                        # failover-re-entered phase by the retry count
                        prev["rowsPerSec"] = (
                            round(prev["rows"] / prev["seconds"])
                            if prev.get("rows") and prev["seconds"] > 0
                            else None
                        )
                        for fam in ("compile", "featurize"):
                            for k, v in cell[fam].items():
                                prev[fam][k] += v
                self.poll_memory()
                self._emit_progress({
                    "event": "phase",
                    "phase": name,
                    "seconds": round(secs, 4),
                    "elapsed": round(self.elapsed(), 4),
                })
            except Exception as e:
                log.debug("run recorder phase(%s) failed: %s", name, e)

    def set_phase_rows(self, name: str, rows: int) -> None:
        with self._lock:
            cell = self.phases.get(name)
            if cell is not None:
                cell["rows"] = rows
                secs = cell["seconds"]
                cell["rowsPerSec"] = round(rows / secs) if secs > 0 else None

    # --------------------------------------------------------------- layers
    def on_layer_start(self, index: int, total: int | None = None) -> None:
        try:
            with self._lock:
                self._layer_t0[index] = (self._now(), self._sim_total)
        except Exception as e:
            log.debug("run recorder layer_start failed: %s", e)

    def on_layer_end(
        self,
        index: int,
        total: int | None = None,
        stages: int | None = None,
        rows: int | None = None,
    ) -> None:
        try:
            now = self._now()
            with self._lock:
                mark = self._layer_t0.pop(index, None)
                sim_now = self._sim_total
            secs = (
                0.0 if mark is None
                else now - mark[0] + (sim_now - mark[1])
            )
            self.eta.update(secs)
            remaining = None if total is None else max(0, total - index - 1)
            eta_s = self.eta.eta(remaining)
            with self._lock:
                self.layers.append({
                    "index": index,
                    "seconds": round(secs, 4),
                    "stages": stages,
                    "rows": rows,
                    "rowsPerSec": (
                        round(rows / secs) if rows and secs > 0 else None
                    ),
                })
            _STATS.bump("layersTimed")
            self.poll_memory()
            self._emit_progress({
                "event": "layer",
                "index": index,
                "total": total,
                "seconds": round(secs, 4),
                "secondsPerLayer": self.eta.seconds_per_unit,
                "etaSeconds": None if eta_s is None else round(eta_s, 4),
                "elapsed": round(self.elapsed(), 4),
            })
        except Exception as e:
            log.debug("run recorder layer_end failed: %s", e)

    # ---------------------------------------------------------------- folds
    def on_fold_start(self, fold: int, total: int | None = None) -> None:
        try:
            with self._lock:
                self._fold_t0[fold] = (self._now(), self._sim_total)
        except Exception as e:
            log.debug("run recorder fold_start failed: %s", e)

    def on_fold_end(
        self,
        fold: int,
        total: int | None = None,
        rows: int | None = None,
        sweep: dict | None = None,
    ) -> None:
        try:
            now = self._now()
            with self._lock:
                mark = self._fold_t0.pop(fold, None)
                sim_now = self._sim_total
            secs = (
                0.0 if mark is None
                else now - mark[0] + (sim_now - mark[1])
            )
            record = {
                "fold": fold,
                "seconds": round(secs, 4),
                "rows": rows,
                "rowsPerSec": (
                    round(rows / secs) if rows and secs > 0 else None
                ),
            }
            if sweep is not None:
                # fold-scoped lane occupancy / pad waste: the caller hands
                # the compileStats delta across its fold (workflow/cv.py),
                # so each fold record carries its own sweep accounting
                record["sweep"] = _sweep_summary(sweep)
            with self._lock:
                self.folds.append(record)
            _STATS.bump("foldsTimed")
            self._emit_progress({
                "event": "fold",
                "fold": fold,
                "total": total,
                "seconds": round(secs, 4),
                "elapsed": round(self.elapsed(), 4),
            })
        except Exception as e:
            log.debug("run recorder fold_end failed: %s", e)

    def on_candidate(
        self,
        model: str,
        points: int,
        seconds: float,
        rows: int | None = None,
        fold: int | None = None,
        error: str | None = None,
    ) -> None:
        """One candidate family's sweep (the selector's internal validator
        batches folds into one program; workflow CV pulses per fold)."""
        try:
            with self._lock:
                self.candidates.append({
                    "model": model,
                    "points": points,
                    "fold": fold,
                    "seconds": round(seconds, 4),
                    "rows": rows,
                    "rowsPerSec": (
                        round(rows / seconds) if rows and seconds > 0 else None
                    ),
                    "error": error,
                })
            _STATS.bump("candidatesTimed")
        except Exception as e:
            log.debug("run recorder candidate pulse failed: %s", e)

    # ------------------------------------------------------------- finalize
    def record_quality(self, metrics: dict[str, Any] | None) -> None:
        if metrics:
            self.quality = {
                k: v for k, v in metrics.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)
            }

    def finalize(self, train_rows: int | None = None) -> dict[str, Any]:
        """Freeze the run into its schema-versioned report (the unified
        bench envelope with the nested ``run`` payload)."""
        from ..featurize import stats as _fstats

        if train_rows is not None:
            self.train_rows = train_rows
        self._wall = self.elapsed()
        self.poll_memory()
        run_delta = delta(self._run_before or {})
        compile_delta = no_compile_delta()
        featurize_delta = _fstats.delta(self._featurize_before or {})
        _STATS.bump("runsRecorded")
        return build_report(
            self, run_delta, compile_delta, featurize_delta
        )


def _sweep_summary(compile_delta: dict) -> dict[str, Any]:
    """Sweep lane occupancy/pad-waste from the compileStats delta:
    ``record_sweep`` counts lanes-1 dedup hits per batched sweep and the
    inert pad lanes bucketing added, so occupancy ≈ useful lanes over
    dispatched lanes (approximate — unbucketed sweeps contribute no pad
    accounting)."""
    dedup = compile_delta.get("dedupHits", 0)
    pads = compile_delta.get("laneBucketPads", 0)
    sweeps = compile_delta.get("bucketedSweeps", 0)
    useful = dedup + sweeps  # lanes-1 per sweep + one lane-0 per padded sweep
    total = useful + pads
    return {
        "dedupHits": dedup,
        "laneBucketPads": pads,
        "bucketedSweeps": sweeps,
        "laneOccupancy": _tm.ratio(useful, total),
        "padWasteRatio": _tm.ratio(pads, total),
    }


def build_report(
    rec: RunRecorder,
    run_delta: dict,
    compile_delta: dict,
    featurize_delta: dict,
) -> dict[str, Any]:
    wall = rec._wall if rec._wall is not None else rec.elapsed()
    census = {
        "hostToDevice": {
            "count": run_delta["h2dTransfers"],
            "bytes": run_delta["h2dBytes"],
            "seconds": run_delta["h2dSeconds"],
        },
        "deviceToHost": {
            "count": run_delta["d2hTransfers"],
            "bytes": run_delta["d2hBytes"],
            "seconds": run_delta["d2hSeconds"],
        },
    }
    mem = dict(rec._mem_high)
    mem["polls"] = rec._mem_polls
    mem["highWaterBytes"] = max(
        mem["deviceBytesInUse"], mem["devicePeakBytes"]
    )
    if rec._chunk_mem:
        mem["chunkSeries"] = list(rec._chunk_mem)
        mem["chunkSeriesStride"] = rec._chunk_stride
    metrics: dict[str, Any] = {
        "wall_s": round(wall, 4),
        "train_rows": rec.train_rows,
        "layers": len(rec.layers),
        "folds": len(rec.folds),
        "candidates": len(rec.candidates),
        "programs_compiled": compile_delta.get("programsCompiled", 0),
        "compile_cache_hits": (
            compile_delta.get("cacheHitsMemory", 0)
            + compile_delta.get("cacheHitsDisk", 0)
        ),
        "sweep_dedup_lanes": compile_delta.get("dedupHits", 0),
        "sweep_pad_lanes": compile_delta.get("laneBucketPads", 0),
        "rows_featurized": featurize_delta.get("rowsFeaturized", 0),
        "h2d_transfers": census["hostToDevice"]["count"],
        "h2d_bytes": census["hostToDevice"]["bytes"],
        "d2h_transfers": census["deviceToHost"]["count"],
        "d2h_bytes": census["deviceToHost"]["bytes"],
        "device_high_water_bytes": mem["highWaterBytes"],
        "live_array_high_water_bytes": mem["liveArrayBytes"],
        "host_rss_high_water_bytes": mem["hostRssBytes"],
    }
    if rec.stream is not None:
        metrics["stream_chunks_folded"] = rec.stream.get("chunksFolded", 0)
        metrics["stream_chunks_quarantined"] = rec.stream.get(
            "quarantinedTotal", 0
        )
        metrics["stream_rows_seen"] = rec.stream.get("rowsSeen", 0)
    for name, cell in rec.phases.items():
        metrics[f"phase_{name}_s"] = cell["seconds"]
    if rec.quality:
        for k, v in rec.quality.items():
            metrics[f"quality_{k}"] = v
    return {
        # the unified bench-report envelope (bench.validate_bench_report
        # accepts this shape as-is)
        "schema_version": 1,
        "metric": "train_run_wallclock",
        "value": round(wall, 4),
        "unit": "s",
        "seed": None,
        "median_of": None,
        "metrics": metrics,
        "run": {
            "schemaVersion": RUN_SCHEMA_VERSION,
            "runId": rec.run_id,
            "startedUnix": round(rec.started_unix, 3),
            "wallSeconds": round(wall, 4),
            "trainRows": rec.train_rows,
            "phases": rec.phases,
            "layers": rec.layers,
            "folds": rec.folds,
            "candidates": rec.candidates,
            "eta": {
                "secondsPerLayer": rec.eta.seconds_per_unit,
                "updates": rec.eta.updates,
            },
            "compileStats": compile_delta,
            "featurizeStats": featurize_delta,
            "sweeps": _sweep_summary(compile_delta),
            "transferCensus": census,
            "deviceMemory": mem,
            "quality": rec.quality,
            # out-of-core ingest accounting — only when train streamed
            # (additive: validate_run_report checks it when present)
            **({"stream": rec.stream} if rec.stream is not None else {}),
        },
    }


# ------------------------------------------------------- active-recorder seam
_ACTIVE: list[RunRecorder] = []
_ACTIVE_LOCK = threading.Lock()


def active_recorder() -> RunRecorder | None:
    """The innermost installed recorder (None outside a recorded train)."""
    with _ACTIVE_LOCK:
        return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def recording(rec: RunRecorder) -> Iterator[RunRecorder]:
    """Install ``rec`` as the active recorder for the block (re-entrant:
    a nested train — the CV label-DAG refits — pulses the innermost)."""
    with _ACTIVE_LOCK:
        _ACTIVE.append(rec)
    try:
        yield rec
    finally:
        with _ACTIVE_LOCK:
            if rec in _ACTIVE:
                _ACTIVE.remove(rec)


# ---------------------------------------------------------------- persistence
def run_filename(report: dict[str, Any]) -> str:
    started = report.get("run", {}).get("startedUnix") or time.time()
    # millisecond-resolution stamp: two same-second runs must still sort
    # chronologically by NAME (list_run_reports / prev / last / the
    # auto-diff baseline all lean on that ordering)
    stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime(started))
    # truncate, never round: rounding a >=.9995 fraction would wrap to
    # 000 without carrying the second, sorting BEFORE earlier runs
    millis = min(999, int((started % 1.0) * 1000))
    run_id = report.get("run", {}).get("runId", "unknown")
    return f"{RUN_FILE_PREFIX}{stamp}{millis:03d}_{run_id}.json"


def save_run_report(report: dict[str, Any], run_dir: str) -> str:
    """Write one ``RUN_*.json`` artifact (filename recorded inside the
    report, so the diff surfaces can name their baseline); returns the
    path. The write is atomic (temp + rename), so a killed writer — or a
    concurrent ``runs`` CLI / ``latest_run_report`` reader — never
    observes a truncated document."""
    os.makedirs(run_dir, exist_ok=True)
    name = run_filename(report)
    report.setdefault("run", {})["file"] = name
    path = os.path.join(run_dir, name)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(report, fh, default=str)
        fh.write("\n")
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------- run reports
def load_run_report(path: str) -> dict[str, Any]:
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    problems = validate_run_report(doc)
    if problems:
        raise ValueError(f"{path}: not a valid run report: {problems}")
    return doc


def list_run_reports(run_dir: str) -> list[str]:
    """Paths of the directory's run artifacts, oldest first (the
    ``RUN_<utcstamp>_<id>.json`` names sort chronologically)."""
    if not os.path.isdir(run_dir):
        return []
    names = sorted(
        n for n in os.listdir(run_dir)
        if n.startswith(RUN_FILE_PREFIX) and n.endswith(".json")
    )
    return [os.path.join(run_dir, n) for n in names]


def latest_run_report(run_dir: str) -> dict[str, Any] | None:
    """The newest loadable run report in ``run_dir`` (skips unparseable
    files rather than failing the caller's train)."""
    for path in reversed(list_run_reports(run_dir)):
        try:
            return load_run_report(path)
        except Exception as e:
            log.warning("skipping unreadable run report %s: %s", path, e)
    return None


def validate_run_report(doc: Any) -> list[str]:
    """Problems with a run report (empty list = valid). Checks both the
    unified bench envelope and the nested ``run`` payload this module
    owns."""
    problems: list[str] = []
    if not isinstance(doc, dict):
        return [f"not a JSON object: {type(doc).__name__}"]
    if doc.get("schema_version") != 1:
        problems.append(f"bad schema_version {doc.get('schema_version')!r}")
    if doc.get("metric") != "train_run_wallclock":
        problems.append(f"bad metric {doc.get('metric')!r}")
    if not isinstance(doc.get("metrics"), dict):
        problems.append("missing 'metrics' map")
    run = doc.get("run")
    if not isinstance(run, dict):
        return problems + ["missing 'run' payload"]
    if run.get("schemaVersion") != RUN_SCHEMA_VERSION:
        problems.append(f"bad run.schemaVersion {run.get('schemaVersion')!r}")
    for key, types in (
        ("runId", str), ("wallSeconds", (int, float)), ("phases", dict),
        ("layers", list), ("transferCensus", dict), ("deviceMemory", dict),
        ("compileStats", dict), ("featurizeStats", dict),
    ):
        if not isinstance(run.get(key), types):
            problems.append(f"run.{key} missing or invalid")
    census = run.get("transferCensus")
    if isinstance(census, dict):
        for side in ("hostToDevice", "deviceToHost"):
            cell = census.get(side)
            if not isinstance(cell, dict) or not all(
                isinstance(cell.get(k), (int, float))
                for k in ("count", "bytes", "seconds")
            ):
                problems.append(f"run.transferCensus.{side} invalid")
    # out-of-core ingest block: additive, validated WHEN PRESENT
    stream = run.get("stream")
    if stream is not None:
        if not isinstance(stream, dict):
            problems.append("run.stream not a map")
        else:
            for key in ("chunksFolded", "rowsSeen", "quarantinedTotal"):
                if not isinstance(stream.get(key), int):
                    problems.append(f"run.stream.{key} missing or invalid")
    return problems


# --------------------------------------------------------------- run diffing
@dataclasses.dataclass
class RunTolerances:
    """Regression thresholds for :func:`diff_runs`. Ratios compare
    current/baseline; the absolute floors keep noise on tiny runs (a
    40 ms ingest doubling to 80 ms) from crying wolf."""

    phase_slowdown_ratio: float = 1.5
    phase_min_seconds: float = 0.25
    compile_blowup_ratio: float = 1.5
    compile_blowup_abs: int = 2
    transfer_growth_ratio: float = 1.5
    transfer_min_bytes: int = 1 << 20
    quality_drop: float = 0.02


#: quality-metric names (substring match) where LOWER is better — a drop
#: in these is an improvement, a rise a regression
_LOWER_IS_BETTER = ("rmse", "mse", "mae", "loss", "error", "brier")


def _quality_regressed(name: str, base: float, cur: float, tol: float) -> bool:
    lower_better = any(s in name.lower() for s in _LOWER_IS_BETTER)
    return (cur - base > tol) if lower_better else (base - cur > tol)


def _census_bytes(run: dict[str, Any]) -> int:
    c = run.get("transferCensus") or {}
    return int(
        (c.get("hostToDevice") or {}).get("bytes", 0)
        + (c.get("deviceToHost") or {}).get("bytes", 0)
    )


def diff_runs(
    baseline: dict[str, Any] | str,
    current: dict[str, Any] | str,
    tolerances: RunTolerances | None = None,
    emit_events: bool = True,
):
    """Compare two run reports; returns an
    :class:`~..analysis.findings.Report` whose findings are the
    TPR-coded regressions (per-phase slowdown TPR001, compile-count
    blowup TPR002, transfer-bytes growth TPR003, quality drop TPR004 —
    all WARNING severity: nothing is refused, the verdict is evidence).
    Each regression bumps the run ledger and, with ``emit_events``, lands
    one ``run_regression`` event in the structured log."""
    from ..analysis.findings import Report, Severity

    tol = tolerances or RunTolerances()
    base_doc = load_run_report(baseline) if isinstance(baseline, str) else baseline
    cur_doc = load_run_report(current) if isinstance(current, str) else current
    base = base_doc.get("run") or {}
    cur = cur_doc.get("run") or {}
    report = Report()

    # ---- TPR001: per-phase slowdowns
    base_phases = base.get("phases") or {}
    for name, cell in (cur.get("phases") or {}).items():
        b = base_phases.get(name)
        if b is None:
            continue
        bs, cs = float(b.get("seconds", 0.0)), float(cell.get("seconds", 0.0))
        # a zero-cost baseline phase growing real seconds is a slowdown
        # too (also the injectable-clock regime, where clean timings are
        # exactly zero and only simulated chaos seconds register)
        if cs > tol.phase_min_seconds and (
            bs <= 0.0 or cs > bs * tol.phase_slowdown_ratio
        ):
            ratio_s = f"{cs / bs:.2f}x" if bs > 0 else "from zero"
            report.add(
                "TPR001",
                f"phase '{name}' slowed {ratio_s} between runs "
                f"({bs:.3f}s -> {cs:.3f}s, tolerance "
                f"{tol.phase_slowdown_ratio:.2f}x)",
                subject=name,
                severity=Severity.WARNING,
                baselineSeconds=bs,
                currentSeconds=cs,
            )

    # ---- TPR002: compile-count blowups
    bc = int((base.get("compileStats") or {}).get("programsCompiled", 0))
    cc = int((cur.get("compileStats") or {}).get("programsCompiled", 0))
    if cc > max(bc * tol.compile_blowup_ratio, bc + tol.compile_blowup_abs):
        report.add(
            "TPR002",
            f"programs compiled blew up {bc} -> {cc} between runs — a "
            "cache/bucketing regression",
            subject="programsCompiled",
            severity=Severity.WARNING,
            baseline=bc,
            current=cc,
        )

    # ---- TPR003: transfer-bytes growth
    bb, cb = _census_bytes(base), _census_bytes(cur)
    if cb > tol.transfer_min_bytes and cb > max(
        bb * tol.transfer_growth_ratio, bb + tol.transfer_min_bytes
    ):
        report.add(
            "TPR003",
            f"host<->device transfer volume grew {bb} -> {cb} bytes "
            "between runs — a new boundary crossing in the hot path",
            subject="transferCensus",
            severity=Severity.WARNING,
            baselineBytes=bb,
            currentBytes=cb,
        )

    # ---- TPR004: quality drops
    base_q = base.get("quality") or {}
    for name, cv in (cur.get("quality") or {}).items():
        bv = base_q.get(name)
        if not isinstance(bv, (int, float)) or not isinstance(cv, (int, float)):
            continue
        if _quality_regressed(name, float(bv), float(cv), tol.quality_drop):
            report.add(
                "TPR004",
                f"quality metric '{name}' regressed {bv} -> {cv} "
                f"(tolerance {tol.quality_drop})",
                subject=name,
                severity=Severity.WARNING,
                baseline=float(bv),
                current=float(cv),
            )

    report.data["runDiff"] = {
        "baselineRunId": base.get("runId"),
        "currentRunId": cur.get("runId"),
        "baselineWallSeconds": base.get("wallSeconds"),
        "currentWallSeconds": cur.get("wallSeconds"),
        "regressions": len(report),
    }
    if report.findings:
        _STATS.bump("runRegressions", len(report.findings))
        if emit_events:
            _tevents.emit(
                "run_regression",
                baselineRunId=base.get("runId"),
                currentRunId=cur.get("runId"),
                codes=sorted({f.code for f in report.findings}),
                findings=len(report.findings),
            )
    return report


class RegressionSentinel:
    """Standing cross-run regression check: pin a baseline report (dict
    or path) and :meth:`check` each new run against it."""

    def __init__(
        self,
        baseline: dict[str, Any] | str,
        tolerances: RunTolerances | None = None,
    ):
        self.baseline = (
            load_run_report(baseline) if isinstance(baseline, str) else baseline
        )
        self.tolerances = tolerances or RunTolerances()

    def check(self, current: dict[str, Any] | str):
        """Diff ``current`` against the pinned baseline; returns the
        findings Report (``.ok`` is True — regressions are warnings — so
        callers gate on ``len(report)``)."""
        return diff_runs(self.baseline, current, self.tolerances)
