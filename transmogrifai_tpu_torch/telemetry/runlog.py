"""The run ledger's transfer census: :class:`RunStats`, a process-wide
:class:`~.metrics.LedgerCore` ledger (the ``run`` registry source)
counting the host<->device copies of scoring at run time. The fused
scoring graph records its one upload and its one download a batch here,
with the bytes it already counts (``compiler/fused.py``). The run
recorder, its reports, the cross-run diff and the regression sentinel,
whose counters the ledger also carries, are not ported yet
(``ROADMAP.md`` A12).
"""
from __future__ import annotations

from . import metrics as _tm

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


