"""``featurizeStats``: the featurize plane's process-wide ledger, the port
of the JAX package's ``featurize/stats.py``.

One thread-safe counter object records every featurization event: rows
pushed through vectorizer stages (with per-stage wall-clock, so the
summary can report rows/s per stage), bytes assembled into output
matrices, fused-assembly buffers that skipped the combiner copy, pool
tasks with their busy seconds (utilization = busy / (wall x workers)),
interning builds (native or the Python dict interner), Python-route
kernel calls and stale-library kernels.

The port builds its native library from its source's hash
(``native.py``), so a library can never predate a kernel:
``staleLibraryKernels`` stays 0 by construction and is kept for the
reference's key set.

Counters are cumulative per process. A consumer that wants a per-phase
view (the model selector's summary, ``Workflow.train()``) takes a
``snapshot()`` before and reports ``delta(before)`` after. The counters
sit under one lock of their own, where the reference shares
``telemetry.metrics.LedgerCore`` with its other ledgers. The ledger
registers itself as the ``featurize`` source of the metrics registry, so
``telemetry.render_prometheus()`` exposes it as the reference's does.
"""
from __future__ import annotations

import threading

from ..telemetry import metrics as _tm

_COUNTER_KEYS = (
    "rowsFeaturized",        # rows through instrumented vectorizer stages
    "bytesAssembled",        # bytes written into assembled output blocks
    "stagesExecuted",        # instrumented stage transform calls
    "fusedAssemblies",       # stage outputs written into a shared fusion
                             # buffer (combiner concat skipped)
    "fusedBytes",            # bytes that skipped the combiner copy
    "poolTasks",             # chunk tasks executed on the featurize pool
    "chunkedStages",         # stage transforms split across row chunks
    "internNativeBuilds",    # token/value interning served by the library
    "internFallbackBuilds",  # interning built by the Python dict path
    "fallbackKernels",       # Python-route kernel invocations
    "staleLibraryKernels",   # kernels missing from a stale library
)


def _ratio(num: float, denom: float, ndigits: int = 4) -> float | None:
    """Rounded ``num/denom``; None for an empty denominator."""
    return round(num / denom, ndigits) if denom else None


def _named_delta(now: dict, before: dict) -> dict:
    """Difference of two ``{name: count}`` maps, dropping zero entries."""
    return {
        name: n - before.get(name, 0)
        for name, n in now.items()
        if n - before.get(name, 0)
    }


class FeaturizeStats:
    """Thread-safe counters (one lock over the counter dict); per-stage
    rows/seconds and pool busy/wall seconds ride along as floats."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {k: 0 for k in _COUNTER_KEYS}
        #: operation name -> [rows, seconds]: rows/s per stage kind
        self._stage: dict[str, list[float]] = {}
        self._fallback_by_kernel: dict[str, int] = {}
        self._pool_busy_s = 0.0
        self._pool_wall_s = 0.0
        self._pool_workers = 0

    # ------------------------------------------------------------ recording
    def record_stage(
        self, name: str, rows: int, seconds: float, out_bytes: int = 0
    ) -> None:
        with self._lock:
            self._counts["stagesExecuted"] += 1
            self._counts["rowsFeaturized"] += rows
            self._counts["bytesAssembled"] += out_bytes
            cell = self._stage.setdefault(name, [0.0, 0.0])
            cell[0] += rows
            cell[1] += seconds

    def record_fused(self, out_bytes: int) -> None:
        with self._lock:
            self._counts["fusedAssemblies"] += 1
            self._counts["fusedBytes"] += out_bytes

    def record_pool(
        self, tasks: int, busy_s: float, wall_s: float, workers: int
    ) -> None:
        with self._lock:
            self._counts["poolTasks"] += tasks
            self._counts["chunkedStages"] += 1
            self._pool_busy_s += busy_s
            self._pool_wall_s += wall_s
            self._pool_workers = max(self._pool_workers, workers)

    def record_intern(self, native: bool) -> None:
        key = "internNativeBuilds" if native else "internFallbackBuilds"
        with self._lock:
            self._counts[key] += 1

    def count_fallback(self, kernel: str) -> None:
        with self._lock:
            self._counts["fallbackKernels"] += 1
            self._fallback_by_kernel[kernel] = (
                self._fallback_by_kernel.get(kernel, 0) + 1
            )

    # ------------------------------------------------------------ reporting
    def snapshot(self) -> dict:
        """JSON-able view. ``poolUtilization`` is busy seconds over
        wall x workers; ``stageRowsPerSec`` reports per-operation
        throughput."""
        with self._lock:
            out: dict = dict(self._counts)
            out["poolBusySeconds"] = round(self._pool_busy_s, 3)
            out["poolWallSeconds"] = round(self._pool_wall_s, 3)
            out["poolWorkers"] = self._pool_workers
            out["fallbacksByKernel"] = dict(self._fallback_by_kernel)
            out["staleKernels"] = []  # a hash-keyed library is never stale
            stage = {
                name: {
                    "rows": int(rows),
                    "seconds": round(sec, 4),
                    "rowsPerSec": round(rows / sec) if sec > 0 else None,
                }
                for name, (rows, sec) in sorted(self._stage.items())
            }
        out["stageRowsPerSec"] = stage
        out["poolUtilization"] = _pool_utilization(out)
        return out


def _pool_utilization(counts: dict) -> float | None:
    denom = counts["poolWallSeconds"] * max(counts["poolWorkers"], 1)
    return _ratio(counts["poolBusySeconds"], denom) if denom > 0 else None


_STATS = FeaturizeStats()
_tm.REGISTRY.register_source("featurize", _STATS.snapshot)


def stats() -> FeaturizeStats:
    return _STATS


def snapshot() -> dict:
    return _STATS.snapshot()


def delta(before: dict) -> dict:
    """Per-phase view: the current snapshot minus an earlier
    ``snapshot()`` (utilization recomputed from the deltas)."""
    now = _STATS.snapshot()
    out: dict = {k: now[k] - before.get(k, 0) for k in _COUNTER_KEYS}
    for k in ("poolBusySeconds", "poolWallSeconds"):
        out[k] = round(now[k] - before.get(k, 0.0), 3)
    out["poolWorkers"] = now["poolWorkers"]
    before_stage = before.get("stageRowsPerSec", {})
    stage = {}
    for name, cell in now["stageRowsPerSec"].items():
        prev = before_stage.get(name, {})
        rows = cell["rows"] - prev.get("rows", 0)
        sec = round(cell["seconds"] - prev.get("seconds", 0.0), 4)
        if rows or sec:
            stage[name] = {
                "rows": rows,
                "seconds": sec,
                "rowsPerSec": round(rows / sec) if sec > 0 else None,
            }
    out["stageRowsPerSec"] = stage
    out["fallbacksByKernel"] = _named_delta(
        now["fallbacksByKernel"], before.get("fallbacksByKernel", {})
    )
    out["staleKernels"] = now["staleKernels"]
    out["poolUtilization"] = _pool_utilization(out)
    return out
