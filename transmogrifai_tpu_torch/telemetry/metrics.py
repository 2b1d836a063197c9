"""Unified metrics registry — counters, gauges, exponential-bucket
histograms, and the shared snapshot/delta core under the process ledgers.

Before this module existed the repo carried three disconnected ad-hoc
ledgers (``compiler.stats`` compileStats, ``featurize.stats``
featurizeStats, the resilience/distributed failover counters), each with
its own hand-rolled lock + snapshot + ``delta()``. They keep their public
APIs, but now:

* each ledger subclasses :class:`LedgerCore`, which owns the counter dict
  and shares ONE process-wide re-entrant lock (``REGISTRY.lock``) — so a
  snapshot taken under :func:`snapshot_lock` is a consistent point-in-time
  view ACROSS ledgers (no torn cross-ledger counts under concurrent
  scoring);
* the duplicated per-key delta arithmetic lives here once
  (:func:`counter_delta` / :func:`float_delta` / :func:`named_delta` /
  :func:`ratio`);
* each ledger registers its ``snapshot`` as a registry *source*, which is
  how ``telemetry.render_prometheus()`` exposes every counter without the
  ledgers knowing anything about exposition formats.

The registry also owns the new first-class metrics: span-duration and
serve-path latency histograms (exponential buckets, interpolated
p50/p95/p99) recorded by ``telemetry.spans``.

Everything here is stdlib-only and thread-safe; the module is on the
list of subsystems that threads cross, so module-global mutations hold
a lock.
"""
from __future__ import annotations

import bisect
import threading
from typing import Any, Callable, Iterable, Sequence

from ..analysis import schedule as _schedule

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LedgerCore",
    "MetricsRegistry",
    "REGISTRY",
    "counter_delta",
    "exponential_buckets",
    "float_delta",
    "named_delta",
    "ratio",
    "snapshot_lock",
]


def exponential_buckets(
    start: float, factor: float, count: int
) -> tuple[float, ...]:
    """``count`` ascending upper bounds: start, start*factor, ... — the
    Prometheus-style exponential bucket ladder."""
    if start <= 0 or factor <= 1.0 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    out = []
    b = float(start)
    for _ in range(count):
        out.append(b)
        b *= factor
    return tuple(out)


#: default latency ladder: 10 µs ... ~429 s at ≤30% relative resolution
DEFAULT_BUCKETS = exponential_buckets(1e-5, 1.3, 68)


class Counter:
    """Monotonic counter (the registry lock serializes writers)."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = "", lock=None):
        self.name = name
        self.help = help
        # every in-package counter is registry-built and shares the
        # registry lock (what the tpc alias declares); a STANDALONE
        # construction gets its own traced node, so if one ever starts
        # ordering against real locks the schedule reconciler sees it
        if lock is None:
            lock = _schedule.make_lock("telemetry/metrics.py:Counter._lock")
        self._lock = lock
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Point-in-time value."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = "", lock=None):
        self.name = name
        self.help = help
        # registry-built gauges share the registry lock; see Counter
        if lock is None:
            lock = _schedule.make_lock("telemetry/metrics.py:Gauge._lock")
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Exponential-bucket histogram with interpolated quantiles.

    ``observe`` is O(log buckets) (bisect over precomputed bounds);
    ``quantile`` interpolates linearly inside the target bucket, so the
    estimate's relative error is bounded by the bucket growth factor."""

    __slots__ = (
        "name", "help", "labels", "bounds", "_counts", "_sum", "_count",
        "_lock",
    )

    def __init__(
        self,
        name: str,
        bounds: Sequence[float] = DEFAULT_BUCKETS,
        labels: dict[str, str] | None = None,
        help: str = "",
        lock=None,
    ):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.bounds = tuple(bounds)
        self._counts = [0] * (len(self.bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        # registry-built histograms share the registry lock; see Counter
        if lock is None:
            lock = _schedule.make_lock("telemetry/metrics.py:Histogram._lock")
        self._lock = lock

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def _quantile_from(
        self, counts: Sequence[int], total: int, q: float
    ) -> float | None:
        if total == 0:
            return None
        target = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c and cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                # the overflow bucket has no upper bound: report its floor
                hi = self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
                return lo + (hi - lo) * ((target - cum) / c)
            cum += c
        return self.bounds[-1]

    def quantile(self, q: float) -> float | None:
        """Interpolated quantile estimate (None when empty)."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
        return self._quantile_from(counts, total, q)

    def snapshot(self) -> dict[str, Any]:
        # one locked read feeds count, sum, AND all three quantiles, so a
        # concurrent observe() can never tear count vs quantiles
        with self._lock:
            counts = list(self._counts)
            count, total = self._count, self._sum
        return {
            "count": count,
            "sum": round(total, 6),
            "p50": self._quantile_from(counts, count, 0.50),
            "p95": self._quantile_from(counts, count, 0.95),
            "p99": self._quantile_from(counts, count, 0.99),
        }

    def bucket_counts(self) -> tuple[list[int], int, float]:
        """(cumulative bucket counts incl. +Inf, count, sum) — the
        Prometheus exposition shape."""
        with self._lock:
            counts = list(self._counts)
            count, total = self._count, self._sum
        cum = []
        running = 0
        for c in counts:
            running += c
            cum.append(running)
        return cum, count, total


class MetricsRegistry:
    """One process-wide home for metrics and ledger sources.

    ``lock`` is re-entrant and shared with every :class:`LedgerCore`, so
    ``with registry.lock:`` brackets a consistent multi-ledger snapshot."""

    def __init__(self) -> None:
        # the instrumented-lock seam (analysis/schedule.py): the literal
        # name is the static analyzer's canonical key for this lock, so
        # the dynamic lock-order graph reconciles against the static one
        self.lock = _schedule.make_lock(
            "telemetry/metrics.py:MetricsRegistry.lock", threading.RLock
        )
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[tuple, Histogram] = {}
        self._sources: dict[str, Callable[[], dict]] = {}

    # ------------------------------------------------------------- metrics
    def counter(self, name: str, help: str = "") -> Counter:
        with self.lock:
            got = self._counters.get(name)
            if got is None:
                got = self._counters[name] = Counter(name, help, self.lock)
            return got

    def gauge(self, name: str, help: str = "") -> Gauge:
        with self.lock:
            got = self._gauges.get(name)
            if got is None:
                got = self._gauges[name] = Gauge(name, help, self.lock)
            return got

    def histogram(
        self,
        name: str,
        labels: dict[str, str] | None = None,
        bounds: Sequence[float] = DEFAULT_BUCKETS,
        help: str = "",
    ) -> Histogram:
        key = (name, tuple(sorted((labels or {}).items())))
        with self.lock:
            got = self._histograms.get(key)
            if got is None:
                got = self._histograms[key] = Histogram(
                    name, bounds, labels, help, self.lock
                )
            return got

    def histograms_named(self, name: str) -> list[Histogram]:
        with self.lock:
            return [h for (n, _), h in self._histograms.items() if n == name]

    # ------------------------------------------------------------- sources
    def register_source(self, name: str, fn: Callable[[], dict]) -> None:
        """A source is a zero-arg callable returning a JSON-able counter
        mapping (a ledger snapshot). Re-registering a name replaces it."""
        with self.lock:
            self._sources[name] = fn

    def source_snapshots(self) -> dict[str, dict]:
        """Snapshot every registered source. The source callables run
        OUTSIDE the registry lock: sources reach into their subsystem's
        own locks (the standing service's, the load shedder's), and those
        subsystems take the registry lock on their hot paths (gauges,
        counters) — invoking sources under the registry lock is an ABBA
        deadlock with any concurrent submit/update. Each ledger source
        still snapshots consistently under its own lock; only
        cross-source simultaneity is (harmlessly) approximate."""
        with self.lock:
            items = list(self._sources.items())
        out: dict[str, dict] = {}
        for name, fn in items:
            try:
                out[name] = fn()
            except Exception:  # a dead source must not kill exposition
                out[name] = {}
        return out

    # ------------------------------------------------------------ snapshot
    def snapshot_all(self) -> dict[str, Any]:
        """JSON-able view of everything the registry knows. Metrics are
        read under the shared lock (one consistent point in time); source
        snapshots run after it, outside the lock (see
        :meth:`source_snapshots` — each source is internally consistent
        under its own lock)."""
        with self.lock:
            out: dict[str, Any] = {
                "counters": {
                    n: c.value for n, c in sorted(self._counters.items())
                },
                "gauges": {
                    n: g.value for n, g in sorted(self._gauges.items())
                },
                "histograms": [
                    {"name": h.name, "labels": dict(h.labels), **h.snapshot()}
                    for _, h in sorted(self._histograms.items())
                ],
            }
        out["sources"] = self.source_snapshots()
        return out

    def reset_metrics_for_tests(self) -> None:
        """Drop counters/gauges/histograms (sources stay registered)."""
        with self.lock:
            self._counters = {}
            self._gauges = {}
            self._histograms = {}


REGISTRY = MetricsRegistry()


def snapshot_lock():
    """The shared re-entrant snapshot lock: ``with snapshot_lock():``
    brackets a consistent point-in-time read across every registered
    ledger (their recorders serialize on the same lock)."""
    return REGISTRY.lock


# ---------------------------------------------------------------- ledger core
class LedgerCore:
    """Shared base of the process-wide counter ledgers.

    Owns the counter dict + the registry's shared lock; subclasses keep
    their recording helpers and their snapshot shapes (which are pinned by
    existing tests), but the snapshot/delta arithmetic lives in the
    module-level helpers below instead of three hand-rolled copies."""

    def __init__(
        self, counter_keys: Iterable[str], registry: MetricsRegistry | None = None
    ) -> None:
        reg = registry if registry is not None else REGISTRY
        self._lock = reg.lock
        self._keys = tuple(counter_keys)
        self._counts: dict[str, int] = {k: 0 for k in self._keys}

    def bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[key] += n

    def _reset_counts(self) -> None:
        """Caller holds ``self._lock``."""
        self._counts = {k: 0 for k in self._keys}


# ------------------------------------------------------------- delta helpers
def counter_delta(
    now: dict, before: dict, keys: Iterable[str]
) -> dict[str, int]:
    """Per-key integer difference — the shared core of every ledger
    ``delta()``."""
    return {k: now[k] - before.get(k, 0) for k in keys}


def float_delta(
    now: dict, before: dict, key: str, ndigits: int = 3
) -> float:
    return round(now[key] - before.get(key, 0.0), ndigits)


def named_delta(now: dict, before: dict) -> dict:
    """Difference of two ``{name: count}`` maps, dropping zero entries."""
    return {
        name: n - before.get(name, 0)
        for name, n in now.items()
        if n - before.get(name, 0)
    }


def ratio(num: float, denom: float, ndigits: int = 4) -> float | None:
    """Rounded ``num/denom``; None for an empty denominator (the ledgers'
    rate convention — 'no acquisitions yet' must not read as 0%)."""
    return round(num / denom, ndigits) if denom else None
