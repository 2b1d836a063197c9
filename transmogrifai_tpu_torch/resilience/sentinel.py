"""Serving sentinels: schema validation, quarantine, drift, circuit breaking.

The serving closure built by ``local.scoring.score_function`` faces the
failure modes the model-serving literature isolates (PAPERS.md: Clipper's
per-model fault isolation, TFX's training/serving skew detection):

* **SchemaSentinel** — validates/coerces every incoming row against the
  model's raw-feature schema, with a configurable action per violation
  class (``missing`` / ``wrong_type`` / ``non_finite`` / ``unparseable``):
  ``coerce``, ``default``, ``quarantine``, ``raise``, or ``allow``;
* **QuarantineLog** — per-row error records (row index, feature, reason)
  for rows that failed validation or poisoned a stage; the row is replaced
  by the default prediction so the rest of the batch scores;
* **DriftSentinel** — compares a sliding window of serve-time values per
  raw feature (fill rate + ``StreamingHistogram``) against the training
  profiles captured by ``Workflow.train()`` (fill-rate ratio and
  Jensen-Shannon divergence — the RawFeatureFilter drift rules, applied
  continuously at serve time instead of once before training);
* **CircuitBreaker** — closed/open/half-open per scoring stage: after K
  consecutive failures the stage short-circuits to default predictions
  until a half-open probe succeeds; an optional per-stage deadline
  (injectable clock) counts overruns as failures.

Everything surfaces counters through ``score_fn.metadata()`` and is
deterministically testable through ``resilience.faults`` hooks.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time
from collections import Counter, deque
from typing import Any, Callable, Iterable

import numpy as np

from ..analysis import schedule as _schedule
from ..telemetry import events as _tevents
from ..types import Storage
from ..utils.streaming_histogram import StreamingHistogram, histogram_from_values

log = logging.getLogger(__name__)

#: violation-policy actions
ACTIONS = ("allow", "coerce", "default", "quarantine", "raise")


class SchemaViolationError(ValueError):
    """A row violated the raw-feature schema under action='raise'."""


@dataclasses.dataclass(frozen=True)
class QuarantineRecord:
    """One quarantined row: which row, which feature/stage, and why."""

    index: int
    feature: str
    kind: str      # missing | wrong_type | non_finite | unparseable | stage
    reason: str


@dataclasses.dataclass
class SentinelPolicy:
    """Action per violation class. Defaults preserve the historical codec
    semantics as closely as possible while never killing a batch: absent
    keys score as missing, parseable strings coerce, NaN/Inf become
    missing, and truly unparseable values quarantine the row (previously
    they raised out of ``score_batch`` and killed all n rows)."""

    missing: str = "default"
    wrong_type: str = "coerce"
    non_finite: str = "default"
    unparseable: str = "quarantine"

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v not in ACTIONS:
                raise ValueError(
                    f"unknown action {v!r} for {f.name} (one of {ACTIONS})"
                )

    @classmethod
    def off(cls) -> "SentinelPolicy":
        """Validation fully disabled (every class allowed through)."""
        return cls("allow", "allow", "allow", "allow")

    def action_for(self, kind: str) -> str:
        return getattr(self, kind)


_NUMERIC_STORAGES = (Storage.REAL, Storage.INTEGRAL, Storage.DATE)


def _inspect_value(ftype: type, v: Any) -> tuple[str | None, Any]:
    """Classify one value against a feature type.

    Returns ``(violation_kind | None, coerced_value)`` where
    ``coerced_value`` is the repaired value when coercion is possible and
    the sentinel marker ``_UNCOERCIBLE`` when it is not."""
    storage = ftype.storage
    if storage in _NUMERIC_STORAGES:
        # exact type checks + math.isfinite first: this runs per value on
        # the serving batch hot loop, and isinstance/np.isfinite chains
        # cost ~3x as much as the whole codec for clean numeric rows
        tv = type(v)
        if tv is float:
            if not math.isfinite(v):
                return "non_finite", None
            if storage is Storage.REAL:
                return None, v
            if v.is_integer():
                return None, v
            # fractional float on an integer-typed feature: same verdict
            # as the string "3.7" — the codec would silently truncate it
            return "unparseable", _UNCOERCIBLE
        if tv is int or tv is bool:
            return None, v
        if isinstance(v, (np.integer, np.bool_)):
            return None, v
        if isinstance(v, np.floating):
            if not np.isfinite(v):
                return "non_finite", None
            if storage is not Storage.REAL and not float(v).is_integer():
                return "unparseable", _UNCOERCIBLE
            return None, v
        if isinstance(v, str):
            s = v.strip()
            if s == "":
                return "missing", None
            try:
                parsed = float(s)
            except ValueError:
                return "unparseable", _UNCOERCIBLE
            if not math.isfinite(parsed):
                return "non_finite", None
            if storage is Storage.REAL:
                return "wrong_type", parsed
            if parsed.is_integer():
                return "wrong_type", int(parsed)
            return "unparseable", _UNCOERCIBLE
        return "wrong_type", _UNCOERCIBLE
    if storage is Storage.BINARY:
        if isinstance(v, (bool, np.bool_)):
            return None, bool(v)
        if isinstance(v, (int, float, np.integer, np.floating)):
            if isinstance(v, (float, np.floating)) and not math.isfinite(v):
                return "non_finite", None
            return "wrong_type", bool(v)
        if isinstance(v, str):
            # only recognized tokens coerce — arbitrary garbage must NOT
            # silently score as a legitimate False signal
            from ..types.columns import FALSE_TOKENS, TRUE_TOKENS

            s = v.strip().lower()
            if s == "":
                return "missing", None
            if s in TRUE_TOKENS:
                return "wrong_type", True
            if s in FALSE_TOKENS:
                return "wrong_type", False
            return "unparseable", _UNCOERCIBLE
        return "wrong_type", _UNCOERCIBLE
    if storage is Storage.TEXT:
        if isinstance(v, str):
            return None, v
        if isinstance(v, (int, float, bool, np.integer, np.floating)):
            return "wrong_type", str(v)
        return "wrong_type", _UNCOERCIBLE
    if storage is Storage.TEXT_SET:
        if isinstance(v, (set, frozenset, list, tuple, str)):
            return None, v  # the codec accepts all of these
        return "wrong_type", _UNCOERCIBLE
    if storage is Storage.TEXT_LIST:
        if isinstance(v, (list, tuple)):
            return None, v
        if isinstance(v, str):
            # the raw codec would explode a bare string into characters —
            # a single-element list is what the producer meant
            return "wrong_type", [v]
        return "wrong_type", _UNCOERCIBLE
    if storage in (Storage.DATE_LIST, Storage.GEO):
        if isinstance(v, (list, tuple)):
            return None, v
        return "wrong_type", _UNCOERCIBLE
    if storage is Storage.MAP:
        if isinstance(v, dict):
            return None, v
        return "wrong_type", _UNCOERCIBLE
    if storage is Storage.VECTOR:
        if isinstance(v, (list, tuple, np.ndarray)):
            return None, v
        return "wrong_type", _UNCOERCIBLE
    return None, v


_UNCOERCIBLE = object()


class SchemaSentinel:
    """Row-dict validation against the model's raw-feature schema.

    ``check_row(row)`` returns ``(sanitized_row, quarantine_reasons)``:
    the sanitized row shares the original dict unless a value had to
    change (copy-on-write), and ``quarantine_reasons`` is a list of
    ``(feature, kind, reason)`` triples — non-empty means the row must be
    quarantined. Response features are never validated (serving rows
    legitimately lack labels). Every non-``allow`` violation is counted in
    ``counts`` (by kind) and ``by_feature``; counter mutations hold the
    instance lock (the registry-lock treatment), so concurrent service
    workers sharing one sentinel never lose increments."""

    def __init__(
        self,
        raw_features: Iterable[Any],
        policy: SentinelPolicy | None = None,
        per_feature: dict[str, SentinelPolicy] | None = None,
    ):
        self.policy = policy if policy is not None else SentinelPolicy()
        self.per_feature = dict(per_feature or {})
        self._fields = [
            (f.name, f.ftype) for f in raw_features if not f.is_response
        ]
        self._lock = _schedule.make_lock(
            "resilience/sentinel.py:SchemaSentinel._lock"
        )
        self.counts: Counter[str] = Counter()
        self.by_feature: Counter[str] = Counter()
        self.rows_seen = 0

    def _policy_for(self, name: str) -> SentinelPolicy:
        return self.per_feature.get(name, self.policy)

    def check_row(
        self, row: dict[str, Any]
    ) -> tuple[dict[str, Any], list[tuple[str, str, str]]]:
        with self._lock:
            self.rows_seen += 1
        out = row
        quarantine: list[tuple[str, str, str]] = []
        for name, ftype in self._fields:
            v = row.get(name)
            if v is None:
                kind: str | None = "missing"
                coerced: Any = None
            else:
                kind, coerced = _inspect_value(ftype, v)
            if kind is None:
                continue
            action = self._policy_for(name).action_for(kind)
            if action == "coerce" and (
                kind == "missing" or coerced is _UNCOERCIBLE
            ):
                # nothing to coerce a missing key from; an uncoercible value
                # escalates to the unparseable action
                action = (
                    "default" if kind == "missing"
                    else self._policy_for(name).action_for("unparseable")
                )
            if action == "allow":
                continue
            if kind == "missing" and action == "default":
                # a legitimately absent optional field is normal sparsity
                # (the codec already reads it as missing): no copy, and no
                # violation counted — fill-rate monitoring is the drift
                # sentinel's job, and real violations must not drown in it
                continue
            with self._lock:
                self.counts[kind] += 1
                self.by_feature[name] += 1
            reason = f"{kind}: {_describe(v)} for {ftype.__name__}"
            if action == "raise":
                raise SchemaViolationError(f"feature '{name}' — {reason}")
            if action == "quarantine":
                quarantine.append((name, kind, reason))
                continue
            # default / coerce both repair in place
            fixed = None if action == "default" else coerced
            if fixed is _UNCOERCIBLE:
                fixed = None
            if out is row:
                out = dict(row)
            out[name] = fixed
        return out, quarantine

    def check_rows(
        self, rows: list[dict[str, Any]]
    ) -> list[tuple[dict[str, Any], list[tuple[str, str, str]]]]:
        """Batch twin of ``check_row`` — identical verdicts, counters,
        coercions and raise order, without per-(row, field) Python for
        clean batches.

        Strategy: a TYPE CENSUS per field (one C-speed ``set(map(type,
        column))``) proves most columns can't violate anything; numeric
        columns additionally get vectorized NaN/Inf/fractional checks.
        Only rows flagged as possibly-violating re-run the exact
        ``check_row`` (in row order, so an escalating ``raise`` fires on
        the same row and field it always did)."""
        n = len(rows)
        flagged = np.zeros(n, dtype=bool)
        for name, ftype in self._fields:
            vals = [r.get(name) for r in rows]
            census = set(map(type, vals))
            miss_action = self._policy_for(name).action_for("missing")
            flag_missing = miss_action in ("raise", "quarantine")
            storage = ftype.storage
            clean_types = _CENSUS_CLEAN.get(storage)
            if clean_types is not None and census <= clean_types:
                if census & _NUMERIC_CHECKED:
                    # census-clean numerics still need the value checks:
                    # NaN/Inf, and fractional floats on integer storages
                    try:
                        arr = np.asarray(
                            [v if v is not None else np.nan for v in vals],
                            dtype=np.float64,
                        )
                    except (OverflowError, TypeError, ValueError):
                        # e.g. an int beyond float64 range next to floats:
                        # can't vectorize — exact per-row re-check instead
                        arr = None
                        flagged |= np.fromiter(
                            (v is not None for v in vals), bool, n
                        )
                    if arr is not None:
                        bad = ~np.isfinite(arr)
                        if storage in _NUMERIC_STORAGES:
                            if storage is not Storage.REAL:
                                with np.errstate(invalid="ignore"):
                                    bad |= arr != np.floor(arr)
                            flagged |= bad & np.fromiter(
                                (v is not None for v in vals), bool, n
                            )
                if flag_missing:
                    flagged |= np.fromiter(
                        (v is None for v in vals), bool, n
                    )
            else:
                # unknown storage / off-census types: flag every row whose
                # value could possibly violate (off-census type, a value
                # needing the numeric checks, or a non-defaulting missing)
                # — flagged rows re-run the EXACT per-row check, so a
                # spurious flag costs time, never correctness
                ct = clean_types or frozenset()
                flagged |= np.fromiter(
                    (
                        (v is None and flag_missing)
                        or (
                            v is not None
                            and (
                                type(v) not in ct
                                or type(v) in _NUMERIC_CHECKED
                            )
                        )
                        for v in vals
                    ),
                    bool, n,
                )
        out = []
        clean_run = 0  # clean rows count in bulk — one lock per run
        for i, row in enumerate(rows):
            if flagged[i]:
                if clean_run:
                    with self._lock:
                        self.rows_seen += clean_run
                    clean_run = 0
                out.append(self.check_row(row))
            else:
                clean_run += 1
                out.append((row, []))
        if clean_run:
            with self._lock:
                self.rows_seen += clean_run
        return out

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "rowsSeen": self.rows_seen,
                "violations": dict(self.counts),
                "byFeature": dict(self.by_feature),
            }


#: per-storage type sets that can never produce a violation worse than
#: "missing" under check_row's classification (numerics still get value
#: checks); anything off-census re-runs the exact per-row path
_SAFE_NUMERIC_TYPES = frozenset({
    float, int, bool, type(None),
    np.float64, np.float32, np.float16,
    np.int64, np.int32, np.int16, np.int8,
    np.uint64, np.uint32, np.uint16, np.uint8, np.bool_,
})
#: types whose VALUES (not just types) need the vectorized numeric checks
_NUMERIC_CHECKED = frozenset({
    float, np.float64, np.float32, np.float16,
})
_CENSUS_CLEAN: dict[Any, frozenset] = {
    Storage.REAL: _SAFE_NUMERIC_TYPES,
    Storage.INTEGRAL: _SAFE_NUMERIC_TYPES,
    Storage.DATE: _SAFE_NUMERIC_TYPES,
    Storage.BINARY: frozenset({bool, np.bool_, type(None)}),
    Storage.TEXT: frozenset({str, type(None)}),
    Storage.TEXT_SET: frozenset(
        {set, frozenset, list, tuple, str, type(None)}
    ),
    Storage.TEXT_LIST: frozenset({list, tuple, type(None)}),
    Storage.DATE_LIST: frozenset({list, tuple, type(None)}),
    Storage.GEO: frozenset({list, tuple, type(None)}),
    Storage.MAP: frozenset({dict, type(None)}),
    Storage.VECTOR: frozenset({list, tuple, np.ndarray, type(None)}),
}


def _describe(v: Any) -> str:
    r = repr(v)
    return f"{type(v).__name__} {r[:40]}{'…' if len(r) > 40 else ''}"


class QuarantineLog:
    """Cumulative + per-batch quarantine records (bounded memory).

    Records are per (row, feature) — a row violating two features yields
    two records — but ``quarantinedRows`` counts distinct ROWS, so the
    counter matches "k bad rows" exactly.

    Thread-safe: cumulative counters mutate under the instance lock, and
    the per-batch view (``last`` / ``batch_rows``) is THREAD-LOCAL — each
    service worker scores its own batch, so "this batch's records" must
    mean "this thread's batch", not whichever batch last called
    ``start_batch`` anywhere in the process."""

    def __init__(self, keep: int = 1000):
        self.keep = keep
        self._lock = _schedule.make_lock(
            "resilience/sentinel.py:QuarantineLog._lock"
        )
        self.records: deque[QuarantineRecord] = deque(maxlen=keep)
        self.total_rows = 0
        self.total_records = 0
        self.by_kind: Counter[str] = Counter()
        self._tls = threading.local()

    @property
    def last(self) -> list[QuarantineRecord]:
        """This thread's current-batch records (empty before any batch)."""
        return getattr(self._tls, "last", [])

    def batch_rows(self) -> set[int]:
        """Distinct row indices quarantined in this thread's batch."""
        return set(getattr(self._tls, "rows", ()))

    def start_batch(self) -> None:
        self._tls.last = []
        self._tls.rows = set()

    def add(self, rec: QuarantineRecord) -> None:
        batch_last = getattr(self._tls, "last", None)
        if batch_last is None:  # add() without start_batch(): direct use
            batch_last = self._tls.last = []
            self._tls.rows = set()
        batch_last.append(rec)
        new_row = rec.index not in self._tls.rows
        if new_row:
            self._tls.rows.add(rec.index)
        with self._lock:
            self.records.append(rec)
            self.total_records += 1
            self.by_kind[rec.kind] += 1
            if new_row:
                self.total_rows += 1

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "quarantinedRows": self.total_rows,
                "records": self.total_records,
                "lastBatch": len(self.last),
                "byKind": dict(self.by_kind),
            }


# ------------------------------------------------------------ circuit breaker
@dataclasses.dataclass
class BreakerConfig:
    """Shared configuration for the per-stage breakers. The clock is
    injectable (same seam as ``RetryPolicy``) so open→half-open recovery is
    testable without real sleeps."""

    failure_threshold: int = 5
    recovery_time: float = 30.0
    deadline: float | None = None  # seconds per stage execution
    clock: Callable[[], float] = time.monotonic


class CircuitBreaker:
    """Closed / open / half-open breaker for one scoring stage.

    ``allow()`` gates execution: closed passes, open short-circuits until
    ``recovery_time`` has elapsed, half-open admits EXACTLY ONE probe at a
    time — concurrent callers racing the recovery window short-circuit
    until the in-flight probe reports back (two service workers sharing a
    breaker must not both hammer a still-broken stage).
    ``record_success``/``record_failure`` drive the transitions; K
    *consecutive* failures open the breaker, a successful probe closes
    it, a failed probe re-opens it. All state moves under the instance
    lock, so transition counters stay exact under concurrent scoring."""

    def __init__(self, name: str, config: BreakerConfig):
        self.name = name
        self.config = config
        self._lock = _schedule.make_lock(
            "resilience/sentinel.py:CircuitBreaker._lock"
        )
        self.state = "closed"
        self.consecutive_failures = 0
        self.opened_at: float | None = None
        self.short_circuits = 0
        self.deadline_overruns = 0
        self.probe_in_flight = False
        self.transitions: Counter[str] = Counter()

    def _to(self, state: str) -> None:
        """Caller holds the lock."""
        self.transitions[f"{self.state}->{state}"] += 1
        _tevents.emit(
            "breaker_transition", stage=self.name,
            transition=f"{self.state}->{state}",
            consecutiveFailures=self.consecutive_failures,
        )
        self.state = state

    def allow(self) -> bool:
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                now = self.config.clock()
                if (
                    self.opened_at is not None
                    and now - self.opened_at >= self.config.recovery_time
                ):
                    self._to("half_open")
                    self.probe_in_flight = True
                    return True
                self.short_circuits += 1
                return False
            # half_open: one probe at a time; racers short-circuit
            if self.probe_in_flight:
                self.short_circuits += 1
                return False
            self.probe_in_flight = True
            return True

    def release_probe(self) -> None:
        """Abandon an in-flight half-open probe WITHOUT recording an
        outcome (the caller is unwinding past the stage on an exception
        that is not the stage's failure — e.g. a deadline rejection or a
        guard escalation). The breaker stays half-open and the next
        caller may claim the probe slot."""
        with self._lock:
            self.probe_in_flight = False

    def would_short_circuit(self) -> bool:
        """Pure peek at ``allow()`` — no transition, no counter. Used by
        the per-row isolation re-runs, which must skip open-breaker stages
        without consuming the half-open probe or counting short-circuits."""
        return self.state == "open" and (
            self.opened_at is None
            or self.config.clock() - self.opened_at < self.config.recovery_time
        )

    def record_success(self) -> None:
        with self._lock:
            self.probe_in_flight = False
            if self.state == "half_open":
                self._to("closed")
                log.info(
                    "breaker %s recovered (half-open probe ok)", self.name
                )
            self.consecutive_failures = 0

    def record_failure(self, overrun: bool = False) -> None:
        """``overrun=True`` counts a per-stage deadline overrun (treated
        as a failure) — folded in here so the overrun counter mutates
        under the same lock as the rest of the breaker state."""
        with self._lock:
            self.probe_in_flight = False
            if overrun:
                self.deadline_overruns += 1
            self.consecutive_failures += 1
            if self.state == "half_open":
                self._to("open")
                self.opened_at = self.config.clock()
            elif (
                self.state == "closed"
                and self.consecutive_failures >= self.config.failure_threshold
            ):
                self._to("open")
                self.opened_at = self.config.clock()
                log.warning(
                    "breaker %s opened after %d consecutive failures",
                    self.name, self.consecutive_failures,
                )

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "state": self.state,
                "consecutiveFailures": self.consecutive_failures,
                "shortCircuits": self.short_circuits,
                "deadlineOverruns": self.deadline_overruns,
                "transitions": dict(self.transitions),
            }


# ------------------------------------------------------------- drift sentinel
@dataclasses.dataclass
class DriftConfig:
    """Sliding-window drift monitoring thresholds. The window is chunked:
    full chunks age out whole, so memory stays bounded without per-row
    eviction from the histogram sketch."""

    window: int = 2048          # rows per feature in the sliding window
    chunks: int = 4
    min_rows: int = 50          # no verdicts before this many rows
    js_warn: float = 0.25
    js_threshold: float = 0.5
    fill_ratio_warn: float = 2.0
    fill_ratio_threshold: float = 10.0
    max_bins: int = 64
    compare_bins: int = 64      # discretization for the JS computation


class _Window:
    """Chunked sliding window: (histogram, rows, nulls) per chunk."""

    def __init__(self, config: DriftConfig):
        self.config = config
        self.chunk_rows = max(1, config.window // config.chunks)
        self.chunks: deque[list] = deque()  # [StreamingHistogram, rows, nulls]

    def _tail_chunk(self) -> list:
        if not self.chunks or self.chunks[-1][1] >= self.chunk_rows:
            self.chunks.append([StreamingHistogram(self.config.max_bins), 0, 0])
            if len(self.chunks) > self.config.chunks:
                self.chunks.popleft()
        return self.chunks[-1]

    def observe_bulk(
        self, values: np.ndarray, rows: int, nulls: int
    ) -> None:
        """Columnar ingestion: ``values`` are the present numeric values of
        ``rows`` incoming rows (``nulls`` of which were missing). Rows fill
        chunks in order; values and nulls are apportioned proportionally —
        within-batch ordering is immaterial for distribution monitoring,
        and the vectorized bulk build keeps the serving batch hot loop off
        the per-value ``update`` path."""
        total = rows
        n_values = len(values)
        done = consumed_v = consumed_n = 0
        while done < rows:
            chunk = self._tail_chunk()
            k = min(self.chunk_rows - chunk[1], rows - done)
            done += k
            tv = round(n_values * done / total)
            tn = round(nulls * done / total)
            kv, kn = tv - consumed_v, tn - consumed_n
            if kv > 0:
                chunk[0] = chunk[0].merge(
                    histogram_from_values(
                        values[consumed_v:consumed_v + kv],
                        self.config.max_bins,
                    )
                )
            consumed_v, consumed_n = tv, tn
            chunk[1] += k
            chunk[2] += kn

    @property
    def rows(self) -> int:
        return sum(c[1] for c in self.chunks)

    @property
    def nulls(self) -> int:
        return sum(c[2] for c in self.chunks)

    def histogram(self) -> StreamingHistogram:
        out = StreamingHistogram(self.config.max_bins)
        for c in self.chunks:
            out = out.merge(c[0])
        return out


def histogram_js_divergence(
    train: StreamingHistogram, serve: StreamingHistogram, bins: int = 64
) -> float:
    """Jensen-Shannon divergence (base 2, in [0, 1]) between two sketches,
    discretized onto shared equal-width bins spanning their combined
    support — the serve-time analog of FeatureDistribution.js_divergence."""
    if train.total_count == 0 or serve.total_count == 0:
        return 0.0
    t_pts, s_pts = train.bins, serve.bins
    lo = min(t_pts[0][0], s_pts[0][0])
    hi = max(t_pts[-1][0], s_pts[-1][0])
    if hi <= lo:
        return 0.0  # both concentrated on one identical point
    edges = np.linspace(lo, hi, bins + 1)

    def masses(h: StreamingHistogram) -> np.ndarray:
        cum = np.array([h.sum_at(e) for e in edges[1:]])
        m = np.diff(np.concatenate([[0.0], cum]))
        # sum_at(last edge) == total_count, but guard drift from float error
        m = np.clip(m, 0.0, None)
        total = m.sum()
        return m / total if total > 0 else m

    p, q = masses(train), masses(serve)
    m = 0.5 * (p + q)

    def kl(a: np.ndarray, b: np.ndarray) -> float:
        mask = a > 0
        return float(np.sum(a[mask] * np.log2(a[mask] / b[mask])))

    return 0.5 * kl(p, m) + 0.5 * kl(q, m)


@dataclasses.dataclass
class _TrainProfile:
    count: int
    nulls: int
    histogram: StreamingHistogram | None

    @property
    def fill_rate(self) -> float:
        return 0.0 if self.count == 0 else 1.0 - self.nulls / self.count


class DriftSentinel:
    """Serve-time train/serve skew detection against persisted profiles.

    Feed it raw columns (``observe_columns`` — both scoring paths build
    columns before the stage plan runs, so there is ONE intake);
    ``report()`` yields, per profiled feature, train/serve fill rates, the
    fill-rate ratio, and the JS divergence of the value distributions,
    with a status of ``ok`` / ``warn`` / ``alert`` against the configured
    thresholds. Torn or corrupt profiles disable monitoring for that
    feature only (listed in ``torn``) — a damaged artifact must degrade
    observability, not scoring.

    Each feature's sliding window has its own lock: ``observe_columns``
    (the scoring hot path) and ``report()`` (monitoring) both take it per
    feature, so a concurrent ``observe`` can no longer tear the window
    stats mid-read (rows/nulls/histogram snapshot inconsistency under
    ``score_fn.metadata()``)."""

    def __init__(
        self,
        profiles: dict[str, dict[str, Any]] | None,
        config: DriftConfig | None = None,
    ):
        from . import faults

        self.config = config or DriftConfig()
        self.profiles: dict[str, _TrainProfile] = {}
        self.torn: list[str] = []
        self.rows_observed = 0
        self.alerts_total = 0
        self._alerting: set[str] = set()
        plan = faults.active()
        for name, prof in (profiles or {}).items():
            if plan is not None and plan.on_profile_load(name):
                self.torn.append(name)
                continue
            try:
                hist = (
                    StreamingHistogram.from_json(prof["histogram"])
                    if prof.get("histogram") is not None
                    else None
                )
                self.profiles[name] = _TrainProfile(
                    int(prof["count"]), int(prof["nulls"]), hist
                )
            except Exception as e:
                log.warning(
                    "drift sentinel: training profile for '%s' is torn or "
                    "corrupt (%s); drift monitoring disabled for it", name, e,
                )
                self.torn.append(name)
        self._windows = {name: _Window(self.config) for name in self.profiles}
        # per-feature lock FAMILY: one node in the lock-order graphs
        self._window_locks = {
            name: _schedule.make_lock(
                "resilience/sentinel.py:DriftSentinel._window_locks[]"
            )
            for name in self.profiles
        }
        self._report_lock = _schedule.make_lock(
            "resilience/sentinel.py:DriftSentinel._report_lock"
        )  # alert bookkeeping + totals

    @property
    def enabled(self) -> bool:
        return bool(self.profiles)

    def observe_columns(self, cols: dict[str, Any], num_rows: int) -> None:
        """Columnar ingestion — the shared intake of ``score_batch`` (post
        codec) and ``score_columns``. Numeric columns feed the window in
        one vectorized bulk merge; everything else contributes fill rate."""
        from . import faults
        from ..prep.raw_feature_filter import _null_mask
        from ..types.columns import NumericColumn

        if not self.profiles:
            return
        plan = faults.active()
        with self._report_lock:
            self.rows_observed += num_rows
        for name in self.profiles:
            w = self._windows[name]
            col = cols.get(name)
            if col is None:
                with self._window_locks[name]:
                    w.observe_bulk(np.empty(0), num_rows, num_rows)
                continue
            if isinstance(col, NumericColumn):
                vals = np.asarray(
                    col.values[:num_rows], dtype=np.float64
                )[np.asarray(col.mask[:num_rows], dtype=bool)]
                if plan is not None and len(vals) and plan.wants_drift(name):
                    vals = np.asarray([
                        plan.on_drift_observe(name, float(v)) for v in vals
                    ])
                with self._window_locks[name]:
                    w.observe_bulk(vals, num_rows, num_rows - len(vals))
            else:
                nulls = int(_null_mask(col)[:num_rows].sum())
                with self._window_locks[name]:
                    w.observe_bulk(np.empty(0), num_rows, nulls)

    def report(self) -> dict[str, Any]:
        features: dict[str, Any] = {}
        alerts: list[str] = []
        for name, prof in self.profiles.items():
            w = self._windows[name]
            # snapshot (rows, nulls, merged histogram) under the feature's
            # window lock — a concurrent observe_columns can no longer tear
            # rows vs nulls vs histogram mid-read under metadata(); the
            # slow JS computation runs on the snapshot, outside
            with self._window_locks[name]:
                rows = w.rows
                nulls = w.nulls
                hist = w.histogram() if prof.histogram is not None else None
            if rows < self.config.min_rows:
                features[name] = {"status": "insufficient", "rows": rows}
                continue
            serve_fill = 1.0 - nulls / rows
            train_fill = prof.fill_rate
            lo, hi = sorted((serve_fill, train_fill))
            fill_ratio = (
                1.0 if hi == 0.0 else float("inf") if lo == 0.0 else hi / lo
            )
            js = None
            if prof.histogram is not None:
                js = histogram_js_divergence(
                    prof.histogram, hist, self.config.compare_bins
                )
            status = "ok"
            if (
                fill_ratio > self.config.fill_ratio_warn
                or (js is not None and js > self.config.js_warn)
            ):
                status = "warn"
            if (
                fill_ratio > self.config.fill_ratio_threshold
                or (js is not None and js > self.config.js_threshold)
            ):
                status = "alert"
            features[name] = {
                "status": status,
                "rows": rows,
                "trainFillRate": train_fill,
                "serveFillRate": serve_fill,
                # inf is not valid JSON for strict serializers (the report
                # ships to monitoring endpoints): a vanished feature
                # reports null here, the alert status carries the verdict
                "fillRatio": None if math.isinf(fill_ratio) else fill_ratio,
                "jsDivergence": js,
            }
            if status == "alert":
                alerts.append(name)
                with self._report_lock:
                    fresh_alert = name not in self._alerting
                    if fresh_alert:
                        self._alerting.add(name)
                        self.alerts_total += 1
                if fresh_alert:
                    _tevents.emit(
                        "drift_alert", feature=name,
                        fillRatio=(
                            None if math.isinf(fill_ratio) else
                            round(fill_ratio, 4)
                        ),
                        jsDivergence=None if js is None else round(js, 4),
                    )
                    log.warning(
                        "drift sentinel: feature '%s' drifted (fillRatio="
                        "%.3g, js=%s)", name, fill_ratio,
                        "n/a" if js is None else f"{js:.3f}",
                    )
            else:
                with self._report_lock:
                    recovered = name in self._alerting
                    self._alerting.discard(name)
                if recovered:
                    # hysteresis pair of the once-per-episode drift_alert
                    # above: emitted exactly once when the window returns
                    # under threshold, so the retrain loop (and operators)
                    # can tell "still drifting" from "recovered on its own"
                    _tevents.emit(
                        "drift_cleared", feature=name,
                        fillRatio=(
                            None if math.isinf(fill_ratio) else
                            round(fill_ratio, 4)
                        ),
                        jsDivergence=None if js is None else round(js, 4),
                    )
                    log.info(
                        "drift sentinel: feature '%s' recovered (fillRatio="
                        "%.3g, js=%s)", name, fill_ratio,
                        "n/a" if js is None else f"{js:.3f}",
                    )
        with self._report_lock:
            return {
                "enabled": self.enabled,
                "rowsObserved": self.rows_observed,
                "tornProfiles": list(self.torn),
                "alerts": alerts,
                "driftAlertsTotal": self.alerts_total,
                "features": features,
            }


# ------------------------------------------------------- train-time profiling
def compute_serving_profiles(
    dataset: Any, raw_features: Iterable[Any], max_bins: int = 64
) -> dict[str, dict[str, Any]]:
    """Per-raw-feature training profiles for the drift sentinel: row count,
    null count, and (numeric features) a ``StreamingHistogram`` of present
    values. JSON-able; persisted in the model manifest as
    ``servingProfiles``. Non-numeric features get fill-rate-only profiles
    (``histogram: null``)."""
    from ..prep.raw_feature_filter import _null_mask
    from ..types.columns import NumericColumn

    profiles: dict[str, dict[str, Any]] = {}
    for f in raw_features:
        if f.is_response or f.name not in dataset:
            continue
        col = dataset[f.name]
        nulls = int(_null_mask(col).sum())
        hist = None
        if isinstance(col, NumericColumn):
            present = col.values[col.mask]
            hist = histogram_from_values(present, max_bins=max_bins).to_json()
        profiles[f.name] = {
            "count": int(len(col)),
            "nulls": nulls,
            "histogram": hist,
        }
    return profiles
