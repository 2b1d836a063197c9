"""Out-of-core streaming fit: bounded-memory chunked ingest.

The event readers (DataReaders.Aggregate/Conditional, the sequence
aggregators) exist so training never materializes the dataset. This
module is the fit-side half: a
``Workflow.train(stream=True)`` ingest that folds fit-time statistics
through streaming monoid aggregation while the featurize pool
(featurize/parallel.py ``pipeline_tasks``) featurizes chunk k+1 as chunk
k reduces. The in-flight chunk window is the backpressure knob
(``TPTPU_STREAM_INFLIGHT``): host RSS and device high-water stay flat no
matter how many chunks the source produces.

Robust by construction:

* chunk fetches ride the reader's ``RetryPolicy`` with a typed
  :class:`~..readers.streaming.StreamExhausted` when the
  budget runs dry (readers/streaming.py);
* torn / corrupt chunks (``FaultPlan.tear_stream_chunk`` /
  ``corrupt_chunk``) are quarantined with counters, never folded;
* the checkpoint plane grows a **stream cursor** (chunks folded +
  reducer/buffer state snapshot, temp+rename atomic) so a crash
  mid-ingest resumes costing < 1 chunk of rework;
* a seeded memory-pressure fault (``oom_chunk``) halves the in-flight
  window instead of dying.

Exactness contract: the column-stat monoid (``ExactSum`` — Shewchuk
non-overlapping partials, the ``math.fsum`` algorithm kept mergeable)
makes count/sum/mean/min/max bit-identical for ANY chunk split or
permutation of the same rows; histograms fold value-by-value in row
order, so streamed histograms are bit-identical to the one-shot pass for
any chunk boundaries (and permutation-invariant while their bins stay
exact). tests/test_stream_property.py pins both.
"""
from __future__ import annotations

import json
import logging
import math
import os
import random
from fractions import Fraction
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from ..dataset import Dataset
from ..readers.core import SimpleReader
from ..telemetry import metrics as _tmetrics
from ..types.columns import NumericColumn
from ..utils.streaming_histogram import StreamingHistogram

log = logging.getLogger(__name__)


# ------------------------------------------------------------------ knobs
def stream_inflight() -> int:
    """Bounded in-flight chunk window (backpressure): how many chunks may
    be fetched + featurized ahead of the reducer. ``TPTPU_STREAM_INFLIGHT``
    overrides; the memory-pressure degradation halves the live value."""
    try:
        return max(1, int(os.environ.get("TPTPU_STREAM_INFLIGHT", "4")))
    except ValueError:
        return 4


def stream_buffer_rows() -> int:
    """Training-buffer row cap (the configured memory cap): sources that
    fit keep every row (streamed fit == materialized fit, bit for bit);
    larger sources degrade to a seeded reservoir sample while the monoid
    stats still cover EVERY folded row. ``TPTPU_STREAM_BUFFER_ROWS``
    overrides."""
    try:
        return max(1, int(os.environ.get("TPTPU_STREAM_BUFFER_ROWS", "100000")))
    except ValueError:
        return 100000


# -------------------------------------------------------------- exact sum
class ExactSum:
    """Exact mergeable float accumulator: Shewchuk's non-overlapping
    partials (the ``math.fsum`` algorithm) kept as monoid state. ``add``
    and ``merge`` lose no information, so the rounded :meth:`value` is
    identical for any grouping or ordering of the same multiset of
    floats — the invariance the chunk-boundary/permutation property
    tests pin. Inputs must be finite (callers screen non-finite values
    into their own counter)."""

    __slots__ = ("partials",)

    def __init__(self, partials: Sequence[float] | None = None):
        self.partials: list[float] = [float(p) for p in partials or ()]

    def add(self, x: float) -> None:
        partials = self.partials
        x = float(x)
        i = 0
        for y in partials:
            if abs(x) < abs(y):
                x, y = y, x
            hi = x + y
            lo = y - (hi - x)
            if lo:
                partials[i] = lo
                i += 1
            x = hi
        partials[i:] = [x]

    def merge(self, other: "ExactSum") -> None:
        for y in other.partials:
            self.add(y)

    def value(self) -> float:
        """The correctly rounded exact sum."""
        return math.fsum(self.partials)

    def exact(self) -> Fraction:
        """The exact rational sum (finalize-time variance arithmetic)."""
        return sum((Fraction(p) for p in self.partials), Fraction(0))

    def to_json(self) -> list[float]:
        # float repr round-trips exactly through json in Python
        return list(self.partials)

    @classmethod
    def from_json(cls, data: Sequence[float]) -> "ExactSum":
        return cls(data)


# ------------------------------------------------------------ column stats
class ColumnStat:
    """Per-column streaming monoid: row/present/non-finite counts exact;
    sum and sum-of-squares via :class:`ExactSum`; min/max; a
    :class:`StreamingHistogram` folded value-by-value in row order.
    Non-numeric columns keep the count plane only."""

    def __init__(self, numeric: bool, max_bins: int = 64):
        self.numeric = bool(numeric)
        self.max_bins = int(max_bins)
        self.rows = 0
        self.present = 0
        self.non_finite = 0
        self.sum = ExactSum()
        self.sumsq = ExactSum()
        self.min: float | None = None
        self.max: float | None = None
        self.hist = StreamingHistogram(max_bins)

    # ---------------------------------------------------------- building
    def update_column(self, col: Any) -> None:
        n = len(col)
        self.rows += n
        if not self.numeric or not isinstance(col, NumericColumn):
            if isinstance(col, NumericColumn):
                self.present += int(np.count_nonzero(col.mask))
            else:
                self.present += sum(
                    1 for v in col.to_list() if v is not None
                )
            return
        vals = np.asarray(col.values, dtype=np.float64)[
            np.asarray(col.mask, dtype=bool)
        ]
        self.present += int(vals.size)
        for v in vals.tolist():
            if not math.isfinite(v):
                self.non_finite += 1
                continue
            self.sum.add(v)
            self.sumsq.add(v * v)
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self.hist.update(v)

    def merge(self, other: "ColumnStat") -> "ColumnStat":
        assert self.numeric == other.numeric
        self.rows += other.rows
        self.present += other.present
        self.non_finite += other.non_finite
        self.sum.merge(other.sum)
        self.sumsq.merge(other.sumsq)
        for v in (other.min,):
            if v is not None:
                self.min = v if self.min is None else min(self.min, v)
        for v in (other.max,):
            if v is not None:
                self.max = v if self.max is None else max(self.max, v)
        self.hist = self.hist.merge(other.hist)
        return self

    # ----------------------------------------------------------- queries
    def finalize(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "count": self.rows,
            "present": self.present,
        }
        if not self.numeric:
            return out
        out["nonFinite"] = self.non_finite
        n = self.present - self.non_finite
        if n > 0:
            s = self.sum.exact()
            sq = self.sumsq.exact()
            mean = s / n
            var = (sq - s * mean) / n
            out["sum"] = self.sum.value()
            out["mean"] = float(mean)
            out["variance"] = max(0.0, float(var))
            out["min"] = self.min
            out["max"] = self.max
        out["histogram"] = self.hist.to_json()
        return out

    def to_json(self) -> dict[str, Any]:
        return {
            "numeric": self.numeric,
            "maxBins": self.max_bins,
            "rows": self.rows,
            "present": self.present,
            "nonFinite": self.non_finite,
            "sum": self.sum.to_json(),
            "sumsq": self.sumsq.to_json(),
            "min": self.min,
            "max": self.max,
            "hist": self.hist.to_json(),
        }

    @classmethod
    def from_json(cls, data: dict[str, Any]) -> "ColumnStat":
        st = cls(data["numeric"], data["maxBins"])
        st.rows = int(data["rows"])
        st.present = int(data["present"])
        st.non_finite = int(data["nonFinite"])
        st.sum = ExactSum.from_json(data["sum"])
        st.sumsq = ExactSum.from_json(data["sumsq"])
        st.min = data["min"]
        st.max = data["max"]
        st.hist = StreamingHistogram.from_json(data["hist"])
        return st


class ChunkStatsReducer:
    """Field-name → :class:`ColumnStat` over per-chunk Datasets — the
    streaming analog of one ``pcolumn_stats`` pass, folded chunk by
    chunk. Serializable (the stream cursor snapshots it) and mergeable
    (per-chunk partials combine associatively)."""

    def __init__(self, max_bins: int = 64):
        self.max_bins = int(max_bins)
        self.fields: dict[str, ColumnStat] = {}

    def fold_dataset(self, ds: Dataset) -> None:
        for name, col in ds.columns.items():
            stat = self.fields.get(name)
            if stat is None:
                stat = ColumnStat(
                    isinstance(col, NumericColumn), self.max_bins
                )
                self.fields[name] = stat
            stat.update_column(col)

    def merge(self, other: "ChunkStatsReducer") -> "ChunkStatsReducer":
        for name, stat in other.fields.items():
            mine = self.fields.get(name)
            if mine is None:
                self.fields[name] = stat
            else:
                mine.merge(stat)
        return self

    def finalize(self) -> dict[str, dict[str, Any]]:
        return {
            name: self.fields[name].finalize()
            for name in sorted(self.fields)
        }

    def to_json(self) -> dict[str, Any]:
        return {
            "maxBins": self.max_bins,
            "fields": {
                name: st.to_json() for name, st in self.fields.items()
            },
        }

    @classmethod
    def from_json(cls, data: dict[str, Any]) -> "ChunkStatsReducer":
        red = cls(data["maxBins"])
        red.fields = {
            name: ColumnStat.from_json(st)
            for name, st in data["fields"].items()
        }
        return red


# ----------------------------------------------------------------- ledger
class _StreamIngestStats(_tmetrics.LedgerCore):
    """Process-wide out-of-core ingest ledger, merged into the
    ``resilience`` exposition source (resilience/distributed.py) next to
    the chunk-fetch retry counters."""

    KEYS = (
        "streamChunksFolded",
        "streamChunksTorn",
        "streamChunksCorrupt",
        "streamChunksQuarantined",
        "streamOomEvents",
        "streamWindowHalvings",
        "streamRowsFolded",
        "streamCursorSaves",
        "streamResumes",
        "streamChunksSkipped",
    )

    def __init__(self) -> None:
        super().__init__(self.KEYS)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset_for_tests(self) -> None:
        with self._lock:
            self._reset_counts()


STREAM_STATS = _StreamIngestStats()


# ------------------------------------------------------------------ cursor
def stream_signature(raw_features: Sequence[Any], seed: int) -> str:
    """What a stream cursor is valid for: the raw-feature schema (names +
    response flags, in order) and the reservoir seed. A resumed ingest
    under a different schema or seed re-ingests from chunk 0 instead of
    restoring the wrong reducer state."""
    import hashlib

    h = hashlib.sha256()
    h.update(f"seed={seed};".encode())
    for f in raw_features:
        h.update(f"{f.name}|{int(f.is_response)};".encode())
    return h.hexdigest()[:16]


def _rng_state_json(rng: random.Random) -> list:
    st = rng.getstate()
    return [st[0], list(st[1]), st[2]]


def _rng_restore(rng: random.Random, data: Sequence) -> None:
    rng.setstate((data[0], tuple(data[1]), data[2]))


# ------------------------------------------------------------------ engine
def stream_ingest(
    reader: Any,
    raw_features: Sequence[Any],
    *,
    recorder: Any = None,
    checkpoint: Any = None,
    resume: bool = False,
    max_buffer_rows: int | None = None,
    inflight: int | None = None,
    seed: int = 0,
    max_bins: int = 64,
) -> tuple[Dataset, dict[str, Any]]:
    """Drive the chunked out-of-core ingest: fetch → featurize (pipelined
    on the featurize pool, bounded in-flight window) → fold (monoid
    stats + bounded training buffer) → cursor. Returns the bounded
    training Dataset (every row when the source fits the buffer cap,
    else a seeded reservoir sample) and the ingest summary (chunk /
    quarantine / window accounting + the reduced fit stats).

    Fault semantics (resilience/faults.py): torn/corrupt chunks are
    quarantined — counted, never folded; memory pressure halves the
    in-flight window; ``SimulatedCrash`` propagates, and a later
    ``resume=True`` call restores the cursor and re-processes at most
    the one chunk that was in flight.
    """
    from ..featurize.parallel import pipeline_tasks
    from ..resilience import faults
    from ..resilience.faults import (
        CorruptChunkError,
        MemoryPressure,
        TornChunkError,
    )

    cap = stream_buffer_rows() if max_buffer_rows is None else int(max_buffer_rows)
    window = [stream_inflight() if inflight is None else max(1, int(inflight))]
    initial_window = window[0]
    sig = stream_signature(raw_features, seed)
    key_fn = getattr(reader, "key_fn", None)

    reducer = ChunkStatsReducer(max_bins)
    buffer: list[Any] = []
    rng = random.Random(seed)
    rows_seen = 0
    skip = 0
    torn: list[int] = []
    corrupt: list[int] = []
    oom_events = 0
    halvings = 0
    cursor_saves = 0
    resumed = False
    cursor_ok = [checkpoint is not None]

    if resume and checkpoint is not None:
        cur = checkpoint.load_stream_cursor(sig)
        if cur is not None:
            reducer = ChunkStatsReducer.from_json(cur["reducer"])
            buffer = list(cur["buffer"])
            rows_seen = int(cur["rowsSeen"])
            skip = int(cur["chunksDone"])
            torn = [int(i) for i in cur.get("torn", [])]
            corrupt = [int(i) for i in cur.get("corrupt", [])]
            _rng_restore(rng, cur["rngState"])
            resumed = True
            STREAM_STATS.bump("streamResumes")
            log.info(
                "stream ingest resumed at chunk %d (%d rows folded)",
                skip, rows_seen,
            )

    plan = faults.active()
    chunks_folded = 0
    chunks_skipped = 0
    chunks_done = skip  # source chunks consumed (folded OR quarantined)

    def _save_cursor() -> None:
        nonlocal cursor_saves
        if not cursor_ok[0]:
            return
        payload = {
            "version": 1,
            "signature": sig,
            "chunksDone": chunks_done,
            "rowsSeen": rows_seen,
            "reducer": reducer.to_json(),
            "buffer": buffer,
            "rngState": _rng_state_json(rng),
            "torn": torn,
            "corrupt": corrupt,
        }
        try:
            checkpoint.save_stream_cursor(payload)
        except TypeError as e:
            # non-JSON records: crash-resume degrades to re-ingest, the
            # ingest itself keeps going — warn once, not per chunk
            cursor_ok[0] = False
            log.warning(
                "stream cursor disabled (records not JSON-serializable: "
                "%s) — a crash re-ingests from chunk 0", e,
            )
            return
        cursor_saves += 1
        STREAM_STATS.bump("streamCursorSaves")

    def _fold_rows(batch: Sequence[Any]) -> None:
        nonlocal rows_seen
        for j, r in enumerate(batch):
            i = rows_seen + j
            if len(buffer) < cap:
                buffer.append(r)
            else:
                k = rng.randrange(i + 1)
                if k < cap:
                    buffer[k] = r
        rows_seen += len(batch)

    def _chunk_source() -> Iterator[tuple[int, Sequence[Any]]]:
        nonlocal chunks_skipped
        for idx, batch in enumerate(reader.stream_batches()):
            if idx < skip:
                # already folded before the crash: consumed and
                # discarded without featurize or fold — the < 1 chunk
                # rework guarantee
                chunks_skipped += 1
                STREAM_STATS.bump("streamChunksSkipped")
                continue
            yield idx, batch

    def _featurize_thunks() -> Iterator[Callable[[], tuple]]:
        for idx, batch in _chunk_source():
            def thunk(idx=idx, batch=batch):
                ds = SimpleReader(batch, key_fn).generate_dataset(
                    raw_features
                )
                return idx, batch, ds
            yield thunk

    for idx, batch, ds in pipeline_tasks(
        _featurize_thunks(), lambda: window[0]
    ):
        quarantine: str | None = None
        if plan is not None:
            try:
                plan.on_stream_fold(idx)
            except TornChunkError:
                quarantine = "torn"
                torn.append(idx)
                STREAM_STATS.bump("streamChunksTorn")
            except CorruptChunkError:
                quarantine = "corrupt"
                corrupt.append(idx)
                STREAM_STATS.bump("streamChunksCorrupt")
            except MemoryPressure as e:
                # degrade, don't die: shrink the in-flight window (takes
                # effect on the pipeline's next refill), fold the chunk
                oom_events += 1
                halved = max(1, window[0] // 2)
                if halved < window[0]:
                    halvings += 1
                    STREAM_STATS.bump("streamWindowHalvings")
                window[0] = halved
                STREAM_STATS.bump("streamOomEvents")
                log.warning(
                    "memory pressure on stream chunk %d (%s): in-flight "
                    "window now %d", idx, e, window[0],
                )
        chunks_done = idx + 1
        if quarantine is not None:
            STREAM_STATS.bump("streamChunksQuarantined")
            log.error(
                "stream chunk %d quarantined (%s) — not folded", idx,
                quarantine,
            )
            _save_cursor()
            continue
        reducer.fold_dataset(ds)
        _fold_rows(batch)
        chunks_folded += 1
        STREAM_STATS.bump("streamChunksFolded")
        STREAM_STATS.bump("streamRowsFolded", len(batch))
        if recorder is not None:
            try:
                recorder.poll_chunk_memory(idx)
            except Exception:  # observability must never break ingest
                pass
        _save_cursor()
        if plan is not None:
            plan.on_stream_chunk_end(idx)

    if not buffer:
        raise ValueError(
            "stream ingest produced no rows (every chunk empty or "
            "quarantined)"
        )
    train = SimpleReader(buffer, key_fn).generate_dataset(raw_features)
    summary = {
        "signature": sig,
        "resumed": resumed,
        "chunksDone": chunks_done,
        "chunksFolded": chunks_folded,
        "chunksSkippedOnResume": chunks_skipped,
        "chunksQuarantined": {"torn": torn, "corrupt": corrupt},
        "quarantinedTotal": len(torn) + len(corrupt),
        "rowsSeen": rows_seen,
        "rowsBuffered": len(buffer),
        "sampled": rows_seen > len(buffer),
        "window": {
            "initial": initial_window,
            "final": window[0],
            "halvings": halvings,
        },
        "oomEvents": oom_events,
        "cursorSaves": cursor_saves,
        "fitStats": reducer.finalize(),
    }
    return train, summary
