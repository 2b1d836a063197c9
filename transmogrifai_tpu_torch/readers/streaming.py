"""Streaming reader — micro-batch scoring source.

Reference: readers/.../StreamingReaders.scala:50-70 (`StreamingReaders.Simple
.avro`) feeding OpWorkflowRunner.streamingScore (OpWorkflowRunner.scala:232).
The Spark Streaming DStream becomes a plain iterator of record batches; the
runner scores each batch with the score function. ``FileStreamingReader``
streams csv / avro / parquet files as chunks for the out-of-core fit
(``workflow/stream.py``); ``StreamExhausted`` names a chunk whose fetch
spent its retry budget, and the chunk-fetch ledger counts every fetch.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Callable, Iterable, Iterator, Sequence

from ..dataset import Dataset
from ..features.feature import Feature
from ..resilience.retry import TransientError
from ..telemetry import metrics as _tmetrics
from .core import SimpleReader

log = logging.getLogger(__name__)


class StreamExhausted(TransientError):
    """A chunk fetch burned its whole retry budget on transient errors:
    names the chunk, the attempts spent, and the last underlying error.
    Subclasses ``TransientError`` on purpose — the
    file-stream defer/drop path and the out-of-core ingest quarantine
    both treat it as the bounded transient failure it is, while typed
    callers can read ``chunk``/``attempts``/``last_error`` instead of
    parsing a log line. Fatal errors (bad format, permissions) still
    raise as themselves: retries never ran, so nothing was exhausted."""

    def __init__(self, chunk: str, attempts: int, last_error: BaseException):
        super().__init__(
            f"stream chunk {chunk!r} exhausted after {attempts} "
            f"attempts: {type(last_error).__name__}: {last_error}"
        )
        self.chunk = chunk
        self.attempts = int(attempts)
        self.last_error = last_error


class _ChunkFetchStats(_tmetrics.LedgerCore):
    """Process-wide chunk-fetch ledger: every ``_fetch_chunk`` attempt
    count lands here (the RetryPolicy returns how many attempts one fetch
    took, but until now that number only reached a log line). Snapshotted
    into the ``resilience`` ledger source (resilience/distributed.py), so
    the counters reach ``score_fn.metadata()`` and the Prometheus
    exposition like every other resilience counter."""

    KEYS = (
        "streamChunkFetches",     # successful fetches (post-retry)
        "streamChunkRetries",     # fetches that needed more than 1 attempt
        "streamChunkAttempts",    # total attempts across all fetches
        "streamChunkExhausted",   # fetches whose retry budget ran out
    )

    def __init__(self) -> None:
        super().__init__(self.KEYS)

    def record_fetch(self, attempts: int) -> None:
        with self._lock:
            self._counts["streamChunkFetches"] += 1
            self._counts["streamChunkAttempts"] += int(attempts)
            if attempts > 1:
                self._counts["streamChunkRetries"] += 1

    def record_exhausted(self, attempts: int = 0) -> None:
        with self._lock:
            self._counts["streamChunkExhausted"] += 1
            self._counts["streamChunkAttempts"] += int(attempts)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset_for_tests(self) -> None:
        with self._lock:
            self._reset_counts()


CHUNK_STATS = _ChunkFetchStats()


class StreamingReader:
    """An iterator of micro-batches, each a list of records.

    ``fetch_fn`` (optional) materializes each raw batch — a remote read,
    a decode, a validation pass — behind the chunk ``RetryPolicy``: a
    transient failure backs off and retries inside the fetch, and a
    budget that runs dry raises the typed :class:`StreamExhausted`
    (``stream_batches`` quarantines such a chunk — counted on
    ``CHUNK_STATS`` — instead of killing the stream). Without
    ``fetch_fn`` batches pass through untouched, exactly as before."""

    #: chunk retry policy — None picks resilience.retry.default_io_policy
    retry_policy = None

    def __init__(
        self,
        batches: Iterable[Sequence[Any]],
        key_fn: Callable[[Any], str] | None = None,
        fetch_fn: Callable[[Sequence[Any]], Sequence[Any]] | None = None,
    ):
        self._batches = batches
        self.key_fn = key_fn
        self.fetch_fn = fetch_fn

    def is_unbounded(self) -> bool:
        """Streaming sources declare no known size — ``Workflow.train``
        auto-routes them through the out-of-core chunked fit
        (workflow/stream.py) instead of materializing."""
        return True

    def _fetch_batch(self, index: int, batch: Sequence[Any]) -> Sequence[Any]:
        """One chunk fetch behind the RetryPolicy + fault hooks; raises
        ``StreamExhausted`` when transient retries run dry."""
        from ..resilience import faults
        from ..resilience.retry import default_io_policy, is_transient

        chunk_name = f"chunk-{index}"

        def fetch() -> Sequence[Any]:
            plan = faults.active()
            if plan is not None:
                plan.on_stream_chunk(chunk_name)
            return self.fetch_fn(batch) if self.fetch_fn else batch

        policy = self.retry_policy or default_io_policy()
        try:
            records, attempts = policy.call(fetch)
        except Exception as e:
            attempts = getattr(e, "_retry_attempts", 1)
            CHUNK_STATS.record_exhausted(attempts)
            if is_transient(e):
                raise StreamExhausted(chunk_name, attempts, e) from e
            raise
        CHUNK_STATS.record_fetch(attempts)
        return records

    def stream_batches(self) -> Iterator[Sequence[Any]]:
        """Yield record batches in arrival order. With a ``fetch_fn``,
        each batch rides the retry policy; an exhausted budget quarantines
        that chunk (``streamChunkExhausted`` on the resilience ledger)
        and the stream continues — bounded badness, never a dead train."""
        for i, batch in enumerate(self._batches):
            if not batch:
                continue
            if self.fetch_fn is None:
                yield batch
                continue
            try:
                records = self._fetch_batch(i, batch)
            except StreamExhausted as e:
                log.error(
                    "stream chunk %s quarantined after %d attempts: %s",
                    e.chunk, e.attempts, e.last_error,
                )
                continue
            if records:
                yield records

    def stream_datasets(
        self, raw_features: Sequence[Feature]
    ) -> Iterator[Dataset]:
        """Yield one columnar Dataset per micro-batch."""
        for batch in self.stream_batches():
            yield SimpleReader(batch, self.key_fn).generate_dataset(raw_features)


class FileStreamingReader(StreamingReader):
    """Directory-monitoring micro-batch source — the file-stream analog of
    ``StreamingReaders.Simple.avro`` (StreamingReaders.scala:50-70), where
    Spark Streaming's file source turns each newly arrived file into one
    micro-batch.

    Each matching file (csv/avro/parquet by extension; anything else
    raises) becomes one batch of records, in arrival (mtime, then name)
    order. ``poll`` mode keeps watching the directory for files appearing
    after the stream started — ``max_polls``/``poll_interval_s`` bound the
    watch so scoring loops terminate deterministically in tests and batch
    jobs.

    Producers must move files INTO the directory atomically (write
    elsewhere or to a non-matching name, then rename) — the Spark
    file-source contract. For producers that write in place, set
    ``settle_s`` > 0: files whose mtime is younger than that are left for
    a later poll instead of being read mid-write. Transiently unreadable
    files are retried on the next poll (and logged), not silently dropped.
    """

    #: retry policy for chunk fetches — None picks the module default
    #: (resilience.retry.default_io_policy). A transient error mid-fetch
    #: (flaky NFS, object-store hiccup) backs off and retries INSIDE one
    #: poll before the defer-to-next-poll path even engages; fatal errors
    #: (bad format, permissions) fail immediately as before.
    retry_policy = None

    def __init__(
        self,
        directory: str,
        pattern: str = "*.csv",
        key_fn: Callable[[Any], str] | None = None,
        poll: bool = False,
        poll_interval_s: float = 0.5,
        max_polls: int = 10,
        headers: Sequence[str] | None = None,
        has_header: bool | None = None,
        settle_s: float = 0.0,
    ):
        super().__init__((), key_fn)
        self.directory = directory
        self.pattern = pattern
        self.poll = poll
        self.poll_interval_s = poll_interval_s
        self.max_polls = max_polls
        #: csv schema passthrough — Spark-style part files have no header
        #: row (CsvReader would otherwise consume row 1 as column names)
        self.headers = list(headers) if headers is not None else None
        self.has_header = has_header
        self.settle_s = settle_s

    def _fetch_chunk(self, path: str) -> list:
        """One chunk fetch behind the RetryPolicy: transient errors (and
        injected ``fail_chunk_read`` faults) back off and retry before the
        caller's defer/drop handling sees anything."""
        from ..resilience import faults
        from ..resilience.retry import default_io_policy

        def fetch() -> list:
            plan = faults.active()
            if plan is not None:
                plan.on_stream_chunk(path)
            return self._read_file(path)

        from ..resilience.retry import is_transient

        policy = self.retry_policy or default_io_policy()
        try:
            records, attempts = policy.call(fetch)
        except Exception as e:
            # the policy attaches the burned attempt count to the final
            # exception — land it in the ledger before re-raising so an
            # exhausted retry budget is visible, not just a log line
            attempts = getattr(e, "_retry_attempts", 1)
            CHUNK_STATS.record_exhausted(attempts)
            if is_transient(e):
                # retries genuinely ran dry: surface the typed exception
                # naming chunk + attempts + last error (still a
                # TransientError, so the defer/drop path below is intact)
                raise StreamExhausted(path, attempts, e) from e
            raise
        CHUNK_STATS.record_fetch(attempts)
        if attempts > 1:
            log.warning(
                "stream chunk %s fetched after %d attempts", path, attempts
            )
        return records

    def _read_file(self, path: str) -> list:
        if path.endswith(".avro"):
            from ..utils.avro import read_avro

            return list(read_avro(path))
        if path.endswith(".parquet"):
            from .parquet import read_parquet

            return read_parquet(path).rows()
        if path.endswith((".csv", ".tsv", ".txt")):
            from .csv import CsvReader

            return list(
                CsvReader(
                    path, headers=self.headers, has_header=self.has_header
                ).read_records()
            )
        raise ValueError(
            f"unsupported stream file format: {os.path.basename(path)} "
            "(csv/tsv/txt, avro, parquet)"
        )

    def _batches_iter(self) -> Iterator[list]:
        import fnmatch
        import time

        seen: set[str] = set()
        polls = 0
        while True:
            try:
                entries = [
                    os.path.join(self.directory, n)
                    for n in os.listdir(self.directory)
                    if fnmatch.fnmatch(n, self.pattern)
                ]
            except FileNotFoundError:
                entries = []

            def arrival(p):
                # a file can vanish between listdir and stat (concurrent
                # archiver) — sort the gone ones first, they're skipped on
                # read below
                try:
                    return (os.path.getmtime(p), p)
                except OSError:
                    return (-1.0, p)

            fresh = sorted((p for p in entries if p not in seen), key=arrival)

            def try_read(p: str, final: bool):
                """(records | None, ok). Not-ok files are deferred (poll /
                first pass) or dropped LOUDLY (final retry): a file inside
                the settle window may still be mid-write — reading it would
                yield a TRUNCATED batch."""
                if self.settle_s > 0:
                    try:
                        settling = (
                            time.time() - os.path.getmtime(p) < self.settle_s
                        )
                    except OSError as e:
                        settling = True
                        if final:
                            log.error(
                                "stream file %s dropped after retry (%s)",
                                p, e,
                            )
                            return None, False
                    if settling:
                        if final:
                            log.error(
                                "stream file %s still being written after "
                                "settle retry; dropped", p,
                            )
                        return None, False
                try:
                    records = self._fetch_chunk(p)
                except (OSError, TimeoutError, TransientError) as e:
                    # the RetryPolicy exhausted its attempts on a transient
                    # error (or the error was fatal): defer to the next
                    # poll / final retry exactly as before
                    if final:
                        log.error(
                            "stream file %s dropped after retry (%s)", p, e
                        )
                    else:
                        log.warning(
                            "stream file %s unreadable (%s); will retry",
                            p, e,
                        )
                    return None, False
                seen.add(p)
                return records, True

            deferred: list[str] = []
            for p in fresh:
                records, ok = try_read(p, final=False)
                if not ok:
                    deferred.append(p)
                elif records:
                    yield records
            if not self.poll:
                # single pass has no next poll: wait out the settle window
                # once and retry the deferred files
                if deferred:
                    time.sleep(self.settle_s if self.settle_s > 0 else 0.05)
                    for p in deferred:
                        records, ok = try_read(p, final=True)
                        if ok and records:
                            yield records
                return
            polls += 1
            if polls >= self.max_polls:
                return
            time.sleep(self.poll_interval_s)

    def stream_batches(self) -> Iterator[Sequence[Any]]:
        return self._batches_iter()

    def stream_datasets(
        self, raw_features: Sequence[Feature]
    ) -> Iterator[Dataset]:
        for batch in self._batches_iter():
            yield SimpleReader(batch, self.key_fn).generate_dataset(raw_features)
