"""Chunked parallel featurization, the port of the JAX package's
``featurize/parallel.py``: a worker pool over row chunks.

The host kernels this plane leans on (native tokenize/intern/scatter in
the port's ``native.py`` library via ctypes, numpy ufuncs) all release
the GIL, so plain
threads scale the featurize plane across cores without pickling columns
to worker processes. Row-pointwise vectorizer transforms partition
perfectly: chunk outputs concatenate (or land in disjoint row slices of
one preallocated matrix) bit-identically to the single-threaded pass. A
call made from a pool thread (a chunked stage inside a family thread's
fit, for instance) runs its tasks on its own thread instead of waiting on
the fixed-size pool.

Env knobs:

* ``TPTPU_FEATURIZE_THREADS`` — worker count; ``0``/``1`` disables the
  pool (default: ``min(4, cpu_count)``).
* ``TPTPU_FEATURIZE_CHUNK`` — minimum rows per chunk (default 8192);
  batches smaller than two chunks run single-threaded.
"""
from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence

import numpy as np

from . import stats as fstats

_LOCK = threading.Lock()
_POOL: ThreadPoolExecutor | None = None
_POOL_SIZE = 0


def featurize_threads() -> int:
    env = os.environ.get("TPTPU_FEATURIZE_THREADS")
    if env is not None:
        try:
            return max(0, int(env))
        except ValueError:
            return 0
    return min(4, os.cpu_count() or 1)


def min_chunk_rows() -> int:
    try:
        return max(1, int(os.environ.get("TPTPU_FEATURIZE_CHUNK", "8192")))
    except ValueError:
        return 8192


def pool_enabled() -> bool:
    return featurize_threads() >= 2


def _pool() -> ThreadPoolExecutor:
    global _POOL, _POOL_SIZE
    n = featurize_threads()
    with _LOCK:
        if _POOL is None or _POOL_SIZE != n:
            if _POOL is not None:
                _POOL.shutdown(wait=False)
            _POOL = ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="tptpu-featurize"
            )
            _POOL_SIZE = n
        return _POOL


def chunk_ranges(n: int, max_chunks: int | None = None) -> list[tuple[int, int]]:
    """Split ``n`` rows into at most ``workers`` contiguous chunks of at
    least ``min_chunk_rows()`` each; a single chunk means 'don't bother'."""
    workers = featurize_threads()
    if max_chunks is not None:
        workers = min(workers, max_chunks)
    if workers < 2 or n < 2 * min_chunk_rows():
        return [(0, n)]
    # floor division keeps every chunk AT LEAST min_chunk_rows tall
    chunks = max(1, min(workers, n // min_chunk_rows()))
    step = -(-n // chunks)
    return [(i, min(i + step, n)) for i in range(0, n, step)]


def run_tasks(tasks: Sequence[Callable[[], object]]) -> list:
    """Run thunks on the featurize pool (in-order results). Falls back to
    sequential execution for a single task or a disabled pool. Exceptions
    propagate (first failing task, like the sequential loop). Worker busy
    seconds and wall clock land in the featurizeStats ledger.

    Nested calls (a chunked stage inside an already-parallel fit) run
    sequentially instead of deadlocking the fixed-size pool."""
    if len(tasks) == 1 or not pool_enabled():
        return [t() for t in tasks]
    if getattr(_ON_POOL, "active", False):
        return [t() for t in tasks]
    busy = [0.0] * len(tasks)

    def _timed(i: int, t: Callable[[], object]):
        _ON_POOL.active = True
        try:
            t0 = time.perf_counter()
            out = t()
            busy[i] = time.perf_counter() - t0
            return out
        finally:
            _ON_POOL.active = False

    t0 = time.perf_counter()
    futures = [_pool().submit(_timed, i, t) for i, t in enumerate(tasks)]
    results = [f.result() for f in futures]
    wall = time.perf_counter() - t0
    fstats.stats().record_pool(
        len(tasks), sum(busy), wall, featurize_threads()
    )
    return results


def pipeline_tasks(thunks, window) -> "Iterator[object]":
    """Sliding-window pipeline over an ITERATOR of thunks: at most
    ``window`` tasks are submitted ahead on the featurize pool while
    earlier results are consumed, and results yield in submission order.
    This is the out-of-core ingest's backpressure primitive (the
    reference's ``workflow/stream.py``, ROADMAP A12): chunk k+1 featurizes
    on the pool while chunk k reduces on the caller's thread, and the
    bounded window keeps host RSS flat regardless of how many chunks the
    source produces.

    ``window`` may be a callable re-read before every refill, so the
    caller can SHRINK the in-flight window mid-stream (the memory-
    pressure degradation path) and the change takes effect on the next
    submission. Sequential fallback when the pool is disabled or the
    caller already runs on it (same nested-call rule as ``run_tasks``).
    Pulling the next thunk from ``thunks`` happens on the caller's
    thread, so source-side effects (fetch retries, fault hooks) stay
    deterministic."""
    win = window if callable(window) else (lambda: window)
    it = iter(thunks)
    if not pool_enabled() or getattr(_ON_POOL, "active", False):
        for t in it:
            yield t()
        return

    import collections

    def _on_pool(t):
        _ON_POOL.active = True
        try:
            return t()
        finally:
            _ON_POOL.active = False

    pending: collections.deque = collections.deque()
    done = False
    tasks = 0
    busy = 0.0
    t0 = time.perf_counter()
    try:
        while True:
            target = max(1, int(win()))
            while not done and len(pending) < target:
                try:
                    t = next(it)
                except StopIteration:
                    done = True
                    break
                pending.append(_pool().submit(_on_pool, t))
                tasks += 1
            if not pending:
                break
            f = pending.popleft()
            b0 = time.perf_counter()
            out = f.result()
            busy += time.perf_counter() - b0
            yield out
    finally:
        # an abandoned generator must not leak queued work
        for f in pending:
            f.cancel()
        if tasks:
            fstats.stats().record_pool(
                tasks, busy, time.perf_counter() - t0, featurize_threads()
            )


_ON_POOL = threading.local()


def slice_rows(col, a: int, b: int):
    """Contiguous row slice of a column — the chunk-partition primitive.
    Unlike ``take(arange)``, list/object payloads slice at C speed and the
    interned CSR layout rebases offsets without a gather."""
    from ..types.columns import (
        ListColumn,
        MapColumn,
        NumericColumn,
        SetColumn,
        SparseMatrix,
        TextColumn,
        VectorColumn,
    )
    from .interning import InternedTextList, TokenCodes

    if isinstance(col, InternedTextList):
        tc = col.interned
        ta, tb = int(tc.offsets[a]), int(tc.offsets[b])
        return InternedTextList(
            col.feature_type,
            TokenCodes(
                tc.codes[ta:tb], tc.offsets[a:b + 1] - ta, tc.vocab
            ),
        )
    if isinstance(col, NumericColumn):
        return NumericColumn(
            col.feature_type, col.values[a:b], col.mask[a:b]
        )
    if isinstance(col, TextColumn):
        return TextColumn(col.feature_type, col.values[a:b])
    if isinstance(col, (ListColumn, MapColumn, SetColumn)):
        out = type(col)(col.feature_type, col.values[a:b])
        cached = getattr(col, "_extract_cache", None)
        if cached is not None:
            # per-key extraction (ops.maps.map_key_values) slices at C
            # speed — chunk workers must not re-walk the row dicts
            out._extract_cache = (
                cached[0],
                {k: lst[a:b] for k, lst in cached[1].items()},
            )
        return out
    if isinstance(col, VectorColumn):
        if isinstance(col.values, SparseMatrix):
            return col.take(np.arange(a, b, dtype=np.int64))
        return VectorColumn(
            col.feature_type, col.values[a:b], col.metadata
        )
    return col.take(np.arange(a, b, dtype=np.int64))
