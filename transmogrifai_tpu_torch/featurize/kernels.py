"""Code-array kernels for the interned text plane, the port of the JAX
package's ``featurize/kernels.py``.

Every transform over interned tokens reduces to the same shape: map the
batch vocabulary (small) to output columns once, then scatter per token
into a ``[N, width]`` count/presence block. The dense scatter runs in
``native.code_bincount`` (GIL released), its numpy route exact; wide
blocks come back as :class:`types.columns.SparseMatrix` so a
``vocab_size = 2**18`` count vectorizer never materializes an
``N × 2^18`` dense matrix (the Spark-default width that used to allocate
~1 GB per 1k rows).

Also here: the vectorized calendar-period kernel backing the time-period
transformers (bit-identical to the scalar ``period_value``) and the
segment-mean kernel feeding the Word2Vec transform.
"""
from __future__ import annotations

import os

import numpy as np

from ..types.columns import SparseMatrix
from .interning import TokenCodes

#: vocabularies wider than this emit SparseMatrix blocks instead of dense
#: [N, W] float32 (override with TPTPU_DENSE_VOCAB_MAX)
DENSE_VOCAB_MAX = int(os.environ.get("TPTPU_DENSE_VOCAB_MAX", "4096"))


def dense_vocab_max() -> int:
    return DENSE_VOCAB_MAX


def map_vocab(vocab: list, index: dict) -> np.ndarray:
    """code → output column (−1 = dropped): one dict hit per UNIQUE token."""
    out = np.empty(len(vocab), dtype=np.int32)
    for i, t in enumerate(vocab):
        out[i] = index.get(t, -1)
    return out


def hash_vocab(
    vocab: list, num_buckets: int, seed: int = 42, prefix: str = ""
) -> np.ndarray:
    """code → murmur3 bucket: each UNIQUE token is hashed once (native
    batch hash), token occurrences then ride the code array."""
    from .. import native

    if not vocab:
        return np.zeros(0, dtype=np.int32)
    terms = [prefix + t for t in vocab] if prefix else list(vocab)
    h = native.murmur3_batch(terms, seed)
    return (h % np.uint32(num_buckets)).astype(np.int32)


def term_count_block(
    tc: TokenCodes,
    code_to_col: np.ndarray,
    width: int,
    binary: bool = False,
    out: np.ndarray | None = None,
    col_offset: int = 0,
) -> np.ndarray:
    """Dense [N, width] count/presence block from interned codes (written
    in place when ``out`` is given — the fused-assembly path)."""
    from .. import native

    if out is None:
        out = np.zeros((tc.num_rows, width), dtype=np.float32)
        col_offset = 0
    if tc.num_tokens:
        native.code_bincount(
            tc.codes, tc.offsets, code_to_col, out,
            binary=binary, col_offset=col_offset,
        )
    return out


def unique_pairs(
    rows: np.ndarray, cols: np.ndarray, width: int
) -> tuple[np.ndarray, np.ndarray]:
    """Distinct (row, col) pairs, sorted row-major — the shared dedup
    primitive behind binary term blocks and document frequencies."""
    flat = np.unique(
        rows.astype(np.int64) * np.int64(width) + cols.astype(np.int64)
    )
    return flat // width, flat % width


def distinct_pair_bincount(
    rows: np.ndarray, cols: np.ndarray, width: int
) -> np.ndarray:
    """Per-column count of DISTINCT (row, col) pairs — document frequency
    over token/bucket occurrences, one bincount, no densification."""
    _, cols_u = unique_pairs(rows, cols, width)
    return np.bincount(cols_u, minlength=width)


def term_count_sparse(
    tc: TokenCodes,
    code_to_col: np.ndarray,
    width: int,
    binary: bool = False,
) -> SparseMatrix:
    """Sparse (COO, implicit 1.0 per pair) variant of term_count_block —
    duplicates accumulate into counts; binary mode pre-dedupes per row."""
    if tc.num_tokens == 0:
        return SparseMatrix(
            np.zeros(0, np.int32), np.zeros(0, np.int32), (tc.num_rows, width)
        )
    cols = code_to_col[tc.codes]
    rows = tc.row_index()
    keep = cols >= 0
    rows, cols = rows[keep], cols[keep].astype(np.int64)
    if binary and len(rows):
        rows, cols = unique_pairs(rows, cols, width)
    return SparseMatrix(
        rows.astype(np.int32), cols.astype(np.int32), (tc.num_rows, width)
    )


# ------------------------------------------------------- calendar periods
_MS_PER_HOUR = 3_600_000
_MS_PER_DAY = 86_400_000


def calendar_periods(ms: np.ndarray, period: str) -> np.ndarray:
    """Vectorized twin of ``ops.time_period.period_value`` over an int64
    epoch-millis array (UTC, joda conventions: Monday=1, months 1-12,
    WeekOfMonth 1-based). Bit-identical to the scalar path over a
    +-5000-year sweep."""
    ms = np.asarray(ms, dtype=np.int64)
    if period == "HourOfDay":
        return (ms // _MS_PER_HOUR) % 24
    if period == "DayOfWeek":
        return ((ms // _MS_PER_DAY + 3) % 7) + 1  # epoch day 0 = Thursday
    # calendar math via numpy datetime64 (floor division handles pre-epoch)
    days = (ms // _MS_PER_DAY).astype("datetime64[D]")
    if period == "DayOfMonth":
        return (days - days.astype("datetime64[M]")).astype(np.int64) + 1
    if period == "DayOfYear":
        return (days - days.astype("datetime64[Y]")).astype(np.int64) + 1
    if period == "MonthOfYear":
        return (days.astype("datetime64[M]").astype(np.int64) % 12) + 1
    if period == "WeekOfMonth":
        dom = (days - days.astype("datetime64[M]")).astype(np.int64)
        return dom // 7 + 1
    if period == "WeekOfYear":
        # ISO-8601 week number: the week containing this date's Thursday,
        # counted within that Thursday's year
        day_idx = ms // _MS_PER_DAY
        dow0 = (day_idx + 3) % 7  # 0 = Monday
        thursday = (day_idx + (3 - dow0)).astype("datetime64[D]")
        jan1 = thursday.astype("datetime64[Y]").astype("datetime64[D]")
        return (thursday - jan1).astype(np.int64) // 7 + 1
    raise ValueError(f"Unknown time period {period}")


def segment_mean_f32(
    vectors: np.ndarray, tc_codes: np.ndarray, offsets: np.ndarray
) -> np.ndarray:
    """Per-row mean of ``vectors[code]`` over each CSR segment, zeros for
    empty rows: the Word2Vec transform feed.

    Byte parity with the historical per-row ``vectors[ids].mean(axis=0)``
    requires BOTH the same float32 accumulation order (sequential over a
    segment's rows — ``np.add.reduceat`` associates differently) and
    np.mean's division semantics (float32 sums over INTEGER counts:
    float64 elementwise divide cast back to float32). The segment sums
    run as one vectorized add per token POSITION — position j of every
    row accumulates in the same step, so each segment sees the exact
    sequential association at a cost of max-tokens-per-row array ops."""
    n = len(offsets) - 1
    dim = vectors.shape[1] if vectors.size else 0
    out = np.zeros((n, dim), dtype=np.float32)
    counts = np.diff(offsets)
    if dim == 0 or not len(tc_codes):
        return out
    nonempty = np.nonzero(counts > 0)[0]
    seg_counts = counts[nonempty]
    starts = offsets[:-1][nonempty]
    gathered = vectors[tc_codes]  # [T, D] float32
    sums = np.zeros((len(nonempty), dim), dtype=np.float32)
    max_len = int(seg_counts.max())
    for j in range(max_len):
        sel = seg_counts > j
        sums[sel] += gathered[starts[sel] + j]
    out[nonempty] = (sums / seg_counts[:, None]).astype(np.float32)
    return out
