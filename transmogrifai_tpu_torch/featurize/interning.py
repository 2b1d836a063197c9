"""Token-code interning, the port of the JAX package's
``featurize/interning.py``: tokenize a text column ONCE into a flat int32
code array + row offsets (CSR layout) over a per-batch vocabulary.

The reference's text stages pass ``Seq[Seq[String]]`` between every stage
(TextTokenizer → NGram → StopWordsRemover → CountVectorizer/HashingTF);
the CPython equivalent (list-of-list-of-str) makes every downstream stage
pay a per-row, per-token interpreter loop. Interning replaces the token
payload with three arrays:

* ``codes``   — int32 ``[T]``: one vocabulary code per token occurrence;
* ``offsets`` — int64 ``[N+1]``: row r's tokens are
  ``codes[offsets[r]:offsets[r+1]]``;
* ``vocab``   — the unique token strings, first-occurrence order — the
  ONLY per-token Python strings ever built.

Downstream transforms become vocabulary-sized dict work (tiny) plus numpy
/native array kernels over the codes (``featurize.kernels``). The build
itself runs in one native pass (``tp_intern_tokens``, GIL released) for
ASCII rows; non-ASCII rows take the exact-Unicode Python tokenizer and
share the vocabulary, which lists the ASCII rows' tokens first (the
reference's order, which decides tie-breaks downstream).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..types.columns import ListColumn
from ..utils.text import tokenize
from . import stats as fstats


@dataclasses.dataclass
class TokenCodes:
    """CSR token layout of one text/token-list column."""

    codes: np.ndarray    # int32 [T]
    offsets: np.ndarray  # int64 [N+1]
    vocab: list[str]

    @property
    def num_rows(self) -> int:
        return len(self.offsets) - 1

    @property
    def num_tokens(self) -> int:
        return int(self.offsets[-1])

    def row_counts(self) -> np.ndarray:
        return np.diff(self.offsets)

    def row_index(self) -> np.ndarray:
        """int64 [T]: the row of each token occurrence."""
        return np.repeat(
            np.arange(self.num_rows, dtype=np.int64), self.row_counts()
        )

    def vocab_array(self) -> np.ndarray:
        arr = getattr(self, "_vocab_arr", None)
        if arr is None:
            arr = np.empty(len(self.vocab), dtype=object)
            arr[:] = self.vocab
            self._vocab_arr = arr
        return arr

    def to_lists(self) -> list[list[str]]:
        """Materialize list-of-list-of-str (row-dict scoring, tests)."""
        toks = self.vocab_array()[self.codes] if len(self.vocab) else self.codes
        off = self.offsets
        return [
            toks[off[r]:off[r + 1]].tolist() for r in range(self.num_rows)
        ]

    def take_rows(self, indices: np.ndarray) -> "TokenCodes":
        indices = np.asarray(indices)
        if indices.dtype == bool:
            indices = np.nonzero(indices)[0]
        indices = indices.astype(np.int64)
        counts = self.row_counts()[indices]
        offsets = np.zeros(len(indices) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        total = int(offsets[-1])
        starts = self.offsets[:-1][indices]
        pos = (
            np.arange(total, dtype=np.int64)
            - np.repeat(offsets[:-1], counts)
            + np.repeat(starts, counts)
        )
        return TokenCodes(self.codes[pos], offsets, self.vocab)


class InternedTextList(ListColumn):
    """A ``ListColumn`` whose payload is a :class:`TokenCodes` — the
    hot-path text stages read ``.interned`` and never materialize the
    list-of-lists; ``.values`` materializes lazily for anything else
    (row-dict rendering, tests, legacy consumers)."""

    def __init__(self, feature_type: type, interned: TokenCodes):
        self.feature_type = feature_type
        self.interned = interned
        self._values: list | None = None

    @property
    def values(self) -> list:  # type: ignore[override]
        if self._values is None:
            self._values = self.interned.to_lists()
        return self._values

    def __len__(self) -> int:
        return self.interned.num_rows

    def to_list(self) -> list:
        return list(self.values)

    def take(self, indices: np.ndarray) -> "InternedTextList":
        return InternedTextList(
            self.feature_type, self.interned.take_rows(indices)
        )


def _intern_lists(rows: list) -> TokenCodes:
    """Dict-based interner over already-tokenized rows (fallback, and the
    adapter for plain ListColumn inputs)."""
    index: dict[str, int] = {}
    vocab: list[str] = []
    codes: list[int] = []
    offsets = np.zeros(len(rows) + 1, dtype=np.int64)
    for r, row in enumerate(rows):
        if row:
            for t in row:
                code = index.get(t)
                if code is None:
                    code = index[t] = len(vocab)
                    vocab.append(t)
                codes.append(code)
        offsets[r + 1] = len(codes)
    fstats.stats().record_intern(native=False)
    return TokenCodes(np.asarray(codes, dtype=np.int32), offsets, vocab)


def tokenize_text_column(
    values,
    to_lowercase: bool = True,
    min_token_length: int = 1,
) -> TokenCodes:
    """Tokenize one text column (str | None per row) into interned codes.
    Null/empty rows get zero tokens (TextTokenizer semantics). ASCII
    columns ride one native pass; columns with non-ASCII rows keep those
    rows on the exact-Unicode Python tokenizer."""
    from .. import native

    n = len(values)
    texts: list[str] = []
    rows_idx: list[int] = []
    for r, v in enumerate(values):
        if v:
            texts.append(v if isinstance(v, str) else str(v))
            rows_idx.append(r)
    if not texts:
        return TokenCodes(
            np.zeros(0, dtype=np.int32), np.zeros(n + 1, dtype=np.int64), []
        )
    res = native.intern_tokens(
        texts, to_lowercase=to_lowercase, min_token_length=min_token_length
    )
    if res is not None and len(rows_idx) == n:
        codes, offsets, vocab = res
        fstats.stats().record_intern(native=True)
        return TokenCodes(codes, offsets, vocab)
    if res is not None:
        # nulls present: scatter the compact per-row counts onto all rows
        codes, sub_offsets, vocab = res
        counts = np.zeros(n, dtype=np.int64)
        counts[rows_idx] = np.diff(sub_offsets)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        fstats.stats().record_intern(native=True)
        return TokenCodes(codes, offsets, vocab)
    # non-ASCII rows (or no native lib): native pass over the ASCII rows,
    # exact-Unicode Python tokenizer for the rest, one shared vocabulary
    ascii_texts, ascii_rows = [], []
    slow: list[tuple[int, str]] = []
    for r, v in zip(rows_idx, texts):
        if v.isascii():
            ascii_texts.append(v)
            ascii_rows.append(r)
        else:
            slow.append((r, v))
    index: dict[str, int] = {}
    vocab = []
    row_payload: list = [None] * n
    if ascii_texts:
        res = native.intern_tokens(
            ascii_texts, to_lowercase=to_lowercase,
            min_token_length=min_token_length,
        )
        if res is None:  # no native lib at all: everything per-row
            slow = list(zip(ascii_rows, ascii_texts)) + slow
            slow.sort()
        else:
            a_codes, a_offsets, vocab = res
            index = {t: i for i, t in enumerate(vocab)}
            for i, r in enumerate(ascii_rows):
                row_payload[r] = a_codes[a_offsets[i]:a_offsets[i + 1]]
            fstats.stats().record_intern(native=True)
    for r, v in slow:
        toks = tokenize(v, to_lowercase, min_token_length)
        rc = np.empty(len(toks), dtype=np.int32)
        for i, t in enumerate(toks):
            code = index.get(t)
            if code is None:
                code = index[t] = len(vocab)
                vocab.append(t)
            rc[i] = code
        row_payload[r] = rc
    if slow:
        fstats.stats().record_intern(native=False)
    counts = np.asarray(
        [0 if p is None else len(p) for p in row_payload], dtype=np.int64
    )
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    nonempty = [p for p in row_payload if p is not None and len(p)]
    codes = (
        np.concatenate(nonempty).astype(np.int32, copy=False)
        if nonempty else np.zeros(0, dtype=np.int32)
    )
    return TokenCodes(codes, offsets, vocab)


def interned_of(col) -> TokenCodes:
    """The TokenCodes of a token-list column: pass-through for
    :class:`InternedTextList`, one cached dict-interning pass otherwise."""
    got = getattr(col, "interned", None)
    if got is not None:
        return got
    cached = getattr(col, "_interned_cache", None)
    if cached is not None:
        return cached
    tc = _intern_lists(col.values)
    try:
        col._interned_cache = tc
    except Exception:  # pragma: no cover - exotic column type
        pass
    return tc


def interned_output(feature_type: type, interned: TokenCodes) -> InternedTextList:
    return InternedTextList(feature_type, interned)


def intern_values(values: list) -> tuple[np.ndarray, list, np.ndarray]:
    """Whole-VALUE interning: ``(codes int32[n], uniques, counts int64[U])``
    with uniques in first-occurrence order — the capped-Counter primitive
    behind TextStats / one-hot fits / pivot transforms. Callers map None
    out first. Str values ride the native byte-exact pass when the
    library is present; non-str values (or no library) take the
    raw-keyed dict interner — the historical per-value semantics."""
    from .. import native

    res = native.intern_values(values)
    if res is not None:
        codes, first_rows, counts = res
        fstats.stats().record_intern(native=True)
        return codes, [values[int(i)] for i in first_rows], counts
    index: dict[str, int] = {}
    uniques: list[str] = []
    counts_l: list[int] = []
    codes = np.empty(len(values), dtype=np.int32)
    for i, v in enumerate(values):
        code = index.get(v)
        if code is None:
            code = index[v] = len(uniques)
            uniques.append(v)
            counts_l.append(0)
        counts_l[code] += 1
        codes[i] = code
    fstats.stats().record_intern(native=False)
    return codes, uniques, np.asarray(counts_l, dtype=np.int64)
