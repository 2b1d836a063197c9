"""Columnar physical data model.

Each feature is a column. Numeric-family columns are (values, validity-mask)
ndarray pairs, text columns are object arrays of ``str | None``, the vector
plane is a dense float32 [N, D] matrix carrying provenance metadata, and a
model's output is a PredictionColumn of dense (prediction, probability,
raw) arrays. MultiPickList columns hold one frozenset per row, the list
types (TextList, DateList, DateTimeList, Geolocation) one Python list per
row and the map types one dict per row, an empty one meaning missing.
Semantics match ``transmogrifai_tpu.types.columns``. A wide hashed text
plane of a large batch is a :class:`SparseMatrix` (COO, the featurize
plane's sparse blocks); dense consumers densify it with ``np.asarray``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Sequence

import numpy as np

from . import OPMap, Prediction, Storage


class SparseMatrix:
    """COO float32 matrix with implicit value 1.0 per (row, col) pair —
    duplicates accumulate (token counts). The wide hashed text planes are
    ~99.8% zeros at 512 buckets (SmartTextVectorizer emits sparse vectors
    for the same reason, SmartTextVectorizer.scala:79-132); materializing
    them densely on the host costs ~50x the bytes.

    Ducks enough of the ndarray surface (``shape``, ``__array__``,
    ``astype``, ``__len__``) that dense consumers keep working — they pay
    the densification exactly when they touch the values: every site that
    hands a vector's values to torch goes through ``np.asarray`` first
    (``torch.as_tensor`` cannot read this class).
    """

    __slots__ = ("rows", "cols", "vals", "shape", "_dense")

    def __init__(self, rows: np.ndarray, cols: np.ndarray,
                 shape: tuple[int, int], vals: np.ndarray | None = None):
        self.rows = np.asarray(rows, dtype=np.int32)
        self.cols = np.asarray(cols, dtype=np.int32)
        #: None = implicit 1.0 per pair (token counts / indicators)
        self.vals = (
            None if vals is None else np.asarray(vals, dtype=np.float32)
        )
        self.shape = (int(shape[0]), int(shape[1]))
        self._dense: np.ndarray | None = None

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def __len__(self) -> int:
        return self.shape[0]

    def toarray(self) -> np.ndarray:
        if self._dense is None:
            n, d = self.shape
            if d > 0 and n > 0 and self.nnz:
                flat = np.bincount(
                    self.rows.astype(np.int64) * d + self.cols,
                    weights=self.vals,
                    minlength=n * d,
                ).astype(np.float32)
                self._dense = flat.reshape(n, d)
            else:
                self._dense = np.zeros((n, d), dtype=np.float32)
        return self._dense

    def __array__(self, dtype=None, copy=None):
        out = self.toarray()
        if dtype is not None and np.dtype(dtype) != out.dtype:
            return out.astype(dtype)
        # matching dtype: hand back the cached plane unless the protocol
        # explicitly demanded a copy (np.array(..., copy=True)) — mutating
        # consumers must not corrupt the cache
        return out.copy() if copy else out

    def astype(self, dtype, copy: bool = True):
        return self.toarray().astype(dtype, copy=copy)

    def _vals_of(self, keep) -> np.ndarray | None:
        return None if self.vals is None else self.vals[keep]

    def take_rows(self, indices: np.ndarray) -> "SparseMatrix":
        """Row gather, renumbered to ``indices`` order. Duplicate indices
        replicate their rows (matching dense ``x[indices]``); negative
        indices wrap like numpy's."""
        indices = np.asarray(indices)
        if indices.dtype == bool:
            indices = np.nonzero(indices)[0]
        n = self.shape[0]
        src = np.where(indices < 0, indices + n, indices).astype(np.int64)
        if src.size and (src.min() < 0 or src.max() >= n):
            raise IndexError(
                f"take_rows indices out of range for {n} rows"
            )
        # CSR-style gather: group pairs by source row, then expand each
        # output position's row-range (an inverse-remap scatter keeps only
        # ONE output position per source row and silently zeroes duplicate
        # gathers)
        order = np.argsort(self.rows, kind="stable")
        counts = np.bincount(self.rows, minlength=n)
        starts = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        reps = counts[src]
        total = int(reps.sum())
        out_rows = np.repeat(
            np.arange(len(src), dtype=np.int32), reps
        )
        base = np.repeat(starts[src], reps)
        cum = np.zeros(len(src) + 1, dtype=np.int64)
        np.cumsum(reps, out=cum[1:])
        within = np.arange(total, dtype=np.int64) - np.repeat(cum[:-1], reps)
        pos = order[base + within]
        return SparseMatrix(
            out_rows, self.cols[pos],
            (len(src), self.shape[1]), self._vals_of(pos),
        )

    @staticmethod
    def from_dense(x: np.ndarray) -> "SparseMatrix":
        """COO form of a dense block (values preserved)."""
        x = np.asarray(x)
        r, c = np.nonzero(x)
        return SparseMatrix(
            r.astype(np.int32), c.astype(np.int32), x.shape,
            x[r, c].astype(np.float32),
        )

    @staticmethod
    def hstack(blocks: Sequence, widths: Sequence[int],
               num_rows: int) -> "SparseMatrix":
        """Concatenate blocks (SparseMatrix or dense ndarray) column-wise
        into one SparseMatrix; ``widths`` gives each block's column width."""
        rows_parts, cols_parts, vals_parts = [], [], []
        any_vals = False
        off = 0
        for b, w in zip(blocks, widths):
            if not isinstance(b, SparseMatrix):
                b = SparseMatrix.from_dense(b)
            rows_parts.append(b.rows)
            cols_parts.append(b.cols + np.int32(off) if off else b.cols)
            vals_parts.append(b.vals)
            any_vals = any_vals or b.vals is not None
            off += int(w)
        if not rows_parts:
            return SparseMatrix(
                np.zeros(0, np.int32), np.zeros(0, np.int32), (num_rows, off)
            )
        vals = None
        if any_vals:
            vals = np.concatenate(
                [
                    v if v is not None else np.ones(len(r), dtype=np.float32)
                    for v, r in zip(vals_parts, rows_parts)
                ]
            )
        return SparseMatrix(
            np.concatenate(rows_parts), np.concatenate(cols_parts),
            (num_rows, off), vals,
        )


class Column:
    """Base class for all physical columns."""

    feature_type: type

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def to_list(self) -> list:  # pragma: no cover - abstract
        """Row-wise view (None for missing) — for local scoring."""
        raise NotImplementedError

    def take(self, indices: np.ndarray) -> "Column":  # pragma: no cover
        raise NotImplementedError


@dataclasses.dataclass
class NumericColumn(Column):
    """Real/Integral/Binary/Date columns: dense values + validity mask.
    Missing entries have mask=False and value 0."""

    feature_type: type
    values: np.ndarray  # [N] float64 / int64 / bool
    mask: np.ndarray    # [N] bool, True = present

    def __post_init__(self) -> None:
        if self.values.shape != self.mask.shape:
            raise ValueError(
                f"values {self.values.shape} and mask {self.mask.shape} differ"
            )

    def __len__(self) -> int:
        return len(self.values)

    def to_list(self) -> list:
        return [
            (v if m else None)
            for v, m in zip(self.values.tolist(), self.mask.tolist())
        ]

    def take(self, indices: np.ndarray) -> "NumericColumn":
        return NumericColumn(
            self.feature_type, self.values[indices], self.mask[indices]
        )


@dataclasses.dataclass
class TextColumn(Column):
    """Text-family column: object ndarray of str | None."""

    feature_type: type
    values: np.ndarray  # [N] object: str | None

    def __len__(self) -> int:
        return len(self.values)

    def to_list(self) -> list:
        return list(self.values)

    def take(self, indices: np.ndarray) -> "TextColumn":
        return TextColumn(self.feature_type, self.values[indices])


def _take_rows(values: list, indices) -> list:
    """Rows of a per-row Python list by a slice (a view's rows, as
    ``ops.base`` chunks a batch), an index array or a boolean mask."""
    if isinstance(indices, slice):
        return values[indices]
    indices = np.asarray(indices)
    if indices.dtype == bool:
        indices = np.nonzero(indices)[0]
    return [values[i] for i in indices.tolist()]


@dataclasses.dataclass
class SetColumn(Column):
    """MultiPickList column: per-row frozenset[str] (empty set = missing)."""

    feature_type: type
    values: list  # list[frozenset[str]]

    def __len__(self) -> int:
        return len(self.values)

    def to_list(self) -> list:
        return list(self.values)

    def take(self, indices) -> "SetColumn":
        return SetColumn(self.feature_type, _take_rows(self.values, indices))


@dataclasses.dataclass
class ListColumn(Column):
    """TextList/DateList/DateTimeList/Geolocation: per-row Python list
    (empty list = missing)."""

    feature_type: type
    values: list  # list[list]

    def __len__(self) -> int:
        return len(self.values)

    def to_list(self) -> list:
        return list(self.values)

    def take(self, indices) -> "ListColumn":
        return ListColumn(self.feature_type, _take_rows(self.values, indices))


@dataclasses.dataclass
class MapColumn(Column):
    """Map-family column: per-row dict (empty dict = missing)."""

    feature_type: type
    values: list  # list[dict[str, Any]]

    def __len__(self) -> int:
        return len(self.values)

    def to_list(self) -> list:
        return list(self.values)

    def take(self, indices) -> "MapColumn":
        return MapColumn(self.feature_type, _take_rows(self.values, indices))


@dataclasses.dataclass
class VectorColumn(Column):
    """OPVector column: float32 [N, D] values, a dense ndarray or a
    :class:`SparseMatrix`, and column provenance metadata (a
    ``stages.metadata.VectorMetadata``, or None)."""

    feature_type: type
    values: Any  # [N, D] float32 ndarray / SparseMatrix
    metadata: Any = None

    def __len__(self) -> int:
        return int(self.values.shape[0])

    @property
    def dim(self) -> int:
        return int(self.values.shape[1])

    @property
    def is_sparse(self) -> bool:
        return isinstance(self.values, SparseMatrix)

    def to_list(self) -> list:
        return [np.asarray(row) for row in np.asarray(self.values)]

    def take(self, indices: np.ndarray) -> "VectorColumn":
        if self.is_sparse:
            return VectorColumn(
                self.feature_type, self.values.take_rows(indices),
                self.metadata,
            )
        return VectorColumn(
            self.feature_type, np.asarray(self.values)[indices], self.metadata
        )


@dataclasses.dataclass
class PredictionColumn(Column):
    """Prediction column: dense arrays instead of a per-row map.
    ``probability``/``raw`` are [N, C]; regression has neither."""

    feature_type: type
    prediction: np.ndarray                 # [N] float64
    probability: np.ndarray | None = None  # [N, C] float64
    raw: np.ndarray | None = None          # [N, C] float64

    def __len__(self) -> int:
        return len(self.prediction)

    def to_list(self) -> list:
        """Row-wise Prediction maps with the reference's key names:
        ``prediction``, ``probability_<j>``, ``rawPrediction_<j>``."""
        keys = [Prediction.KEY_PREDICTION]
        cols = [np.asarray(self.prediction).tolist()]
        for key, arr in (
            (Prediction.KEY_PROB, self.probability),
            (Prediction.KEY_RAW, self.raw),
        ):
            if arr is None:
                continue
            arr = np.asarray(arr)
            keys += [f"{key}_{j}" for j in range(arr.shape[1])]
            cols += [arr[:, j].tolist() for j in range(arr.shape[1])]
        return [dict(zip(keys, row)) for row in zip(*cols, strict=True)]

    def take(self, indices: np.ndarray) -> "PredictionColumn":
        return PredictionColumn(
            self.feature_type,
            self.prediction[indices],
            None if self.probability is None else self.probability[indices],
            None if self.raw is None else self.raw[indices],
        )


_STORAGE_DTYPE = {
    Storage.REAL: np.float64,
    Storage.INTEGRAL: np.int64,
    Storage.DATE: np.int64,
    Storage.BINARY: bool,
}

#: string forms the Binary codec reads as True
TRUE_TOKENS = frozenset(("true", "1", "1.0", "yes", "t"))


def _coerce(storage: Storage, feature_type: type, v: Any) -> Any:
    """One raw value -> a Python scalar of the storage's kind, or None."""
    if isinstance(v, bool) or v is None:
        return v
    if isinstance(v, float) and np.isnan(v):
        return None
    if storage is Storage.BINARY:
        if isinstance(v, str):
            return v.strip().lower() in TRUE_TOKENS
        return bool(v)
    if isinstance(v, str):
        v = v.strip()
        if v == "":
            return None
        if storage is Storage.REAL:
            return float(v)
        try:
            return int(v)
        except ValueError:
            f = float(v)
            if not f.is_integer():
                raise ValueError(
                    f"Non-integral value {v!r} for "
                    f"{feature_type.__name__} column"
                ) from None
            return int(f)
    return v


def _numeric_column(feature_type: type, raw: Sequence[Any]) -> NumericColumn:
    storage = feature_type.storage
    dtype = _STORAGE_DTYPE[storage]
    lst = raw if isinstance(raw, list) else list(raw)
    if storage is not Storage.BINARY:
        # already-typed rows: numpy reads None as NaN for float targets and
        # raises on strings or on None for int targets (those take the
        # per-value path below)
        try:
            vals = np.asarray(lst, dtype=dtype)
            if vals.dtype == np.float64:
                mask = ~np.isnan(vals)
                vals = np.where(mask, vals, 0.0)
            else:
                mask = np.ones(len(lst), dtype=bool)
            return NumericColumn(feature_type, vals, mask)
        except (TypeError, ValueError, OverflowError):
            pass
    coerced = [_coerce(storage, feature_type, v) for v in lst]
    mask = np.array([v is not None for v in coerced], dtype=bool)
    vals = np.array(
        [0 if v is None else v for v in coerced], dtype=dtype
    ).reshape(len(coerced))
    return NumericColumn(feature_type, vals, mask)


def column_from_values(feature_type: type, raw: Iterable[Any]) -> Column:
    """The physical column for ``feature_type`` from row values: the one
    place that knows how each feature family is stored."""
    storage = feature_type.storage
    if storage in _STORAGE_DTYPE:
        return _numeric_column(feature_type, list(raw))
    if storage is Storage.TEXT:
        lst = [None if v is None or v == "" else str(v) for v in raw]
        out = np.empty(len(lst), dtype=object)
        out[:] = lst
        return TextColumn(feature_type, out)
    if storage is Storage.TEXT_SET:
        # a bare string is one member, not a character collection
        return SetColumn(feature_type, [
            frozenset((v,)) if isinstance(v, str)
            else frozenset(v) if v else frozenset()
            for v in raw
        ])
    if storage in (Storage.TEXT_LIST, Storage.DATE_LIST, Storage.GEO):
        return ListColumn(feature_type, [list(v) if v else [] for v in raw])
    if storage is Storage.MAP:
        if feature_type is Prediction:
            raise TypeError(
                "Prediction columns are built by models, not from raw values")
        if not issubclass(feature_type, OPMap):
            raise TypeError(f"{feature_type.__name__} is not a map type")
        return MapColumn(feature_type, [dict(v) if v else {} for v in raw])
    if storage is Storage.VECTOR:
        arr = np.asarray(list(raw), dtype=np.float32)
        if arr.ndim != 2:
            raise ValueError(
                f"OPVector values must be [N, D], got shape {arr.shape}"
            )
        return VectorColumn(feature_type, arr)
    raise ValueError(f"No physical column for storage {storage}")


def concat_columns(cols: Sequence[Column]) -> Column:
    """Row-wise concatenation of same-typed columns, the inverse of
    ``take`` slicing."""
    c0 = cols[0]
    if len(cols) == 1:
        return c0
    if isinstance(c0, NumericColumn):
        return NumericColumn(
            c0.feature_type,
            np.concatenate([c.values for c in cols]),
            np.concatenate([c.mask for c in cols]),
        )
    if isinstance(c0, TextColumn):
        return TextColumn(
            c0.feature_type, np.concatenate([c.values for c in cols])
        )
    if isinstance(c0, (SetColumn, ListColumn, MapColumn)):
        return type(c0)(c0.feature_type, [v for c in cols for v in c.values])
    if isinstance(c0, VectorColumn):
        return VectorColumn(
            c0.feature_type,
            np.concatenate(
                [np.asarray(c.values, dtype=np.float32) for c in cols], axis=0
            ),
            c0.metadata,
        )
    if isinstance(c0, PredictionColumn):
        def _cat(field):
            parts = [getattr(c, field) for c in cols]
            if any(p is None for p in parts):
                return None  # mixed shapes degrade to prediction-only
            return np.concatenate([np.asarray(p) for p in parts], axis=0)

        return PredictionColumn(
            c0.feature_type,
            np.concatenate([np.asarray(c.prediction) for c in cols]),
            _cat("probability"),
            _cat("raw"),
        )
    raise TypeError(f"cannot concatenate {type(c0).__name__}")


def empty_like(feature_type: type, n: int) -> Column:
    """An all-missing column of length n."""
    if feature_type.storage is Storage.VECTOR:
        return VectorColumn(feature_type, np.zeros((n, 0), dtype=np.float32))
    if feature_type is Prediction:
        return PredictionColumn(Prediction, np.zeros(n, dtype=np.float64))
    return column_from_values(feature_type, [None] * n)
