"""Parquet / Arrow ingestion with schema-directed typing, plus columnar
dataset save/load.

Reference surface covered here:
  - ``DataReaders.Simple.parquetCase`` (readers/.../DataReaders.scala:116) —
    typed parquet reading;
  - ``DataReaders.Simple.avro`` — covered by the gated avro entry points at
    the bottom (the image has no avro library; parquet is the native
    columnar interchange for this build and arrow covers in-memory);
  - ``RichDataset.saveAvro``/``loadAvro`` (features/.../utils/spark/
    RichDataset.scala:201-330) — ``write_parquet``/``read_parquet`` round-trip
    a typed Dataset, preserving feature types in file metadata.

Arrow column buffers come out of the file contiguous and typed, so
numeric features go straight into (values, mask) ndarray pairs without a
per-row boxing pass. ``pyarrow`` is optional: without it these entry points
raise and name the CSV reader. Files written by either package carry the
same feature-type metadata key, so each package reads the other's.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Iterable, Sequence

import numpy as np

from .. import types as T
from ..dataset import Dataset
from ..types.columns import (
    ListColumn,
    MapColumn,
    NumericColumn,
    TextColumn,
    column_from_values,
)
from .core import DataReader

_META_KEY = b"transmogrifai_tpu.feature_types"


def _require_pyarrow():
    try:
        import pyarrow  # noqa: F401
        import pyarrow.parquet  # noqa: F401
    except ImportError as e:  # pragma: no cover - env-dependent
        raise ImportError(
            "pyarrow is required for parquet/arrow ingestion; install it or "
            "use the CSV reader (readers.csv)"
        ) from e
    import pyarrow as pa

    return pa


def _arrow_to_ftype(pa: Any, typ: Any) -> type:
    """Arrow type -> feature type (FeatureBuilder.fromDataFrame's
    schema-directed inference, features/FeatureBuilder.scala:232)."""
    if pa.types.is_boolean(typ):
        return T.Binary
    if pa.types.is_integer(typ):
        return T.Integral
    if pa.types.is_floating(typ) or pa.types.is_decimal(typ):
        return T.Real
    if pa.types.is_timestamp(typ):
        return T.DateTime
    if pa.types.is_date(typ):
        return T.Date
    if pa.types.is_string(typ) or pa.types.is_large_string(typ):
        return T.Text
    if pa.types.is_list(typ) or pa.types.is_large_list(typ):
        inner = typ.value_type
        if pa.types.is_string(inner) or pa.types.is_large_string(inner):
            return T.TextList
        if pa.types.is_timestamp(inner):
            return T.DateTimeList
        if pa.types.is_integer(inner):
            # FeatureSparkTypes.scala:216 maps ArrayType(LongType) to
            # DateList; DateTimeList is reserved for timestamp elements
            return T.DateList
        if pa.types.is_floating(inner):
            return T.Geolocation
        return T.TextList
    if pa.types.is_map(typ):
        val = typ.item_type
        if pa.types.is_floating(val) or pa.types.is_decimal(val):
            return T.RealMap
        if pa.types.is_integer(val):
            return T.IntegralMap
        if pa.types.is_boolean(val):
            return T.BinaryMap
        return T.TextMap
    if pa.types.is_struct(typ):
        return T.TextMap
    return T.Text


def _numeric_from_chunked(ftype: type, arr: Any, dtype: Any) -> NumericColumn:
    """Zero-boxing path: arrow buffer -> (values, mask) ndarrays."""
    np_arr = arr.to_numpy(zero_copy_only=False)
    if np_arr.dtype == object:  # nullable ints surface as object
        mask = np.array([v is not None for v in np_arr], dtype=bool)
        vals = np.array(
            [v if v is not None else 0 for v in np_arr], dtype=dtype
        )
        return NumericColumn(ftype, vals, mask)
    mask = ~np.isnan(np_arr) if np_arr.dtype.kind == "f" else np.ones(
        len(np_arr), dtype=bool
    )
    null_mask = arr.is_null().to_numpy(zero_copy_only=False)
    mask &= ~null_mask
    # only NaN means missing; +/-inf are real values and must survive
    vals = np.nan_to_num(np_arr, nan=0.0, posinf=np.inf, neginf=-np.inf)
    return NumericColumn(ftype, vals.astype(dtype, copy=False), mask)


def dataset_from_arrow(
    table: Any, type_overrides: dict[str, type] | None = None
) -> Dataset:
    """Typed columnar Dataset from a pyarrow Table."""
    pa = _require_pyarrow()
    overrides = dict(type_overrides or {})
    # honor feature types a previous write_parquet stamped into the schema
    meta = table.schema.metadata or {}
    if _META_KEY in meta:
        by_name = T.FEATURE_TYPES_BY_NAME
        stamped = json.loads(meta[_META_KEY].decode())
        for name, tname in stamped.items():
            if name not in overrides and tname in by_name:
                overrides[name] = by_name[tname]

    columns: dict[str, Any] = {}
    for field in table.schema:
        name = field.name
        arr = table.column(name).combine_chunks()
        ftype = overrides.get(name) or _arrow_to_ftype(pa, field.type)
        storage = ftype.storage
        if storage in (T.Storage.REAL,):
            columns[name] = _numeric_from_chunked(ftype, arr, np.float64)
        elif storage in (T.Storage.INTEGRAL, T.Storage.DATE):
            if pa.types.is_timestamp(field.type):
                # normalize to epoch millis (the reference's Date unit)
                arr = arr.cast(pa.timestamp("ms")).cast(pa.int64())
            elif pa.types.is_date(field.type):
                import pyarrow.compute as pc

                if pa.types.is_date32(field.type):  # days -> epoch millis
                    arr = arr.cast(pa.int32()).cast(pa.int64())
                    arr = pc.multiply(arr, pa.scalar(86_400_000, type=pa.int64()))
                else:  # date64 is already millis
                    arr = arr.cast(pa.int64())
            columns[name] = _numeric_from_chunked(ftype, arr, np.int64)
        elif storage is T.Storage.BINARY:
            columns[name] = _numeric_from_chunked(ftype, arr, bool)
        elif storage is T.Storage.TEXT:
            vals = arr.to_pylist()
            columns[name] = TextColumn.from_values(
                ftype, [None if v is None else str(v) for v in vals]
            )
        else:
            columns[name] = column_from_values(ftype, arr.to_pylist())
    return Dataset.of(columns)


def infer_parquet_dataset(
    path: str, type_overrides: dict[str, type] | None = None
) -> Dataset:
    """Read a parquet file into a typed Dataset (DataReaders.Simple.parquetCase)."""
    _require_pyarrow()
    import pyarrow.parquet as pq

    return dataset_from_arrow(pq.read_table(path), type_overrides)


def read_parquet(path: str, **kwargs: Any) -> Dataset:
    return infer_parquet_dataset(path, **kwargs)


def write_parquet(dataset: Dataset, path: str) -> None:
    """Persist a typed Dataset, stamping feature types into file metadata so
    ``read_parquet`` round-trips exactly (RichDataset.saveAvro analog)."""
    pa = _require_pyarrow()
    import pyarrow.parquet as pq

    arrays, names, stamped = [], [], {}
    for name, col in dataset.columns.items():
        stamped[name] = col.feature_type.__name__
        if isinstance(col, NumericColumn):
            vals = col.values.astype(object)
            vals[~col.mask] = None
            arrays.append(pa.array(vals.tolist()))
        elif isinstance(col, (TextColumn, ListColumn, MapColumn)):
            vals = col.to_list()
            if isinstance(col, MapColumn):
                # empty map ≠ missing: only None becomes null
                arrays.append(
                    pa.array(
                        [
                            list(v.items()) if v is not None else None
                            for v in vals
                        ],
                        type=_map_arrow_type(pa, vals),
                    )
                )
            elif isinstance(col, ListColumn):
                arrays.append(
                    pa.array([list(v) if v is not None else None for v in vals])
                )
            else:
                arrays.append(pa.array(vals))
        else:
            # vector/prediction/set columns: store as list<double>/list<string>
            vals = col.to_list()
            arrays.append(
                pa.array([
                    None if v is None
                    else sorted(v) if isinstance(v, frozenset)
                    else list(np.asarray(v, dtype=float))
                    for v in vals
                ])
            )
        names.append(name)
    table = pa.table(dict(zip(names, arrays)))
    table = table.replace_schema_metadata(
        {**(table.schema.metadata or {}), _META_KEY: json.dumps(stamped).encode()}
    )
    pq.write_table(table, path)


def _map_arrow_type(pa: Any, vals: list) -> Any:
    for v in vals:
        if v:
            sample = next(iter(v.values()))
            if isinstance(sample, bool):
                return pa.map_(pa.string(), pa.bool_())
            if isinstance(sample, (int, np.integer)):
                return pa.map_(pa.string(), pa.int64())
            if isinstance(sample, (float, np.floating)):
                return pa.map_(pa.string(), pa.float64())
            break
    return pa.map_(pa.string(), pa.string())


class ParquetReader(DataReader):
    """Record reader over parquet rows (DataReaders.Simple.parquetCase)."""

    def __init__(self, path: str, key_fn: Callable[[Any], str] | None = None):
        super().__init__(key_fn)
        self.path = path

    def read_records(self) -> Iterable[dict[str, Any]]:
        _require_pyarrow()
        import pyarrow.parquet as pq

        return pq.read_table(self.path).to_pylist()


# --- avro --------------------------------------------------------------------

def _read_avro_records(path: str) -> list[dict[str, Any]]:
    """The records of an Avro container file, through the package's own
    decoder (``utils/avro.py``; the port depends on no Avro library)."""
    from ..utils.avro import read_avro

    return read_avro(path)


def _avro_value_type(values: list[Any]) -> type:
    """Feature type from decoded Avro values (CSVAutoReaders.scala infers
    from the Avro schema; here the schema already decoded to Python)."""
    present = [v for v in values if v is not None]
    if not present:
        return T.Text
    if all(isinstance(v, bool) for v in present):
        return T.Binary
    if all(isinstance(v, int) and not isinstance(v, bool) for v in present):
        return T.Integral
    if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in present):
        return T.Real
    if all(isinstance(v, list) for v in present):
        return T.TextList
    if all(isinstance(v, dict) for v in present):
        inner = [x for v in present for x in v.values() if x is not None]
        if inner and all(
            isinstance(x, (int, float)) and not isinstance(x, bool)
            for x in inner
        ):
            return T.RealMap
        return T.TextMap
    return T.Text


def infer_avro_dataset(path: str, **kwargs: Any) -> Dataset:
    """DataReaders.Simple.avro equivalent (CSVAutoReaders.scala)."""
    records = _read_avro_records(path)
    names: list[str] = []
    for r in records:
        for k in r:
            if k not in names:
                names.append(k)
    overrides = kwargs.get("type_overrides", {})
    cols = {}
    for n in names:
        values = [r.get(n) for r in records]
        cols[n] = column_from_values(
            overrides.get(n, _avro_value_type(values)), values
        )
    return Dataset.of(cols)


class AvroReader(DataReader):
    def __init__(self, path: str, key_fn: Callable[[Any], str] | None = None):
        super().__init__(key_fn)
        self.path = path

    def read_records(self) -> Iterable[dict[str, Any]]:
        return _read_avro_records(self.path)
