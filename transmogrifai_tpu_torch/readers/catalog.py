"""Reader catalog — the ``DataReaders.Simple/Aggregate/Conditional`` factory
surface (readers/.../DataReaders.scala:44-198), so reference users find the
same entry points by name.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable

from .aggregate import (
    AggregateParams,
    AggregateReader,
    ConditionalParams,
    ConditionalReader,
)
from .core import DatasetReader, SimpleReader
from .csv import CsvReader
from .parquet import AvroReader, ParquetReader


class Simple:
    """One record per row (DataReaders.scala:49-116)."""

    @staticmethod
    def csv(path: str, key_fn: Callable[[Any], str] | None = None, **kw: Any) -> CsvReader:
        return CsvReader(path, key_fn=key_fn, **kw)

    @staticmethod
    def parquet(path: str, key_fn: Callable[[Any], str] | None = None) -> ParquetReader:
        return ParquetReader(path, key_fn=key_fn)

    @staticmethod
    def avro(path: str, key_fn: Callable[[Any], str] | None = None) -> AvroReader:
        return AvroReader(path, key_fn=key_fn)

    @staticmethod
    def records(records: Iterable[Any], key_fn: Callable[[Any], str] | None = None) -> SimpleReader:
        """csvCase/parquetCase analog: pre-parsed records (dicts/dataclasses)."""
        return SimpleReader(records, key_fn=key_fn)

    @staticmethod
    def dataset(ds: Any) -> DatasetReader:
        return DatasetReader(ds)


class Aggregate:
    """Group events by key and monoid-aggregate them with a CutOffTime
    (DataReaders.scala:116-160; AggregateParams DataReader.scala:279)."""

    @staticmethod
    def records(
        records: Iterable[Any],
        key_fn: Callable[[Any], str],
        params: AggregateParams,
    ) -> AggregateReader:
        return AggregateReader(records, key_fn=key_fn, aggregate_params=params)

    @staticmethod
    def csv(
        path: str, key_fn: Callable[[Any], str], params: AggregateParams, **kw: Any
    ) -> AggregateReader:
        return AggregateReader(
            CsvReader(path, **kw).read_records(), key_fn=key_fn, aggregate_params=params
        )

    @staticmethod
    def parquet(
        path: str, key_fn: Callable[[Any], str], params: AggregateParams
    ) -> AggregateReader:
        return AggregateReader(
            ParquetReader(path).read_records(), key_fn=key_fn, aggregate_params=params
        )


class Conditional:
    """Aggregate relative to a per-key target event time — temporally
    leakage-free labels (DataReaders.scala:160-198; ConditionalParams
    DataReader.scala:351)."""

    @staticmethod
    def records(
        records: Iterable[Any],
        key_fn: Callable[[Any], str],
        params: ConditionalParams,
    ) -> ConditionalReader:
        return ConditionalReader(records, key_fn=key_fn, conditional_params=params)

    @staticmethod
    def csv(
        path: str, key_fn: Callable[[Any], str], params: ConditionalParams, **kw: Any
    ) -> ConditionalReader:
        return ConditionalReader(
            CsvReader(path, **kw).read_records(), key_fn=key_fn, conditional_params=params
        )

    @staticmethod
    def parquet(
        path: str, key_fn: Callable[[Any], str], params: ConditionalParams
    ) -> ConditionalReader:
        return ConditionalReader(
            ParquetReader(path).read_records(), key_fn=key_fn, conditional_params=params
        )


class DataReaders:
    Simple = Simple
    Aggregate = Aggregate
    Conditional = Conditional
