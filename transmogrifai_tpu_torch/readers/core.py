"""DataReader core: records -> raw-feature columns (DataReader.scala:57-203).
A reader reads its source records and applies each raw feature's
extraction, giving one Column per raw feature. ``DatasetReader`` passes an
already columnar dataset through; the aggregate and conditional readers
are ``readers/aggregate.py``, the joined ones ``readers/joins.py``, the
streamed ones ``readers/streaming.py`` and the file formats
``readers/{csv,parquet}.py``. Record
reads go through a ``RetryPolicy`` (``resilience/retry.py``): transient
errors back off and retry, every other error, a kernel fault among them,
fails at once."""
from __future__ import annotations

from typing import Any, Callable, Iterable, Sequence

from ..dataset import Dataset
from ..features.feature import Feature, FeatureGeneratorStage


class DataReader:
    """Base reader (DataReader.scala:57)."""

    #: retry policy for record I/O; None picks the module default
    #: (``resilience.retry.default_io_policy``)
    retry_policy = None

    def __init__(self, key_fn: Callable[[Any], str] | None = None):
        self.key_fn = key_fn

    def read_records(self) -> Iterable[Any]:  # pragma: no cover - abstract
        raise NotImplementedError

    def is_unbounded(self) -> bool:
        """Whether the source declares no known size. Materializing readers
        are bounded; a streaming source returns True and ``Workflow.train``
        routes it through the out-of-core fit (``workflow/stream.py``)."""
        return False

    def _read_records_with_retry(self) -> list[Any]:
        from ..resilience.retry import default_io_policy

        policy = self.retry_policy or default_io_policy()
        records, attempts = policy.call(lambda: list(self.read_records()))
        if attempts > 1:
            import logging

            logging.getLogger(__name__).warning(
                "reader %s succeeded after %d attempts",
                type(self).__name__, attempts,
            )
        return records

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        """One column per raw feature, extracted from the records; keyed
        readers add the ``key`` column."""
        records = self._read_records_with_retry()
        cols = {}
        for f in raw_features:
            stage = f.origin_stage
            if not isinstance(stage, FeatureGeneratorStage):
                raise TypeError(
                    f"Raw feature {f.name} must originate from a "
                    "FeatureGeneratorStage"
                )
            cols[f.name] = stage.extract_column(records)
        if self.key_fn is not None and "key" not in cols:
            from .. import types as T
            from ..types.columns import column_from_values

            cols = {
                "key": column_from_values(
                    T.ID, [self.key_fn(r) for r in records]
                ),
                **cols,
            }
        return Dataset.of(cols)


class SimpleReader(DataReader):
    """One record per row (DataReaders.Simple, DataReaders.scala:44)."""

    def __init__(
        self, records: Iterable[Any], key_fn: Callable[[Any], str] | None = None
    ):
        super().__init__(key_fn)
        self._records = records

    def read_records(self) -> Iterable[Any]:
        return self._records


class DatasetReader(DataReader):
    """Pass-through reader over an already columnar Dataset (the
    ``set_input_dataset`` path, core/.../OpWorkflowCore.scala)."""

    def __init__(self, dataset: Dataset):
        super().__init__(None)
        self.dataset = dataset

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        cols = {}
        rows = None  # the row-wise view, made at most once
        for f in raw_features:
            stage = f.origin_stage
            if (
                isinstance(stage, FeatureGeneratorStage)
                and stage.extract_fn is not None
            ):
                # the user's extraction always wins over a column by name
                if rows is None:
                    rows = self.dataset.rows()
                cols[f.name] = stage.extract_column(rows)
            elif f.name in self.dataset:
                cols[f.name] = self.dataset[f.name]
            else:
                raise KeyError(
                    f"Raw feature '{f.name}' missing from input dataset"
                )
        return Dataset.of(cols)
