"""DataReader core: records -> raw-feature columns (DataReader.scala:57-203).
A reader reads its source records and applies each raw feature's
extraction, giving one Column per raw feature. The aggregate, streaming
and joined readers are not ported yet (``ROADMAP.md`` A12);
``DatasetReader`` passes an already columnar dataset through."""
from __future__ import annotations

from typing import Any, Callable, Iterable, Sequence

from ..dataset import Dataset
from ..features.feature import Feature, FeatureGeneratorStage


class DataReader:
    """Base reader (DataReader.scala:57)."""

    def __init__(self, key_fn: Callable[[Any], str] | None = None):
        self.key_fn = key_fn

    def read_records(self) -> Iterable[Any]:  # pragma: no cover - abstract
        raise NotImplementedError

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        """One column per raw feature, extracted from the records; keyed
        readers add the ``key`` column."""
        records = list(self.read_records())
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
