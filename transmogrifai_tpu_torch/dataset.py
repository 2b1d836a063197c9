"""Columnar Dataset — an ordered mapping feature-name -> Column plus a row
count. Transformers append columns; estimators reduce columns to small
summaries. All columns share one length."""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from .types.columns import Column


@dataclasses.dataclass
class Dataset:
    columns: dict[str, Column]
    num_rows: int

    @staticmethod
    def of(columns: dict[str, Column]) -> "Dataset":
        lengths = {name: len(c) for name, c in columns.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"Ragged dataset: {lengths}")
        n = next(iter(lengths.values())) if lengths else 0
        return Dataset(dict(columns), n)

    def __len__(self) -> int:
        return self.num_rows

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self.columns)

    def with_column(self, name: str, col: Column) -> "Dataset":
        if len(col) != self.num_rows and self.columns:
            raise ValueError(
                f"Column '{name}' has {len(col)} rows, dataset has "
                f"{self.num_rows}"
            )
        cols = dict(self.columns)
        cols[name] = col
        return Dataset(cols, self.num_rows if self.num_rows else len(col))

    def select(self, names: list[str]) -> "Dataset":
        return Dataset({n: self.columns[n] for n in names}, self.num_rows)

    def drop(self, names: list[str]) -> "Dataset":
        gone = set(names)
        return Dataset(
            {n: c for n, c in self.columns.items() if n not in gone},
            self.num_rows,
        )

    def take(self, indices: np.ndarray) -> "Dataset":
        indices = np.asarray(indices)
        return Dataset(
            {n: c.take(indices) for n, c in self.columns.items()}, len(indices)
        )

    def rows(self, names: list[str] | None = None) -> list[dict]:
        """Row-wise dict view."""
        names = list(self.columns) if names is None else names
        cols = {n: self.columns[n].to_list() for n in names}
        return [
            {n: cols[n][i] for n in names} for i in range(self.num_rows)
        ]
