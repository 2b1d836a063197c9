"""Vector column provenance metadata: every column of a feature vector
records which raw feature(s) it came from, the parent feature type, an
optional grouping (the pivot group), an optional indicator value (the
pivoted value, OTHER, or the null-indicator marker) and an optional
descriptor. Field for field the same records as the reference's, so a saved
model's metadata loads unchanged."""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Sequence

#: marks null-indicator columns
NULL_STRING = "NullIndicatorValue"
#: marks the other/rest pivot bucket
OTHER_STRING = "OTHER"


@dataclasses.dataclass(frozen=True)
class ColumnMeta:
    """One vector column's provenance."""

    parent_names: tuple[str, ...]
    parent_type: str
    grouping: str | None = None
    indicator_value: str | None = None
    descriptor_value: str | None = None
    index: int = 0

    def make_name(self) -> str:
        """Human-readable column name (OpVectorColumnMetadata.makeColName)."""
        parts = ["_".join(self.parent_names)]
        if self.grouping:
            parts.append(self.grouping)
        if self.descriptor_value:
            parts.append(self.descriptor_value)
        if self.indicator_value:
            parts.append(self.indicator_value)
        return "_".join(parts) + f"_{self.index}"

    def grouped_key(self) -> tuple:
        """The pivot group this column belongs to: the SanityChecker drops
        a group's columns together."""
        return (self.parent_names, self.grouping)

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict[str, Any]) -> "ColumnMeta":
        d = dict(d)
        d["parent_names"] = tuple(d["parent_names"])
        return ColumnMeta(**d)


@dataclasses.dataclass
class VectorMetadata:
    """Provenance for a whole feature vector."""

    name: str
    columns: tuple[ColumnMeta, ...] = ()

    @property
    def size(self) -> int:
        return len(self.columns)

    def column_names(self) -> list[str]:
        return [c.make_name() for c in self.columns]

    @staticmethod
    def flatten(name: str, parts: Sequence["VectorMetadata"]) -> "VectorMetadata":
        """Concatenate per-vectorizer metadata, reindexing columns."""
        cols: list[ColumnMeta] = []
        for part in parts:
            for c in part.columns:
                cols.append(dataclasses.replace(c, index=len(cols)))
        return VectorMetadata(name, tuple(cols))

    def select(self, indices: Iterable[int]) -> "VectorMetadata":
        """Keep a subset of columns, reindexed."""
        cols = [
            dataclasses.replace(self.columns[i], index=j)
            for j, i in enumerate(indices)
        ]
        return VectorMetadata(self.name, tuple(cols))

    def index_of_group(self) -> dict[tuple, list[int]]:
        """Pivot-group key -> column indices (group-wise removal)."""
        groups: dict[tuple, list[int]] = {}
        for i, c in enumerate(self.columns):
            groups.setdefault(c.grouped_key(), []).append(i)
        return groups

    def to_json(self) -> dict[str, Any]:
        return {"name": self.name, "columns": [c.to_json() for c in self.columns]}

    @staticmethod
    def from_json(d: dict[str, Any]) -> "VectorMetadata":
        return VectorMetadata(
            d["name"], tuple(ColumnMeta.from_json(c) for c in d["columns"])
        )
