"""Feature — a node in the lineage-traced feature DAG.

A Feature is a typed, named handle produced by an origin stage from parent
features. Scoring walks ``origin_stage`` / inputs backwards from the result
features to rebuild the stage DAG.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

from .. import types as T
from ..stages.base import PipelineStage, Transformer
from ..types.columns import Column, column_from_values
from ..utils import uid as uid_util


@dataclasses.dataclass(eq=False)
class Feature:
    name: str
    ftype: type
    origin_stage: PipelineStage | None = None
    parents: tuple["Feature", ...] = ()
    is_response: bool = False
    uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = uid_util.make_uid("Feature")

    @property
    def is_raw(self) -> bool:
        return isinstance(self.origin_stage, FeatureGeneratorStage)

    def transform_with(self, stage: PipelineStage, *others: "Feature") -> Any:
        """Apply a stage to this feature (+ others): its output feature."""
        stage.set_input(self, *others)
        return stage.get_output()

    def _live_parents(self) -> tuple["Feature", ...]:
        stage = self.origin_stage
        if stage is not None and not isinstance(stage, FeatureGeneratorStage):
            return tuple(stage.input_features)
        return self.parents

    def parent_stages(self) -> dict[PipelineStage, int]:
        """All ancestor stages mapped to their LONGEST distance from this
        feature, so a stage runs only after everything it needs."""
        dists: dict[PipelineStage, int] = {}

        def visit(feature: "Feature", depth: int) -> None:
            stage = feature.origin_stage
            if stage is None or dists.get(stage, -1) >= depth:
                return
            dists[stage] = depth
            for p in feature._live_parents():
                visit(p, depth + 1)

        visit(self, 0)
        return dists

    def raw_features(self) -> list["Feature"]:
        """All raw-feature leaves under this feature; two distinct raw
        features sharing a name is an error."""
        seen: dict[str, Feature] = {}

        def visit(f: "Feature") -> None:
            if f.is_raw or f.origin_stage is None:
                prior = seen.get(f.name)
                if prior is not None and prior.uid != f.uid:
                    raise ValueError(
                        f"Two distinct raw features named '{f.name}' in one DAG"
                    )
                seen[f.name] = f
            for p in f._live_parents():
                visit(p)

        visit(self)
        return list(seen.values())

    def history(self) -> dict[str, Any]:
        """Originating raw features and the stages' operation names
        (FeatureLike.history)."""
        stages = sorted(self.parent_stages(), key=lambda s: s.uid)
        return {
            "originFeatures": sorted(f.name for f in self.raw_features()),
            "stages": [s.operation_name for s in stages],
        }

    def __repr__(self) -> str:
        kind = "response" if self.is_response else "predictor"
        return f"Feature[{self.ftype.__name__}]({self.name!r}, {kind})"

    def __hash__(self) -> int:
        return hash(self.uid)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Feature) and other.uid == self.uid


class FeatureGeneratorStage(Transformer):
    """DAG leaf: one raw feature. Its column is built by a reader from the
    source records (``extract_fn`` maps one record to a raw value; without
    one, dict records are read by the feature's name), not by the DAG."""

    def __init__(
        self, name: str, ftype: type,
        extract_fn: Callable[[Any], Any] | None = None,
        is_response: bool = False, uid: str | None = None,
    ):
        super().__init__(operation_name=f"featureGen_{name}", uid=uid)
        self.feature_name = name
        self.ftype = ftype
        self.extract_fn = extract_fn
        self.is_response = is_response

    @property
    def output_name(self) -> str:  # type: ignore[override]
        return self.feature_name

    def get_output(self) -> Feature:
        return Feature(
            name=self.feature_name,
            ftype=self.ftype,
            origin_stage=self,
            parents=(),
            is_response=self.is_response,
        )

    def extract_column(self, records: Iterable[Any]) -> Column:
        records = list(records)
        if self.extract_fn:
            values = [self.extract_fn(r) for r in records]
        elif records and isinstance(records[0], dict):
            # row dicts carry every header key in every record; a map
            # feature's records may be the raw map values themselves
            if self.feature_name in records[0]:
                values = [r.get(self.feature_name) for r in records]
            elif issubclass(self.ftype, T.OPMap):
                values = records
            else:
                raise KeyError(
                    f"Raw feature '{self.feature_name}' missing from the "
                    f"record stream (record keys: {sorted(records[0])[:8]}...)"
                )
        else:
            values = records
        return column_from_values(self.ftype, values)

    def transform_columns(self, *cols: Column, num_rows: int) -> Column:
        raise TypeError("FeatureGeneratorStage runs in the reader, not the DAG")
