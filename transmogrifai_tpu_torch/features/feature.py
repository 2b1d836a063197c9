"""Feature — a node in the lineage-traced feature DAG.

A Feature is a typed, named handle produced by an origin stage from parent
features. Scoring walks ``origin_stage`` / inputs backwards from the result
features to rebuild the stage DAG.
"""
from __future__ import annotations

import dataclasses

from ..stages.base import PipelineStage, Transformer
from ..types.columns import Column
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

    def __repr__(self) -> str:
        kind = "response" if self.is_response else "predictor"
        return f"Feature[{self.ftype.__name__}]({self.name!r}, {kind})"

    def __hash__(self) -> int:
        return hash(self.uid)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Feature) and other.uid == self.uid


class FeatureGeneratorStage(Transformer):
    """DAG leaf: one raw feature. Its column is built from the request rows
    by name, not by the DAG."""

    def __init__(
        self, name: str, ftype: type, is_response: bool = False,
        uid: str | None = None,
    ):
        super().__init__(operation_name=f"featureGen_{name}", uid=uid)
        self.feature_name = name
        self.ftype = ftype
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

    def transform_columns(self, *cols: Column, num_rows: int) -> Column:
        raise TypeError("FeatureGeneratorStage runs in the reader, not the DAG")
