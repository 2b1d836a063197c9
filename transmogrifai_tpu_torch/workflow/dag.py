"""DAG assembly from result features: map every stage to its longest
distance from a result feature and group into layers, deepest first, so a
stage runs only after all its ancestors. Raw-feature leaves are excluded."""
from __future__ import annotations

from typing import Iterable

from ..features.feature import Feature, FeatureGeneratorStage
from ..stages.base import PipelineStage


def compute_dag(result_features: Iterable[Feature]) -> list[list[PipelineStage]]:
    """Layers of stages, deepest (furthest from results) first."""
    dists: dict[PipelineStage, int] = {}
    for rf in result_features:
        for stage, d in rf.parent_stages().items():
            if isinstance(stage, FeatureGeneratorStage):
                continue
            if dists.get(stage, -1) < d:
                dists[stage] = d
    by_depth: dict[int, list[PipelineStage]] = {}
    for stage, d in dists.items():
        by_depth.setdefault(d, []).append(stage)
    return [
        sorted(by_depth[d], key=lambda s: s.uid)
        for d in sorted(by_depth, reverse=True)
    ]
