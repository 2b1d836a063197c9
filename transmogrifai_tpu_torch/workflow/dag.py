"""DAG assembly from result features: map every stage to its longest
distance from a result feature and group into layers, deepest first, so a
stage runs only after all its ancestors. Raw-feature leaves are excluded
(``raw_features_of`` lists them)."""
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


def raw_features_of(result_features: Iterable[Feature]) -> list[Feature]:
    """All distinct raw-feature leaves the result features need; distinct
    raw features sharing a name is an error."""
    seen: dict[str, Feature] = {}
    for rf in result_features:
        for f in rf.raw_features():
            prior = seen.get(f.name)
            if prior is not None and prior.uid != f.uid:
                raise ValueError(
                    f"Two distinct raw features named '{f.name}' in one workflow"
                )
            seen[f.name] = f
    return list(seen.values())
