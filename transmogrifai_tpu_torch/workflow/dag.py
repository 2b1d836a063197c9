"""DAG assembly from result features: map every stage to its longest
distance from a result feature and group into layers, deepest first, so a
stage runs only after all its ancestors. Raw-feature leaves are excluded
(``raw_features_of`` lists them); ``validate_stages`` checks the layers
before a train."""
from __future__ import annotations

from typing import Iterable

from ..features.feature import Feature, FeatureGeneratorStage
from ..stages.base import Estimator, PipelineStage, Transformer


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


def validate_stages(layers: list[list[PipelineStage]]) -> None:
    """Workflow-level stage validation (OpWorkflow.scala:280-338): every
    stage is an Estimator or a Transformer with its inputs wired and of its
    declared types, uids are distinct, and so are output feature names.
    Raises one ``ValueError`` listing every finding, each naming its stage
    and feature."""
    findings: list[str] = []
    by_uid: dict[str, PipelineStage] = {}
    by_output: dict[str, PipelineStage] = {}
    for s in (s for layer in layers for s in layer):
        if not isinstance(s, (Estimator, Transformer)):
            findings.append(f"stage {s!r} is neither Estimator nor Transformer")
            continue
        if not s.input_features:
            findings.append(f"stage {s!r} has no input features wired")
            continue
        declared = getattr(s, "input_types", None)
        if declared is not None:
            if len(s.input_features) != len(declared):
                findings.append(
                    f"stage {s!r} expects {len(declared)} input(s), got "
                    f"{len(s.input_features)} ({', '.join(s.input_names)})"
                )
            else:
                for i, (f, want) in enumerate(zip(s.input_features, declared)):
                    if not issubclass(f.ftype, want):
                        findings.append(
                            f"stage {s!r} input {i} ('{f.name}') has type "
                            f"{f.ftype.__name__}, expected {want.__name__}"
                        )
        prior = by_uid.setdefault(s.uid, s)
        if prior is not s:
            findings.append(
                f"duplicate stage uid '{s.uid}' on distinct stages "
                f"{type(prior).__name__} and {type(s).__name__}"
            )
        prior = by_output.setdefault(s.output_name, s)
        if prior is not s:
            findings.append(
                f"stages {prior!r} and {s!r} both produce output feature "
                f"'{s.output_name}'"
            )
    if findings:
        raise ValueError("invalid workflow stages:\n  " + "\n  ".join(findings))


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
