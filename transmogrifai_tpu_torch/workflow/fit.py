"""DAG fitting engine (FitStagesUtil.scala:212-290): per layer, fit every
estimator on the current dataset, then apply all of the layer's (fitted)
transformers, each appending its output column. The reference's prefetch
of the next layer's inputs, telemetry spans, fault plans and layer
checkpoints are not ported yet (``ROADMAP.md`` A12, A14)."""
from __future__ import annotations

from typing import Iterable

from ..dataset import Dataset
from ..features.feature import Feature
from ..stages.base import Estimator, PipelineStage, Transformer
from .dag import compute_dag


def fit_and_transform_dag(
    dataset: Dataset,
    result_features: Iterable[Feature],
    prefitted: dict[str, PipelineStage] | None = None,
) -> tuple[Dataset, dict[str, PipelineStage]]:
    """Fit the whole DAG: (transformed dataset, fitted stage by original
    stage uid). ``prefitted`` supplies already-fitted models by estimator
    uid; those estimators are not fitted again."""
    fitted: dict[str, PipelineStage] = {}
    dataset = _fit_layers(
        compute_dag(list(result_features)), dataset, fitted, prefitted or {}
    )
    return dataset, fitted


def _fit_layers(layers, dataset, fitted, prefitted) -> Dataset:
    for layer in layers:
        dataset = _fit_one_layer(layer, dataset, fitted, prefitted)
    return dataset


def _fit_one_layer(layer, dataset, fitted, prefitted) -> Dataset:
    """One DAG layer: fit its estimators, then apply its transformers."""
    transformers: list[Transformer] = []
    for stage in layer:
        if stage.uid in prefitted:
            model = prefitted[stage.uid]
        elif isinstance(stage, Estimator):
            model = stage.fit(dataset)
        elif isinstance(stage, Transformer):
            model = stage
        else:
            raise TypeError(f"Cannot fit {stage}")
        fitted[stage.uid] = model
        transformers.append(model)
    for t in transformers:
        dataset = t.transform(dataset)
    return dataset


def apply_transformations_dag(
    dataset: Dataset,
    result_features: Iterable[Feature],
    fitted: dict[str, PipelineStage],
) -> Dataset:
    """Scoring path: apply the fitted DAG (OpWorkflowCore.scala:324)."""
    for layer in compute_dag(list(result_features)):
        for stage in layer:
            t = fitted.get(stage.uid, stage)
            if isinstance(t, Estimator):
                raise ValueError(f"Stage {t} was never fitted")
            dataset = t.transform(dataset)
    return dataset
