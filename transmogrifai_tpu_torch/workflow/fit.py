"""DAG fitting engine (FitStagesUtil.scala:212-290): per layer, fit every
estimator on the current dataset, then apply all of the layer's (fitted)
transformers, each appending its output column.

An installed fault plan (``resilience/faults.py``) is consulted before each
estimator fit (``fail_stage_fit``), on each transform's output
(``nan_output``, and ``slow_stage``'s simulated seconds, which land on the
run recorder's timings) and at each layer's end (``crash_after_layer``,
the retrain-scoped ``fail_retrain`` / ``crash_retrain``). With a
``CheckpointManager`` every completed layer's fitted stages are persisted
atomically before that hook, so a killed run resumes through the
``prefitted`` warm-start seam. The active run recorder
(``telemetry/runlog.py``) gets a pulse at each layer's start and end, and
each layer, fit and transform runs under a telemetry span. The port's
fits upload their own inputs, so there is no prefetch of the next layer's
matrices; a failover controller's heartbeat at the layer boundary is
distributed resilience, ``ROADMAP.md`` A13b.
"""
from __future__ import annotations

from typing import Iterable

from ..dataset import Dataset
from ..features.feature import Feature
from ..resilience import faults
from ..stages.base import Estimator, Model, PipelineStage, Transformer
from ..telemetry import runlog as _runlog
from ..telemetry import spans as _tspans
from .dag import compute_dag


def fit_and_transform_dag(
    dataset: Dataset,
    result_features: Iterable[Feature],
    prefitted: dict[str, PipelineStage] | None = None,
    checkpoint=None,
) -> tuple[Dataset, dict[str, PipelineStage]]:
    """Fit the whole DAG: (transformed dataset, fitted stage by original
    stage uid). ``prefitted`` supplies already-fitted models by estimator
    uid; those estimators are not fitted again. ``checkpoint`` (a
    ``resilience.checkpoint.CheckpointManager``) persists each completed
    layer's fitted estimators."""
    layers = compute_dag(list(result_features))
    signature = None
    if checkpoint is not None:
        from ..resilience.checkpoint import dag_signature, dataset_fingerprint

        signature = dag_signature(layers, dataset_fingerprint(dataset))
    fitted: dict[str, PipelineStage] = {}
    prefitted = prefitted or {}
    plan = faults.active()
    recorder = _runlog.active_recorder()
    for li, layer in enumerate(layers):
        if recorder is not None:
            recorder.on_layer_start(li, total=len(layers))
        with _tspans.span("train/layer", index=li, stages=len(layer)):
            dataset = _fit_one_layer(
                li, layer, dataset, fitted, prefitted, plan, checkpoint,
                signature,
            )
        if recorder is not None:
            recorder.on_layer_end(
                li, total=len(layers), stages=len(layer),
                rows=dataset.num_rows,
            )
    return dataset, fitted


def _fit_one_layer(
    li, layer, dataset, fitted, prefitted, plan, checkpoint, signature,
) -> Dataset:
    """One DAG layer: fit its estimators, apply its transformers,
    checkpoint the layer, then the layer-end fault hook."""
    transformers: list[Transformer] = []
    newly_fitted = False
    for stage in layer:
        if stage.uid in prefitted:
            model = prefitted[stage.uid]
        elif isinstance(stage, Estimator):
            if plan is not None:
                plan.on_stage_fit(stage)
            with _tspans.span("train/fit", stage=type(stage).__name__):
                model = stage.fit(dataset)
            newly_fitted = True
        elif isinstance(stage, Transformer):
            model = stage
        else:
            raise TypeError(f"Cannot fit {stage}")
        fitted[stage.uid] = model
        transformers.append(model)
    for t in transformers:
        with _tspans.span("train/transform", stage=type(t).__name__):
            dataset = t.transform(dataset)
        if plan is not None:
            corrupted = plan.on_stage_output(t, dataset[t.output_name])
            if corrupted is not None:
                dataset = dataset.with_column(t.output_name, corrupted)
            # simulated slow-stage seconds ride the recorder's timings, as
            # the serving path's breaker-elapsed seconds do: no real sleep
            extra = plan.on_stage_duration(t)
            if extra:
                recorder = _runlog.active_recorder()
                if recorder is not None:
                    recorder.add_simulated(extra)
    if checkpoint is not None and (
        newly_fitted or not checkpoint.has_layer(li)
    ):
        # a layer restored intact from disk is not written again
        checkpoint.save_layer(
            li,
            signature,
            [
                (pos, s.uid, fitted[s.uid])
                for pos, s in enumerate(layer)
                if isinstance(fitted[s.uid], Model)
            ],
        )
    if plan is not None:
        plan.on_layer_end(li)
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
