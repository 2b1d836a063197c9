"""WorkflowModel — a fitted workflow as loading and scoring need it: the
result and raw features, the fitted stages, and the device the predictors
run on."""
from __future__ import annotations

import torch

from ..features.feature import Feature
from ..stages.base import PipelineStage
from ..utils.device import resolve_device
from .dag import compute_dag


class WorkflowModel:
    def __init__(
        self,
        result_features: tuple[Feature, ...],
        raw_features: tuple[Feature, ...],
        fitted: dict[str, PipelineStage],
        device: torch.device,
    ):
        self.result_features = result_features
        self.raw_features = raw_features
        self.fitted = fitted
        self.device = device

    def to(self, device=None) -> "WorkflowModel":
        """Place every fitted stage on ``device`` (``None`` means ``cuda``)."""
        dev = resolve_device(device)
        if dev != self.device:
            for stage in self.fitted.values():
                stage.to(dev)
            self.device = dev
        return self

    def stage_plan(self) -> list[PipelineStage]:
        """The fitted DAG flattened into application order."""
        return [
            stage for layer in compute_dag(self.result_features)
            for stage in layer
        ]
