"""SelectedModelCombiner — ensemble two model selectors, the port of the
JAX package's ``selector/combiner.py``.

Reference: core/.../stages/impl/selector/SelectedModelCombiner.scala (248
LoC): fits two ModelSelectors on the same (label, features) inputs and
either keeps the better one ("Best") or weight-averages their probability
outputs by validation metric ("Weighted"). The DAG still sees ONE selector
stage (the workflow's single-selector rule applies to the combiner itself).
"""
from __future__ import annotations

import enum
from typing import Any

import numpy as np

from ..evaluators import Evaluator
from ..models.base import PredictorModel
from .model_selector import ModelSelector, SelectedModel
from .validators import Validator


class CombinationStrategy(enum.Enum):
    """SelectedModelCombiner.scala combination strategies."""

    BEST = "Best"
    WEIGHTED = "Weighted"


class CombinedModel(PredictorModel):
    """Weighted-average of two fitted selector winners."""

    def __init__(
        self,
        model1: PredictorModel,
        model2: PredictorModel,
        weight1: float,
        weight2: float,
        problem_kind: str,
        uid=None,
    ):
        super().__init__("modelCombiner", uid=uid)
        self.model1 = model1
        self.model2 = model2
        total = weight1 + weight2
        self.weight1 = weight1 / total if total else 0.5
        self.weight2 = weight2 / total if total else 0.5
        self.problem_kind = problem_kind

    @property
    def kernel_libraries(self) -> tuple[str, ...]:
        return tuple(sorted(set(self.model1.kernel_libraries)
                            | set(self.model2.kernel_libraries)))

    def to(self, device) -> "CombinedModel":
        self.model1.to(device)
        self.model2.to(device)
        return self

    def predict_arrays(self, x: np.ndarray):
        p1, prob1, raw1 = self.model1.predict_arrays(x)
        p2, prob2, raw2 = self.model2.predict_arrays(x)
        if prob1 is not None and prob2 is not None:
            c = min(prob1.shape[1], prob2.shape[1])
            prob = self.weight1 * prob1[:, :c] + self.weight2 * prob2[:, :c]
            pred = prob.argmax(axis=1).astype(np.float64)
            return pred, prob, prob
        # regression: weighted mean of predictions
        pred = self.weight1 * p1 + self.weight2 * p2
        return pred, None, None

    def get_arrays(self):
        out = {f"m1__{k}": v for k, v in self.model1.get_arrays().items()}
        out.update({f"m2__{k}": v for k, v in self.model2.get_arrays().items()})
        return out

    def get_params(self):
        return {
            "model1_class": type(self.model1).__name__,
            "model1_params": self.model1.get_params(),
            "model2_class": type(self.model2).__name__,
            "model2_params": self.model2.get_params(),
            "weight1": self.weight1,
            "weight2": self.weight2,
            "problem_kind": self.problem_kind,
        }

    @classmethod
    def from_params(cls, params, arrays):
        from ..workflow.persistence import construct_stage

        m1 = construct_stage(
            params["model1_class"], params["model1_params"],
            {k[4:]: v for k, v in arrays.items() if k.startswith("m1__")},
        )
        m2 = construct_stage(
            params["model2_class"], params["model2_params"],
            {k[4:]: v for k, v in arrays.items() if k.startswith("m2__")},
        )
        return cls(m1, m2, params["weight1"], params["weight2"],
                   params.get("problem_kind", "unknown"))


class SelectedModelCombiner(ModelSelector):
    """Estimator[(RealNN, OPVector)] → Prediction wrapping TWO selectors
    (SelectedModelCombiner.scala). Fits both; combines by strategy."""

    def __init__(
        self,
        selector1: ModelSelector,
        selector2: ModelSelector,
        strategy: CombinationStrategy = CombinationStrategy.BEST,
        uid: str | None = None,
    ):
        super().__init__(
            validator=selector1.validator,
            splitter=selector1.splitter,
            models=list(selector1.models) + list(selector2.models),
            evaluator=selector1.evaluator,
            problem_kind=selector1.problem_kind,
            uid=uid,
        )
        if selector1.evaluator.name != selector2.evaluator.name:
            raise ValueError(
                "Combined selectors must share an evaluation metric "
                f"({selector1.evaluator.name} vs {selector2.evaluator.name})"
            )
        self.operation_name = "modelCombiner"
        self.selector1 = selector1
        self.selector2 = selector2
        self.strategy = strategy

    def get_params(self):
        return {"strategy": self.strategy.value, "problem_kind": self.problem_kind}

    def fit_arrays(self, x, y, row_mask) -> SelectedModel:
        # fit both selectors on the same data; each runs its own validation
        self.selector1.set_input(*self.input_features)
        self.selector2.set_input(*self.input_features)
        if self.precomputed_results is not None:
            # workflow-level CV validated the union of both selectors'
            # candidates: hand each selector its own families' results. An
            # empty share (all its families failed CV) falls back to that
            # selector's own validation rather than crashing best([]).
            uids1 = {est.uid for est, _ in self.selector1.models}
            r1 = [r for r in self.precomputed_results if r.model_uid in uids1]
            r2 = [r for r in self.precomputed_results if r.model_uid not in uids1]
            self.selector1.precomputed_results = r1 or None
            self.selector2.precomputed_results = r2 or None
            self.precomputed_results = None
        m1 = self.selector1.fit_arrays(x, y, row_mask)
        m2 = self.selector2.fit_arrays(x, y, row_mask)
        v1 = self._validation_metric(m1)
        v2 = self._validation_metric(m2)
        larger_better = self.evaluator.is_larger_better

        if self.strategy is CombinationStrategy.BEST:
            first_wins = (v1 >= v2) if larger_better else (v1 <= v2)
            winner, loser = (m1, m2) if first_wins else (m2, m1)
            summary = dict(winner.summary)
            summary["combinationStrategy"] = self.strategy.value
            summary["otherModelValidation"] = self._validation_metric(loser)
            summary["validationResults"] = (
                m1.summary["validationResults"] + m2.summary["validationResults"]
            )
            self.metadata["modelSelectorSummary"] = summary
            return SelectedModel(winner.best_model, summary)

        # Weighted: weights proportional to validation metric (inverted for
        # smaller-is-better metrics, SelectedModelCombiner.scala weighting);
        # a perfect 0.0 error metric gets a finite, strongly-dominant weight
        if larger_better:
            w1, w2 = v1, v2
        else:
            eps = 1e-12
            w1, w2 = 1.0 / max(v1, eps), 1.0 / max(v2, eps)
        combined = CombinedModel(
            m1.best_model, m2.best_model, w1, w2, self.problem_kind
        )
        summary = {
            "problemKind": self.problem_kind,
            "validationType": type(self.validator).__name__,
            "evaluationMetric": self.evaluator.default_metric,
            "bestModelName": "CombinedModel",
            "bestModelType": "CombinedModel",
            "bestGrid": {},
            "combinationStrategy": self.strategy.value,
            "weights": [combined.weight1, combined.weight2],
            "validationResults": (
                m1.summary["validationResults"] + m2.summary["validationResults"]
            ),
            "trainEvaluation": None,
            "extraTrainEvaluations": {},
            "holdoutEvaluation": None,
            "splitterSummary": None,
        }
        pred, prob, _ = combined.predict_arrays(x[np.nonzero(row_mask > 0)[0]])
        yt = y[np.nonzero(row_mask > 0)[0]]
        summary["trainEvaluation"] = self.evaluator.evaluate_arrays(yt, pred, prob)
        self.metadata["modelSelectorSummary"] = summary
        return SelectedModel(combined, summary)

    def _validation_metric(self, m: SelectedModel) -> float:
        results = m.summary["validationResults"]
        best_name = m.summary["bestModelType"]
        grid = m.summary["bestGrid"]
        for r in results:
            if r["modelName"] == best_name and r["grid"] == grid:
                return float(r["metricMean"])
        return float(np.mean([r["metricMean"] for r in results]))
