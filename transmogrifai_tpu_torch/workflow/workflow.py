"""Workflow + WorkflowModel: result-feature-driven training and scoring.

Reference: core/.../OpWorkflow.scala (train :347, DAG assembly :90-110,
validation :280-338) and core/.../OpWorkflowModel.scala (score :259,
summary :187-223).

The user declares result features; the workflow rebuilds the stage DAG
from their lineage, reads the raw data, reserves a holdout through the
model selector's splitter (OpWorkflow.scala:380-384), fits the DAG layer by
layer, evaluates the selected model on the holdout, and returns a fitted
``WorkflowModel`` that scores, evaluates, summarizes and saves.

Not ported yet, each raising ``NotImplementedError`` that names its
``ROADMAP.md`` item: checkpoints and resume, streaming ingest, the progress
callback and run reports (A12), an execution mesh (A13), sensitive
feature detection (A11). ``with_raw_feature_filter`` runs the
RawFeatureFilter before the holdout split (and before workflow CV's
folds) and rewrites the DAG without the blocklisted features. ``train()`` validates the stages with
``validate_stages`` in place of the reference's preflight analysis (A14).
``train()`` stores the serving profiles (``resilience.sentinel.
compute_serving_profiles`` over the training rows) that the scoring
closure's drift sentinel compares the live stream with; the attribution
profiles are ``None`` until A10, and ``summary_pretty`` leaves out the
insights lines until A10. Its serving-resilience line sums the counters
of every live score function built off the model.
"""
from __future__ import annotations

import logging
from typing import Any, Sequence

import numpy as np
import torch

from ..dataset import Dataset
from ..features.feature import Feature
from ..featurize import stats as fstats
from ..readers.core import DataReader, DatasetReader
from ..selector.model_selector import ModelSelector, SelectedModel
from ..stages.base import PipelineStage
from ..types.columns import NumericColumn, VectorColumn
from ..utils.device import resolve_device
from .dag import compute_dag, raw_features_of, validate_stages
from .fit import apply_transformations_dag, fit_and_transform_dag

log = logging.getLogger(__name__)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, {item})")


class Workflow:
    def __init__(self):
        self.result_features: tuple[Feature, ...] = ()
        self.reader: DataReader | None = None
        self._stage_overrides: dict[str, dict[str, Any]] = {}
        self._prefitted: dict[str, PipelineStage] = {}
        self._workflow_cv = False
        self._raw_feature_filter = None
        self._rff_score_reader: DataReader | None = None
        self.blocklisted_features: list[str] = []

    # ----------------------------------------------------------- configure
    def set_result_features(self, *features: Feature) -> "Workflow":
        self.result_features = tuple(features)
        return self

    def set_input_dataset(self, dataset: Dataset) -> "Workflow":
        self.reader = DatasetReader(dataset)
        return self

    def set_reader(self, reader: DataReader) -> "Workflow":
        self.reader = reader
        return self

    def set_stage_parameters(self, overrides: dict[str, dict[str, Any]]) -> "Workflow":
        """Per-stage param overrides keyed by stage uid or class name,
        applied before fit (OpWorkflow.setStageParameters,
        OpWorkflow.scala:179-201)."""
        self._stage_overrides.update(overrides)
        return self

    def with_model_stages(self, model: "WorkflowModel") -> "Workflow":
        """Warm start (OpWorkflow.withModelStages, OpWorkflow.scala:468-472):
        a previous model's fitted stages stand in for their estimators (by
        estimator uid), so only new estimators train."""
        self._prefitted.update(model.fitted)
        return self

    def with_workflow_cv(self) -> "Workflow":
        """Workflow-level cross-validation (OpWorkflow.withWorkflowCV,
        OpWorkflow.scala:403-453): the label-dependent estimators upstream
        of the model selector are fitted again inside every CV fold, so
        their statistics cannot leak validation rows into the selection."""
        self._workflow_cv = True
        return self

    def with_raw_feature_filter(
        self,
        score_dataset: Dataset | None = None,
        score_reader: DataReader | None = None,
        **params: Any,
    ) -> "Workflow":
        """Attach a RawFeatureFilter of ``params``
        (OpWorkflow.withRawFeatureFilter): before the fit, the raw features
        that fail its fill, drift or leakage rules (against the scoring
        data, where given) are blocklisted and the DAG is rewritten without
        them."""
        from ..prep.raw_feature_filter import RawFeatureFilter

        self._raw_feature_filter = RawFeatureFilter(**params)
        if score_dataset is not None:
            score_reader = DatasetReader(score_dataset)
        self._rff_score_reader = score_reader
        return self

    def _apply_blocklist(self, blocklist: list[str]) -> None:
        """The DAG without the blocklisted raw features
        (OpWorkflow.setBlocklist, OpWorkflow.scala:118-167): a
        variable-arity stage loses the blocklisted inputs; a fixed-arity
        stage, or one left with no input, dies, and its output is
        blocklisted in turn."""
        if not blocklist:
            return
        dead = set(blocklist)
        for layer in compute_dag(self.result_features):
            for stage in layer:
                kept = tuple(
                    f for f in stage.input_features if f.name not in dead
                )
                if len(kept) == len(stage.input_features):
                    continue
                if not kept or getattr(stage, "input_types", None) is not None:
                    dead.add(stage.output_name)
                else:
                    stage.input_features = kept
        for rf in self.result_features:
            if rf.name in dead:
                raise ValueError(
                    f"RawFeatureFilter removed everything feeding result "
                    f"feature '{rf.name}'"
                )
        self.blocklisted_features = sorted(dead)

    def set_parallelism(self, mesh: Any) -> "Workflow":
        raise _not_ported("an execution mesh", "A13")

    def with_sensitive_feature_detection(self) -> "Workflow":
        raise _not_ported("sensitive feature detection", "A11")

    # --------------------------------------------------------------- train
    def _stages(self) -> list[PipelineStage]:
        layers = compute_dag(self.result_features)
        validate_stages(layers)
        return [s for layer in layers for s in layer]

    def _apply_overrides(self, stages: Sequence[PipelineStage]) -> None:
        for stage in stages:
            for key in (stage.uid, type(stage).__name__):
                if key in self._stage_overrides:
                    stage.set_params(**self._stage_overrides[key])

    def compute_data_up_to(self, *features: Feature) -> Dataset:
        """The DAG's data up to the given features, without a full train
        (OpWorkflowCore.computeDataUpTo)."""
        targets = list(features) or list(self.result_features)
        if not targets:
            raise ValueError("computeDataUpTo needs target features")
        if self.reader is None:
            raise ValueError("No input data: call set_input_dataset or set_reader")
        stages = list({s.uid: s for f in targets for s in f.parent_stages()}.values())
        self._apply_overrides(stages)
        raw = self.reader.generate_dataset(raw_features_of(targets))
        data, _ = fit_and_transform_dag(raw, targets, prefitted=self._prefitted)
        return data

    def train(
        self,
        checkpoint_dir: str | None = None,
        resume: bool = False,
        progress: Any = None,
        run_dir: str | None = None,
        stream: bool | None = None,
    ) -> "WorkflowModel":
        """Fit the DAG: read, reserve the holdout, fit (with workflow-level
        CV when asked), evaluate the selected model on the holdout."""
        if checkpoint_dir is not None or resume:
            raise _not_ported("checkpoint_dir / resume", "A12")
        if stream:
            raise _not_ported("streaming ingest (stream=True)", "A12")
        if progress is not None or run_dir is not None:
            raise _not_ported("progress / run_dir (the run ledger)", "A12")
        if not self.result_features:
            raise ValueError("setResultFeatures must be called before train")
        if self.reader is None:
            raise ValueError("No input data: call set_input_dataset or set_reader")
        stages = self._stages()
        self._apply_overrides(stages)
        # the featurize plane's ledger over this train: the delta over the
        # whole ingest lands in the selector summary
        featurize_baseline = fstats.snapshot()
        selectors = [s for s in stages if isinstance(s, ModelSelector)]
        if len(selectors) > 1:
            raise ValueError(
                "Only one ModelSelector is allowed per workflow "
                f"(found {len(selectors)})"  # FitStagesUtil.cutDAG:310 parity
            )
        selector = selectors[0] if selectors else None

        raw_features = raw_features_of(self.result_features)
        raw = self.reader.generate_dataset(raw_features)
        if raw.num_rows == 0:
            raise ValueError("Input dataset cannot be empty")

        rff_results = None
        if self._raw_feature_filter is not None:
            label_names = [f.name for f in raw_features if f.is_response]
            score_data = (
                self._rff_score_reader.generate_dataset(
                    [f for f in raw_features if not f.is_response]
                )
                if self._rff_score_reader is not None
                else None
            )
            blocklist = self._raw_feature_filter.compute_exclusions(
                raw,
                raw_features,
                score=score_data,
                label_name=label_names[0] if label_names else None,
            )
            rff_results = self._raw_feature_filter.results
            if blocklist:
                log.info("RawFeatureFilter blocklisted: %s", blocklist)
                self._apply_blocklist(blocklist)
                raw_features = raw_features_of(self.result_features)
                raw = raw.drop(blocklist)
                validate_stages(compute_dag(self.result_features))

        train_data, holdout_data = raw, None
        if selector is not None and selector.splitter is not None:
            train_idx, holdout_idx = selector.splitter.split(raw.num_rows)
            if len(holdout_idx):
                train_data = raw.take(train_idx)
                holdout_data = raw.take(holdout_idx)

        if self._workflow_cv and selector is not None:
            from .cv import workflow_cv_results

            selector.precomputed_results = workflow_cv_results(
                selector, train_data, prefitted=self._prefitted,
            )
        fitted_data, fitted = fit_and_transform_dag(
            train_data, self.result_features, prefitted=self._prefitted,
        )

        selector_info = None
        if selector is not None:
            selector_info = {
                "estimatorUid": selector.uid,
                "labelName": selector.input_names[0],
                "vectorName": selector.input_names[1],
                "predName": selector.output_name,
                "evaluator": selector.evaluator.name,
                "problemKind": selector.problem_kind,
            }
            sel_stage = fitted.get(selector.uid)
            if isinstance(sel_stage, SelectedModel):
                sel_stage.summary["distributedResilience"] = None
                sel_stage.summary["featurizeStats"] = fstats.delta(
                    featurize_baseline
                )

        if selector is not None and holdout_data is not None:
            sel_model = fitted[selector.uid]
            transformed = apply_transformations_dag(
                holdout_data, self.result_features, fitted
            )
            label_name, vec_name = selector.input_names
            label, vec = transformed[label_name], transformed[vec_name]
            if not (isinstance(label, NumericColumn) and isinstance(vec, VectorColumn)):
                raise TypeError("holdout: expected (numeric label, vector) columns")
            metrics = sel_model.evaluate_holdout(
                np.asarray(vec.values, dtype=np.float32),
                label.values.astype(np.float64),
                selector.evaluator,
            )
            log.info("Holdout metrics: %s", metrics)

        label_summary = None
        if selector_info is not None:
            label_summary = _label_summary(
                fitted_data, selector_info, self.result_features
            )

        # serving-drift profiles (resilience/sentinel.py): per-raw-feature
        # fill rate + value histogram over the training rows, persisted in
        # the model artifact so score_function's drift sentinel can compare
        # the live stream against what the model was trained on
        from ..resilience.sentinel import compute_serving_profiles

        serving_profiles = compute_serving_profiles(train_data, raw_features)

        model = WorkflowModel(
            result_features=self.result_features,
            raw_features=tuple(raw_features),
            fitted=fitted,
            selector_info=selector_info,
            train_rows=train_data.num_rows,
            holdout_rows=0 if holdout_data is None else holdout_data.num_rows,
            rff_results=None if rff_results is None else rff_results.to_json(),
            blocklisted=list(self.blocklisted_features),
            label_summary=label_summary,
            training_params=dict(self._stage_overrides),
            serving_profiles=serving_profiles,
        )
        if selector is not None:
            # the live evaluator keeps a custom one working in memory (the
            # name in selector_info covers a loaded model)
            model._live_evaluator = selector.evaluator
        return model


def _label_summary(
    fitted_data: Dataset,
    selector_info: dict[str, Any],
    result_features: Sequence[Feature],
) -> dict[str, Any] | None:
    """LabelSummary (ModelInsights.scala:293-325): raw lineage, sample size
    and distribution: Discrete {domain, prob} for classification,
    Continuous {min, max, mean, variance} for regression."""
    name = selector_info["labelName"]
    if name not in fitted_data:
        return None
    col = fitted_data[name]
    vals = np.asarray(col.values, dtype=np.float64)
    mask = np.asarray(col.mask, dtype=bool) if hasattr(col, "mask") else np.ones(len(vals), bool)
    present = vals[mask]
    label_feat = next((f for f in result_features if f.name == name), None)
    raw = label_feat.raw_features() if label_feat is not None else []
    summary: dict[str, Any] = {
        "labelName": name,
        "rawFeatureName": [f.name for f in raw],
        "rawFeatureType": [f.ftype.__name__ for f in raw],
        "stagesApplied": (
            label_feat.history()["stages"] if label_feat is not None else []
        ),
        "sampleSize": float(len(present)),
    }
    if len(present) == 0:
        summary["distribution"] = None
    elif selector_info["problemKind"] == "Regression":
        summary["distribution"] = {
            "type": "Continuous",
            "min": float(present.min()),
            "max": float(present.max()),
            "mean": float(present.mean()),
            "variance": float(present.var()),
        }
    else:
        uniq, counts = np.unique(present, return_counts=True)
        summary["distribution"] = {
            "type": "Discrete",
            "domain": [str(int(u)) if u == int(u) else str(u) for u in uniq],
            "prob": (counts / counts.sum()).tolist(),
        }
    return summary


class WorkflowModel:
    """A fitted workflow: the result and raw features, the fitted stages by
    estimator uid, the selector's info and the training summary's fields.
    ``device`` is where the predictors were placed (``None``: each fitted
    predictor places itself on its fit's device at its first predict)."""

    def __init__(
        self,
        result_features: tuple[Feature, ...],
        raw_features: tuple[Feature, ...],
        fitted: dict[str, PipelineStage],
        selector_info: dict[str, Any] | None = None,
        train_rows: int = 0,
        holdout_rows: int = 0,
        rff_results: dict[str, Any] | None = None,
        blocklisted: list[str] | None = None,
        label_summary: dict[str, Any] | None = None,
        training_params: dict[str, Any] | None = None,
        serving_profiles: dict[str, Any] | None = None,
        device: torch.device | None = None,
    ):
        self.result_features = result_features
        self.raw_features = raw_features
        self.fitted = fitted
        self.selector_info = selector_info
        self.train_rows = train_rows
        self.holdout_rows = holdout_rows
        self.rff_results = rff_results
        self.blocklisted = blocklisted or []
        self.label_summary = label_summary
        self.training_params = training_params or {}
        #: per-raw-feature training distributions for the serve-time drift
        #: sentinel (fill rate + StreamingHistogram JSON); None on models
        #: saved without them
        self.serving_profiles = serving_profiles
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
            self.fitted.get(stage.uid, stage)
            for layer in compute_dag(self.result_features)
            for stage in layer
        ]

    # --------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        """OpWorkflowModelWriter: ``manifest.json`` + ``arrays.npz``."""
        from .persistence import save_workflow_model

        save_workflow_model(self, path)

    @staticmethod
    def load(path: str, device=None) -> "WorkflowModel":
        """OpWorkflowModel.load (OpWorkflowModel.scala:456); the predictors
        go to ``device`` (``None`` means ``cuda``)."""
        from .persistence import load_workflow_model

        return load_workflow_model(path, device=device)

    # --------------------------------------------------------------- score
    def _prepare_raw(self, dataset: Dataset | None, reader: DataReader | None) -> Dataset:
        if dataset is not None:
            reader = DatasetReader(self._with_missing_response(dataset))
        if reader is None:
            raise ValueError("score requires a dataset or reader")
        try:
            raw = reader.generate_dataset(list(self.raw_features))
        except KeyError:
            # scoring data often lacks the response: read the predictors
            raw = reader.generate_dataset(
                [f for f in self.raw_features if not f.is_response]
            )
        return self._with_missing_response(raw)

    def _with_missing_response(self, dataset: Dataset) -> Dataset:
        """Null labels of the response's type where the data lacks it;
        evaluation refuses all-null labels."""
        from ..types.columns import empty_like

        for f in self.raw_features:
            if f.is_response and f.name not in dataset:
                dataset = dataset.with_column(
                    f.name, empty_like(f.ftype, dataset.num_rows)
                )
        return dataset

    def score(
        self,
        dataset: Dataset | None = None,
        reader: DataReader | None = None,
        keep_raw_features: bool = False,
        keep_intermediate_features: bool = False,
    ) -> Dataset:
        """Apply the fitted DAG (OpWorkflowModel.score, OpWorkflowModel.scala:259)."""
        raw = self._prepare_raw(dataset, reader)
        transformed = apply_transformations_dag(raw, self.result_features, self.fitted)
        if keep_intermediate_features:
            return transformed
        keep = [f.name for f in self.result_features if f.name in transformed]
        if keep_raw_features:
            keep = [f.name for f in self.raw_features] + keep
        return transformed.select(keep)

    def score_and_evaluate(
        self,
        dataset: Dataset | None = None,
        evaluator=None,
        reader: DataReader | None = None,
    ) -> tuple[Dataset, dict[str, Any]]:
        scores = self.score(dataset, reader=reader, keep_intermediate_features=True)
        metrics = self._evaluate_transformed(scores, evaluator)
        keep = [f.name for f in self.result_features if f.name in scores]
        return scores.select(keep), metrics

    def evaluate(
        self,
        dataset: Dataset | None = None,
        evaluator=None,
        reader: DataReader | None = None,
    ) -> dict[str, Any]:
        """Score and evaluate against the true labels in the data."""
        transformed = self.score(
            dataset, reader=reader, keep_intermediate_features=True
        )
        return self._evaluate_transformed(transformed, evaluator)

    def _evaluate_transformed(self, transformed: Dataset, evaluator=None) -> dict[str, Any]:
        if self.selector_info is None:
            raise ValueError("evaluate requires a ModelSelector in the workflow")
        if evaluator is None:
            evaluator = getattr(self, "_live_evaluator", None)
        if evaluator is None:
            from ..evaluators import (
                BinaryClassificationEvaluator,
                ForecastEvaluator,
                MultiClassificationEvaluator,
                RegressionEvaluator,
            )

            by_name = {
                e.name: e
                for e in (
                    BinaryClassificationEvaluator(),
                    MultiClassificationEvaluator(),
                    RegressionEvaluator(),
                    ForecastEvaluator(),
                )
            }
            name = self.selector_info["evaluator"]
            if name not in by_name:
                raise ValueError(
                    f"Evaluator '{name}' is not a builtin; pass the evaluator "
                    "object explicitly to evaluate()/score_and_evaluate()"
                )
            evaluator = by_name[name]
        label = transformed[self.selector_info["labelName"]]
        if isinstance(label, NumericColumn) and not label.mask.any():
            raise ValueError(
                "evaluate requires true labels, but the response column "
                f"'{self.selector_info['labelName']}' is absent/all-null in "
                "the provided data"
            )
        pred = transformed[self.selector_info["predName"]]
        return evaluator.evaluate(label, pred)

    # ------------------------------------------------------------- summary
    def summary_json(self) -> dict[str, Any]:
        """The reference's summary keys; those of planes not ported yet
        (sensitive features, the resilience and retrain ledgers, the
        analysis and run reports) are ``None``."""
        sel_summary = None
        if self.selector_info is not None:
            model = self.fitted.get(self.selector_info["estimatorUid"])
            if isinstance(model, SelectedModel):
                sel_summary = model.summary
        return {
            "trainRows": self.train_rows,
            "holdoutRows": self.holdout_rows,
            "rawFeatures": [f.name for f in self.raw_features],
            "resultFeatures": [f.name for f in self.result_features],
            "blocklistedFeatures": self.blocklisted,
            "rawFeatureFilterResults": self.rff_results,
            "sensitiveFeatures": None,
            "modelSelectorSummary": sel_summary,
            "stageMetadata": {
                uid: s.metadata for uid, s in self.fitted.items() if s.metadata
            },
            "distributedResilience": None,
            "retrainLedger": None,
            "analysis": None,
            "run": None,
        }

    def summary_pretty(self) -> str:
        """Human-readable training summary (the reference README's
        summaryPretty): the evaluated families, the selected model's
        parameter table and one combined holdout / training metric table.
        The insights tables wait for A10."""
        from ..utils.table import render_table

        s = self.summary_json()
        lines: list[str] = []
        sel = s.get("modelSelectorSummary")
        if sel:
            results = sel["validationResults"]
            by_family: dict[str, list[float]] = {}
            for r in results:
                by_family.setdefault(r["modelName"], []).append(r["metricMean"])
            metric = sel["evaluationMetric"]
            n_folds = len(results[0].get("metricValues", [])) if results else 0
            lines.append(
                f"Evaluated {', '.join(sorted(by_family))} models with "
                f"{n_folds} folds and {metric} metric."
            )
            for name, vals in sorted(by_family.items()):
                lines.append(
                    f"Evaluated {len(vals)} {name} models with {metric} "
                    f"between [{min(vals)}, {max(vals)}]"
                )
            for a in sel.get("candidateAttempts") or []:
                if a.get("excluded"):
                    lines.append(
                        f"Excluded {a['modelName']} after "
                        f"{a.get('attempts', 1)} attempt(s): {a.get('error')}"
                    )
                elif a.get("attempts", 1) > 1:
                    lines.append(
                        f"Retried {a['modelName']}: succeeded on attempt "
                        f"{a['attempts']}"
                    )
            lines.append("")
            lines.append(f"Selected model {sel['bestModelType']} with parameters:")
            params: dict[str, Any] = {"modelType": sel["bestModelType"]}
            stage = self.fitted.get(self.selector_info["estimatorUid"])
            best_model = getattr(stage, "best_model", None)
            if best_model is not None:
                params.update(best_model.get_params())
            params.update(sel.get("bestGrid", {}))
            lines.append(
                render_table(
                    ["Model Param", "Value"],
                    [[k, str(v)] for k, v in sorted(params.items())],
                )
            )
            lines.append("")
            train_m = sel.get("trainEvaluation") or {}
            hold_m = sel.get("holdoutEvaluation") or {}
            keys = [
                k for k in {**hold_m, **train_m}
                if isinstance((hold_m.get(k, train_m.get(k))), (int, float))
            ]
            if keys:
                lines.append("Model evaluation metrics:")
                lines.append(
                    render_table(
                        ["Metric Name", "Hold Out Set Value",
                         "Training Set Value"],
                        [
                            [k, str(hold_m.get(k, "")), str(train_m.get(k, ""))]
                            for k in keys
                        ],
                    )
                )
                lines.append("")
        lines.append(
            f"Trained on {s['trainRows']} rows (holdout {s['holdoutRows']}); "
            f"{len(s['rawFeatures'])} raw features"
        )
        serve = self._serving_resilience_line()
        if serve:
            lines.append(serve)
        return "\n".join(lines)

    def _serving_resilience_line(self) -> str | None:
        """Aggregate serve-side counters from every live score function
        built off this model (local.scoring keeps weak references), so one
        report covers train-side retries AND serve-side degradation."""
        quarantined = guarded = drift_alerts = breaker_trips = 0
        seen = False
        for ref in getattr(self, "_serving_monitors", []):
            fn = ref()
            if fn is None:
                continue
            try:
                md = fn.metadata()
            except Exception as e:  # monitoring must never break the summary
                log.debug("serving monitor skipped: %s", e)
                continue
            seen = True
            quarantined += md["quarantine"]["quarantinedRows"]
            guarded += md["scoreGuard"]["guardedRows"]
            drift = md.get("drift") or {}
            drift_alerts += drift.get("driftAlertsTotal", 0)
            for br in md["breakers"].values():
                t = br["transitions"]
                breaker_trips += t.get("closed->open", 0) + t.get(
                    "half_open->open", 0
                )
        if not seen:
            return None
        return (
            f"Serving resilience: {quarantined} quarantined row(s), "
            f"{guarded} guarded row(s), {drift_alerts} drift alert(s), "
            f"{breaker_trips} breaker trip(s)"
        )
