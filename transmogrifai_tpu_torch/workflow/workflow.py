"""Workflow + WorkflowModel: result-feature-driven training and scoring.

Reference: core/.../OpWorkflow.scala (train :347, DAG assembly :90-110,
validation :280-338) and core/.../OpWorkflowModel.scala (score :259,
summary :187-223).

The user declares result features; the workflow rebuilds the stage DAG
from their lineage, reads the raw data, reserves a holdout through the
model selector's splitter (OpWorkflow.scala:380-384), fits the DAG layer by
layer, evaluates the selected model on the holdout, and returns a fitted
``WorkflowModel`` that scores, evaluates, summarizes and saves.

``train(checkpoint_dir=, resume=, progress=, run_dir=, stream=)`` takes
the reference's arguments: layer and candidate checkpoints with resume
(``resilience/checkpoint.py``), the out-of-core streamed ingest
(``workflow/stream.py``), and the run recorder every train installs
(``telemetry/runlog.py``), whose RUN report the model carries
(``run_report``, ``summary_json()["run"]``, the manifest, the "Run
report:" line of ``summary_pretty``). Not ported yet: an execution mesh,
and with it the failover loop that re-enters the fit after a lost host
(``set_parallelism`` and ``train``'s ``on_mesh_mismatch`` are A13).
``with_sensitive_feature_detection`` scans the raw text features at train
time (``prep/sensitive.py``) and records the findings in the model
(``sensitive_info``: its summary's ``sensitiveFeatures`` and the saved
manifest). ``with_raw_feature_filter`` runs the
RawFeatureFilter before the holdout split (and before workflow CV's
folds) and rewrites the DAG without the blocklisted features. ``train()`` validates the stages with
``validate_stages`` in place of the reference's preflight analysis (A14).
``train()`` stores the serving profiles (``resilience.sentinel.
compute_serving_profiles`` over the training rows) that the scoring
closure's drift sentinel compares the live stream with, and the
attribution baseline (``insights.drift.compute_attribution_profile``: one
LOCO sweep over at most ``TPTPU_ATTRIBUTION_PROFILE_ROWS`` training rows,
default 256, 0 disables) that the closure's attribution drift monitor
compares ``explain=k`` sweeps with. The reference drops any failure of the
baseline; the port drops every failure but a kernel fault
(``utils.cuda_build.is_kernel_fault``), which propagates out of
``train()``. ``summary_pretty`` carries the reference's insights lines.
Its serving-resilience line sums the counters of every live score
function built off the model.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Any, Sequence

import numpy as np
import torch

from ..dataset import Dataset
from ..features.feature import Feature
from ..featurize import stats as fstats
from ..readers.core import DataReader, DatasetReader
from ..selector.model_selector import ModelSelector, SelectedModel
from ..stages.base import PipelineStage
from ..telemetry import runlog as _runlog
from ..telemetry import spans as _tspans
from ..types.columns import NumericColumn, VectorColumn
from ..utils.cuda_build import is_kernel_fault
from ..utils.device import resolve_device
from .dag import compute_dag, raw_features_of, validate_stages
from .fit import apply_transformations_dag, fit_and_transform_dag

log = logging.getLogger(__name__)


#: one warning per process for a degraded summary section; the later ones
#: still count on the run ledger and the event log
_SUMMARY_DEGRADED_WARNED = [False]


def _report_summary_degraded(section: str, e: Exception) -> None:
    """A ``summary_pretty`` section failed to render: count it on the run
    ledger (``summaryDegraded``), emit a ``summary_degraded`` event, and
    warn once per process."""
    from ..telemetry import events as _tevents

    detail = f"{type(e).__name__}: {e}"
    _runlog.stats().bump("summaryDegraded")
    _tevents.emit("summary_degraded", section=section, error=detail)
    if not _SUMMARY_DEGRADED_WARNED[0]:
        _SUMMARY_DEGRADED_WARNED[0] = True
        log.warning(
            "summary_pretty %s section degraded (%s); counted as "
            "summaryDegraded on the run ledger", section, detail,
        )
    else:
        log.debug("summary_pretty %s section degraded (%s)", section, detail)


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
        self._detect_sensitive = False
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
        """``None`` is one device, the port's only layout; a mesh is the
        distributed plane's (A13)."""
        if mesh is not None:
            raise _not_ported("an execution mesh", "A13")
        return self

    def with_sensitive_feature_detection(self) -> "Workflow":
        """Scan raw text features for personal data at train time and record
        SensitiveFeatureInformation in the model summary
        (SensitiveFeatureInformation.scala)."""
        self._detect_sensitive = True
        return self

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
        CV when asked), evaluate the selected model on the holdout.

        With ``checkpoint_dir`` every completed layer and every finished
        candidate family's sweep is persisted atomically there;
        ``resume=True`` restores the completed layers as warm-start stages
        (on the device of the estimators they stand in for) and consumes
        the candidate results, so only unfinished work runs again.

        Every train is recorded (``telemetry/runlog.py``): per-phase,
        per-layer, per-fold and per-candidate timings, the featurize
        ledger's deltas, the transfer census and the device-memory high
        water land in a RUN report on the model (``model.run_report``,
        ``summary_json()["run"]``, the manifest). ``progress`` receives
        phase, layer and fold pulses with a seconds-per-layer ETA.
        ``run_dir`` (None: ``$TPTPU_RUN_DIR``; ``""`` disables) persists the
        report as ``RUN_*.json`` and diffs it against the directory's
        latest report, warning on TPR findings.

        ``stream=True`` (or, when ``stream`` is None, a reader that
        declares ``is_unbounded()``) ingests through the out-of-core fit
        (``workflow/stream.py``): chunk by chunk, stats folded as monoids,
        torn and corrupt chunks quarantined, and with ``checkpoint_dir`` a
        stream cursor per chunk, so a crash mid-ingest resumes with less
        than one chunk of rework. ``stream=False`` materializes even an
        unbounded reader."""
        if not self.result_features:
            raise ValueError("setResultFeatures must be called before train")
        if self.reader is None:
            raise ValueError("No input data: call set_input_dataset or set_reader")
        if resume and checkpoint_dir is None:
            raise ValueError("resume=True requires checkpoint_dir")
        recorder = _runlog.RunRecorder(progress=progress).start()
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
        use_stream = (
            stream if stream is not None else self.reader.is_unbounded()
        )
        ckpt = None
        stream_summary = None
        if use_stream:
            if not hasattr(self.reader, "stream_batches"):
                raise ValueError(
                    "stream=True requires a chunked reader exposing "
                    "stream_batches() (readers/streaming.py); "
                    f"{type(self.reader).__name__} does not"
                )
            if checkpoint_dir is not None:
                # made before the ingest, whose cursor it persists per
                # chunk; a fresh train clears stale state once here
                from ..resilience.checkpoint import CheckpointManager

                ckpt = CheckpointManager(checkpoint_dir)
                if not resume:
                    ckpt.clear()
            from .stream import stream_ingest

            with recorder.phase("ingest"):
                with _tspans.span(
                    "train/ingest", features=len(raw_features), stream=1
                ):
                    raw, stream_summary = stream_ingest(
                        self.reader, raw_features,
                        recorder=recorder, checkpoint=ckpt, resume=resume,
                    )
            recorder.set_phase_rows("ingest", stream_summary["rowsSeen"])
            recorder.set_stream_summary(stream_summary)
            log.info(
                "Streamed raw data: %d rows over %d chunks "
                "(%d quarantined), %d buffered for fit",
                stream_summary["rowsSeen"], stream_summary["chunksDone"],
                stream_summary["quarantinedTotal"], raw.num_rows,
            )
        else:
            with recorder.phase("ingest"):
                with _tspans.span("train/ingest", features=len(raw_features)):
                    raw = self.reader.generate_dataset(raw_features)
            recorder.set_phase_rows("ingest", raw.num_rows)
        if raw.num_rows == 0:
            raise ValueError("Input dataset cannot be empty")

        sensitive_info = None
        if self._detect_sensitive:
            from ..prep.sensitive import detect_sensitive_features

            sensitive_info = [
                s.to_json()
                for s in detect_sensitive_features(raw, raw_features)
            ]
            if sensitive_info:
                log.info("Sensitive features detected: %s", sensitive_info)

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

        # checkpoints: completed layers restore into the warm-start dict;
        # the selector checkpoints its candidate families
        prefitted = dict(self._prefitted)
        if checkpoint_dir is not None:
            from ..resilience.checkpoint import (
                CheckpointManager,
                dag_signature,
                dataset_fingerprint,
            )

            fresh_ckpt = ckpt is None  # stream mode made and cleared it
            if fresh_ckpt:
                ckpt = CheckpointManager(checkpoint_dir)
                if not resume:
                    # stale entries of an earlier run in the same directory
                    # must never mix into a later crash and resume
                    ckpt.clear()
            if resume:
                dag_layers = compute_dag(self.result_features)
                prefitted.update(ckpt.load_layers(
                    dag_signature(dag_layers, dataset_fingerprint(train_data)),
                    dag_layers,
                ))
            if selector is not None:
                selector._checkpoint = ckpt
                # candidate results are consumed on an explicit resume only
                selector._checkpoint_resume = resume

        # the fit runs with the recorder installed, so the layer, fold and
        # candidate pulses of fit.py, cv.py and validators.py land on it
        try:
            with _runlog.recording(recorder), recorder.phase(
                "fit", rows=train_data.num_rows
            ):
                if self._workflow_cv and selector is not None:
                    from .cv import workflow_cv_results

                    # restored checkpoint stages stay out of the per-fold
                    # refits: they were fitted on the whole training split
                    selector.precomputed_results = workflow_cv_results(
                        selector, train_data, prefitted=self._prefitted,
                    )
                fitted_data, fitted = fit_and_transform_dag(
                    train_data, self.result_features, prefitted=prefitted,
                    checkpoint=ckpt,
                )
        finally:
            if selector is not None:
                selector._checkpoint = None
                selector._checkpoint_resume = False

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
                if stream_summary is not None:
                    # the chunk, quarantine and window accounting; the
                    # reduced fit stats are too large for the summary
                    sel_stage.summary["streamIngest"] = {
                        k: v for k, v in stream_summary.items()
                        if k != "fitStats"
                    }

        holdout_metrics = None
        if selector is not None and holdout_data is not None:
            sel_model = fitted[selector.uid]
            with recorder.phase("eval", rows=len(holdout_data)):
                with _tspans.span("train/eval", rows=len(holdout_data)):
                    transformed = apply_transformations_dag(
                        holdout_data, self.result_features, fitted
                    )
                    label_name, vec_name = selector.input_names
                    label, vec = transformed[label_name], transformed[vec_name]
                    if not (isinstance(label, NumericColumn)
                            and isinstance(vec, VectorColumn)):
                        raise TypeError(
                            "holdout: expected (numeric label, vector) columns")
                    holdout_metrics = sel_model.evaluate_holdout(
                        np.asarray(vec.values, dtype=np.float32),
                        label.values.astype(np.float64),
                        selector.evaluator,
                    )
            log.info("Holdout metrics: %s", holdout_metrics)

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

        # attribution baseline (insights/drift.py): one batched LOCO sweep
        # over a bounded training sample, persisted next to servingProfiles
        attribution_profiles = None
        attribution_seconds = None
        if selector_info is not None:
            t0 = time.perf_counter()
            with recorder.phase("attribution"):
                attribution_profiles = _attribution_baseline(
                    fitted, selector_info, fitted_data)
            attribution_seconds = time.perf_counter() - t0

        # freeze the recorder into the RUN report, persist it where a run
        # directory is configured and diff it against that directory's
        # latest run (the regression sentinel)
        run_report = _finalize_run_report(
            recorder, holdout_metrics, train_data.num_rows,
            run_dir if run_dir is not None else os.environ.get("TPTPU_RUN_DIR"),
        )

        model = WorkflowModel(
            result_features=self.result_features,
            raw_features=tuple(raw_features),
            fitted=fitted,
            selector_info=selector_info,
            train_rows=train_data.num_rows,
            holdout_rows=0 if holdout_data is None else holdout_data.num_rows,
            rff_results=None if rff_results is None else rff_results.to_json(),
            blocklisted=list(self.blocklisted_features),
            sensitive_info=sensitive_info,
            label_summary=label_summary,
            training_params=dict(self._stage_overrides),
            serving_profiles=serving_profiles,
            attribution_profiles=attribution_profiles,
            run_report=run_report,
        )
        #: wall seconds of the attribution baseline inside this train()
        model.attribution_seconds = attribution_seconds
        if selector is not None:
            # the live evaluator keeps a custom one working in memory (the
            # name in selector_info covers a loaded model)
            model._live_evaluator = selector.evaluator
        return model


def _finalize_run_report(
    recorder: "_runlog.RunRecorder",
    holdout_metrics: dict[str, Any] | None,
    train_rows: int,
    run_dir: str | None,
) -> dict[str, Any] | None:
    """Freeze the recorder into its RUN report; with a run directory, diff
    it against the directory's latest run first (the verdict rides inside
    the new report), then persist ``RUN_*.json``. A capture failure gives
    ``run_report=None``, never a failed train."""
    try:
        recorder.record_quality(holdout_metrics)
        report = recorder.finalize(train_rows=train_rows)
        if run_dir:
            baseline = _runlog.latest_run_report(run_dir)
            if baseline is not None:
                diff = _runlog.diff_runs(baseline, report)
                report["run"]["regression"] = {
                    "baselineRunId": (baseline.get("run") or {}).get("runId"),
                    "baselineFile": (baseline.get("run") or {}).get("file"),
                    "findings": [f.to_json() for f in diff.findings],
                }
                if diff.findings:
                    log.warning(
                        "train run regressed vs %s:\n%s",
                        (baseline.get("run") or {}).get("file", "<baseline>"),
                        diff.pretty(),
                    )
            path = _runlog.save_run_report(report, run_dir)
            log.info("run report written: %s", path)
        return report
    except Exception as e:  # observability must never fail a train
        log.warning("run report capture failed: %s", e)
        return None


def _attribution_baseline(
    fitted: dict[str, Any],
    selector_info: dict[str, Any],
    fitted_data: Dataset,
) -> dict[str, Any] | None:
    """The train-time baseline attribution profile (insights/drift.py): a
    best-effort capture that never fails a train, except on a kernel
    fault, which is a fault of the card and propagates."""
    import os

    try:
        max_rows = int(os.environ.get("TPTPU_ATTRIBUTION_PROFILE_ROWS", "256"))
    except ValueError:
        max_rows = 256
    if max_rows <= 0:
        return None
    sel_model = fitted.get(selector_info["estimatorUid"])
    vec_name = selector_info["vectorName"]
    if sel_model is None or vec_name not in fitted_data:
        return None
    vec = fitted_data[vec_name]
    if not isinstance(vec, VectorColumn):
        return None
    try:
        from ..insights.drift import compute_attribution_profile

        with _tspans.span("train/attribution", rows=min(max_rows, len(vec))):
            return compute_attribution_profile(
                sel_model,
                np.asarray(vec.values, dtype=np.float32),
                vec.metadata,
                max_rows=max_rows,
            )
    except Exception as e:
        if is_kernel_fault(e):
            raise
        log.warning("attribution baseline capture skipped: %s", e)
        return None


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
        sensitive_info: list[dict[str, Any]] | None = None,
        label_summary: dict[str, Any] | None = None,
        training_params: dict[str, Any] | None = None,
        serving_profiles: dict[str, Any] | None = None,
        attribution_profiles: dict[str, Any] | None = None,
        run_report: dict[str, Any] | None = None,
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
        self.sensitive_info = sensitive_info
        self.label_summary = label_summary
        self.training_params = training_params or {}
        #: per-raw-feature training distributions for the serve-time drift
        #: sentinel (fill rate + StreamingHistogram JSON); None on models
        #: saved without them
        self.serving_profiles = serving_profiles
        #: the train-time per-group LOCO contribution baseline the
        #: attribution drift monitor compares explain sweeps with
        self.attribution_profiles = attribution_profiles
        #: the train's RUN report (``telemetry/runlog.py``); None on models
        #: saved without one, or where its capture failed
        self.run_report = run_report
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
        (the distributed-resilience ledger, the analysis report) are
        ``None``."""
        from ..resilience.retrain import ledger_snapshot

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
            "sensitiveFeatures": self.sensitive_info,
            "modelSelectorSummary": sel_summary,
            "stageMetadata": {
                uid: s.metadata for uid, s in self.fitted.items() if s.metadata
            },
            "distributedResilience": None,
            "retrainLedger": ledger_snapshot(),
            "analysis": None,
            "run": self.run_report,
        }

    def summary_pretty(self) -> str:
        """Human-readable training summary (the reference README's
        summaryPretty): the evaluated families, the selected model's
        parameter table, one combined holdout / training metric table, the
        correlation-ranked top insights and contributions tables, and the
        attribution ledger's "Record insights" line."""
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
            lines.extend(self._insights_lines())
        insights_line = self._record_insights_line()
        if insights_line:
            lines.append(insights_line)
        lines.extend(self._run_report_lines())
        from ..telemetry.export import summary_line

        tel = summary_line()
        if tel:
            lines.append(tel)
        lines.append(
            f"Trained on {s['trainRows']} rows (holdout {s['holdoutRows']}); "
            f"{len(s['rawFeatures'])} raw features"
        )
        serve = self._serving_resilience_line()
        if serve:
            lines.append(serve)
        return "\n".join(lines)

    def _run_report_lines(self) -> list[str]:
        """The RUN report's lines: "Run report:" (wall, phases, layers, the
        transfer census, the device high-water, the file where persisted)
        and a regression line where the diff against the run directory's
        previous run found TPR findings."""
        run = (self.run_report or {}).get("run") or {}
        if not run:
            return []
        phases = run.get("phases") or {}
        phase_s = ", ".join(
            f"{name} {cell.get('seconds', 0.0):.2f}s"
            for name, cell in phases.items()
        )
        census = run.get("transferCensus") or {}
        h2d = census.get("hostToDevice") or {}
        d2h = census.get("deviceToHost") or {}
        mem = run.get("deviceMemory") or {}
        line = (
            f"Run report: {run.get('wallSeconds', 0.0):.2f}s wall"
            + (f" ({phase_s})" if phase_s else "")
            + f", {len(run.get('layers') or [])} layer(s), "
            f"h2d {h2d.get('count', 0)}x/{h2d.get('bytes', 0):,} B, "
            f"d2h {d2h.get('count', 0)}x/{d2h.get('bytes', 0):,} B, "
            f"device high-water {mem.get('highWaterBytes', 0):,} B "
            f"({mem.get('backend', '?')})"
        )
        if run.get("file"):
            line += f" — {run['file']}"
        lines = [line]
        findings = (run.get("regression") or {}).get("findings") or []
        if findings:
            codes: dict[str, int] = {}
            for f in findings:
                codes[f["code"]] = codes.get(f["code"], 0) + 1
            code_s = ", ".join(
                f"{c}×{n}" if n > 1 else c for c, n in sorted(codes.items())
            )
            lines.append(
                f"Run regression: {len(findings)} finding(s) vs "
                f"{run['regression'].get('baselineFile', 'previous run')} "
                f"({code_s})"
            )
        return lines

    def _insights_lines(self) -> list[str]:
        """The top insights by label correlation and the model's top
        contributions (README: "Top model insights computed using
        correlation"); all or nothing, best effort."""
        from ..insights.model_insights import model_insights
        from ..utils.table import render_table

        try:
            ins = model_insights(self)
            derived = [d for f in ins.get("features", [])
                       for d in f.get("derivedFeatures", [])]
            lines: list[str] = []
            with_corr = [
                d for d in derived
                if isinstance(d.get("corr"), (int, float))
                and np.isfinite(d["corr"])
            ]
            with_corr.sort(key=lambda d: -d["corr"])
            pos = [d for d in with_corr if d["corr"] >= 0]
            if with_corr:
                lines.append("Top model insights computed using correlation:")
                if pos:
                    lines.append(render_table(
                        ["Top Positive Insights", "Correlation"],
                        [[d["derivedFeatureName"], f"{d['corr']:.4f}"]
                         for d in pos[:7]],
                    ))
                negs = [d for d in reversed(with_corr) if d["corr"] < 0]
                if negs:
                    lines.append(render_table(
                        ["Top Negative Insights", "Correlation"],
                        [[d["derivedFeatureName"], f"{d['corr']:.4f}"]
                         for d in negs[:7]],
                    ))
                lines.append("")
            with_contrib = [d for d in derived
                            if isinstance(d.get("contribution"), (int, float))]
            with_contrib.sort(key=lambda d: -abs(d["contribution"]))
            if with_contrib and any(d["contribution"] for d in with_contrib):
                lines.append("Top Contributions:")
                lines.append(render_table(
                    ["Top Contributions", "Value"],
                    [[d["derivedFeatureName"], f"{d['contribution']:.4f}"]
                     for d in with_contrib[:7]],
                ))
                lines.append("")
            return lines
        except Exception as e:  # insights stay best-effort, but observable
            _report_summary_degraded("insights", e)
            return []

    def _record_insights_line(self) -> str | None:
        """The attribution ledger's one-line view (train-time baseline
        sweeps and any serve-time ``explain=k`` work)."""
        from ..insights import ledger as _attr_ledger

        att = _attr_ledger.snapshot()
        if not (att.get("rowsExplained") or att.get("profilesCaptured")):
            return None
        rate = att.get("explainRowsPerSec")
        rate_s = f" @ {rate:,} rows/s" if rate else ""
        profiled = len((self.attribution_profiles or {}).get("groups", {}))
        return (
            f"Record insights: {att.get('rowsExplained', 0):,} "
            f"row(s) explained{rate_s}, "
            f"{att.get('laneDispatches', 0)} lane(s) dispatched "
            f"({att.get('lanesDeduped', 0)} deduped, "
            f"{att.get('lanesPadded', 0)} padded), "
            f"{profiled} group(s) profiled, "
            f"{att.get('attributionDriftAlerts', 0)} attribution "
            f"drift alert(s), {att.get('explainShedRows', 0)} "
            f"row(s) shed"
        )

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
