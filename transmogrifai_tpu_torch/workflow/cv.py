"""Workflow-level cross-validation: refit the label-dependent DAG per fold.

Reference: core/.../OpWorkflow.scala:403-453 (fitStages withWorkflowCV) and
FitStagesUtil.cutDAG (core/.../utils/stages/FitStagesUtil.scala:302-355).
Selector-level CV fits the estimators upstream of the selector (the
SanityChecker, for one) once on all training rows, so their statistics
would leak validation rows into the selection. Workflow CV fits them again
inside each fold: the DAG up to the selector's inputs is fitted on the
fold's training rows only, the fold's validation rows go through those
fitted stages, and every candidate x grid point sweeps on the resulting
arrays. The aggregated ``CandidateResult``s go to the ``ModelSelector``,
which skips its own validator and refits the winner on all training rows.

The sweep is pipelined: a GLM family's ``sweep_dispatch_masks`` issues its
lanes and returns a collector, so each fold issues every GLM family's lanes
first, fits the tree families while those run on the card (PyTorch queues
the launches asynchronously), then collects. Failure isolation is
lane-granular: a lane whose predict or evaluation fails drops its own
(uid, grid point) entry only. A kernel fault (``utils.cuda_build.
is_kernel_fault``) is the program's and propagates.

Each fold and each family's sweep in it runs under a telemetry span
(``cv/fold``, ``cv/candidate``) and pulses the active run recorder
(``telemetry/runlog.py``): the fold's start and end, and one candidate
record per family per fold (with the error of a dropped family). The
reference's fold-resume stash, which lets its failover loop re-enter the
sweep after a lost host, waits for the distributed plane (``ROADMAP.md``
A13); so does the per-fold sweep-lane accounting of the compile plane
(A14), whose fold records read zero.
"""
from __future__ import annotations

import logging
from typing import Any, Sequence

import numpy as np

from ..dataset import Dataset
from ..evaluators.base import Evaluator
from ..prep.splitters import DataCutter
from ..selector.model_selector import ModelSelector
from ..selector.validators import CandidateResult, batched_masks_hook, expand_grid
from ..telemetry import runlog as _runlog
from ..telemetry import spans as _tspans
from ..types.columns import NumericColumn, VectorColumn
from ..utils.cuda_build import is_kernel_fault
from .fit import apply_transformations_dag, fit_and_transform_dag

log = logging.getLogger(__name__)


def workflow_cv_results(
    selector: ModelSelector,
    train_data: Dataset,
    prefitted: dict[str, Any] | None = None,
) -> list[CandidateResult]:
    """The per-fold DAG refits and candidate sweeps; the aggregated
    candidate results for the selector."""
    label_feature, vector_feature = selector.input_features
    targets = [label_feature, vector_feature]

    # the label per row (labels may be derived: fit a label-only DAG)
    label_data, _ = fit_and_transform_dag(
        train_data, [label_feature], prefitted=prefitted
    )
    label_col = label_data[label_feature.name]
    if not isinstance(label_col, NumericColumn):
        raise TypeError(f"label '{label_feature.name}' is not numeric")
    y_all = label_col.values.astype(np.float64)

    # the pre-validation prepare of ModelSelector.fit_arrays: DataCutter
    # trims rare labels before the folds
    if isinstance(selector.splitter, DataCutter):
        keep = np.nonzero(selector.splitter.prepare(y_all))[0]
        train_data = train_data.take(keep)
        y_all = y_all[keep]

    folds = selector.validator.split_masks(y_all)
    per_candidate: dict[tuple[str, int], CandidateResult] = {}
    failed: set[str] = set()
    failed_lanes: set[tuple[str, int]] = set()
    for fold_i, (train_mask, val_mask) in enumerate(folds):
        _run_fold(
            selector, train_data, prefitted, targets, label_feature,
            vector_feature, selector.evaluator, folds, fold_i, train_mask,
            val_mask, per_candidate, failed, failed_lanes,
        )
    results = list(per_candidate.values())
    if not results:
        raise RuntimeError("All model candidates failed workflow-level CV")
    return results


def _run_fold(
    selector,
    train_data,
    prefitted,
    targets,
    label_feature,
    vector_feature,
    evaluator,
    folds,
    fold_i: int,
    train_mask,
    val_mask,
    per_candidate: dict,
    failed: set,
    failed_lanes: set,
) -> None:
    """One fold: the DAG refit, the pipelined candidate sweep, the run
    recorder's pulses."""
    recorder = _runlog.active_recorder()
    if recorder is not None:
        recorder.on_fold_start(fold_i, total=len(folds))
    with _tspans.span("cv/fold", fold=fold_i):
        fold_train = train_data.take(np.nonzero(train_mask)[0])
        fold_val = train_data.take(np.nonzero(val_mask)[0])

        # the leak-free part: every estimator up to the selector's inputs
        # is fitted on the fold's training rows only
        fitted_t, fitted_stages = fit_and_transform_dag(
            fold_train, targets, prefitted=prefitted
        )
        transformed_v = apply_transformations_dag(
            fold_val, targets, fitted_stages
        )
        xt, yt = _arrays(fitted_t, label_feature.name, vector_feature.name)
        xv, yv = _arrays(
            transformed_v, label_feature.name, vector_feature.name
        )
        ones = np.ones(len(yt), dtype=np.float32)

        def pulse(est, points, t0, error=None):
            if recorder is not None:
                recorder.on_candidate(
                    type(est).__name__, len(points), _tspans.clock() - t0,
                    rows=len(yt), fold=fold_i, error=error,
                )

        def drop(est, points, e, t0):
            if not is_kernel_fault(e):
                pulse(est, points, t0, error=str(e))
            _drop_family(est, points, e, per_candidate, failed)

        # issue every GLM family's lanes, fit the tree families on the host
        # while those run, then collect the GLM lanes
        pending: list[tuple[Any, list[dict], Any, float]] = []
        host_side: list[tuple[Any, list[dict]]] = []
        for est, grid in selector.models:
            if est.uid in failed:
                continue
            points = expand_grid(grid)
            dispatcher = getattr(est, "sweep_dispatch_masks", None)
            if dispatcher is None:
                host_side.append((est, points))
                continue
            t0 = _tspans.clock()
            try:
                pending.append(
                    (est, points, dispatcher(xt, yt, [ones], points), t0))
            except Exception as e:  # the whole family
                drop(est, points, e, t0)

        for est, points in host_side:
            t0 = _tspans.clock()
            try:
                with _tspans.span("cv/candidate", model=type(est).__name__,
                                  points=len(points)):
                    _sweep_fold(
                        est, points, xt, yt, xv, yv, evaluator,
                        per_candidate, failed_lanes,
                    )
                pulse(est, points, t0)
            except Exception as e:  # candidate-level isolation
                drop(est, points, e, t0)

        for est, points, collect, t0 in pending:
            try:
                with _tspans.span("cv/candidate", model=type(est).__name__,
                                  points=len(points)):
                    _eval_lanes(
                        est, points, collect()[0], xv, yv, evaluator,
                        per_candidate, failed_lanes,
                    )
                pulse(est, points, t0)
            except Exception as e:  # the whole family
                drop(est, points, e, t0)

    if recorder is not None:
        recorder.on_fold_end(
            fold_i, total=len(folds),
            rows=int(train_mask.sum() + val_mask.sum()),
            sweep=_runlog.no_compile_delta(),
        )


def _drop_family(est, points, e, per_candidate, failed) -> None:
    """A whole family failed: drop exactly its grid keys. A kernel fault
    is the program's and propagates."""
    if is_kernel_fault(e):
        raise e
    log.warning("Model %s failed workflow CV: %s", type(est).__name__, e)
    failed.add(est.uid)
    for gi in range(len(points)):
        per_candidate.pop((est.uid, gi), None)


def _arrays(data: Dataset, label_name: str, vec_name: str):
    label, vec = data[label_name], data[vec_name]
    if not (isinstance(label, NumericColumn) and isinstance(vec, VectorColumn)):
        raise TypeError("workflow CV: expected (numeric label, vector) columns")
    return (
        np.asarray(vec.values, dtype=np.float32),
        label.values.astype(np.float64),
    )


def _eval_lanes(
    est,
    points: list[dict[str, Any]],
    models: Sequence,
    xv: np.ndarray,
    yv: np.ndarray,
    evaluator: Evaluator,
    per_candidate: dict,
    failed_lanes: set,
) -> None:
    """Lane-granular scoring: a lane whose predict or evaluation fails
    loses only its own (uid, grid point) entry."""
    for gi, model in enumerate(models):
        key = (est.uid, gi)
        if key in failed_lanes:
            continue
        try:
            pred, prob, _ = model.predict_arrays(xv)
            metrics = evaluator.evaluate_arrays(yv, pred, prob)
            value = evaluator.metric_of(metrics)
        except Exception as e:  # lane-level isolation
            if is_kernel_fault(e):
                raise
            log.warning(
                "Lane %d (%s) of %s failed scoring: %s",
                gi, points[gi], type(est).__name__, e,
            )
            failed_lanes.add(key)
            per_candidate.pop(key, None)
            continue
        if key not in per_candidate:
            per_candidate[key] = CandidateResult(
                model_name=type(est).__name__,
                model_uid=est.uid,
                grid=points[gi],
                metric_values=[],
            )
        per_candidate[key].metric_values.append(value)


def _sweep_fold(
    est,
    points: list[dict[str, Any]],
    xt: np.ndarray,
    yt: np.ndarray,
    xv: np.ndarray,
    yv: np.ndarray,
    evaluator: Evaluator,
    per_candidate: dict,
    failed_lanes: set,
) -> None:
    """One fold's fits of one family. Fold vector widths can differ (the
    per-fold SanityChecker drops differ), so models never cross folds."""
    ones = np.ones(len(yt), dtype=np.float32)
    batched = batched_masks_hook(est)
    if batched is not None:
        models = batched(xt, yt, [ones], points)[0]
    else:
        models = [est.with_params(**p).fit_arrays(xt, yt, ones) for p in points]
    _eval_lanes(
        est, points, models, xv, yv, evaluator, per_candidate, failed_lanes,
    )
