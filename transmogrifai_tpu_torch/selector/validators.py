"""Validators: k-fold cross validation and train/validation split.

Reference: core/.../stages/impl/tuning/{OpCrossValidation,OpTrainValidationSplit,
OpValidator}.scala. Defaults (OpValidator.scala:371-379): 3 folds, train ratio
0.75, candidate-fit parallelism 8, per-candidate failure tolerance (a failed
model/grid is logged and skipped; an error only if all fail).

Folds are row masks and a family's grid is the lane axis of its batched fit:
``fit_arrays_batched_masks(x, y, masks, points)`` (or, for the GLMs,
``sweep_dispatch_masks``) trains the whole folds x grid sweep, and a family
without either hook fits point by point. The families sweep on a thread
pool; the card runs their kernels in the order the threads issue them.

One difference from the reference's isolation: an error of the kernels or
the card (``utils.cuda_build.is_kernel_fault``: a kernel that did not
build, load or launch, or a CUDA runtime error) is a fault of the program,
not of a candidate, and propagates out of ``validate``; the retry policy
never retries it. Each family's sweep runs under ``retry_policy``
(``resilience/retry.py``): a transient failure backs off and retries before
the family is excluded, a fatal one excludes it at once, and the attempts
land in ``last_attempt_info``. An installed fault plan is consulted inside
the retried region (``fail_candidate``).

With a ``CheckpointManager`` (``resilience/checkpoint.py``) each finished
family's fold metrics are saved under a key of its class, position, grid
points, fold masks, metric and a sample of the data; ``resume=True``
consumes a matching entry, so only unfinished families sweep again (a
checkpoint hit is recorded as ``fromCheckpoint``). Each family's sweep
pulses the active run recorder (``telemetry/runlog.py``) with its time.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Sequence

import numpy as np

from ..evaluators.base import Evaluator
from ..models.base import PredictorEstimator
from ..resilience import faults
from ..resilience.retry import RetryPolicy
from ..telemetry import runlog as _runlog
from ..telemetry import spans as _tspans
from ..utils.cuda_build import is_kernel_fault

log = logging.getLogger(__name__)


@dataclasses.dataclass
class CandidateResult:
    model_name: str
    model_uid: str
    grid: dict[str, Any]
    metric_values: list[float]

    @property
    def metric_mean(self) -> float:
        return float(np.mean(self.metric_values)) if self.metric_values else float("nan")

    def to_json(self) -> dict[str, Any]:
        return {
            "modelName": self.model_name,
            "modelUID": self.model_uid,
            "grid": dict(self.grid),
            "metricValues": self.metric_values,
            "metricMean": self.metric_mean,
        }


def expand_grid(grid: dict[str, Sequence[Any]]) -> list[dict[str, Any]]:
    """Cartesian product of param value lists (ParamGridBuilder.build)."""
    points: list[dict[str, Any]] = [{}]
    for key, values in grid.items():
        points = [{**p, key: v} for p in points for v in values]
    return points


def _data_fingerprint(x: np.ndarray, y: np.ndarray) -> str:
    """Cheap content fingerprint of the sweep's training arrays, so a CV
    checkpoint recorded against one dataset can never answer for another.
    Bounded sampling via resilience.checkpoint.update_array_sample — never
    a full-array scan/copy for big data."""
    from ..resilience.checkpoint import update_array_sample

    h = hashlib.sha256()
    for a in (x, y):
        update_array_sample(h, a)
    return h.hexdigest()[:16]


def _folds_fingerprint(
    folds: Sequence[tuple[np.ndarray, np.ndarray]]
) -> str:
    """Fingerprint of the actual fold masks — covers every split-shaping
    knob (validator class, seed, num_folds, stratify, train ratio) at once,
    so checkpointed fold metrics can never answer for a differently-split
    resume."""
    h = hashlib.sha256()
    for train_mask, val_mask in folds:
        h.update(np.packbits(np.asarray(train_mask, dtype=bool)).tobytes())
        h.update(np.packbits(np.asarray(val_mask, dtype=bool)).tobytes())
    return h.hexdigest()[:16]


def _candidate_key(
    index: int,
    est: PredictorEstimator,
    points: list[dict[str, Any]],
    folds_fp: str,
    evaluator: Evaluator,
    data_fp: str,
) -> str:
    """Stable checkpoint key for one candidate family's sweep: the family
    class + position + a hash of (grid points, fold masks, metric, data
    fingerprint). Uids are process-local, so they stay out of the key on
    purpose — a resumed process regenerates them but the sweep identity is
    unchanged."""
    blob = json.dumps(
        {
            "model": type(est).__name__,
            "points": points,
            "folds": folds_fp,
            "metric": evaluator.default_metric,
            "data": data_fp,
        },
        sort_keys=True,
        default=str,
    )
    digest = hashlib.sha256(blob.encode()).hexdigest()[:12]
    return f"{type(est).__name__}-{index}-{digest}"


def batched_masks_hook(est):
    """The family's folds x grid fit ``(x, y, masks, points) ->
    models[mask][point]``: the GLMs' dispatch and collect at once, else
    ``fit_arrays_batched_masks``, else None."""
    dispatcher = getattr(est, "sweep_dispatch_masks", None)
    if dispatcher is not None:
        return lambda *a: dispatcher(*a)()
    return getattr(est, "fit_arrays_batched_masks", None)


class Validator:
    """Shared candidate-sweep logic; subclasses provide the fold masks."""

    #: candidate-fit parallelism (OpValidator.scala:371-379 default 8)
    parallelism: int = 8
    #: retry policy for candidate sweeps: transient failures back off and
    #: retry BEFORE the candidate-exclusion path; fatal errors (bad grid,
    #: shape mismatch) and kernel faults are never retried
    retry_policy: RetryPolicy = RetryPolicy(max_attempts=3, base_delay=0.25,
                                            max_delay=2.0)

    def __init__(self, seed: int = 42):
        self.seed = seed
        #: family uid -> (points, models[extra_mask_i][point_i]) from the
        #: last validate(extra_masks=...) call: the prefitted refit lanes
        self.last_extra_models: dict[str, tuple[list, list]] = {}
        #: per candidate family from the last validate() call:
        #: {modelName, modelUID, attempts, error, excluded, fromCheckpoint}
        self.last_attempt_info: list[dict[str, Any]] = []

    def split_masks(self, y: np.ndarray) -> list[tuple[np.ndarray, np.ndarray]]:
        raise NotImplementedError

    def validate(
        self,
        candidates: Sequence[tuple[PredictorEstimator, dict[str, Sequence[Any]]]],
        x: np.ndarray,
        y: np.ndarray,
        evaluator: Evaluator,
        extra_masks: Sequence[np.ndarray] = (),
        checkpoint=None,
        resume: bool = False,
    ) -> list[CandidateResult]:
        """Fit every family x grid point on every fold; results carry the
        per-fold metric values. A family that fails is excluded and
        recorded in ``last_attempt_info``; this raises only when every
        family failed, or on a kernel fault.

        ``extra_masks`` ride the same batched fit as the folds as further
        lanes that give no metrics: the selector passes its refit mask here,
        so the winner's refit is fitted when validation returns. They land
        in ``last_extra_models[family_uid] = (points, models)`` with
        ``models[mask_i][point_i]``; families without a batched hook are
        left out (the selector refits the winner directly).

        ``checkpoint`` persists each finished family's fold metrics; with
        ``resume=True`` a matching entry is consumed instead of sweeping
        the family, whose refit lanes then stay empty (the selector refits
        the winner directly)."""
        folds = self.split_masks(y)
        data_fp = _data_fingerprint(x, y) if checkpoint is not None else ""
        folds_fp = _folds_fingerprint(folds) if checkpoint is not None else ""
        results: list[CandidateResult] = []
        errors: list[str] = []
        self.last_extra_models = {}
        self.last_attempt_info = []

        # grids expand once, defensively: a malformed grid stays a failure
        # of its candidate, raised in the pool below
        points_list: list = []
        for _, grid in candidates:
            try:
                points_list.append(expand_grid(grid))
            except Exception as e:
                points_list.append(e)

        def run(i, est, points):
            """One family: a checkpoint hit, or its retried sweep and the
            save: (results, attempts, from checkpoint)."""
            if isinstance(points, Exception):
                raise points
            recorder = _runlog.active_recorder()
            t0 = _tspans.clock() if recorder is not None else 0.0
            key = None
            if checkpoint is not None:
                key = _candidate_key(
                    i, est, points, folds_fp, evaluator, data_fp)
            if key is not None and resume:
                cached = checkpoint.load_candidate(key)
                if cached is not None and len(
                    cached.get("metricValues", [])
                ) == len(points):
                    log.info(
                        "CV checkpoint hit: %s (%d points)", key, len(points))
                    return [
                        CandidateResult(
                            model_name=type(est).__name__,
                            model_uid=est.uid,
                            grid=points[gi],
                            metric_values=list(cached["metricValues"][gi]),
                        )
                        for gi in range(len(points))
                    ], int(cached.get("attempts", 1)), True
            out, attempts = self.retry_policy.call(
                lambda: self._sweep_family(
                    est, points, folds, x, y, evaluator,
                    extra_masks=extra_masks,
                )
            )
            if recorder is not None:
                recorder.on_candidate(
                    type(est).__name__, len(points), _tspans.clock() - t0,
                    rows=len(y),
                )
            if key is not None:
                checkpoint.save_candidate(key, {
                    "modelName": type(est).__name__,
                    "metricValues": [r.metric_values for r in out],
                    "attempts": attempts,
                })
            return out, attempts, False

        n_workers = max(1, min(self.parallelism, len(candidates)))
        # longest grid first: the biggest family's work heads the queue
        order = sorted(
            range(len(candidates)),
            key=lambda i: -(
                len(points_list[i]) if isinstance(points_list[i], list) else 0
            ),
        )
        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            futs = {
                i: pool.submit(run, i, candidates[i][0], points_list[i])
                for i in order
            }
            outs = []
            for i in range(len(candidates)):
                try:
                    outs.append(futs[i].result())
                except Exception as e:
                    outs.append(e)
        faults = [o for o in outs if isinstance(o, Exception) and is_kernel_fault(o)]
        if faults:
            raise faults[0]
        for (est, _), out in zip(candidates, outs):
            name = type(est).__name__
            failed = isinstance(out, Exception)
            from_ckpt = False
            if failed:  # candidate-level isolation
                attempts = getattr(out, "_retry_attempts", 1)
                log.warning(
                    "Model %s failed validation after %d attempt(s): %s",
                    name, attempts, out,
                )
                errors.append(f"{name}: {out}")
            else:
                out, attempts, from_ckpt = out
                results.extend(out)
            self.last_attempt_info.append({
                "modelName": name,
                "modelUID": est.uid,
                "attempts": attempts,
                "error": str(out) if failed else None,
                "excluded": failed,
                "fromCheckpoint": from_ckpt,
            })
        if not results:
            raise RuntimeError(
                f"All model candidates failed validation: {errors}"
            )
        return results

    def _sweep_family(
        self,
        est: PredictorEstimator,
        points: list[dict[str, Any]],
        folds: list[tuple[np.ndarray, np.ndarray]],
        x: np.ndarray,
        y: np.ndarray,
        evaluator: Evaluator,
        extra_masks: Sequence[np.ndarray] = (),
    ) -> list[CandidateResult]:
        plan = faults.active()
        if plan is not None:
            # inside the retried region: each retry attempt re-consults the
            # plan, so "fails twice then succeeds" scripts exactly
            plan.on_candidate_fit(est)
        per_point_values: list[list[float]] = [[] for _ in points]
        batched_masks = batched_masks_hook(est)
        models_by_fold = None
        if batched_masks is not None:
            # the whole folds x grid sweep in as few batched fits as the
            # family's static shapes allow; extra masks are further lanes
            all_masks = [tm.astype(np.float32) for tm, _ in folds] + [
                np.asarray(m, dtype=np.float32) for m in extra_masks
            ]
            models_by_fold = batched_masks(x, y, all_masks, points)
            if extra_masks:
                self.last_extra_models[est.uid] = (
                    points, models_by_fold[len(folds):]
                )
                models_by_fold = models_by_fold[: len(folds)]
            # the trees' metrics from the stacks' training outputs
            sweep_eval = getattr(est, "sweep_eval_batched", None)
            if sweep_eval is not None:
                vals = sweep_eval(models_by_fold, x, y, folds, evaluator)
                if vals is not None:
                    per_point_values = vals
                    folds = []
        for fi, (train_mask, val_mask) in enumerate(folds):
            if models_by_fold is not None:
                models = models_by_fold[fi]
            else:
                models = [
                    est.with_params(**p).fit_arrays(
                        x, y, train_mask.astype(np.float32)
                    )
                    for p in points
                ]
            val_idx = np.nonzero(val_mask)[0]
            for gi, model in enumerate(models):
                # lane-level isolation: a lane whose scoring fails gets a
                # NaN metric (``best`` skips non-finite means); a kernel
                # fault is the program's and propagates
                try:
                    pred, prob, _ = model.predict_arrays(x[val_idx])
                    metrics = evaluator.evaluate_arrays(y[val_idx], pred, prob)
                    value = evaluator.metric_of(metrics)
                except Exception as e:
                    if is_kernel_fault(e):
                        raise
                    log.warning(
                        "Lane %d (%s) of %s failed scoring in fold %d: %s",
                        gi, points[gi], type(est).__name__, fi, e,
                    )
                    value = float("nan")
                per_point_values[gi].append(value)
        return [
            CandidateResult(
                model_name=type(est).__name__,
                model_uid=est.uid,
                grid=points[gi],
                metric_values=per_point_values[gi],
            )
            for gi in range(len(points))
        ]

    @staticmethod
    def best(
        results: Sequence[CandidateResult], evaluator: Evaluator
    ) -> CandidateResult:
        key = lambda r: r.metric_mean  # noqa: E731
        finite = [r for r in results if np.isfinite(r.metric_mean)]
        pool = finite or list(results)
        return max(pool, key=key) if evaluator.is_larger_better else min(pool, key=key)


class CrossValidator(Validator):
    """k-fold CV (OpCrossValidation.scala:42-190; default 3 folds, optional
    label-stratified folds)."""

    def __init__(self, num_folds: int = 3, stratify: bool = False, seed: int = 42):
        super().__init__(seed)
        if num_folds < 2:
            raise ValueError("num_folds must be >= 2")
        self.num_folds = num_folds
        self.stratify = stratify

    def split_masks(self, y: np.ndarray):
        n = len(y)
        rng = np.random.default_rng(self.seed)
        assignment = np.empty(n, dtype=np.int64)
        if self.stratify:
            for cls in np.unique(y):
                idx = np.nonzero(y == cls)[0]
                assignment[idx] = rng.permutation(len(idx)) % self.num_folds
        else:
            assignment = rng.permutation(n) % self.num_folds
        folds = []
        for f in range(self.num_folds):
            val = assignment == f
            folds.append((~val, val))
        return folds


class TrainValidationSplit(Validator):
    """Single random split (OpTrainValidationSplit.scala; default ratio .75)."""

    def __init__(self, train_ratio: float = 0.75, seed: int = 42):
        super().__init__(seed)
        self.train_ratio = train_ratio

    def split_masks(self, y: np.ndarray):
        n = len(y)
        rng = np.random.default_rng(self.seed)
        train = rng.random(n) < self.train_ratio
        return [(train, ~train)]
