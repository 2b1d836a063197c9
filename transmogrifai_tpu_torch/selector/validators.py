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
not of a candidate, and propagates out of ``validate``. The reference's
checkpoint and resume keys, fault plan, run-ledger pulses and retry policy
are not ported yet (``ROADMAP.md`` A12): each candidate makes one attempt.
"""
from __future__ import annotations

import dataclasses
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Sequence

import numpy as np

from ..evaluators.base import Evaluator
from ..models.base import PredictorEstimator
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
        left out (the selector refits the winner directly)."""
        folds = self.split_masks(y)
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

        def run(est, points):
            if isinstance(points, Exception):
                raise points
            return self._sweep_family(
                est, points, folds, x, y, evaluator, extra_masks=extra_masks
            )

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
                i: pool.submit(run, candidates[i][0], points_list[i])
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
            if failed:  # candidate-level isolation
                log.warning("Model %s failed validation: %s", name, out)
                errors.append(f"{name}: {out}")
            else:
                results.extend(out)
            self.last_attempt_info.append({
                "modelName": name,
                "modelUID": est.uid,
                "attempts": 1,
                "error": str(out) if failed else None,
                "excluded": failed,
                "fromCheckpoint": False,
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
