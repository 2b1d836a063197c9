"""ModelSelector: automated model selection with CV over model families x
hyperparameter grids, and its fitted winner ``SelectedModel``.

Reference: core/.../stages/impl/selector/ModelSelector.scala:72-264 and the
problem-specific factories (BinaryClassificationModelSelector.scala,
MultiClassificationModelSelector.scala, RegressionModelSelector.scala).
Flow (ModelSelector.scala:116-208): validator.validate over candidates ->
best estimator -> splitter.validationPrepare -> refit winner on prepared
train -> train metrics -> SelectedModel with ModelSelectorSummary metadata.

The default candidates of each factory take the factory's ``device``
(``None``: the card), and so do ``make_candidates``' estimators, every
family of the reference's enums among them. The summary keeps
the reference's keys: ``featurizeStats`` is the featurize plane's ledger
over the selection (``Workflow.train()`` replaces it with the delta over
the whole train); ``compileStats``, a plane the port does not have yet
(A14), is present and ``None``.
"""
from __future__ import annotations

import logging
from typing import Any, Sequence

import numpy as np

from ..evaluators import (
    BinaryClassificationEvaluator,
    Evaluator,
    MultiClassificationEvaluator,
    RegressionEvaluator,
)
from ..featurize import stats as fstats
from ..models.base import PredictorEstimator, PredictorModel
from ..models.gbdt import (
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    GBTClassifier,
    GBTRegressor,
    RandomForestClassifier,
    RandomForestRegressor,
    XGBoostClassifier,
    XGBoostRegressor,
)
from ..models.glm import GeneralizedLinearRegression
from ..models.linear import LinearRegression
from ..models.logistic import LogisticRegression
from ..models.mlp import MLPClassifier
from ..models.naive_bayes import NaiveBayes
from ..models.svc import LinearSVC
from ..prep.splitters import DataBalancer, DataCutter, DataSplitter
from .validators import CrossValidator, TrainValidationSplit, Validator

log = logging.getLogger(__name__)

# DefaultSelectorParams.scala:37-75
REGULARIZATION = [0.001, 0.01, 0.1, 0.2]
ELASTIC_NET = [0.1, 0.5]
MAX_ITER_LIN = [50]
FIT_INTERCEPT = [True]
MAX_DEPTH = [3, 6, 12]
MIN_INSTANCES = [10, 100]
MIN_INFO_GAIN = [0.001, 0.01, 0.1]
MAX_TREES = [50]
MAX_ITER_TREE = [20]
XGB_NUM_ROUND = [200]
XGB_ETA = [0.02]
XGB_MIN_CHILD_WEIGHT = [1.0, 10.0]
XGB_MAX_DEPTH_BINARY = [10]
XGB_GAMMA_BINARY = [0.8]

# the full candidate enums (*ModelSelector.scala); names beyond the defaults
# are opt-in through ``make_candidates``
BINARY_CLASSIFICATION_MODELS: dict[str, type] = {
    "OpLogisticRegression": LogisticRegression,
    "OpRandomForestClassifier": RandomForestClassifier,
    "OpXGBoostClassifier": XGBoostClassifier,
    "OpGBTClassifier": GBTClassifier,
    "OpDecisionTreeClassifier": DecisionTreeClassifier,
    "OpNaiveBayes": NaiveBayes,
    "OpLinearSVC": LinearSVC,
    "OpMultilayerPerceptronClassifier": MLPClassifier,
}
MULTI_CLASSIFICATION_MODELS: dict[str, type] = {
    "OpLogisticRegression": LogisticRegression,
    "OpRandomForestClassifier": RandomForestClassifier,
    "OpXGBoostClassifier": XGBoostClassifier,
    "OpDecisionTreeClassifier": DecisionTreeClassifier,
    "OpNaiveBayes": NaiveBayes,
    "OpMultilayerPerceptronClassifier": MLPClassifier,
}
REGRESSION_MODELS: dict[str, type] = {
    "OpLinearRegression": LinearRegression,
    "OpRandomForestRegressor": RandomForestRegressor,
    "OpGBTRegressor": GBTRegressor,
    "OpXGBoostRegressor": XGBoostRegressor,
    "OpDecisionTreeRegressor": DecisionTreeRegressor,
    "OpGeneralizedLinearRegression": GeneralizedLinearRegression,
}


def make_candidates(
    problem_kind: str, names: Sequence[str], device=None,
) -> list[tuple[PredictorEstimator, dict[str, Sequence[Any]]]]:
    """(estimator on ``device``, default grid) pairs for the selectors'
    ``models=`` argument, from the reference's model-enum names."""
    catalog = {
        "BinaryClassification": BINARY_CLASSIFICATION_MODELS,
        "MultiClassification": MULTI_CLASSIFICATION_MODELS,
        "Regression": REGRESSION_MODELS,
    }.get(problem_kind)
    if catalog is None:
        raise ValueError(f"unknown problem kind {problem_kind!r}")
    out = []
    for name in names:
        if name not in catalog:
            raise ValueError(
                f"{name!r} is not a {problem_kind} model; choose from "
                f"{sorted(catalog)}"
            )
        cls = catalog[name]
        out.append((cls(device=device), _default_grid_for(cls)))
    return out


def _default_grid_for(cls: type) -> dict[str, Sequence[Any]]:
    grids: dict[type, dict[str, Sequence[Any]]] = {
        LogisticRegression: _lr_grid(),
        LinearRegression: _lr_grid(),
        RandomForestClassifier: _rf_grid(),
        RandomForestRegressor: _rf_grid(),
        GBTClassifier: _gbt_grid(),
        GBTRegressor: _gbt_grid(),
        XGBoostClassifier: _xgb_binary_grid(),
        XGBoostRegressor: _xgb_binary_grid(),
        DecisionTreeClassifier: _tree_grid(),
        DecisionTreeRegressor: _tree_grid(),
        NaiveBayes: {"smoothing": [1.0]},
        LinearSVC: {"reg_param": REGULARIZATION, "max_iter": MAX_ITER_LIN},
        MLPClassifier: {},
        GeneralizedLinearRegression: {
            "family": ["gaussian", "poisson", "gamma"],
            "reg_param": REGULARIZATION,
        },
    }
    return grids.get(cls, {})


def _lr_grid() -> dict[str, Sequence[Any]]:
    return {
        "fit_intercept": FIT_INTERCEPT,
        "elastic_net_param": ELASTIC_NET,
        "max_iter": MAX_ITER_LIN,
        "reg_param": REGULARIZATION,
    }


def _rf_grid() -> dict[str, Sequence[Any]]:
    return {
        "max_depth": MAX_DEPTH,
        "min_info_gain": MIN_INFO_GAIN,
        "min_instances_per_node": MIN_INSTANCES,
        "num_trees": MAX_TREES,
    }


def _gbt_grid() -> dict[str, Sequence[Any]]:
    return {
        "max_depth": MAX_DEPTH,
        "min_info_gain": MIN_INFO_GAIN,
        "min_instances_per_node": MIN_INSTANCES,
        "max_iter": MAX_ITER_TREE,
    }


def _tree_grid() -> dict[str, Sequence[Any]]:
    return {
        "max_depth": MAX_DEPTH,
        "min_info_gain": MIN_INFO_GAIN,
        "min_instances_per_node": MIN_INSTANCES,
    }


def _xgb_binary_grid() -> dict[str, Sequence[Any]]:
    return {
        "num_round": XGB_NUM_ROUND,
        "eta": XGB_ETA,
        "gamma": XGB_GAMMA_BINARY,
        "max_depth": XGB_MAX_DEPTH_BINARY,
        "min_child_weight": XGB_MIN_CHILD_WEIGHT,
    }


class SelectedModel(PredictorModel):
    """The fitted winner (SelectedModel in ModelSelector.scala): it
    delegates predict to the best inner model and carries the selection
    summary."""

    def __init__(self, best_model: PredictorModel, summary: dict[str, Any], uid=None):
        super().__init__("modelSelector", uid=uid)
        self.best_model = best_model
        self.metadata["modelSelectorSummary"] = summary

    @property
    def kernel_libraries(self) -> tuple[str, ...]:
        return self.best_model.kernel_libraries

    def to(self, device) -> "SelectedModel":
        self.best_model.to(device)
        return self

    def predict_arrays(self, x: np.ndarray):
        return self.best_model.predict_arrays(x)

    def fused_predict_spec(self):
        """The winner's device core for the fused graph (its epilogue too,
        so the staged path's arithmetic carries over)."""
        spec_fn = getattr(self.best_model, "fused_predict_spec", None)
        if spec_fn is None:
            from ..compiler.fused import Unfuseable

            raise Unfuseable(
                f"selected model family {type(self.best_model).__name__} "
                "has no fused device predict"
            )
        return spec_fn()

    def fused_bin_thresholds(self):
        """The winner's bin edges for the quantized plane (None where the
        winning family does not bin: the quantizer takes affine codes)."""
        thr_fn = getattr(self.best_model, "fused_bin_thresholds", None)
        return thr_fn() if thr_fn is not None else None

    def get_arrays(self):
        return {f"best__{k}": v for k, v in self.best_model.get_arrays().items()}

    def get_params(self):
        return {
            "best_model_class": type(self.best_model).__name__,
            "best_model_params": self.best_model.get_params(),
            "summary": self.metadata.get("modelSelectorSummary", {}),
        }

    @classmethod
    def from_params(cls, params, arrays):
        from ..workflow.persistence import construct_stage

        inner_arrays = {
            k[len("best__"):]: v for k, v in arrays.items()
            if k.startswith("best__")
        }
        inner = construct_stage(
            params["best_model_class"], params["best_model_params"], inner_arrays
        )
        return cls(inner, params.get("summary", {}))

    @property
    def summary(self) -> dict[str, Any]:
        return self.metadata["modelSelectorSummary"]

    def evaluate_holdout(self, x: np.ndarray, y: np.ndarray, evaluator: Evaluator):
        pred, prob, _ = self.predict_arrays(x)
        metrics = evaluator.evaluate_arrays(y, pred, prob)
        self.metadata["modelSelectorSummary"]["holdoutEvaluation"] = metrics
        return metrics


def _refit_outputs(model) -> np.ndarray | None:
    """The refit's raw training outputs, which its batched fit already
    computed: its lane's [N], a multiclass forest's C lanes [C, N]
    (``_sweep_lanes``), or None."""
    stack = getattr(model, "_sweep_stack", None)
    if stack is None or stack.get("outputs") is None:
        return None
    lanes = getattr(model, "_sweep_lanes", None)
    if lanes is not None:
        return np.asarray(stack["outputs"])[lanes]
    if not hasattr(model, "predictions_from_sweep"):
        return None
    return np.asarray(stack["outputs"])[model._sweep_lane]


class ModelSelector(PredictorEstimator):
    """Estimator[(RealNN, OPVector)] -> Prediction that finds, refits and
    wraps the best model family x grid point."""

    def __init__(
        self,
        validator: Validator,
        splitter: DataSplitter | None,
        models: Sequence[tuple[PredictorEstimator, dict[str, Sequence[Any]]]],
        evaluator: Evaluator,
        extra_evaluators: Sequence[Evaluator] = (),
        problem_kind: str = "unknown",
        uid: str | None = None,
    ):
        super().__init__("modelSelector", uid=uid)
        self.validator = validator
        self.splitter = splitter
        self.models = list(models)
        self.evaluator = evaluator
        self.extra_evaluators = list(extra_evaluators)
        self.problem_kind = problem_kind
        #: set by workflow-level CV (workflow/cv.py): validation already ran
        #: with per-fold DAG refits, so fit skips the validator
        self.precomputed_results: list | None = None

    def get_params(self):
        return {
            "problem_kind": self.problem_kind,
            "evaluator": self.evaluator.name,
            "validator": type(self.validator).__name__,
            "splitter": type(self.splitter).__name__ if self.splitter else None,
        }

    def fit_arrays(self, x, y, row_mask) -> SelectedModel:
        featurize_baseline = fstats.snapshot()
        train_idx = np.nonzero(row_mask > 0)[0]
        xt, yt = x[train_idx], y[train_idx]

        # pre-validation prepare (DataCutter removes rare labels up front)
        if isinstance(self.splitter, DataCutter):
            keep = self.splitter.prepare(yt)
            xt, yt = xt[keep], yt[keep]

        # the validation prepare (balancing, down-sampling) is a seeded
        # function of yt, so the refit mask is known before validation and
        # rides the sweep as one more lane of the same batched fit
        final_mask = np.ones(len(yt), dtype=np.float32)
        if self.splitter is not None and not isinstance(self.splitter, DataCutter):
            final_mask = self.splitter.prepare(yt).astype(np.float32)

        attempt_info: list = []
        if self.precomputed_results is not None:
            # consumed once: fold metrics must not leak into a later train
            results = self.precomputed_results
            self.precomputed_results = None
            prefit = {}
        else:
            results = self.validator.validate(
                self.models, xt, yt, self.evaluator, extra_masks=[final_mask],
            )
            prefit = self.validator.last_extra_models
            attempt_info = list(self.validator.last_attempt_info)
        best = Validator.best(results, self.evaluator)
        log.info(
            "ModelSelector best: %s %s (%s=%.4f over %d candidates)",
            best.model_name, best.grid, self.evaluator.default_metric,
            best.metric_mean, len(results),
        )

        family = next(est for est, _ in self.models if est.uid == best.model_uid)
        final_est = family.with_params(**best.grid)

        splitter_summary = None
        if self.splitter is not None and self.splitter.summary is not None:
            splitter_summary = self.splitter.summary.to_json()

        # the winner's refit is usually the extra lane fitted on final_mask;
        # otherwise (workflow CV, a family without the batched hook) refit
        best_model = None
        refit_raw = None
        if best.model_uid in prefit:
            points, extra_rows = prefit[best.model_uid]
            if best.grid in points and extra_rows:
                best_model = extra_rows[0][points.index(best.grid)]
                # the refit lane's outputs on xt came with its fit: take them
                # before the stack is freed, so train metrics need no predict
                refit_raw = _refit_outputs(best_model)
                refit_multi = getattr(best_model, "_sweep_lanes", None) is not None
                detach = getattr(best_model, "detach_from_sweep", None)
                if detach is not None:
                    detach()
        self.validator.last_extra_models = {}
        if best_model is None:
            batched = getattr(final_est, "fit_arrays_batched_masks", None)
            if batched is not None:
                best_model = batched(xt, yt, [final_mask], [dict(best.grid)])[0][0]
            else:
                best_model = final_est.fit_arrays(xt, yt, final_mask)

        if refit_raw is not None:
            from_sweep = (best_model.predictions_from_sweep_multi if refit_multi
                          else best_model.predictions_from_sweep)
            pred, prob, _ = from_sweep(refit_raw)
        else:
            pred, prob, _ = best_model.predict_arrays(xt)
        train_metrics = self.evaluator.evaluate_arrays(yt, pred, prob)
        extra_train = {
            ev.name: ev.evaluate_arrays(yt, pred, prob)
            for ev in self.extra_evaluators
        }

        summary = {
            "problemKind": self.problem_kind,
            "validationType": type(self.validator).__name__,
            "evaluationMetric": self.evaluator.default_metric,
            "bestModelName": f"{best.model_name}_{best.model_uid}",
            "bestModelType": best.model_name,
            "bestGrid": best.grid,
            "validationResults": [r.to_json() for r in results],
            "candidateAttempts": attempt_info,
            "trainEvaluation": train_metrics,
            "extraTrainEvaluations": extra_train,
            "holdoutEvaluation": None,
            "splitterSummary": splitter_summary,
            "compileStats": None,
            "featurizeStats": fstats.delta(featurize_baseline),
        }
        self.metadata["modelSelectorSummary"] = summary
        return SelectedModel(best_model, summary)


def BinaryClassificationModelSelector(
    validator: Validator | None = None,
    splitter: DataSplitter | None = None,
    models: Sequence[tuple[PredictorEstimator, dict[str, Sequence[Any]]]] | None = None,
    evaluator: Evaluator | None = None,
    num_folds: int = 3,
    seed: int = 42,
    device=None,
) -> ModelSelector:
    """CV binary selector (BinaryClassificationModelSelector.scala; default
    3-fold CV, DataBalancer, AuPR metric; default candidates LR + RF + XGB
    per modelTypesToUse :61-63, on ``device``)."""
    if models is None:
        models = [
            (LogisticRegression(device=device), _lr_grid()),
            (RandomForestClassifier(device=device), _rf_grid()),
            (XGBoostClassifier(device=device), _xgb_binary_grid()),
        ]
    return ModelSelector(
        validator=validator or CrossValidator(num_folds=num_folds, seed=seed),
        splitter=splitter if splitter is not None else DataBalancer(seed=seed),
        models=models,
        evaluator=evaluator or BinaryClassificationEvaluator(),
        extra_evaluators=(),
        problem_kind="BinaryClassification",
    )


def MultiClassificationModelSelector(
    validator: Validator | None = None,
    splitter: DataSplitter | None = None,
    models: Sequence[tuple[PredictorEstimator, dict[str, Sequence[Any]]]] | None = None,
    evaluator: Evaluator | None = None,
    num_folds: int = 3,
    seed: int = 42,
    device=None,
) -> ModelSelector:
    """Multiclass selector (MultiClassificationModelSelector.scala; default
    3-fold CV, DataCutter, weighted F1; default candidates LR + RF per
    modelTypesToUse :61-63, on ``device``): the multinomial logistic lanes
    and the random forest's one-vs-rest lanes, masks x points x classes in
    one batched fit per depth group."""
    if models is None:
        models = [
            (LogisticRegression(device=device), _lr_grid()),
            (RandomForestClassifier(device=device), _rf_grid()),
        ]
    return ModelSelector(
        validator=validator or CrossValidator(num_folds=num_folds, seed=seed),
        splitter=splitter if splitter is not None else DataCutter(seed=seed),
        models=models,
        evaluator=evaluator or MultiClassificationEvaluator(),
        problem_kind="MultiClassification",
    )


def RegressionModelSelector(
    validator: Validator | None = None,
    splitter: DataSplitter | None = None,
    models: Sequence[tuple[PredictorEstimator, dict[str, Sequence[Any]]]] | None = None,
    evaluator: Evaluator | None = None,
    seed: int = 42,
    device=None,
) -> ModelSelector:
    """Regression selector (RegressionModelSelector.scala; default
    train/validation split .75, DataSplitter, RMSE; default candidates
    LinearRegression + RF + GBT per :61-63, on ``device``)."""
    if models is None:
        models = [
            (LinearRegression(device=device), _lr_grid()),
            (RandomForestRegressor(device=device), _rf_grid()),
            (GBTRegressor(device=device), _gbt_grid()),
        ]
    return ModelSelector(
        validator=validator or TrainValidationSplit(seed=seed),
        splitter=splitter if splitter is not None else DataSplitter(seed=seed),
        models=models,
        evaluator=evaluator or RegressionEvaluator(),
        problem_kind="Regression",
    )
