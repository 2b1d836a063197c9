"""ModelInsights — merged per-feature diagnostics for a fitted workflow, the port of the JAX
package's ``insights/model_insights.py``.

Reference: core/.../ModelInsights.scala:74-850 (extractFromStages :444):
feature history + SanityChecker statistics + selector validation summary +
model feature importances, grouped per raw feature with one record per
derived vector column.

Feature contributions:
  * GLMs: |coefficient| per column (mean over classes for multinomial);
  * tree ensembles: split-frequency importance from the stored tree arrays;
  * MLP: L2 norm of the first-layer weight row.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from ..models.base import PredictorModel
from ..selector.model_selector import SelectedModel
from ..prep.derived_filter import FeatureRemovalModel


def _tree_split_importance(split_feats: list[np.ndarray], dim: int) -> np.ndarray:
    counts = np.zeros(dim, dtype=np.float64)
    for sf in split_feats:
        flat = np.asarray(sf).reshape(-1)
        valid = flat[flat >= 0]
        np.add.at(counts, valid, 1.0)
    total = counts.sum()
    return counts / total if total > 0 else counts


def feature_contributions(model: PredictorModel, dim: int) -> np.ndarray:
    """Per-vector-column contribution scores for any supported model."""
    from ..models.gbdt import (
        BoostedBinaryModel,
        BoostedMultiModel,
        BoostedRegressionModel,
        ForestClassifierModel,
        ForestRegressionModel,
    )
    from ..models.linear import LinearRegressionModel
    from ..models.logistic import LogisticRegressionModel
    from ..models.mlp import MLPClassifierModel

    if isinstance(model, SelectedModel):
        return feature_contributions(model.best_model, dim)
    if isinstance(model, (LogisticRegressionModel, LinearRegressionModel)):
        w = np.abs(np.asarray(model.weights, dtype=np.float64))
        return w if w.ndim == 1 else w.mean(axis=1)
    if isinstance(model, MLPClassifierModel):
        return np.linalg.norm(model.params[0]["w"], axis=1)
    if isinstance(model, (BoostedBinaryModel, BoostedRegressionModel, ForestRegressionModel)):
        return _tree_split_importance([model.trees.split_feat], dim)
    if isinstance(model, BoostedMultiModel):
        return _tree_split_importance(
            [t.split_feat for t in model.trees_per_class], dim
        )
    if isinstance(model, ForestClassifierModel):
        return _tree_split_importance(
            [t.split_feat for t in model.forests_per_class], dim
        )
    return np.zeros(dim)


def model_insights(workflow_model) -> dict[str, Any]:
    """One JSON document of per-feature insights (ModelInsights.scala:74)."""
    fitted = workflow_model.fitted
    selected: SelectedModel | None = None
    removal: FeatureRemovalModel | None = None
    for stage in fitted.values():
        if isinstance(stage, SelectedModel):
            selected = stage
        if isinstance(stage, FeatureRemovalModel):
            removal = stage

    # column stats from the SanityChecker ledger (pre-drop indexing)
    checker_columns: list[dict[str, Any]] = []
    for stage in fitted.values():
        summ = stage.metadata.get("sanityCheckerSummary")
        if summ:
            checker_columns = summ["columns"]
            break

    # final-model column metadata (post-drop)
    final_meta = removal.new_metadata if removal is not None else None
    kept = removal.indices_to_keep if removal is not None else None

    dim = final_meta.size if final_meta is not None else (
        len(checker_columns) if checker_columns else 0
    )
    contributions = (
        feature_contributions(selected, dim) if selected is not None and dim else
        np.zeros(dim)
    )

    raw_types = {f.name: f.ftype.__name__ for f in workflow_model.raw_features}
    # stage chain per result feature (all derived columns of the model
    # vector share the lineage of the vector feature)
    stages_applied: list[str] = []
    for f in workflow_model.result_features:
        try:
            stages_applied = f.history()["stages"]
            break
        except Exception:
            pass

    rff = workflow_model.rff_results or {}
    rff_metrics = rff.get("rawFeatureDistributions", {})
    rff_excluded = rff.get("exclusionReasons", [])

    features: dict[str, dict[str, Any]] = {}

    def record(parent: str, entry: dict[str, Any]) -> None:
        if parent not in features:
            features[parent] = {
                "featureName": parent,
                "featureType": raw_types.get(parent, "?"),
                "derivedFeatures": [],
                # RawFeatureFilter ledger (FeatureInsights.metrics /
                # exclusionReasons, ModelInsights.scala:338-348)
                "metrics": rff_metrics.get(parent, {}),
                "exclusionReasons": (
                    rff_excluded.get(parent, [])
                    if isinstance(rff_excluded, dict) else []
                ),
            }
        features[parent]["derivedFeatures"].append(entry)

    if final_meta is not None:
        for j, cm in enumerate(final_meta.columns):
            pre = kept[j] if kept is not None else j
            stats = checker_columns[pre] if pre < len(checker_columns) else {}
            record(
                cm.parent_names[0] if cm.parent_names else "?",
                {
                    "derivedFeatureName": cm.make_name(),
                    "stagesApplied": stages_applied,
                    "derivedFeatureGroup": cm.grouping,
                    "derivedFeatureValue": cm.indicator_value
                    or cm.descriptor_value,
                    "indicatorValue": cm.indicator_value,
                    "descriptorValue": cm.descriptor_value,
                    "corr": stats.get("corr_label"),
                    "cramersV": stats.get("cramers_v"),
                    "mean": stats.get("mean"),
                    "variance": stats.get("variance"),
                    "contribution": float(contributions[j]) if j < len(contributions) else None,
                    "excluded": False,
                },
            )
    # columns the checker dropped still appear, flagged excluded
    for pre, stats in enumerate(checker_columns):
        if stats.get("dropped"):
            record(
                stats.get("parent") or stats["name"],
                {
                    "derivedFeatureName": stats["name"],
                    "stagesApplied": stages_applied,
                    "derivedFeatureGroup": None,
                    "derivedFeatureValue": None,
                    "corr": stats.get("corr_label"),
                    "cramersV": stats.get("cramers_v"),
                    "mean": stats.get("mean"),
                    "variance": stats.get("variance"),
                    "contribution": 0.0,
                    "excluded": True,
                    "exclusionReasons": stats.get("reasons", []),
                },
            )

    # stageInfo: uid -> operation + params for every fitted stage
    # (ModelInsights.stageInfo, RawFeatureFilterConfig etc ride along)
    stage_info: dict[str, Any] = {}
    for uid, stage in fitted.items():
        entry: dict[str, Any] = {
            "operationName": getattr(stage, "operation_name", type(stage).__name__),
            "stageClass": type(stage).__name__,
        }
        try:
            entry["params"] = stage.get_params()
        except Exception:
            pass
        stage_info[uid] = entry

    sel_summary = selected.summary if selected is not None else None
    label = workflow_model.label_summary
    if label is None and workflow_model.selector_info is not None:
        label = {
            "labelName": workflow_model.selector_info["labelName"],
            "problemKind": workflow_model.selector_info["problemKind"],
        }
    elif label is not None and workflow_model.selector_info is not None:
        label = {
            **label,
            "problemKind": workflow_model.selector_info["problemKind"],
        }
    return {
        "label": label,
        "features": sorted(features.values(), key=lambda d: d["featureName"]),
        "selectedModelInfo": sel_summary,
        "trainingParams": workflow_model.training_params,
        "stageInfo": stage_info,
        "trainRows": workflow_model.train_rows,
        "blocklistedFeatures": workflow_model.blocklisted,
        "rawFeatureFilterResults": workflow_model.rff_results,
    }
