"""Save and load workflow models in the format of ``transmogrifai_tpu``.

The saved format is one directory holding ``manifest.json`` (version 1:
features, stages in DAG order with their class, uid, params and wiring,
the selector's info and the training summary's fields) and ``arrays.npz``
(every fitted array, keyed ``<stage_uid>__<name>``). A stage saves through
``get_params()`` / ``get_arrays()`` and loads through ``from_params(params,
arrays)`` (default: the constructor on the params), so a model either
package saved loads in the other. Each saved stage class maps to the
port's class of the same name; the loader rebuilds the feature DAG and
puts the predictors' arrays on the device. The raw feature filter's
results (``rffResults``) and the blocklist travel as the reference writes
them, and so do the serving profiles (``servingProfiles``, the drift
sentinel's training baseline), so a model either package saved brings
them to the other's drift sentinel, the attribution profiles
(``attributionProfiles``, the attribution drift monitor's baseline) and
the sensitive-feature findings (``sensitiveFeatures``). The fitted text
stages carry their state both ways: the word2vec vocabulary and vectors,
LDA's ``topic_word``, the count vectorizer's vocabulary, the IDF weights
and the name detector's decision and dictionary. The manifest fields of
planes the port does not have yet (the distributed-resilience ledger, the
analysis and run reports) are written as ``null``, which the reference's
loader accepts.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np

from .. import types as T
from ..features.feature import Feature, FeatureGeneratorStage
from ..insights.correlation import RecordInsightsCorrModel
from ..insights.loco import RecordInsightsLOCO
from ..models.gbdt import (
    BoostedBinaryModel, BoostedMultiModel, BoostedRegressionModel,
    ForestClassifierModel, ForestRegressionModel,
)
from ..models.glm import GeneralizedLinearRegressionModel
from ..models.isotonic import IsotonicRegressionCalibratorModel
from ..models.linear import LinearRegressionModel
from ..models.logistic import LogisticRegressionModel
from ..models.mlp import MLPClassifierModel
from ..models.naive_bayes import NaiveBayesModel
from ..models.svc import LinearSVCModel
from ..ops import (
    bucketizers, dates, domains, embeddings, lists, maps, phone, prediction,
    scalers, simple, text_stages, time_period,
)
from ..ops import math as opmath
from ..ops.categorical import OneHotModel
from ..ops.combiner import VectorsCombiner
from ..ops.numeric import BinaryVectorizer, NumericVectorizerModel, RealNNVectorizer
from ..ops.text import SmartTextModel
from ..prep.derived_filter import FeatureRemovalModel
from ..selector.combiner import CombinedModel
from ..selector.model_selector import SelectedModel
from ..stages.base import PipelineStage
from ..utils.device import resolve_device


class ModelLoadError(ValueError):
    """A saved model is missing, corrupt, or holds a stage the port does
    not serve yet; the message names the file, member or class."""


#: the reference's stage class name -> the port's class
STAGE_CLASSES: dict[str, type] = {
    cls.__name__: cls
    for cls in (
        NumericVectorizerModel, BinaryVectorizer, RealNNVectorizer,
        OneHotModel, SmartTextModel, VectorsCombiner, FeatureRemovalModel,
        SelectedModel,
        BoostedBinaryModel, BoostedMultiModel, ForestClassifierModel,
        BoostedRegressionModel, ForestRegressionModel, LogisticRegressionModel,
        LinearRegressionModel, NaiveBayesModel, LinearSVCModel,
        GeneralizedLinearRegressionModel, MLPClassifierModel,
        IsotonicRegressionCalibratorModel, CombinedModel,
        RecordInsightsLOCO, RecordInsightsCorrModel,
        text_stages.OpStringIndexerModel, text_stages.OpIndexToString,
        text_stages.TextTokenizer, text_stages.OpNGram,
        text_stages.OpStopWordsRemover, text_stages.OpCountVectorizerModel,
        text_stages.OpHashingTF, text_stages.OpIDFModel,
        text_stages.JaccardSimilarity, text_stages.NGramSimilarity,
        text_stages.LangDetector, text_stages.MimeTypeDetector,
        text_stages.MimeTypeMapDetector, text_stages.ValidEmailTransformer,
        text_stages.HumanNameDetectorModel, text_stages.NameEntityRecognizer,
        embeddings.OpWord2VecModel, embeddings.OpLDAModel,
        dates.DateVectorizer, dates.DateToUnitCircleTransformer,
        time_period.TimePeriodTransformer,
        time_period.TimePeriodListTransformer,
        time_period.TimePeriodMapTransformer,
        phone.PhoneVectorizer, phone.ParsePhoneDefaultCountry,
        phone.ParsePhoneNumber, phone.IsValidPhoneDefaultCountry,
        phone.IsValidPhoneNumber, phone.IsValidPhoneMapDefaultCountry,
        lists.TextListModel, lists.DateListVectorizer, lists.GeolocationModel,
        lists.TextListNullTransformer,
        domains.EmailToPickListTransformer,
        domains.UrlMapToPickListMapTransformer,
        maps.RealMapModel, maps.DateMapModel, maps.TextMapPivotModel,
        maps.SmartTextMapModel, maps.GeolocationMapModel, maps.PhoneMapModel,
        maps.TextMapNullModel, maps.TextMapLenModel,
        maps.DecisionTreeNumericMapBucketizerModel,
        opmath.AddTransformer, opmath.SubtractTransformer,
        opmath.MultiplyTransformer, opmath.DivideTransformer,
        opmath.ScalarAddTransformer, opmath.ScalarSubtractTransformer,
        opmath.ScalarMultiplyTransformer, opmath.ScalarDivideTransformer,
        opmath.AbsoluteValueTransformer, opmath.CeilTransformer,
        opmath.FloorTransformer, opmath.RoundTransformer,
        opmath.RoundDigitsTransformer, opmath.ExpTransformer,
        opmath.SqrtTransformer, opmath.LogTransformer,
        opmath.PowerTransformer,
        scalers.OpScalarStandardScalerModel, scalers.FillMissingWithMeanModel,
        scalers.ScalerTransformer, scalers.DescalerTransformer,
        scalers.PercentileCalibratorModel,
        bucketizers.NumericBucketizer,
        bucketizers.DecisionTreeNumericBucketizerModel,
        bucketizers.DropIndicesByTransformer,
        simple.AliasTransformer, simple.FilterTransformer,
        simple.ReplaceTransformer, simple.SubstringTransformer,
        simple.ToOccurTransformer, simple.ExistsTransformer,
        simple.TextLenTransformer, simple.FilterMap, simple.MultiLabelJoiner,
        simple.TopNLabelProbMap,
        prediction.PredictionFieldExtractor,
    )
}


def construct_stage(
    class_name: str, params: dict[str, Any], arrays: dict[str, np.ndarray]
) -> PipelineStage:
    cls = STAGE_CLASSES.get(class_name)
    if cls is None:
        raise ModelLoadError(
            f"stage class '{class_name}' has no port yet (served classes: "
            f"{sorted(STAGE_CLASSES)})"
        )
    from_params = getattr(cls, "from_params", None)
    if from_params is not None:
        return from_params(params, arrays)
    return cls(**params)


def stage_to_entry(
    est_uid: str, stage: PipelineStage, arrays_out: dict[str, np.ndarray]
) -> dict[str, Any]:
    """One manifest entry for a fitted stage; its fitted arrays go into
    ``arrays_out`` keyed ``<stage_uid>__<name>``."""
    get_arrays = getattr(stage, "get_arrays", None)
    if get_arrays is not None:
        for k, v in get_arrays().items():
            arrays_out[f"{stage.uid}__{k}"] = np.asarray(v)
    return {
        "estimatorUid": est_uid,
        "class": type(stage).__name__,
        "uid": stage.uid,
        "operationName": stage.operation_name,
        "params": stage.get_params(),
        "inputFeatures": [f.name for f in stage.input_features],
        "outputName": stage.output_name,
        "metadata": stage.metadata,
    }


def _json_default(o: Any):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def atomic_write_model_dir(
    path: str, manifest: dict[str, Any], arrays: dict[str, np.ndarray]
) -> None:
    """Write ``manifest.json`` and ``arrays.npz`` into a temporary sibling,
    then swap it in. An existing directory is renamed aside for the swap
    (never removed first), so a kill at any instant leaves the old complete
    directory, the new one, or the old one parked at ``<path>.old-<pid>``;
    other files kept beside the model are carried over."""
    base = path.rstrip(os.sep)
    tmp = f"{base}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=2, default=_json_default)
    np.savez_compressed(os.path.join(tmp, "arrays.npz"), **arrays)
    if os.path.exists(path):
        old = f"{base}.old-{os.getpid()}"
        shutil.rmtree(old, ignore_errors=True)
        os.rename(path, old)
        os.rename(tmp, path)
        for entry in os.listdir(old):
            if entry not in ("manifest.json", "arrays.npz"):
                os.rename(os.path.join(old, entry), os.path.join(path, entry))
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(tmp, path)


def save_workflow_model(model: "WorkflowModel", path: str) -> None:  # noqa: F821
    arrays: dict[str, np.ndarray] = {}
    # application order is DAG order, which the fitted dict's insertion
    # order keeps (fit_and_transform_dag walks the layers)
    stages = [
        stage_to_entry(est_uid, stage, arrays)
        for est_uid, stage in model.fitted.items()
    ]
    manifest = {
        "version": 1,
        "rawFeatures": [
            {"name": f.name, "type": f.ftype.__name__,
             "isResponse": f.is_response, "uid": f.uid}
            for f in model.raw_features
        ],
        "resultFeatures": [f.name for f in model.result_features],
        "stages": stages,
        "selectorInfo": model.selector_info,
        "trainRows": model.train_rows,
        "holdoutRows": model.holdout_rows,
        "rffResults": model.rff_results,
        "blocklisted": model.blocklisted,
        "sensitiveFeatures": model.sensitive_info,
        "servingProfiles": model.serving_profiles,
        "attributionProfiles": model.attribution_profiles,
        "distResilience": None,
        "analysis": None,
        "runReport": None,
    }
    atomic_write_model_dir(path, manifest, arrays)


def _stage_arrays(npz: Any, uid: str, source: str) -> dict[str, np.ndarray]:
    prefix = f"{uid}__"
    out: dict[str, np.ndarray] = {}
    for k in npz.files:
        if k.startswith(prefix):
            try:
                out[k[len(prefix):]] = npz[k]
            except Exception as e:
                raise ModelLoadError(
                    f"{source}: member '{k}' (stage {uid}) is corrupt or "
                    f"truncated: {e}"
                ) from e
    return out


def load_workflow_model(path: str, device=None) -> "WorkflowModel":  # noqa: F821
    """Read a saved model directory; the predictors' arrays go to
    ``device`` (``None`` means ``cuda``, which must be present)."""
    from .workflow import WorkflowModel

    dev = resolve_device(device)
    manifest_path = os.path.join(path, "manifest.json")
    npz_path = os.path.join(path, "arrays.npz")
    try:
        with open(manifest_path) as fh:
            manifest = json.load(fh)
    except FileNotFoundError:
        raise ModelLoadError(
            f"{path}: no manifest.json — not a saved model directory "
            "(or the save was interrupted before commit)"
        ) from None
    except json.JSONDecodeError as e:
        raise ModelLoadError(
            f"{manifest_path} is corrupt or truncated: {e}"
        ) from e
    try:
        npz = np.load(npz_path, allow_pickle=False)
    except FileNotFoundError:
        raise ModelLoadError(f"{path}: missing arrays.npz") from None
    except Exception as e:
        raise ModelLoadError(
            f"{npz_path} is corrupt or truncated: {e}"
        ) from e

    with npz:
        raw_features = []
        feature_by_name: dict[str, Feature] = {}
        for rf in manifest["rawFeatures"]:
            ftype = T.feature_type_by_name(rf["type"])
            feat = FeatureGeneratorStage(
                rf["name"], ftype, is_response=rf["isResponse"]
            ).get_output()
            feat.uid = rf["uid"]
            raw_features.append(feat)
            feature_by_name[feat.name] = feat

        fitted: dict[str, PipelineStage] = {}
        for entry in manifest["stages"]:
            arrays = _stage_arrays(npz, entry["uid"], npz_path)
            try:
                stage = construct_stage(entry["class"], entry["params"], arrays)
            except KeyError as e:
                raise ModelLoadError(
                    f"{npz_path}: stage {entry['uid']} ({entry['class']}) is "
                    f"missing member {e} — the save was likely torn; delete "
                    "and refit"
                ) from e
            stage.uid = entry["uid"]
            stage.operation_name = entry["operationName"]
            stage.metadata = entry.get("metadata", {})
            try:
                inputs = tuple(
                    feature_by_name[name] for name in entry["inputFeatures"]
                )
            except KeyError as e:
                raise ModelLoadError(
                    f"stage {entry['uid']} references unknown feature {e}"
                ) from None
            stage.input_features = inputs
            stage._fixed_output_name = entry["outputName"]
            feature_by_name[entry["outputName"]] = stage.get_output()
            stage.to(dev)
            fitted[entry["estimatorUid"]] = stage

    return WorkflowModel(
        result_features=tuple(
            feature_by_name[name] for name in manifest["resultFeatures"]
        ),
        raw_features=tuple(raw_features),
        fitted=fitted,
        selector_info=manifest.get("selectorInfo"),
        train_rows=manifest.get("trainRows", 0),
        holdout_rows=manifest.get("holdoutRows", 0),
        rff_results=manifest.get("rffResults"),
        blocklisted=manifest.get("blocklisted", []),
        sensitive_info=manifest.get("sensitiveFeatures"),
        serving_profiles=manifest.get("servingProfiles"),
        attribution_profiles=manifest.get("attributionProfiles"),
        device=dev,
    )
