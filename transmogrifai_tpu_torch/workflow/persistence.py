"""Load a workflow model saved by ``transmogrifai_tpu``.

The saved format is one directory holding ``manifest.json`` (features,
stages in DAG order with their class, uid, params and wiring) and
``arrays.npz`` (every fitted array, keyed ``<stage_uid>__<name>``). Each
saved stage class maps to the port's class of the same name; the loader
rebuilds the feature DAG and puts the predictors' arrays on the device.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from .. import types as T
from ..features.feature import Feature, FeatureGeneratorStage
from ..models.gbdt import (
    BoostedBinaryModel, BoostedRegressionModel, ForestClassifierModel,
    ForestRegressionModel,
)
from ..models.linear import LinearRegressionModel
from ..models.logistic import LogisticRegressionModel
from ..ops.categorical import OneHotModel
from ..ops.combiner import VectorsCombiner
from ..ops.numeric import BinaryVectorizer, NumericVectorizerModel, RealNNVectorizer
from ..ops.text import SmartTextModel
from ..prep.derived_filter import FeatureRemovalModel
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
        BoostedBinaryModel, ForestClassifierModel, BoostedRegressionModel,
        ForestRegressionModel, LogisticRegressionModel, LinearRegressionModel,
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


def _stage_arrays(npz: Any, uid: str, source: str) -> dict[str, np.ndarray]:
    prefix = f"{uid}__"
    out: dict[str, np.ndarray] = {}
    for k in npz.files:
        if k.startswith(prefix):
            try:
                out[k[len(prefix):]] = npz[k]
            except (OSError, ValueError) as e:
                raise ModelLoadError(
                    f"{source}: member '{k}' (stage {uid}) is corrupt: {e}"
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
        raise ModelLoadError(f"{path}: no manifest.json") from None
    except json.JSONDecodeError as e:
        raise ModelLoadError(f"{manifest_path} is corrupt: {e}") from e
    try:
        npz = np.load(npz_path, allow_pickle=False)
    except FileNotFoundError:
        raise ModelLoadError(f"{path}: missing arrays.npz") from None

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
                    f"missing member {e}"
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
        device=dev,
    )
