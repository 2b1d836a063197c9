"""FeatureBuilder — typed raw-feature declaration (FeatureBuilder.scala:48)
and ``from_dataset``, one feature per column of a columnar dataset with its
type inferred from the column (``fromDataFrame``, FeatureBuilder.scala:232):

    age  = FeatureBuilder.Real("age").extract(lambda p: p["age"]).as_predictor()
    response, predictors = from_dataset(ds, response="survived")
"""
from __future__ import annotations

from typing import Any, Callable, Iterable

from .. import types as T
from ..dataset import Dataset
from ..types.columns import (
    Column,
    ListColumn,
    MapColumn,
    NumericColumn,
    SetColumn,
    TextColumn,
    VectorColumn,
)
from .feature import Feature, FeatureGeneratorStage


class _TypedBuilder:
    def __init__(self, name: str, ftype: type):
        self.name = name
        self.ftype = ftype
        self._extract_fn: Callable[[Any], Any] | None = None
        self._aggregate_fn: Callable[[Iterable[Any]], Any] | None = None

    def extract(self, fn: Callable[[Any], Any]) -> "_TypedBuilder":
        self._extract_fn = fn
        return self

    def aggregate(self, fn: Callable[[Iterable[Any]], Any]) -> "_TypedBuilder":
        """A custom monoid aggregator for the event-grouped readers
        (MonoidAggregatorDefaults.scala)."""
        self._aggregate_fn = fn
        return self

    def _build(self, is_response: bool) -> Feature:
        return FeatureGeneratorStage(
            self.name, self.ftype, extract_fn=self._extract_fn,
            aggregate_fn=self._aggregate_fn, is_response=is_response,
        ).get_output()

    def as_predictor(self) -> Feature:
        return self._build(is_response=False)

    def as_response(self) -> Feature:
        return self._build(is_response=True)


class _FeatureBuilderMeta(type):
    def __getattr__(cls, type_name: str) -> Callable[[str], _TypedBuilder]:
        ftype = T.FEATURE_TYPES_BY_NAME.get(type_name)
        if ftype is None:
            raise AttributeError(f"FeatureBuilder.{type_name}: unknown feature type")

        def factory(name: str) -> _TypedBuilder:
            return _TypedBuilder(name, ftype)

        return factory


class FeatureBuilder(metaclass=_FeatureBuilderMeta):
    """``FeatureBuilder.<TypeName>(name)`` for all 53 feature types."""


def infer_feature_type(col: Column) -> type:
    """Physical column -> feature type: numeric, text, list and map columns
    keep their own type, a set column is MultiPickList, a vector
    OPVector."""
    if isinstance(col, (NumericColumn, TextColumn, ListColumn, MapColumn)):
        return col.feature_type
    if isinstance(col, SetColumn):
        return T.MultiPickList
    if isinstance(col, VectorColumn):
        return T.OPVector
    raise TypeError(f"Cannot infer feature type for {type(col).__name__}")


def from_dataset(
    dataset: Dataset,
    response: str,
    response_type: type = T.RealNN,
) -> tuple[Feature, list[Feature]]:
    """(response, predictors) from a columnar dataset. The response must be
    numeric (or text, for a text ``response_type``) and never missing;
    each other column becomes a predictor."""
    if response not in dataset:
        raise ValueError(
            f"Response feature '{response}' not found in columns {list(dataset)}"
        )
    resp_col = dataset[response]
    if issubclass(response_type, T.Text):
        if not isinstance(resp_col, TextColumn):
            raise TypeError(
                f"Response '{response}' declared {response_type.__name__} but "
                f"stored as {type(resp_col).__name__}"
            )
        if any(v is None for v in resp_col.values):
            raise ValueError(f"Response '{response}' contains missing values")
    elif not isinstance(resp_col, NumericColumn):
        raise TypeError(
            f"Response '{response}' must be numeric, got {type(resp_col).__name__}"
        )
    elif not resp_col.mask.all():
        raise ValueError(f"Response '{response}' contains missing values")

    resp = FeatureGeneratorStage(
        response, response_type, is_response=True
    ).get_output()
    predictors = [
        FeatureGeneratorStage(name, infer_feature_type(col)).get_output()
        for name, col in dataset.columns.items()
        if name != response
    ]
    return resp, predictors
