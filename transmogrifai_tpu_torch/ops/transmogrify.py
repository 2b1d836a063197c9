"""Transmogrifier — type-directed automated feature engineering
(Transmogrifier.scala:92-340): group features by exact type (sorted by
type name), apply each type's default vectorizer as ONE sequence stage per
type, then combine the vectors with VectorsCombiner into one feature
vector.

Dispatch (defaults in ``ops/defaults.py``):
  OPVector                  passthrough
  Real/Currency/Percent     RealVectorizer (fillWithMean, trackNulls)
  RealNN                    RealNNVectorizer (passthrough)
  Integral                  IntegralVectorizer (fillWithMode, trackNulls)
  Binary                    BinaryVectorizer (fill false, trackNulls)
  Text/TextArea             SmartTextVectorizer (pivot/hash/ignore)
  PickList/ComboBox/ID/Email/URL/Base64/Country/State/City/PostalCode/Street
                            OneHotVectorizer (TopK=20, MinSupport=10)
Every other type raises ``NotImplementedError`` naming the ``ROADMAP.md``
item that ports its vectorizer.
"""
from __future__ import annotations

from typing import Sequence

from .. import types as T
from ..features.feature import Feature
from .categorical import OneHotVectorizer
from .combiner import VectorsCombiner
from .defaults import DEFAULTS, TransmogrifierDefaults
from .numeric import (
    BinaryVectorizer,
    IntegralVectorizer,
    RealNNVectorizer,
    RealVectorizer,
)
from .text import SmartTextVectorizer

_ONE_HOT_TYPES = (
    T.PickList,
    T.ComboBox,
    T.ID,
    T.Email,
    T.URL,
    T.Base64,
    T.Country,
    T.State,
    T.City,
    T.PostalCode,
    T.Street,
)
_SMART_TEXT_TYPES = (T.Text, T.TextArea)

#: types whose vectorizer is still to port, by the module that holds it in
#: the reference (``ROADMAP.md`` A2)
_NOT_PORTED = (
    ((T.Date, T.DateTime), "ops/dates.py"),
    ((T.MultiPickList,), "the set pivot of ops/categorical.py"),
    ((T.Phone,), "ops/phone.py"),
    ((T.TextList, T.DateList, T.DateTimeList, T.Geolocation), "ops/lists.py"),
    ((T.OPMap,), "ops/maps.py"),
)


def _vectorizer_for(ftype: type, d: TransmogrifierDefaults):
    if ftype is T.RealNN:
        return RealNNVectorizer()
    if ftype in (T.Real, T.Currency, T.Percent):
        return RealVectorizer(
            fill_with_mean=d.FillWithMean,
            fill_value=d.FillValue,
            track_nulls=d.TrackNulls,
        )
    if ftype is T.Integral:
        return IntegralVectorizer(
            fill_with_mode=d.FillWithMode,
            fill_value=d.FillValue,
            track_nulls=d.TrackNulls,
        )
    if ftype is T.Binary:
        return BinaryVectorizer(fill_value=d.BinaryFillValue, track_nulls=d.TrackNulls)
    if ftype in _SMART_TEXT_TYPES:
        return SmartTextVectorizer(
            max_cardinality=d.MaxCategoricalCardinality,
            top_k=d.TopK,
            min_support=d.MinSupport,
            coverage_pct=d.CoveragePct,
            num_hashes=d.DefaultNumOfFeatures,
            clean_text=d.CleanText,
            track_nulls=d.TrackNulls,
        )
    if ftype in _ONE_HOT_TYPES:
        return OneHotVectorizer(
            top_k=d.TopK,
            min_support=d.MinSupport,
            clean_text=d.CleanText,
            track_nulls=d.TrackNulls,
        )
    for types, module in _NOT_PORTED:
        if issubclass(ftype, types) and ftype is not T.Prediction:
            raise NotImplementedError(
                f"the vectorizer of {ftype.__name__} ({module}) is not ported "
                "yet: ROADMAP.md A2"
            )
    raise NotImplementedError(
        f"No default vectorizer for feature type {ftype.__name__}"
    )


def transmogrify(
    features: Sequence[Feature],
    label: Feature | None = None,
    defaults: TransmogrifierDefaults = DEFAULTS,
) -> Feature:
    """Vectorize features by type and combine them into one OPVector
    feature (dsl ``.transmogrify()``). ``label`` is accepted for the
    reference's signature and not used."""
    if not features:
        raise ValueError("transmogrify requires at least one feature")
    by_type: dict[str, list[Feature]] = {}
    for f in features:
        by_type.setdefault(f.ftype.__name__, []).append(f)

    vector_features: list[Feature] = []
    for type_name in sorted(by_type):
        group = by_type[type_name]
        ftype = group[0].ftype
        if ftype is T.OPVector:
            vector_features.extend(group)
            continue
        stage = _vectorizer_for(ftype, defaults)
        stage.set_input(*group)
        vector_features.append(stage.get_output())

    if len(vector_features) == 1:
        return vector_features[0]
    combiner = VectorsCombiner()
    combiner.set_input(*vector_features)
    return combiner.get_output()
