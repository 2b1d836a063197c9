"""Transmogrifier — type-directed automated feature engineering
(Transmogrifier.scala:92-340): group features by exact type (sorted by
type name), apply each type's default vectorizer as ONE sequence stage per
type, then combine the vectors with VectorsCombiner into one feature
vector. The dispatch is the reference's ``_vectorizer_for``, type for type.

Dispatch parity map (defaults at Transmogrifier.scala:52-88):
  OPVector                  passthrough
  Real/Currency/Percent     RealVectorizer (fillWithMean, trackNulls)
  RealNN                    RealNNVectorizer (passthrough)
  Integral                  IntegralVectorizer (fillWithMode, trackNulls)
  Binary                    BinaryVectorizer (fill false, trackNulls)
  Date/DateTime             DateVectorizer (unit circles + SinceLast)
  Text/TextArea             SmartTextVectorizer (pivot/hash/ignore)
  PickList/ComboBox/ID/Email/URL/Base64/Country/State/City/PostalCode/Street
                            OneHotVectorizer (TopK=20, MinSupport=10)
  MultiPickList             OneHotVectorizer over sets
  Phone                     PhoneVectorizer (is-valid vs DefaultRegion)
  TextList                  TextListVectorizer (hashing TF, 512 terms)
  DateList/DateTimeList     DateListVectorizer (SinceLast)
  Geolocation               GeolocationVectorizer (fillWithMean)
  numeric maps              RealMapVectorizer (mean/mode/constant per type)
  Date/DateTimeMap          DateMapVectorizer (unit circles + SinceLast)
  categorical maps          TextMapPivotVectorizer (per-key topK pivot)
  TextMap/TextAreaMap       SmartTextMapVectorizer (per-key pivot/hash)
  PhoneMap                  PhoneMapVectorizer
  GeolocationMap            GeolocationMapVectorizer
"""
from __future__ import annotations

from typing import Sequence

from .. import types as T
from ..features.feature import Feature
from .categorical import OneHotVectorizer
from .combiner import VectorsCombiner
from .dates import DateVectorizer
from .defaults import DEFAULTS, TransmogrifierDefaults
from .lists import DateListVectorizer, GeolocationVectorizer, TextListVectorizer
from .maps import (
    DateMapVectorizer,
    GeolocationMapVectorizer,
    PhoneMapVectorizer,
    RealMapVectorizer,
    SmartTextMapVectorizer,
    TextMapPivotVectorizer,
)
from .numeric import (
    BinaryVectorizer,
    IntegralVectorizer,
    RealNNVectorizer,
    RealVectorizer,
)
from .phone import PhoneVectorizer
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

#: categorical maps pivoted per key (Transmogrifier.scala maps dispatch)
_PIVOT_MAP_TYPES = (
    T.Base64Map,
    T.ComboBoxMap,
    T.EmailMap,
    T.IDMap,
    T.MultiPickListMap,
    T.PickListMap,
    T.URLMap,
    T.CountryMap,
    T.StateMap,
    T.CityMap,
    T.PostalCodeMap,
    T.StreetMap,
    T.NameStats,
)
_MEAN_MAP_TYPES = (T.CurrencyMap, T.PercentMap, T.RealMap)


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
    if ftype in (T.Date, T.DateTime):
        return DateVectorizer(
            reference_date_ms=d.ReferenceDateMs,
            circular_reps=d.CircularDateRepresentations,
            track_nulls=d.TrackNulls,
        )
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
    if ftype in _ONE_HOT_TYPES or ftype is T.MultiPickList:
        return OneHotVectorizer(
            top_k=d.TopK,
            min_support=d.MinSupport,
            clean_text=d.CleanText,
            track_nulls=d.TrackNulls,
        )
    if ftype is T.Phone:
        return PhoneVectorizer(track_nulls=d.TrackNulls)
    if ftype is T.TextList:
        return TextListVectorizer(
            num_terms=d.DefaultNumOfFeatures,
            binary_freq=d.BinaryFreq,
            min_doc_freq=d.MinDocFrequency,
            track_nulls=d.TrackNulls,
        )
    if ftype in (T.DateList, T.DateTimeList):
        return DateListVectorizer(
            reference_date_ms=d.ReferenceDateMs, track_nulls=d.TrackNulls
        )
    if ftype is T.Geolocation:
        return GeolocationVectorizer(
            fill_with_mean=d.FillWithMean, track_nulls=d.TrackNulls
        )
    if ftype in _PIVOT_MAP_TYPES:
        return TextMapPivotVectorizer(
            top_k=d.TopK,
            min_support=d.MinSupport,
            clean_text=d.CleanText,
            clean_keys=d.CleanKeys,
            track_nulls=d.TrackNulls,
        )
    if ftype in _MEAN_MAP_TYPES:
        return RealMapVectorizer(
            fill="mean" if d.FillWithMean else "constant",
            fill_value=d.FillValue,
            clean_keys=d.CleanKeys,
            track_nulls=d.TrackNulls,
        )
    if ftype is T.IntegralMap:
        return RealMapVectorizer(
            fill="mode" if d.FillWithMode else "constant",
            fill_value=d.FillValue,
            clean_keys=d.CleanKeys,
            track_nulls=d.TrackNulls,
        )
    if ftype is T.BinaryMap:
        return RealMapVectorizer(
            fill="constant",
            fill_value=float(d.BinaryFillValue),
            clean_keys=d.CleanKeys,
            track_nulls=d.TrackNulls,
        )
    if ftype in (T.DateMap, T.DateTimeMap):
        return DateMapVectorizer(
            reference_date_ms=d.ReferenceDateMs,
            circular_reps=d.CircularDateRepresentations,
            clean_keys=d.CleanKeys,
            track_nulls=d.TrackNulls,
        )
    if ftype in (T.TextMap, T.TextAreaMap):
        return SmartTextMapVectorizer(
            max_cardinality=d.MaxCategoricalCardinality,
            top_k=d.TopK,
            min_support=d.MinSupport,
            coverage_pct=d.CoveragePct,
            num_hashes=d.DefaultNumOfFeatures,
            clean_text=d.CleanText,
            clean_keys=d.CleanKeys,
            track_nulls=d.TrackNulls,
        )
    if ftype is T.PhoneMap:
        return PhoneMapVectorizer(
            clean_keys=d.CleanKeys, track_nulls=d.TrackNulls
        )
    if ftype is T.GeolocationMap:
        return GeolocationMapVectorizer(
            clean_keys=d.CleanKeys, track_nulls=d.TrackNulls
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
    feature (dsl ``.transmogrify()``, RichFeaturesCollection.scala:69).
    ``label`` is accepted for the reference's signature and not used."""
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
