"""Feature type system (the port's copy of ``transmogrifai_tpu.types``:
the same 53 tags under the same names, so a saved manifest's type names
resolve here unchanged).

The reference (TransmogrifAI) models every value as one of 53 immutable wrapper
types arranged in 6 families (features/.../types/FeatureType.scala:44,265-325).
A TPU-native rebuild has no use for per-value boxing: data is *columnar*, and a
"feature type" is a static tag carried by a column that drives type-directed
feature engineering (transmogrification), response/predictor discipline, and
vector-metadata provenance.

Here a feature type is a Python class object (never instantiated per value).
Class-level attributes describe nullability, family, and the physical columnar
storage used on host / device.
"""
from __future__ import annotations

import enum


class Storage(enum.Enum):
    """Physical columnar representation of a feature type.

    REAL/INTEGRAL/BINARY/DATE columns are (values ndarray, validity mask) pairs
    that move to device untouched; TEXT-family columns stay host-side until a
    vectorizer encodes them to integers (hashing / vocabulary lookup).
    """

    REAL = "real"            # float64 values + bool mask
    INTEGRAL = "integral"    # int64 values + bool mask
    BINARY = "binary"        # bool values + bool mask
    DATE = "date"            # int64 epoch values + bool mask
    TEXT = "text"            # object ndarray of str | None
    TEXT_SET = "text_set"    # list of frozenset[str]
    TEXT_LIST = "text_list"  # list of list[str]
    DATE_LIST = "date_list"  # list of list[int]
    GEO = "geolocation"      # list of (lat, lon, accuracy) triples
    MAP = "map"              # list of dict[str, scalar]
    VECTOR = "vector"        # float32 [N, D] dense matrix + VectorMetadata


class FeatureTypeMeta(type):
    def __repr__(cls) -> str:  # noqa: D105
        return cls.__name__


class FeatureType(metaclass=FeatureTypeMeta):
    """Base tag. Mirrors FeatureType.scala:44 (isNullable / isEmpty semantics
    become per-column validity masks)."""

    storage: Storage = Storage.REAL
    is_nullable: bool = True


# ------------------------------- traits ------------------------------------
class NonNullable:
    """FeatureType.scala:122 — types that may never be empty."""

    is_nullable = False


class Categorical:
    """features/.../types/FeatureType.scala:145 — one-hot-able types."""


class Location:
    """Location trait (Country/State/City/PostalCode/Street/Geolocation)."""


class SingleResponse:
    """Valid response types for single-label problems."""


class MultiResponse:
    """Valid response types for multi-label problems."""


# ------------------------------- numerics ----------------------------------
class OPNumeric(FeatureType):
    storage = Storage.REAL


class Real(OPNumeric):
    storage = Storage.REAL


class RealNN(NonNullable, SingleResponse, Real):
    pass


class Currency(Real):
    pass


class Percent(Real):
    pass


class Integral(OPNumeric):
    storage = Storage.INTEGRAL


class Date(Integral):
    storage = Storage.DATE


class DateTime(Date):
    pass


class Binary(SingleResponse, Categorical, OPNumeric):
    storage = Storage.BINARY


# --------------------------------- text ------------------------------------
class Text(FeatureType):
    storage = Storage.TEXT


class Email(Text):
    pass


class URL(Text):
    pass


class Phone(Text):
    pass


class ID(Text):
    pass


class PickList(Categorical, Text):
    pass


class ComboBox(Categorical, Text):
    pass


class Base64(Text):
    pass


class TextArea(Text):
    pass


class Country(Location, Text):
    pass


class State(Location, Text):
    pass


class City(Location, Text):
    pass


class PostalCode(Location, Text):
    pass


class Street(Location, Text):
    pass


# --------------------------------- sets ------------------------------------
class OPSet(FeatureType):
    storage = Storage.TEXT_SET


class MultiPickList(Categorical, MultiResponse, OPSet):
    pass


# --------------------------------- lists -----------------------------------
class OPList(FeatureType):
    storage = Storage.TEXT_LIST


class TextList(OPList):
    pass


class DateList(OPList):
    storage = Storage.DATE_LIST


class DateTimeList(DateList):
    pass


class Geolocation(Location, OPList):
    storage = Storage.GEO


# --------------------------------- maps ------------------------------------
class OPMap(FeatureType):
    """Map family — one map type per scalar type (types/Maps.scala)."""

    storage = Storage.MAP
    #: feature type of the map's values (used for per-key expansion)
    value_type: type = FeatureType


def _map_type(name: str, value_type: type, *extra_bases: type) -> type:
    return FeatureTypeMeta(name, (*extra_bases, OPMap), {"value_type": value_type})


Base64Map = _map_type("Base64Map", Base64)
BinaryMap = _map_type("BinaryMap", Binary)
ComboBoxMap = _map_type("ComboBoxMap", ComboBox)
CurrencyMap = _map_type("CurrencyMap", Currency)
DateMap = _map_type("DateMap", Date)
DateTimeMap = _map_type("DateTimeMap", DateTime)
EmailMap = _map_type("EmailMap", Email)
IDMap = _map_type("IDMap", ID)
IntegralMap = _map_type("IntegralMap", Integral)
MultiPickListMap = _map_type("MultiPickListMap", MultiPickList)
PercentMap = _map_type("PercentMap", Percent)
PhoneMap = _map_type("PhoneMap", Phone)
PickListMap = _map_type("PickListMap", PickList)
RealMap = _map_type("RealMap", Real)
TextAreaMap = _map_type("TextAreaMap", TextArea)
TextMap = _map_type("TextMap", Text)
URLMap = _map_type("URLMap", URL)
CountryMap = _map_type("CountryMap", Country, Location)
StateMap = _map_type("StateMap", State, Location)
CityMap = _map_type("CityMap", City, Location)
PostalCodeMap = _map_type("PostalCodeMap", PostalCode, Location)
StreetMap = _map_type("StreetMap", Street, Location)
GeolocationMap = _map_type("GeolocationMap", Geolocation, Location)


class NameStats(OPMap):
    """Name-detection statistics map (types/Maps.scala NameStats)."""

    value_type = Text


class Prediction(NonNullable, OPMap):
    """Model output map keyed prediction/probability_*/raw_* (types/Maps.scala:339).

    Columnar layout: dedicated PredictionColumn with dense (pred, prob, raw)
    arrays — see ``types.columns``.
    """

    value_type = Real
    KEY_PREDICTION = "prediction"
    KEY_RAW = "rawPrediction"
    KEY_PROB = "probability"


# -------------------------------- vector -----------------------------------
class OPVector(NonNullable, FeatureType):
    storage = Storage.VECTOR


# ------------------------------- registry ----------------------------------
#: All 53 concrete feature types (FeatureType.scala:265-325 registry parity).
ALL_FEATURE_TYPES: tuple[type, ...] = (
    # Vector
    OPVector,
    # Lists
    TextList, DateList, DateTimeList, Geolocation,
    # Maps
    Base64Map, BinaryMap, ComboBoxMap, CurrencyMap, DateMap, DateTimeMap,
    EmailMap, IDMap, IntegralMap, MultiPickListMap, PercentMap, PhoneMap,
    PickListMap, RealMap, TextAreaMap, TextMap, URLMap, CountryMap, StateMap,
    CityMap, PostalCodeMap, StreetMap, NameStats, GeolocationMap, Prediction,
    # Numerics
    Binary, Currency, Date, DateTime, Integral, Percent, Real, RealNN,
    # Sets
    MultiPickList,
    # Text
    Base64, ComboBox, Email, ID, Phone, PickList, Text, TextArea, URL,
    Country, State, City, PostalCode, Street,
)

FEATURE_TYPES_BY_NAME: dict[str, type] = {t.__name__: t for t in ALL_FEATURE_TYPES}


def is_subtype(t: type, parent: type) -> bool:
    """True if feature type ``t`` is ``parent`` (or one of a tuple of
    parents) or a subtype of it."""
    return isinstance(t, type) and issubclass(t, parent)


def feature_type_by_name(name: str) -> type:
    """Look up a feature type by its class name (FeatureType.scala:238)."""
    try:
        return FEATURE_TYPES_BY_NAME[name]
    except KeyError:
        raise ValueError(f"Unknown feature type '{name}'") from None

