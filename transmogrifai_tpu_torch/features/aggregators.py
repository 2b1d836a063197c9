"""Monoid aggregators — event aggregation semantics for raw features.

Reference: features/.../aggregators/MonoidAggregatorDefaults.scala:41 (default
registry), Numerics.scala, Text.scala, Sets.scala, Lists.scala, Maps.scala,
Geolocation.scala, OPVector.scala, TimeBasedAggregator.scala,
CustomMonoidAggregator.scala.

Every aggregator is a *commutative-monoid* fold ``present(plus*(prepare(v)))``
so results are shard-order-invariant — exactly the property that lets the
aggregate/conditional readers run as segment reductions on device
(monoid reduceByKey). The host path here folds per key.

Missing values: ``prepare(None)`` returns the monoid zero, matching the
reference's Option-typed accumulators.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Iterable

from .. import types as T


class MonoidAggregator:
    """prepare → plus (associative+commutative, zero identity) → present."""

    #: monoid identity (must be treated as immutable)
    zero: Any = None

    def prepare(self, value: Any) -> Any:
        return value

    def plus(self, a: Any, b: Any) -> Any:
        raise NotImplementedError

    def present(self, acc: Any) -> Any:
        return acc

    def __call__(self, values: Iterable[Any]) -> Any:
        acc = self.zero
        for v in values:
            acc = self.plus(acc, self.prepare(v))
        return self.present(acc)


def _opt(op: Callable[[Any, Any], Any]) -> Callable[[Any, Any], Any]:
    """Lift a binary op over None-as-zero (the reference's Option monoid)."""

    def lifted(a: Any, b: Any) -> Any:
        if a is None:
            return b
        if b is None:
            return a
        return op(a, b)

    return lifted


class _Lifted(MonoidAggregator):
    """Aggregator over None-able scalars with a lifted binary op."""

    def __init__(self, op: Callable[[Any, Any], Any]):
        self._plus = _opt(op)

    def plus(self, a: Any, b: Any) -> Any:
        return self._plus(a, b)


class SumNumeric(_Lifted):
    """SumReal/SumRealNN/SumCurrency/SumIntegral (Numerics.scala:51-54)."""

    def __init__(self) -> None:
        super().__init__(lambda a, b: a + b)


class MaxNumeric(_Lifted):
    """MaxDate/MaxDateTime/... (Numerics.scala:70-75)."""

    def __init__(self) -> None:
        super().__init__(max)


class MinNumeric(_Lifted):
    def __init__(self) -> None:
        super().__init__(min)


class MeanNumeric(MonoidAggregator):
    """MeanReal/MeanPercent — (sum, count) pairs (Numerics.scala:86-106).

    Percent values are clamped to [0, 1] at prepare (PercentPrepare,
    Numerics.scala:124): x<0 → 0, x>1 → scaled by 1e-2 iff <=100 else 1.
    """

    def __init__(self, is_percent: bool = False):
        self.is_percent = is_percent

    def prepare(self, value: Any) -> Any:
        if value is None:
            return None
        v = float(value)
        if self.is_percent:
            v = _prepare_percent(v)
        return (v, 1)

    def plus(self, a: Any, b: Any) -> Any:
        if a is None:
            return b
        if b is None:
            return a
        return (a[0] + b[0], a[1] + b[1])

    def present(self, acc: Any) -> Any:
        if acc is None:
            return None
        s, n = acc
        return s / n if n else None


def _prepare_percent(v: float) -> float:
    if v < 0.0:
        return 0.0
    if v > 1.0:
        return v / 100.0 if v <= 100.0 else 1.0
    return v


class LogicalOr(_Lifted):
    """Binary default (Numerics.scala:118)."""

    def __init__(self) -> None:
        super().__init__(lambda a, b: bool(a) or bool(b))


class LogicalAnd(_Lifted):
    def __init__(self) -> None:
        super().__init__(lambda a, b: bool(a) and bool(b))


class LogicalXor(_Lifted):
    def __init__(self) -> None:
        super().__init__(lambda a, b: bool(a) != bool(b))


class ConcatText(_Lifted):
    """ConcatTextWithSeparator (Text.scala:41-68): Text/TextArea join with
    " ", everything else (Email/URL/ID/...) with ","."""

    def __init__(self, separator: str = ","):
        super().__init__(lambda a, b: f"{a}{separator}{b}")


class ModeText(MonoidAggregator):
    """ModePickList (Text.scala:73): most frequent value; ties break to the
    lexicographically smallest."""

    zero: dict = {}

    def prepare(self, value: Any) -> Any:
        return {} if value is None else {str(value): 1}

    def plus(self, a: dict, b: dict) -> dict:
        if not a:
            return b
        if not b:
            return a
        out = dict(a)
        for k, v in b.items():
            out[k] = out.get(k, 0) + v
        return out

    def present(self, acc: dict) -> Any:
        if not acc:
            return None
        return min(acc.items(), key=lambda kv: (-kv[1], kv[0]))[0]


class UnionSet(MonoidAggregator):
    """UnionMultiPickList (Sets.scala)."""

    zero: frozenset = frozenset()

    def prepare(self, value: Any) -> Any:
        return frozenset(value) if value else frozenset()

    def plus(self, a: frozenset, b: frozenset) -> frozenset:
        return a | b


class ConcatList(MonoidAggregator):
    """ConcatTextList/ConcatDateList/... (Lists.scala)."""

    zero: tuple = ()

    def prepare(self, value: Any) -> Any:
        return tuple(value) if value else ()

    def plus(self, a: tuple, b: tuple) -> tuple:
        return a + b

    def present(self, acc: tuple) -> list:
        return list(acc)


class GeolocationMidpoint(MonoidAggregator):
    """Geographic midpoint (Geolocation.scala:42-133): average unit-sphere
    (x, y, z) weighted by point count, then project back to lat/lon.
    Accuracy presents as the max of the inputs' accuracy codes (the
    reference reconstructs it from a bounding-prism width — divergence
    documented, same monotone intent)."""

    zero = None  # (x, y, z, weight, acc_max)

    def prepare(self, value: Any) -> Any:
        if not value:
            return None
        lat, lon, acc = float(value[0]), float(value[1]), float(value[2])
        la, lo = math.radians(lat), math.radians(lon)
        return (
            math.cos(la) * math.cos(lo),
            math.cos(la) * math.sin(lo),
            math.sin(la),
            1.0,
            acc,
        )

    def plus(self, a: Any, b: Any) -> Any:
        if a is None:
            return b
        if b is None:
            return a
        w = a[3] + b[3]
        return (
            (a[0] * a[3] + b[0] * b[3]) / w,
            (a[1] * a[3] + b[1] * b[3]) / w,
            (a[2] * a[3] + b[2] * b[3]) / w,
            w,
            max(a[4], b[4]),
        )

    def present(self, acc: Any) -> Any:
        if acc is None:
            return []
        x, y, z, _, a = acc
        lat = math.degrees(math.atan2(z, math.sqrt(x * x + y * y)))
        lon = math.degrees(math.atan2(y, x))
        return [lat, lon, a]


class CombineVector(MonoidAggregator):
    """CombineVector (OPVector.scala:43): vector concatenation."""

    zero: tuple = ()

    def prepare(self, value: Any) -> Any:
        return tuple(value) if value is not None else ()

    def plus(self, a: tuple, b: tuple) -> tuple:
        return a + b

    def present(self, acc: tuple) -> list:
        return list(acc)


class SumVector(MonoidAggregator):
    """SumVector (OPVector.scala:54): elementwise sum."""

    zero: tuple = ()

    def prepare(self, value: Any) -> Any:
        return tuple(value) if value is not None else ()

    def plus(self, a: tuple, b: tuple) -> tuple:
        if not a:
            return b
        if not b:
            return a
        if len(a) != len(b):
            raise ValueError(f"SumVector dims differ: {len(a)} vs {len(b)}")
        return tuple(x + y for x, y in zip(a, b))

    def present(self, acc: tuple) -> list:
        return list(acc)


class UnionMap(MonoidAggregator):
    """Map union with a per-value scalar monoid (Maps.scala:43-125)."""

    zero: dict = {}

    def __init__(self, value_agg: MonoidAggregator):
        self.value_agg = value_agg

    def prepare(self, value: Any) -> Any:
        if not value:
            return {}
        return {k: self.value_agg.prepare(v) for k, v in value.items()}

    def plus(self, a: dict, b: dict) -> dict:
        if not a:
            return b
        if not b:
            return a
        out = dict(a)
        for k, v in b.items():
            out[k] = self.value_agg.plus(out[k], v) if k in out else v
        return out

    def present(self, acc: dict) -> dict:
        return {k: self.value_agg.present(v) for k, v in acc.items()}


class CustomMonoidAggregator(MonoidAggregator):
    """User-supplied monoid (CustomMonoidAggregator.scala)."""

    def __init__(self, zero: Any, plus: Callable[[Any, Any], Any]):
        self.zero = zero
        self._plus = plus

    def plus(self, a: Any, b: Any) -> Any:
        return self._plus(a, b)


class LastAggregator(MonoidAggregator):
    """TimeBasedAggregator.scala: keep the value with the latest event time.
    Accumulator is (time, value); prepare is called with (value, time) via
    ``prepare_event``."""

    newer_wins = True
    zero = None

    def prepare(self, value: Any) -> Any:
        return self.prepare_event(value, 0)

    def prepare_event(self, value: Any, time: int) -> Any:
        return None if value is None else (time, value)

    def plus(self, a: Any, b: Any) -> Any:
        if a is None:
            return b
        if b is None:
            return a
        pick_b = (b[0] >= a[0]) if self.newer_wins else (b[0] < a[0])
        return b if pick_b else a

    def present(self, acc: Any) -> Any:
        return None if acc is None else acc[1]


class FirstAggregator(LastAggregator):
    newer_wins = False


# --------------------------------------------------------------------------
# Default registry (MonoidAggregatorDefaults.scala:52-120)
# --------------------------------------------------------------------------

def aggregator_of(ftype: type) -> MonoidAggregator:
    """Default aggregator for a feature type."""
    # map families first: resolve by per-value semantics
    if T.is_subtype(ftype, T.OPMap):
        return UnionMap(_map_value_aggregator(ftype))
    for base, make in _DEFAULTS:
        if T.is_subtype(ftype, base):
            return make()
    raise ValueError(f"No default aggregator for {ftype.__name__}")


def _map_value_aggregator(map_type: type) -> MonoidAggregator:
    value_type = getattr(map_type, "value_type", None)
    if map_type is T.Prediction:
        return MeanNumeric()  # UnionMeanPredicition
    if value_type is None:
        return ConcatText()
    if T.is_subtype(value_type, T.Percent):
        return MeanNumeric(is_percent=True)  # UnionMeanPercentMap
    if T.is_subtype(value_type, T.Date):
        return MaxNumeric()  # UnionMaxDate(Time)Map
    if T.is_subtype(value_type, T.Binary):
        return LogicalOr()  # UnionBinaryMap
    if T.is_subtype(value_type, (T.Real, T.Integral)):
        return SumNumeric()  # UnionRealMap / UnionIntegralMap / UnionCurrencyMap
    if T.is_subtype(value_type, T.MultiPickList):
        return UnionSet()  # UnionMultiPickListMap
    if T.is_subtype(value_type, T.Geolocation):
        return GeolocationMidpoint()  # UnionGeolocationMidpointMap
    if T.is_subtype(value_type, (T.Text, T.TextArea)):
        sep = " " if value_type in (T.Text, T.TextArea) else ","
        return ConcatText(sep)  # UnionConcat*Map
    return ConcatText()


# Ordered most-specific-first; first matching base wins. Text subtypes
# (Email/URL/...) concat with "," while plain Text/TextArea use " "
# (Text.scala:56-67).
_DEFAULTS: list[tuple[type, Callable[[], MonoidAggregator]]] = [
    (T.OPVector, CombineVector),
    (T.Geolocation, GeolocationMidpoint),
    (T.DateList, ConcatList),  # covers DateTimeList
    (T.TextList, ConcatList),
    (T.MultiPickList, UnionSet),
    (T.Binary, LogicalOr),
    (T.Percent, lambda: MeanNumeric(is_percent=True)),
    (T.Date, MaxNumeric),  # covers DateTime; before Integral
    (T.Integral, SumNumeric),
    (T.Real, SumNumeric),  # covers RealNN, Currency
    (T.PickList, ModeText),
    (T.ComboBox, ConcatText),
    (T.TextArea, lambda: ConcatText(" ")),
    (T.Email, ConcatText),
    (T.URL, ConcatText),
    (T.ID, ConcatText),
    (T.Phone, ConcatText),
    (T.Base64, ConcatText),
    (T.Country, ConcatText),
    (T.State, ConcatText),
    (T.City, ConcatText),
    (T.PostalCode, ConcatText),
    (T.Street, ConcatText),
    (T.Text, lambda: ConcatText(" ")),
]
