"""Transmogrifier defaults, the reference's values
(``transmogrifai_tpu/ops/defaults.py``; Transmogrifier.scala:52-88)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TransmogrifierDefaults:
    DefaultNumOfFeatures: int = 512
    MaxNumOfFeatures: int = 1 << 17
    TopK: int = 20
    MinSupport: int = 10
    FillValue: float = 0.0
    BinaryFillValue: bool = False
    HashWithIndex: bool = False
    PrependFeatureName: bool = True
    CleanText: bool = True
    CleanKeys: bool = False
    BinaryFreq: bool = False
    FillWithMode: bool = True
    FillWithMean: bool = True
    TrackNulls: bool = True
    TrackInvalid: bool = False
    TrackTextLen: bool = False
    MinDocFrequency: int = 0
    MaxCategoricalCardinality: int = 30
    CoveragePct: float = 0.90
    MinTokenLength: int = 1
    ToLowercase: bool = True
    HashSeed: int = 42
    #: circular date encodings (TimePeriod.{HourOfDay,DayOfWeek,DayOfMonth,DayOfYear})
    CircularDateRepresentations: tuple[str, ...] = (
        "HourOfDay",
        "DayOfWeek",
        "DayOfMonth",
        "DayOfYear",
    )
    #: reference date for days-since encodings; fixed at fit time
    ReferenceDateMs: int | None = None


DEFAULTS = TransmogrifierDefaults()
