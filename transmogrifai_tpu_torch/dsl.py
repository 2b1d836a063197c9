"""dsl: the feature vocabulary, attached to ``Feature`` on import.

Reference: core/.../dsl/Rich{Numeric,Text,Date,List,Map,Set,Vector}Feature
.scala and RichFeaturesCollection.scala, as ``transmogrifai_tpu/dsl.py``
attaches them:

    pred = ((f1 + f2) / (f3 + 1)).z_normalize()
    bins = amount.auto_bucketize(label)
    vec = transmogrify_features([pred, bins, ...])
    checked = label.sanity_check(vec, remove_bad_features=True)

The text vocabulary (RichTextFeature.scala) attaches the stages of
``ops/text_stages.py`` and ``ops/embeddings.py``:

    vecs = text.tokenize().word2vec(vector_size=100)
    topics = text.tokenize().count_vectorize(vocab_size=2000).lda(k=10)
    tfidf = text.tokenize().tf_idf(num_terms=512)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

from .features.feature import Feature
from .ops import math as _math
from .ops import phone as _phone
from .ops import simple as _simple
from .ops.bucketizers import DecisionTreeNumericBucketizer, NumericBucketizer
from .ops.dates import DateToUnitCircleTransformer
from .ops.domains import EmailToPickListTransformer, UrlMapToPickListMapTransformer
from .ops.scalers import (
    DescalerTransformer,
    FillMissingWithMean,
    OpScalarStandardScaler,
    PercentileCalibrator,
    ScalerTransformer,
)
from .ops.embeddings import OpLDA, OpWord2Vec
from .ops.text_stages import (
    JaccardSimilarity,
    LangDetector,
    MimeTypeDetector,
    MimeTypeMapDetector,
    NameEntityRecognizer,
    NGramSimilarity,
    OpCountVectorizer,
    OpHashingTF,
    OpIDF,
    OpNGram,
    OpStopWordsRemover,
    OpStringIndexer,
    TextTokenizer,
    ValidEmailTransformer,
)
from .ops.time_period import (
    TimePeriodListTransformer,
    TimePeriodMapTransformer,
    TimePeriodTransformer,
)
from .types import OPMap


def _unary(stage_factory: Callable[..., Any]) -> Callable[..., Feature]:
    def method(self: Feature, *args: Any, **kwargs: Any) -> Feature:
        return self.transform_with(stage_factory(*args, **kwargs))

    return method


def _binary(stage_factory: Callable[..., Any]) -> Callable[..., Feature]:
    def method(self: Feature, other: Feature, *args: Any, **kwargs: Any) -> Feature:
        return self.transform_with(stage_factory(*args, **kwargs), other)

    return method


def _scalar_or_feature(
    feature_cls: type, scalar_cls: type
) -> Callable[..., Feature]:
    def method(self: Feature, other: Any) -> Feature:
        if isinstance(other, Feature):
            return self.transform_with(feature_cls(), other)
        return self.transform_with(scalar_cls(float(other)))

    return method


# ---------------------------------------------------------------- numeric dsl
# RichNumericFeature.scala: +, -, *, / with a feature or a scalar operand
Feature.__add__ = _scalar_or_feature(_math.AddTransformer, _math.ScalarAddTransformer)
Feature.__sub__ = _scalar_or_feature(
    _math.SubtractTransformer, _math.ScalarSubtractTransformer
)
Feature.__mul__ = _scalar_or_feature(
    _math.MultiplyTransformer, _math.ScalarMultiplyTransformer
)
Feature.__truediv__ = _scalar_or_feature(
    _math.DivideTransformer, _math.ScalarDivideTransformer
)
Feature.abs = _unary(_math.AbsoluteValueTransformer)
Feature.ceil = _unary(_math.CeilTransformer)
Feature.floor = _unary(_math.FloorTransformer)
Feature.round = _unary(_math.RoundTransformer)
Feature.round_digits = _unary(_math.RoundDigitsTransformer)
Feature.exp = _unary(_math.ExpTransformer)
Feature.sqrt = _unary(_math.SqrtTransformer)
Feature.log = _unary(_math.LogTransformer)
Feature.power = _unary(_math.PowerTransformer)
Feature.z_normalize = _unary(OpScalarStandardScaler)
Feature.fill_missing_with_mean = _unary(FillMissingWithMean)
Feature.bucketize = _unary(NumericBucketizer)
Feature.scale = _unary(ScalerTransformer)
Feature.descale = _binary(DescalerTransformer)
Feature.calibrate_percentile = _unary(PercentileCalibrator)


def _auto_bucketize(self: Feature, label: Feature, **kwargs: Any) -> Feature:
    """Supervised decision-tree binning (RichNumericFeature.autoBucketize);
    a numeric map takes the per-key variant (RichMapFeature.autoBucketize)."""
    from .ops.maps import DecisionTreeNumericMapBucketizer

    cls = (
        DecisionTreeNumericMapBucketizer
        if issubclass(self.ftype, OPMap)
        else DecisionTreeNumericBucketizer
    )
    return label.transform_with(cls(**kwargs), self)


Feature.auto_bucketize = _auto_bucketize

# ------------------------------------------------------------------- text dsl
# RichTextFeature.scala
Feature.tokenize = _unary(TextTokenizer)
Feature.ngram = _unary(OpNGram)
Feature.remove_stop_words = _unary(OpStopWordsRemover)
Feature.tf = _unary(OpHashingTF)
Feature.count_vectorize = _unary(OpCountVectorizer)
Feature.idf = _unary(OpIDF)
Feature.string_indexed = _unary(OpStringIndexer)
Feature.detect_languages = _unary(LangDetector)
Feature.detect_mime_types = _unary(MimeTypeDetector)
Feature.detect_mime_types_map = _unary(MimeTypeMapDetector)
Feature.is_valid_email = _unary(ValidEmailTransformer)
Feature.email_to_pick_list = _unary(EmailToPickListTransformer)
Feature.url_map_to_pick_list_map = _unary(UrlMapToPickListMapTransformer)
Feature.recognize_entities = _unary(NameEntityRecognizer)
Feature.word2vec = _unary(OpWord2Vec)
Feature.lda = _unary(OpLDA)
Feature.jaccard_similarity = _binary(JaccardSimilarity)
Feature.ngram_similarity = _binary(NGramSimilarity)


def _tf_idf(self: Feature, num_terms: int = 512) -> Feature:
    """tokenized text → hashed TF → IDF (RichTextFeature.tfidf)."""
    return self.transform_with(OpHashingTF(num_features=num_terms)).transform_with(
        OpIDF()
    )


Feature.tf_idf = _tf_idf

# ------------------------------------------------------------------- date dsl
Feature.to_unit_circle = _unary(DateToUnitCircleTransformer)
Feature.to_time_period = _unary(TimePeriodTransformer)
Feature.to_time_period_list = _unary(TimePeriodListTransformer)
Feature.to_time_period_map = _unary(TimePeriodMapTransformer)

# ---------------------------------------------------------------- generic dsl
Feature.alias = _unary(_simple.AliasTransformer)
Feature.filter_values = _unary(_simple.FilterTransformer)
Feature.replace_values = _unary(_simple.ReplaceTransformer)
Feature.substring_of = _binary(_simple.SubstringTransformer)
Feature.occurs = _unary(_simple.ToOccurTransformer)
Feature.exists = _unary(_simple.ExistsTransformer)
Feature.filter_map = _unary(_simple.FilterMap)


# -------------------------------------------------------------------- map dsl
# RichMapFeature.scala: one type-directed ``vectorize`` for every feature
# type, with the knobs of TransmogrifierDefaults and key filtering

#: vectorize() knobs that live on TransmogrifierDefaults, not on the stage
_DEFAULTS_KNOBS = {
    "top_k": "TopK",
    "min_support": "MinSupport",
    "clean_text": "CleanText",
    "clean_keys": "CleanKeys",
    "track_nulls": "TrackNulls",
    "num_hashes": "DefaultNumOfFeatures",
    "max_cardinality": "MaxCategoricalCardinality",
    "coverage_pct": "CoveragePct",
    "fill_with_mean": "FillWithMean",
    "fill_with_mode": "FillWithMode",
    "fill_value": "FillValue",
    "binary_freq": "BinaryFreq",
    "reference_date_ms": "ReferenceDateMs",
}
#: the stage params a defaults knob may appear as
_KNOB_ALIASES = {
    "fill_with_mean": ("fill", "fill_with_mean"),
    "fill_with_mode": ("fill", "fill_with_mode"),
    "num_hashes": ("num_hashes", "num_terms", "num_features"),
    "binary_freq": ("binary_freq", "binary"),
}


def _vectorize_feature(self: Feature, **kwargs: Any) -> Feature:
    """Type-directed vectorization of one feature with explicit knobs,
    ``realMap.vectorize(top_k=5, allow_keys=["a"])`` (RichMapFeature.vectorize
    and the scalar Rich*Feature.vectorize overloads). Knobs of
    TransmogrifierDefaults override the defaults; other keywords go to the
    type's vectorizer; a knob the chosen vectorizer does not read raises
    ``TypeError``."""
    from .ops.defaults import DEFAULTS
    from .ops.transmogrify import _vectorizer_for

    allow = kwargs.pop("allow_keys", None)
    block = kwargs.pop("block_keys", None)
    d = DEFAULTS
    defaults_knobs = {
        k: kwargs.pop(k) for k in list(kwargs) if k in _DEFAULTS_KNOBS
    }
    if defaults_knobs:
        d = dataclasses.replace(
            d, **{_DEFAULTS_KNOBS[k]: v for k, v in defaults_knobs.items()}
        )
    src = self
    if allow or block:
        # RichMapFeature.filter(allowList, blockList) folded in
        src = src.transform_with(
            _simple.FilterMap(allow_keys=allow or (), block_keys=block or ())
        )
    stage = _vectorizer_for(src.ftype, d)
    params = stage.get_params()
    for k in defaults_knobs:
        if not any(a in params for a in _KNOB_ALIASES.get(k, (k,))):
            raise TypeError(
                f"{type(stage).__name__} (for {src.ftype.__name__}) does "
                f"not take vectorize knob {k!r}"
            )
    if kwargs:  # the stage's own params beyond the shared defaults
        stage = type(stage)(**{**params, **kwargs})
    return src.transform_with(stage)


Feature.vectorize = _vectorize_feature
#: smartVectorize: the dispatch already routes the text types to Smart*
Feature.smart_vectorize = _vectorize_feature


def _map_keys_filtered(
    self: Feature,
    allow_keys: Sequence[str] = (),
    block_keys: Sequence[str] = (),
) -> Feature:
    """RichMapFeature.filter(allowList, blockList)."""
    return self.transform_with(
        _simple.FilterMap(allow_keys=allow_keys, block_keys=block_keys)
    )


Feature.filter_keys = _map_keys_filtered
Feature.is_valid_phone_map = _unary(_phone.IsValidPhoneMapDefaultCountry)
Feature.parse_phone = _unary(_phone.ParsePhoneDefaultCountry)
Feature.is_valid_phone = _unary(_phone.IsValidPhoneDefaultCountry)


def _prediction_field(key: str):
    """Prediction accessors (RichMapFeature.scala:1118-1152):
    ``prediction_value()`` -> RealNN, ``probability_vector()`` /
    ``raw_prediction_vector()`` -> OPVector."""
    def method(self: Feature) -> Feature:
        from .ops.prediction import PredictionFieldExtractor

        return self.transform_with(PredictionFieldExtractor(field=key))

    return method


Feature.prediction_value = _prediction_field("prediction")
Feature.probability_vector = _prediction_field("probability")
Feature.raw_prediction_vector = _prediction_field("rawPrediction")


def _tupled(self: Feature) -> tuple[Feature, Feature, Feature]:
    """pred.tupled() -> (prediction RealNN, rawPrediction OPVector,
    probability OPVector), RichMapFeature.scala:1118."""
    return (
        self.prediction_value(),
        self.raw_prediction_vector(),
        self.probability_vector(),
    )


Feature.tupled = _tupled


def _vectorize_collection(features: Sequence[Feature], **kwargs: Any) -> Feature:
    """RichFeaturesCollection.transmogrify on a plain list."""
    from .ops.transmogrify import transmogrify

    return transmogrify(list(features), **kwargs)


def _sanity_check(
    self: Feature, feature_vector: Feature, **kwargs: Any
) -> Feature:
    """label.sanity_check(vector): a SanityChecker of ``kwargs`` (its
    ``device`` among them) over (label, vector)."""
    from .prep.sanity_checker import SanityChecker

    return self.transform_with(SanityChecker(**kwargs), feature_vector)


Feature.sanity_check = _sanity_check

transmogrify_features = _vectorize_collection
