"""dsl — the feature vocabulary the flagship flow uses, attached to
``Feature`` on import (RichNumericFeature.sanityCheck,
RichFeaturesCollection.transmogrify):

    vec = transmogrify(predictors)            # or transmogrify_features
    checked = label.sanity_check(vec, remove_bad_features=True)

The rest of the reference's dsl (``transmogrifai_tpu/dsl.py``) waits for
the stages it installs (``ROADMAP.md`` A2, A11).
"""
from __future__ import annotations

from typing import Any, Sequence

from .features.feature import Feature


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
