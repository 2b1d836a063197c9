"""RawFeatureFilter: the raw features' quality and drift gate before
training.

Reference: core/.../filters/RawFeatureFilter.scala:90-616,
FeatureDistribution.scala:58-260, Summary.scala:43,
RawFeatureFilterResults.scala:50-136.

For each raw feature, on the training data (and the scoring data where
given): a summary and a binned ``FeatureDistribution``: an equal-width
histogram of 100 bins for a numeric feature (the scoring side clipped to
the training range), 255 hashed token bins for the others; nulls counted
apart. A feature is blocklisted when (defaults of RawFeatureFilter.scala)
  - its fill rate < ``min_fill`` (0.001);
  - |train fill - score fill| > ``max_fill_difference`` (0.9);
  - the relative fill ratio > ``max_fill_ratio_diff`` (20.0);
  - the train / score Jensen-Shannon divergence > ``max_js_divergence``
    (0.9);
  - its null indicator's correlation with the label, on labeled rows,
    > ``max_null_label_corr`` (0.95);
unless it is the response or in ``protected_features``. The results
(config, per-feature metrics, exclusion reasons) go on the model; the
workflow rewrites the DAG without the blocklisted features
(OpWorkflow.setBlocklist :118-167).

Host numpy and Python, as ``transmogrifai_tpu/prep/raw_feature_filter.py``.
A text histogram hashes each DISTINCT cleaned token once, in one native
batch (``native.murmur3_batch``), and adds its count (the reference hashes
every occurrence in Python): the bins hold the same integers, so the
results are equal.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any

import numpy as np

from ..dataset import Dataset
from ..features.feature import Feature
from ..native import murmur3_batch
from ..types.columns import (
    Column,
    ListColumn,
    MapColumn,
    NumericColumn,
    SetColumn,
    TextColumn,
)
from ..utils.text import clean_string

MIN_FILL = 0.001
MAX_FILL_DIFFERENCE = 0.90
MAX_FILL_RATIO_DIFF = 20.0
MAX_JS_DIVERGENCE = 0.90
MAX_NULL_LABEL_CORR = 0.95
DEFAULT_BINS = 100
TEXT_BINS = 255


@dataclasses.dataclass
class FeatureDistribution:
    """Binned distribution + fill statistics (FeatureDistribution.scala:58)."""

    name: str
    count: int          # total rows
    nulls: int
    distribution: np.ndarray  # [bins] counts
    summary: dict[str, float]

    @property
    def fill_rate(self) -> float:
        """FeatureDistribution.fillRate (:94)."""
        return 0.0 if self.count == 0 else 1.0 - self.nulls / self.count

    def relative_fill_ratio(self, other: "FeatureDistribution") -> float:
        """:125 — max(fill)/min(fill), inf when one side is empty."""
        a, b = self.fill_rate, other.fill_rate
        lo, hi = min(a, b), max(a, b)
        if lo == 0.0:
            return float("inf") if hi > 0 else 1.0
        return hi / lo

    def js_divergence(self, other: "FeatureDistribution") -> float:
        """:149 — JS divergence of the normalized bin histograms."""
        p = self.distribution.astype(np.float64)
        q = other.distribution.astype(np.float64)
        if p.sum() == 0 or q.sum() == 0:
            return 0.0
        p = p / p.sum()
        q = q / q.sum()
        m = 0.5 * (p + q)

        def kl(a, b):
            mask = a > 0
            return float(np.sum(a[mask] * np.log2(a[mask] / b[mask])))

        return 0.5 * kl(p, m) + 0.5 * kl(q, m)


def _null_mask(col: Column) -> np.ndarray:
    if isinstance(col, NumericColumn):
        return ~col.mask
    if isinstance(col, TextColumn):
        return np.array([v is None for v in col.values], dtype=bool)
    if isinstance(col, (SetColumn, ListColumn, MapColumn)):
        return np.array([not v for v in col.values], dtype=bool)
    return np.zeros(len(col), dtype=bool)


def compute_distribution(
    name: str,
    col: Column,
    bins: int = DEFAULT_BINS,
    text_bins: int = TEXT_BINS,
    numeric_range: tuple[float, float] | None = None,
) -> FeatureDistribution:
    n = len(col)
    nulls = int(_null_mask(col).sum())
    if isinstance(col, NumericColumn):
        vals = col.values[col.mask].astype(np.float64)
        if numeric_range is None:
            lo, hi = (float(vals.min()), float(vals.max())) if len(vals) else (0.0, 1.0)
        else:
            lo, hi = numeric_range
        if hi <= lo:
            hi = lo + 1.0
        # clip into the reference range so out-of-range score-time values
        # land in the edge bins (drift must show up, not vanish)
        hist, _ = np.histogram(np.clip(vals, lo, hi), bins=bins, range=(lo, hi))
        summary = {
            "min": float(vals.min()) if len(vals) else 0.0,
            "max": float(vals.max()) if len(vals) else 0.0,
            "sum": float(vals.sum()),
            "count": float(len(vals)),
        }
        return FeatureDistribution(name, n, nulls, hist.astype(np.float64), summary)
    # text-format hashing (textBinsFormula, RawFeatureFilter.scala:588)
    hist = np.zeros(text_bins, dtype=np.float64)
    counts = Counter(_iter_raw_tokens(col))
    cleaned: Counter = Counter()
    for raw, c in counts.items():
        cleaned[clean_string(raw)] += c
    if cleaned:
        bins_of = murmur3_batch(list(cleaned), 42) % np.uint32(text_bins)
        np.add.at(hist, bins_of.astype(np.int64),
                  np.fromiter(cleaned.values(), np.float64, len(cleaned)))
    total_tokens = sum(cleaned.values())
    summary = {"count": float(n - nulls), "tokens": float(total_tokens)}
    return FeatureDistribution(name, n, nulls, hist, summary)


def _iter_raw_tokens(col: Column):
    """Each token before cleaning: a text value, a set or list member, a
    map entry as ``key:value``."""
    if isinstance(col, TextColumn):
        for v in col.values:
            if v is not None:
                yield v
    elif isinstance(col, (SetColumn, ListColumn)):
        for members in col.values:
            for m in members:
                yield str(m)
    elif isinstance(col, MapColumn):
        for d in col.values:
            for k, v in d.items():
                yield f"{k}:{v}"


@dataclasses.dataclass
class RawFeatureFilterResults:
    """Config + per-feature metrics + exclusion reasons
    (RawFeatureFilterResults.scala:50-136)."""

    config: dict[str, Any]
    feature_metrics: dict[str, dict[str, Any]]
    excluded: dict[str, list[str]]

    def to_json(self) -> dict[str, Any]:
        return {
            "rawFeatureFilterConfig": self.config,
            "rawFeatureDistributions": self.feature_metrics,
            "exclusionReasons": self.excluded,
        }


class RawFeatureFilter:
    def __init__(
        self,
        min_fill: float = MIN_FILL,
        max_fill_difference: float = MAX_FILL_DIFFERENCE,
        max_fill_ratio_diff: float = MAX_FILL_RATIO_DIFF,
        max_js_divergence: float = MAX_JS_DIVERGENCE,
        max_null_label_corr: float = MAX_NULL_LABEL_CORR,
        bins: int = DEFAULT_BINS,
        protected_features: tuple[str, ...] = (),
    ):
        self.min_fill = min_fill
        self.max_fill_difference = max_fill_difference
        self.max_fill_ratio_diff = max_fill_ratio_diff
        self.max_js_divergence = max_js_divergence
        self.max_null_label_corr = max_null_label_corr
        self.bins = bins
        self.protected_features = tuple(protected_features)
        self.results: RawFeatureFilterResults | None = None

    def compute_exclusions(
        self,
        train: Dataset,
        raw_features: list[Feature],
        score: Dataset | None = None,
        label_name: str | None = None,
    ) -> list[str]:
        """Names of raw features to blocklist (generateFilteredRaw :486)."""
        excluded: dict[str, list[str]] = {}
        metrics: dict[str, dict[str, Any]] = {}
        label = None
        label_valid = None
        if label_name is not None and label_name in train:
            lc = train[label_name]
            if isinstance(lc, NumericColumn):
                # unlabeled rows (mask False) hold an unspecified fill value —
                # restrict the null↔label correlation to labeled rows
                label = lc.values.astype(np.float64)
                label_valid = lc.mask

        for f in raw_features:
            if f.is_response or f.name in self.protected_features:
                continue
            if f.name not in train:
                continue
            col = train[f.name]
            dist = compute_distribution(f.name, col, bins=self.bins)
            reasons: list[str] = []
            if dist.fill_rate < self.min_fill:
                reasons.append(f"fillRate={dist.fill_rate:.5f}<{self.min_fill}")

            m: dict[str, Any] = {
                "fillRate": dist.fill_rate,
                "nulls": dist.nulls,
                "count": dist.count,
            }
            if score is not None and f.name in score:
                scol = score[f.name]
                rng = None
                if isinstance(col, NumericColumn):
                    rng = (dist.summary["min"], dist.summary["max"])
                sdist = compute_distribution(
                    f.name, scol, bins=self.bins, numeric_range=rng
                )
                fill_diff = abs(dist.fill_rate - sdist.fill_rate)
                fill_ratio = dist.relative_fill_ratio(sdist)
                js = dist.js_divergence(sdist)
                m.update(
                    {"scoreFillRate": sdist.fill_rate, "fillDifference": fill_diff,
                     "fillRatio": fill_ratio, "jsDivergence": js}
                )
                if fill_diff > self.max_fill_difference:
                    reasons.append(f"fillDifference={fill_diff:.3f}")
                if fill_ratio > self.max_fill_ratio_diff:
                    reasons.append(f"fillRatioDiff={fill_ratio:.2f}")
                if js > self.max_js_divergence:
                    reasons.append(f"jsDivergence={js:.3f}")

            if label is not None:
                nulls = _null_mask(col).astype(np.float64)[label_valid]
                lbl = label[label_valid]
                if len(lbl) > 1 and nulls.std() > 0 and lbl.std() > 0:
                    corr = float(np.corrcoef(nulls, lbl)[0, 1])
                    m["nullLabelCorrelation"] = corr
                    if abs(corr) > self.max_null_label_corr:
                        reasons.append(f"nullLabelCorr={corr:.3f}")

            metrics[f.name] = m
            if reasons:
                excluded[f.name] = reasons

        self.results = RawFeatureFilterResults(
            config={
                "minFill": self.min_fill,
                "maxFillDifference": self.max_fill_difference,
                "maxFillRatioDiff": self.max_fill_ratio_diff,
                "maxJSDivergence": self.max_js_divergence,
                "maxNullLabelCorr": self.max_null_label_corr,
                "bins": self.bins,
            },
            feature_metrics=metrics,
            excluded=excluded,
        )
        return list(excluded)
