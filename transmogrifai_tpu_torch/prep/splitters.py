"""Data splitters: train/holdout reserve, binary balancing, multiclass label
cutting.

Reference: core/.../stages/impl/tuning/{Splitter,DataSplitter,DataBalancer,
DataCutter}.scala. Defaults (Splitter.scala:176-178): reserveTestFraction 0.1,
maxTrainingSample 1e6; DataBalancer sampleFraction 0.1 (target minority
fraction); DataCutter maxLabelCategories 100, minLabelFraction 0.0.

Splitters produce row-index arrays and masks, never copies: folds and
resamples are masks over one training matrix, the lanes of one batched
fit. The draws are numpy's ``default_rng(seed)``, the JAX package's own,
so indices and masks equal its index for index.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

RESERVE_TEST_FRACTION = 0.1
MAX_TRAINING_SAMPLE = 1_000_000
BALANCER_SAMPLE_FRACTION = 0.1
CUTTER_MAX_LABEL_CATEGORIES = 100
CUTTER_MIN_LABEL_FRACTION = 0.0


@dataclasses.dataclass
class SplitterSummary:
    splitter: str
    details: dict[str, Any]

    def to_json(self) -> dict[str, Any]:
        return {"splitter": self.splitter, **self.details}


class DataSplitter:
    """Train/holdout reserve + down-sampling cap (DataSplitter.scala:65-128)."""

    def __init__(
        self,
        reserve_test_fraction: float = RESERVE_TEST_FRACTION,
        max_training_sample: int = MAX_TRAINING_SAMPLE,
        seed: int = 42,
    ):
        self.reserve_test_fraction = reserve_test_fraction
        self.max_training_sample = max_training_sample
        self.seed = seed
        self.summary: SplitterSummary | None = None

    def split(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """(train indices, holdout indices)."""
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(n)
        n_test = int(round(n * self.reserve_test_fraction))
        return np.sort(perm[n_test:]), np.sort(perm[:n_test])

    def prepare(self, y: np.ndarray) -> np.ndarray:
        """validationPrepare: row mask over the training set (down-sampling
        to max_training_sample)."""
        n = len(y)
        mask = np.ones(n, dtype=bool)
        if n > self.max_training_sample:
            rng = np.random.default_rng(self.seed)
            keep = rng.choice(n, self.max_training_sample, replace=False)
            mask = np.zeros(n, dtype=bool)
            mask[keep] = True
        self.summary = SplitterSummary(
            "DataSplitter",
            {"downSampleFraction": float(mask.mean()), "totalRows": n},
        )
        return mask

    def get_params(self) -> dict[str, Any]:
        return {
            "reserve_test_fraction": self.reserve_test_fraction,
            "max_training_sample": self.max_training_sample,
            "seed": self.seed,
        }


class DataBalancer(DataSplitter):
    """Binary balancing (DataBalancer.scala:73-340): if the positive fraction
    is below sample_fraction, down-sample negatives (and/or up-sample
    positives) toward the target minority fraction."""

    def __init__(
        self,
        sample_fraction: float = BALANCER_SAMPLE_FRACTION,
        max_training_sample: int = MAX_TRAINING_SAMPLE,
        reserve_test_fraction: float = RESERVE_TEST_FRACTION,
        seed: int = 42,
    ):
        super().__init__(reserve_test_fraction, max_training_sample, seed)
        self.sample_fraction = sample_fraction

    def prepare(self, y: np.ndarray) -> np.ndarray:
        n = len(y)
        pos = y == 1.0
        n_pos, n_neg = int(pos.sum()), int((~pos).sum())
        mask = np.ones(n, dtype=bool)
        if n_pos == 0 or n_neg == 0:
            self.summary = SplitterSummary(
                "DataBalancer",
                {"positiveFraction": n_pos / max(n, 1), "balanced": False},
            )
            return mask
        minority, majority = min(n_pos, n_neg), max(n_pos, n_neg)
        minority_is_pos = n_pos <= n_neg
        frac = minority / n
        if frac < self.sample_fraction:
            # down-sample majority so minority fraction reaches the target
            target_majority = int(minority / self.sample_fraction) - minority
            rng = np.random.default_rng(self.seed)
            maj_idx = np.nonzero(pos != minority_is_pos)[0]
            keep = rng.choice(maj_idx, min(target_majority, len(maj_idx)), replace=False)
            mask = np.zeros(n, dtype=bool)
            mask[pos == minority_is_pos] = True
            mask[keep] = True
        self.summary = SplitterSummary(
            "DataBalancer",
            {
                "positiveCount": n_pos,
                "negativeCount": n_neg,
                "desiredFraction": self.sample_fraction,
                "keptFraction": float(mask.mean()),
            },
        )
        return mask

    def get_params(self) -> dict[str, Any]:
        return {**super().get_params(), "sample_fraction": self.sample_fraction}


class DataCutter(DataSplitter):
    """Multiclass label cutting (DataCutter.scala:78-260): keep at most
    max_label_categories top labels with at least min_label_fraction mass;
    rows with dropped labels are excluded."""

    def __init__(
        self,
        max_label_categories: int = CUTTER_MAX_LABEL_CATEGORIES,
        min_label_fraction: float = CUTTER_MIN_LABEL_FRACTION,
        reserve_test_fraction: float = RESERVE_TEST_FRACTION,
        max_training_sample: int = MAX_TRAINING_SAMPLE,
        seed: int = 42,
    ):
        super().__init__(reserve_test_fraction, max_training_sample, seed)
        self.max_label_categories = max_label_categories
        self.min_label_fraction = min_label_fraction
        self.labels_kept: list[float] | None = None

    def prepare(self, y: np.ndarray) -> np.ndarray:
        n = len(y)
        vals, counts = np.unique(y, return_counts=True)
        order = np.argsort(-counts, kind="stable")
        kept = [
            float(vals[i])
            for i in order[: self.max_label_categories]
            if counts[i] / n >= self.min_label_fraction
        ]
        self.labels_kept = kept
        mask = np.isin(y, kept)
        self.summary = SplitterSummary(
            "DataCutter",
            {
                "labelsKept": len(kept),
                "labelsDropped": len(vals) - len(kept),
                "keptFraction": float(mask.mean()),
            },
        )
        return mask

    def get_params(self) -> dict[str, Any]:
        return {
            **super().get_params(),
            "max_label_categories": self.max_label_categories,
            "min_label_fraction": self.min_label_fraction,
        }
