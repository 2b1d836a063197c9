"""SanityChecker — automated feature validation and leakage detection
(SanityChecker.scala:58-581, DerivedFeatureFilterUtils.scala; the reference
is ``transmogrifai_tpu/prep/sanity_checker.py``). An estimator of
(label RealNN, features OPVector) whose model removes the bad columns.

Checks (thresholds as SanityChecker.scala:561-581):
  * variance < MinVariance (1e-5)                        -> drop column
  * |corr(feature, label)| > MaxCorrelation (0.95)        -> drop (leakage)
  * corr(feature, feature') > MaxFeatureCorr (0.99)       -> drop the later
  * Cramér's V (categorical group vs label) > MaxCramersV (0.95)
                                                          -> drop the group
  * association-rule max confidence > MaxRuleConfidence with support >=
    MinRequiredRuleSupport (both 1.0 = off by default)    -> drop the group
RemoveFeatureGroup (default true): a label-leakage drop removes every
column of the same parent feature (null indicator included).

The statistics run on the card (``utils/stats.py``): the vector goes up
once, as float32 (its own dtype), and the column stats, the correlation
matrix of [X | y], the feature-feature screen and every group's
contingency table are computed there (the tables in one product per
dtype); only d-long vectors, the flagged pairs and the [K, C] tables come
back. The row sample, when the checker
samples, is numpy's generator, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..stages.base import Estimator
from ..stages.metadata import VectorMetadata
from ..types import OPVector, RealNN
from ..types.columns import NumericColumn, VectorColumn
from ..utils import stats as S
from ..utils.device import resolve_device
from .derived_filter import FeatureRemovalModel

# SanityChecker.scala:561-581 defaults
CHECK_SAMPLE = 1.0
SAMPLE_LOWER_LIMIT = 1_000
SAMPLE_UPPER_LIMIT = 1_000_000
PROTECT_TEXT_SHARED_HASH = False  # SanityChecker.ProtectTextSharedHash
#: parent types whose shared-hash columns protect_text_shared_hash shields
#: (DerivedFeatureFilterUtils.isTextSharedHash)
_TEXT_HASH_PARENT_TYPES = frozenset(
    {"Text", "TextArea", "TextMap", "TextAreaMap"}
)
MAX_CORRELATION = 0.95
MAX_FEATURE_CORR = 0.99
MIN_CORRELATION = 0.0
MIN_VARIANCE = 1e-5
MAX_CRAMERS_V = 0.95
MAX_RULE_CONFIDENCE = 1.0
MIN_REQUIRED_RULE_SUPPORT = 1.0


@dataclasses.dataclass
class ColumnReport:
    name: str
    parent: str | None
    mean: float
    variance: float
    corr_label: float
    cramers_v: float | None
    dropped: bool
    reasons: list[str]


def _is_text_shared_hash(c) -> bool:
    return (
        c.parent_type in _TEXT_HASH_PARENT_TYPES
        and c.grouping is None
        and c.indicator_value is None
    )


class SanityChecker(Estimator):
    """Estimator[(RealNN label, OPVector features)] -> OPVector. ``device``
    is where the statistics run: ``None`` means ``cuda`` (which must be
    present), ``"cpu"`` the plain PyTorch route."""

    input_types = (RealNN, OPVector)
    output_type = OPVector

    def __init__(
        self,
        max_correlation: float = MAX_CORRELATION,
        max_feature_corr: float = MAX_FEATURE_CORR,
        min_correlation: float = MIN_CORRELATION,
        min_variance: float = MIN_VARIANCE,
        max_cramers_v: float = MAX_CRAMERS_V,
        max_rule_confidence: float = MAX_RULE_CONFIDENCE,
        min_required_rule_support: float = MIN_REQUIRED_RULE_SUPPORT,
        remove_bad_features: bool = False,
        remove_feature_group: bool = True,
        protect_text_shared_hash: bool = PROTECT_TEXT_SHARED_HASH,
        correlation_type: str = "pearson",
        correlation_exclusion: str = "NoExclusion",  # or "HashedText"
        check_sample: float = CHECK_SAMPLE,
        sample_lower_limit: int = SAMPLE_LOWER_LIMIT,
        sample_upper_limit: int = SAMPLE_UPPER_LIMIT,
        sample_seed: int = 42,
        device=None,
        uid: str | None = None,
    ):
        super().__init__("sanityCheck", uid=uid)
        self.max_correlation = max_correlation
        self.max_feature_corr = max_feature_corr
        self.min_correlation = min_correlation
        self.min_variance = min_variance
        self.max_cramers_v = max_cramers_v
        self.max_rule_confidence = max_rule_confidence
        self.min_required_rule_support = min_required_rule_support
        self.remove_bad_features = remove_bad_features
        self.remove_feature_group = remove_feature_group
        self.protect_text_shared_hash = protect_text_shared_hash
        self.correlation_type = correlation_type
        self.correlation_exclusion = correlation_exclusion
        self.check_sample = check_sample
        self.sample_lower_limit = sample_lower_limit
        self.sample_upper_limit = sample_upper_limit
        self.sample_seed = sample_seed
        self.device = device

    def _sample_fraction(self, total: int) -> float:
        """SanityChecker.fraction (SanityChecker.scala:356-361): clamp the
        requested check_sample fraction so the checked row count lands in
        [sample_lower_limit, sample_upper_limit]."""
        min_fraction = min(1.0, self.sample_lower_limit / max(total, 1))
        max_fraction = max(0.0, self.sample_upper_limit / max(total, 1))
        return max(min(self.check_sample, max_fraction), min_fraction)

    # ------------------------------------------------------------------ fit
    def fit_model(self, dataset) -> FeatureRemovalModel:
        dev = resolve_device(self.device)
        label_name, vector_name = self.input_names
        label_col = dataset[label_name]
        vec_col = dataset[vector_name]
        if not (
            isinstance(label_col, NumericColumn)
            and isinstance(vec_col, VectorColumn)
        ):
            raise TypeError("SanityChecker takes (numeric label, vector)")

        # the vector is float32 (a sparse plane densified on the host): it
        # goes up as it is, and the float64 and float32 routes convert it
        # on the card without rounding
        xt = torch.from_numpy(
            np.ascontiguousarray(np.asarray(vec_col.values))
        ).to(dev)
        y = label_col.values.astype(np.float64)
        n_total = xt.shape[0]
        frac = self._sample_fraction(n_total)
        if frac < 1.0:
            # stats on a seeded row sample (SanityChecker.scala:356-361,
            # 562-564): the checker's cost is bounded by sample_upper_limit
            rng = np.random.default_rng(self.sample_seed)
            take = rng.choice(
                n_total, size=max(1, round(frac * n_total)), replace=False
            )
            take.sort()
            xt = xt[torch.from_numpy(take).to(dev)]
            y = y[take]
        n, d = xt.shape
        meta = vec_col.metadata or VectorMetadata(vector_name, ())
        names = (
            meta.column_names() if meta.size == d else [f"col_{j}" for j in range(d)]
        )

        col_stats = S.column_stats_tensor(xt.to(S.route_dtype(n * d)))
        yt = torch.from_numpy(y).to(dev)
        if self.correlation_type == "spearman":
            m = torch.cat([xt.double(), yt[:, None]], dim=1)
            ranks = S.rank_columns(m)
            corr = S.correlation_tensor(ranks.to(S.route_dtype(ranks.numel())))
        else:
            dtype = S.route_dtype(n * (d + 1))
            corr = S.correlation_tensor(
                torch.cat([xt.to(dtype), yt.to(dtype)[:, None]], dim=1)
            )
        corr_label = corr[:d, d].cpu().numpy().copy()
        corr_features = corr[:d, :d]

        # CorrelationExclusion.HashedText (SanityChecker.scala:428):
        # text-shared-hash columns sit out the correlation checks entirely
        if self.correlation_exclusion == "HashedText" and meta.size == d:
            excluded = np.array(
                [_is_text_shared_hash(c) for c in meta.columns], dtype=bool
            )
            corr_label[excluded] = np.nan
            ex = torch.from_numpy(excluded).to(dev)
            corr_features[ex, :] = 0.0
            corr_features[:, ex] = 0.0

        # label one-hot for categorical stats. A continuous label (many
        # distinct values for its row count) gets no Cramér's V or
        # association-rule treatment (SanityChecker.scala categoricalLabel)
        classes = np.unique(y)
        label_is_categorical = len(classes) <= min(
            100, max(2, int(0.1 * len(y)))
        )
        onehot = yt[:, None] == torch.from_numpy(classes).to(dev)[None, :]

        drop_reasons: dict[int, list[str]] = {}

        def drop(j: int, reason: str) -> None:
            drop_reasons.setdefault(j, []).append(reason)

        # 1. low variance
        for j in np.nonzero(col_stats.variance < self.min_variance)[0]:
            drop(int(j), f"variance<{self.min_variance}")

        # 2. label-correlation leakage (+ too-low correlation if configured)
        for j in range(d):
            c = abs(corr_label[j])
            if c > self.max_correlation:
                drop(j, f"|corrLabel|={c:.4f}>{self.max_correlation}")
            elif c < self.min_correlation:
                drop(j, f"|corrLabel|={c:.4f}<{self.min_correlation}")

        # 3. feature-feature correlation: drop the later column of each
        # pair (pairs in row-major order, as np.argwhere gives them)
        hi = torch.nonzero(
            torch.triu(corr_features.abs(), diagonal=1) > self.max_feature_corr
        ).cpu().numpy()
        for _, j in hi:
            drop(int(j), f"featureCorr>{self.max_feature_corr}")

        # 4. categorical groups: Cramér's V + association rules
        group_v: dict[tuple, float] = {}
        group_cols: dict[tuple, list[int]] = {}
        if meta.size == d and label_is_categorical:
            keyed = []
            for key, idxs in meta.index_of_group().items():
                cats = [
                    i for i in idxs if meta.columns[i].indicator_value is not None
                ]
                if cats:
                    keyed.append((key, cats))
            tables = S.contingency_tables(xt, [c for _, c in keyed], onehot)
            for (key, cats), contingency in zip(keyed, tables):
                v = S.cramers_v(contingency)
                group_v[key] = v
                group_cols[key] = cats
                if v > self.max_cramers_v:
                    for i in cats:
                        drop(i, f"cramersV={v:.4f}>{self.max_cramers_v}")
                conf, support = S.association_rule_confidence(contingency)
                if self.max_rule_confidence < 1.0:
                    for ci, i in enumerate(cats):
                        if (
                            conf[ci] > self.max_rule_confidence
                            and support[ci] >= self.min_required_rule_support
                        ):
                            drop(i, f"ruleConfidence={conf[ci]:.4f}")

        # 5. group-wise removal at PARENT-FEATURE granularity
        # (DerivedFeatureFilterUtils.reasonsToRemove parentExclusionReasons)
        if self.remove_feature_group and meta.size == d:
            self._parent_removal(meta, d, corr_label, group_v, group_cols, drop,
                                 drop_reasons)

        indices_to_keep = [j for j in range(d) if j not in drop_reasons]

        # ------------------------- summary ledger -------------------------
        reports = [
            ColumnReport(
                name=names[j],
                parent=(
                    meta.columns[j].parent_names[0]
                    if meta.size == d and meta.columns[j].parent_names
                    else None
                ),
                mean=float(col_stats.mean[j]),
                variance=float(col_stats.variance[j]),
                corr_label=float(corr_label[j]),
                cramers_v=(
                    group_v.get(meta.columns[j].grouped_key())
                    if meta.size == d
                    else None
                ),
                dropped=j in drop_reasons,
                reasons=drop_reasons.get(j, []),
            )
            for j in range(d)
        ]
        self.metadata["sanityCheckerSummary"] = {
            "numRows": n,
            "numColumns": d,
            "numDropped": len(drop_reasons),
            "columns": [dataclasses.asdict(r) for r in reports],
            "correlationType": self.correlation_type,
        }
        new_meta = meta.select(indices_to_keep) if meta.size == d else None
        return FeatureRemovalModel(
            indices_to_keep=indices_to_keep,
            remove_bad_features=self.remove_bad_features,
            new_metadata=new_meta,
            operation_name="sanityCheck",
        )

    def _parent_removal(self, meta, d, corr_label, group_v, group_cols, drop,
                        drop_reasons) -> None:
        """A leaky categorical group takes down every column of the same
        parent feature, its hashed-text block and null indicator included,
        unless the column is a text shared hash and protection is on."""

        def parent_key(c):
            base = "_".join(c.parent_names)
            if c.grouping and c.grouping != base:
                return f"{base}_{c.grouping}"  # parentNamesWithMapKeys
            return base

        def no_keys(c):
            return "_".join(c.parent_names)

        # max |corrLabel| and max Cramér's V per parent (NaN-filtered,
        # makeColumnStatistics.maxByParent)
        parent_corr: dict[str, float] = {}
        parent_corr_nk: dict[str, float] = {}
        for j in range(d):
            c = abs(corr_label[j])
            if np.isnan(c):
                continue
            for table, key in (
                (parent_corr, parent_key(meta.columns[j])),
                (parent_corr_nk, no_keys(meta.columns[j])),
            ):
                table[key] = max(table.get(key, 0.0), float(c))
        parent_v: dict[str, float] = {}
        parent_v_nk: dict[str, float] = {}
        for key, v in group_v.items():
            if np.isnan(v):
                continue
            for i in group_cols[key]:
                for table, pk in (
                    (parent_v, parent_key(meta.columns[i])),
                    (parent_v_nk, no_keys(meta.columns[i])),
                ):
                    table[pk] = max(table.get(pk, 0.0), float(v))

        for j in range(d):
            c = meta.columns[j]
            if self.protect_text_shared_hash and _is_text_shared_hash(c):
                continue
            pk, nk = parent_key(c), no_keys(c)
            pv = parent_v.get(pk, parent_v_nk.get(nk))
            if pv is not None and pv > self.max_cramers_v:
                drop(j, f"parentCramersV={pv:.4f}>{self.max_cramers_v}")
            pc = parent_corr.get(pk, parent_corr_nk.get(nk))
            if pc is not None and pc > self.max_correlation:
                drop(j, f"parentCorr={pc:.4f}>{self.max_correlation}")

        # rule-confidence drops still take their indicator group
        # (removedGroups in getFeaturesToDrop)
        groups = meta.index_of_group()
        for j in list(drop_reasons):
            if not any(r.startswith("ruleConfidence") for r in drop_reasons[j]):
                continue
            key = meta.columns[j].grouped_key()
            if key[1] is None:
                continue
            for i in groups.get(key, []):
                if i not in drop_reasons:
                    drop(i, "featureGroupRemoval")
