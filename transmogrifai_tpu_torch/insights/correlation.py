"""RecordInsightsCorr — correlation-based per-record explanations, the port of the JAX
package's ``insights/correlation.py``.

Reference: core/.../stages/impl/insights/RecordInsightsCorr.scala:55-220.
Fit: Pearson (or Spearman) correlation of every feature column with every
prediction column, plus column stats for normalization. Transform: per
record, importance = corr[pred, feature] · normalized feature value; the
top-K |importance| columns per prediction are reported as a map.

The fit is two matmuls (XᵀY correlation + normalization stats); the
transform processes rows in fixed-size blocks with top-k selection via
argpartition, so memory stays at block×D per prediction column.
"""
from __future__ import annotations

import json

import numpy as np

from ..stages.base import Estimator, Model
from ..stages.metadata import VectorMetadata
from ..types import OPVector, TextMap
from ..types.columns import Column, MapColumn, PredictionColumn, VectorColumn

MIN_MAX = "minmax"
Z_SCORE = "zscore"
NONE = "none"


def _scores_matrix(col: Column) -> np.ndarray:
    """Prediction columns become [N, C] scores; plain vectors pass through."""
    if isinstance(col, PredictionColumn):
        if col.probability is not None:
            return np.asarray(col.probability, dtype=np.float64)
        return np.asarray(col.prediction, dtype=np.float64)[:, None]
    assert isinstance(col, VectorColumn)
    return np.asarray(col.values, dtype=np.float64)


class RecordInsightsCorr(Estimator):
    """BinaryEstimator[(Prediction|OPVector, OPVector)] → TextMap."""

    output_type = TextMap

    def __init__(
        self,
        top_k: int = 20,
        norm_type: str = MIN_MAX,
        correlation_type: str = "pearson",
        uid: str | None = None,
    ):
        super().__init__("recordInsightsCorr", uid=uid)
        self.top_k = top_k
        self.norm_type = norm_type
        self.correlation_type = correlation_type

    def get_params(self):
        return {
            "top_k": self.top_k,
            "norm_type": self.norm_type,
            "correlation_type": self.correlation_type,
        }

    def fit_model(self, dataset) -> "RecordInsightsCorrModel":
        pred_name, vec_name = self.input_names
        scores = _scores_matrix(dataset[pred_name])
        vec = dataset[vec_name]
        assert isinstance(vec, VectorColumn)
        x = np.asarray(vec.values, dtype=np.float64)

        if self.correlation_type == "spearman":
            from scipy.stats import rankdata  # pragma: no cover - optional

            x_c = rankdata(x, axis=0)
            s_c = rankdata(scores, axis=0)
        else:
            x_c, s_c = x, scores
        x_sd = x_c.std(0)
        s_sd = s_c.std(0)
        xs = (x_c - x_c.mean(0)) / np.where(x_sd == 0, 1.0, x_sd)
        ss = (s_c - s_c.mean(0)) / np.where(s_sd == 0, 1.0, s_sd)
        corr = ss.T @ xs / len(x)  # [C, D]
        corr = np.nan_to_num(corr)

        if self.norm_type == MIN_MAX:
            lo, hi = x.min(0), x.max(0)
            scale = np.where(hi > lo, hi - lo, 1.0)
            norm = ("minmax", lo, scale)
        elif self.norm_type == Z_SCORE:
            mu, sd = x.mean(0), np.where(x.std(0) == 0, 1.0, x.std(0))
            norm = ("zscore", mu, sd)
        else:
            norm = ("none", np.zeros(x.shape[1]), np.ones(x.shape[1]))
        self.metadata["numPredCols"] = int(corr.shape[0])
        return RecordInsightsCorrModel(
            corr, norm[0], norm[1], norm[2], self.top_k, vec.metadata
        )


class RecordInsightsCorrModel(Model):
    output_type = TextMap

    def __init__(self, corr, norm_kind, shift, scale, top_k, meta=None, uid=None):
        super().__init__("recordInsightsCorr", uid=uid)
        self.corr = np.asarray(corr, dtype=np.float64)
        self.norm_kind = norm_kind
        self.shift = np.asarray(shift, dtype=np.float64)
        self.scale = np.asarray(scale, dtype=np.float64)
        self.top_k = top_k
        self._meta: VectorMetadata | None = meta

    def get_params(self):
        return {"top_k": self.top_k, "norm_kind": self.norm_kind}

    def get_arrays(self):
        return {"corr": self.corr, "shift": self.shift, "scale": self.scale}

    @classmethod
    def from_params(cls, params, arrays):
        return cls(
            arrays["corr"], params["norm_kind"], arrays["shift"],
            arrays["scale"], params["top_k"],
        )

    def _names(self, dim: int) -> list[str]:
        if self._meta is not None and self._meta.size == dim:
            return self._meta.column_names()
        return [f"col_{j}" for j in range(dim)]

    #: rows per block — bounds peak memory at BLOCK×D per prediction column
    #: instead of N×C×D for the whole score set
    _BLOCK = 1 << 16

    def transform_columns(self, *cols: Column, num_rows: int) -> MapColumn:
        vec = cols[-1]
        assert isinstance(vec, VectorColumn)
        x = np.asarray(vec.values, dtype=np.float64)
        if self._meta is None:
            self._meta = vec.metadata
        names = self._names(x.shape[1])
        d = x.shape[1]
        k = min(self.top_k, d)
        out: list[dict[str, str]] = []
        for start in range(0, num_rows, self._BLOCK):
            xb = x[start:start + self._BLOCK]
            nb = len(xb)
            normalized = (xb - self.shift[None, :]) / self.scale[None, :]
            # per feature: the list of [prediction-index, importance] pairs
            # over ALL prediction columns it ranks top-k for (the reference
            # emits one pair per prediction index, RecordInsightsCorr.scala)
            acc: list[dict[str, list]] = [{} for _ in range(nb)]
            for ci in range(self.corr.shape[0]):
                imp = normalized * self.corr[ci][None, :]  # [nb, D]
                mag = np.abs(imp)
                if k < d:
                    idx = np.argpartition(-mag, k - 1, axis=1)[:, :k]
                else:
                    idx = np.broadcast_to(np.arange(d), (nb, d)).copy()
                # deterministic order inside the top-k: |importance| desc
                sub = np.take_along_axis(mag, idx, axis=1)
                idx = np.take_along_axis(idx, np.argsort(-sub, axis=1), axis=1)
                for r in range(nb):
                    row_imp = imp[r]
                    row_acc = acc[r]
                    for j in idx[r]:
                        row_acc.setdefault(names[int(j)], []).append(
                            [ci, float(row_imp[j])]
                        )
            out.extend(
                {name: json.dumps(pairs) for name, pairs in row.items()}
                for row in acc
            )
        return MapColumn(TextMap, out)
