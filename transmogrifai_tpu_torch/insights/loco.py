"""RecordInsightsLOCO — batched leave-one-covariate-out explanations, the
port of the JAX package's ``insights/loco.py``.

Reference: core/.../stages/impl/insights/RecordInsightsLOCO.scala:45-347.
For each derived vector column group (text-hash and date columns
aggregated per parent feature, strategy LeaveOutVector), zero it out,
re-score, and report the top-K score differences.

The whole sweep is one batched model call per lane chunk, as in the
reference: lane ``g`` is the feature plane with group ``g``'s column slice
zeroed, and the chunk scores as one ``[lanes x N, width]`` predict on the
model's device (a tree model's lanes go through kernel K1 and the tree
sums at that row count). Lane counts pad onto the shared buckets
(``compiler.bucketing.lane_bucket``); groups whose slice is all-zero over
the batch are deduped out before dispatch (their contribution is exactly
0.0); a sweep whose ``lanes x N x width`` exceeds
``TPTPU_EXPLAIN_LANE_BUDGET`` float32 elements (default 2^23) runs as a
loop of bucketed lane chunks. Every sweep records its lanes, dedups, pads
and rows/s on the attribution ledger (``insights/ledger.py``), and only
there: the compile plane's sweep ledger is ``ROADMAP.md`` A14's.
"""
from __future__ import annotations

import logging
import os

import numpy as np

from ..models.base import PredictorModel
from ..stages.base import Model
from ..stages.metadata import VectorMetadata
from ..types import OPVector, TextMap
from ..types.columns import Column, MapColumn, VectorColumn
from . import ledger as _ledger

log = logging.getLogger(__name__)

ABS = "abs"
POSITIVE_NEGATIVE = "positive_negative"

#: max float32 elements a single perturbation dispatch may materialize
#: (lanes × rows × width); larger sweeps loop over bucketed lane chunks
_DEFAULT_LANE_BUDGET = 1 << 23


def _lane_budget() -> int:
    try:
        return max(
            1, int(os.environ.get(
                "TPTPU_EXPLAIN_LANE_BUDGET", str(_DEFAULT_LANE_BUDGET)
            ))
        )
    except ValueError:
        return _DEFAULT_LANE_BUDGET


def _column_groups(
    meta: VectorMetadata | None, dim: int, count_fallback: bool = True
) -> list[tuple[str, list[int]]]:
    """Group hashed-text/date columns by parent feature; pivot/numeric
    columns stay individual (RecordInsightsLOCO text aggregation).

    When ``meta`` is absent or inconsistent with the vector width the
    grouping degrades to anonymous per-column groups — that degradation
    used to be silent; it now counts ``metaFallbacks`` on the attribution
    ledger (and the serving-plan auditor reports it as TPX007)."""
    if meta is None or meta.size != dim:
        if count_fallback:
            _ledger.stats().count_meta_fallback()
            log.warning(
                "LOCO column groups degraded to anonymous per-column "
                "groups: vector metadata %s (width %d) — attributions "
                "will name col_<j> instead of features (TPX007)",
                "absent" if meta is None
                else f"size {meta.size} != {dim}",
                dim,
            )
        return [(f"col_{j}", [j]) for j in range(dim)]
    groups: dict[str, list[int]] = {}
    order: list[str] = []
    for j, cm in enumerate(meta.columns):
        if cm.descriptor_value is not None and cm.descriptor_value.startswith("hash_"):
            key = f"{'_'.join(cm.parent_names)}(text)"
        elif cm.descriptor_value is not None:
            key = "_".join(cm.parent_names)  # date components aggregate
        else:
            key = cm.make_name()
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(j)
    return [(k, groups[k]) for k in order]


#: public alias (the serving closure and the train-time profiler group
#: the same way the transformer does)
column_groups = _column_groups


def _floor_lane_bucket(k: int) -> int:
    """Largest lane-bucket boundary <= ``k``, so ``lane_bucket`` of any
    chunk of this size — or a smaller padded tail — never exceeds it.
    Derived from ``compiler.bucketing.lane_bucket`` itself (one source
    of truth for the boundary ladder; a few dozen probes at most)."""
    from ..compiler.bucketing import lane_bucket

    b = max(1, k)
    while b > 1 and lane_bucket(b) > b:
        b -= 1
    return b


def base_from_arrays(
    prob: np.ndarray | None, pred: np.ndarray | None
) -> tuple[np.ndarray, np.ndarray | None]:
    """(base score, base class) from already-rendered prediction arrays —
    the probability of each row's OWN predicted class for classifiers,
    the prediction itself for regressors. Shared by the staged sweep and
    the fused graph's in-dispatch lanes."""
    if prob is not None:
        prob = np.asarray(prob)
        base_class = np.argmax(prob, axis=1)
        rows = np.arange(len(prob))
        return prob[rows, base_class].astype(np.float64), base_class
    return np.asarray(pred, dtype=np.float64), None


def scores_from_outputs(
    pred_p: np.ndarray | None,
    prob_p: np.ndarray | None,
    base_class: np.ndarray | None,
    lanes: int,
    n: int,
) -> np.ndarray:
    """[lanes, N] perturbed scores tracked against each row's BASE class
    (so perturbed scores of different classes are never compared) — the
    one place the lane-output → score convention lives."""
    if prob_p is not None and base_class is not None:
        return prob_p.reshape(lanes, n, -1)[:, np.arange(n), base_class]
    return np.asarray(pred_p, dtype=np.float64).reshape(lanes, n)


def group_masks(
    groups: list[tuple[str, list[int]]], width: int, lanes: int | None = None
) -> np.ndarray:
    """[lanes, width] f32 column masks for the in-graph sweep: lane g is
    1.0 on group g's column slice. Rows beyond ``len(groups)`` (bucket
    padding) stay all-zero — an unperturbed plane whose diff is exactly
    0, sliced off by the caller."""
    out = np.zeros((lanes or len(groups), width), dtype=np.float32)
    for g, (_, idxs) in enumerate(groups):
        out[g, idxs] = 1.0
    return out


def _base_scores(
    model: PredictorModel,
    x: np.ndarray,
    base_prob: np.ndarray | None = None,
    base_pred: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray | None]:
    """Per-row base score tracked against the BASE prediction's class
    (RecordInsightsLOCO tracks the original class's probability, so
    perturbed scores of different classes are never compared). Callers
    that already hold the batch's PredictionColumn pass its arrays in and
    skip the extra base dispatch."""
    if base_prob is not None or base_pred is not None:
        return base_from_arrays(base_prob, base_pred)
    pred, prob, _ = model.predict_arrays(x)
    return base_from_arrays(prob, pred)


def explain_batch(
    model: PredictorModel,
    x: np.ndarray,
    groups: list[tuple[str, list[int]]],
    base_prob: np.ndarray | None = None,
    base_pred: np.ndarray | None = None,
) -> tuple[np.ndarray, dict[str, int]]:
    """LOCO contribution matrix ``[N, G]`` for one feature plane.

    ``diffs[i, g]`` = base score of row ``i`` minus its score with group
    ``g``'s columns zeroed (positive = the group pushed the score UP).
    Dedup → lane bucketing → ``[lanes×N, D]`` predict(s) under the memory
    budget. ``base_prob``/``base_pred``
    reuse an already-computed base prediction (the serving path passes
    the batch's PredictionColumn arrays).

    Returns ``(diffs, sweep_info)`` where ``sweep_info`` carries the lane
    bookkeeping (``lanes`` dispatched incl. pads, ``deduped``, ``padded``,
    ``dispatches``) for the caller's ledger record — the caller owns the
    clock read, so it records rows/seconds in ONE ``record_explain``."""
    from ..compiler.bucketing import lane_bucket

    x = np.ascontiguousarray(x, dtype=np.float32)
    n, dim = x.shape
    g_count = len(groups)
    diffs = np.zeros((n, g_count), dtype=np.float64)
    info = {"lanes": 0, "deduped": 0, "padded": 0, "dispatches": 0}
    if n == 0 or g_count == 0:
        return diffs, info
    base, base_class = _base_scores(model, x, base_prob, base_pred)

    # dedup: a group whose slice is all-zero across the batch cannot move
    # any score — its contribution is exactly 0.0, no lane dispatched
    live: list[int] = []
    for g, (_, idxs) in enumerate(groups):
        if np.any(x[:, idxs]):
            live.append(g)
    info["deduped"] = g_count - len(live)
    if not live:
        return diffs, info

    # lane chunks under the memory budget, each padded onto the shared
    # shape buckets so the dispatch shapes form a small program family.
    # The chunk size is FLOORED to a bucket boundary: a chunk sized
    # budget//(n*dim) would be rounded UP by lane_bucket and the padded
    # dispatch could materialize ~2x the budget — flooring guarantees
    # every chunk (including a padded final partial) stays <= per_chunk
    per_chunk = _floor_lane_bucket(
        max(1, _lane_budget() // max(1, n * dim))
    )
    for start in range(0, len(live), per_chunk):
        chunk = live[start:start + per_chunk]
        k = len(chunk)
        kb = lane_bucket(k)
        pad = kb - k
        plane = np.broadcast_to(x, (kb, n, dim)).copy()
        for lane, g in enumerate(chunk):
            plane[lane, :, groups[g][1]] = 0.0
        # pad lanes replay lane 0 (already zeroed) — inert, sliced off
        pred_p, prob_p, _ = model.predict_arrays(
            plane.reshape(kb * n, dim)
        )
        scores = scores_from_outputs(pred_p, prob_p, base_class, kb, n)
        for lane, g in enumerate(chunk):
            diffs[:, g] = base - scores[lane]
        info["lanes"] += kb
        info["padded"] += pad
        info["dispatches"] += 1
    return diffs, info


def top_k_maps(
    diffs: np.ndarray,
    names: list[str],
    top_k: int,
    strategy: str = ABS,
) -> tuple[list[dict[str, float]], np.ndarray]:
    """Per-row top-k maps (ranked insertion order) + per-group hit counts.

    Selection semantics match the reference exactly: ``abs`` takes the k
    largest |contribution|s; ``positive_negative`` takes the k most
    positive AND k most negative (RecordInsightsLOCO.scala:91)."""
    n, g_count = diffs.shape
    k = min(top_k, g_count)
    hits = np.zeros(g_count, dtype=np.int64)
    values: list[dict[str, float]] = []
    for i in range(n):
        row = diffs[i]
        if strategy == ABS:
            picked = list(np.argsort(-np.abs(row))[:k])
        else:
            # topK most positive AND topK most negative
            # (RecordInsightsLOCO.scala:91 PositiveNegative strategy)
            order = np.argsort(-row)
            pos = [j for j in order[:k] if row[j] > 0]
            neg = [j for j in order[::-1][:k] if row[j] < 0]
            picked = pos + [j for j in neg if j not in pos]
        hits[picked] += 1
        values.append({names[j]: float(row[j]) for j in picked})
    return values, hits


def reference_loop(
    model: PredictorModel,
    x: np.ndarray,
    groups: list[tuple[str, list[int]]],
) -> np.ndarray:
    """The pre-batched implementation — one model call PER COLUMN GROUP —
    kept as the golden oracle for the parity suite (never on a hot
    path)."""
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[0]
    base, base_class = _base_scores(model, x)
    diffs = np.zeros((n, len(groups)), dtype=np.float64)
    rows = np.arange(n)
    for gi, (_, idxs) in enumerate(groups):
        x2 = x.copy()
        x2[:, idxs] = 0.0
        pred, prob, _ = model.predict_arrays(x2)
        if prob is not None and base_class is not None:
            diffs[:, gi] = base - prob[rows, base_class]
        else:
            diffs[:, gi] = base - np.asarray(pred, dtype=np.float64)
    return diffs


class RecordInsightsLOCO(Model):
    """Transformer[OPVector] -> TextMap of top-K column contributions.

    A ``Model`` (not a plain Transformer) so workflow persistence saves the
    wrapped predictor's arrays; the nested model round-trips via
    class-name + params in ``get_params`` and namespaced arrays.
    """

    input_types = (OPVector,)
    output_type = TextMap

    def __init__(
        self,
        model: PredictorModel,
        top_k: int = 20,
        strategy: str = ABS,
        uid: str | None = None,
    ):
        super().__init__("recordInsightsLOCO", uid=uid)
        self.model = model
        self.top_k = top_k
        self.strategy = strategy
        #: (metadata object, dim, groups) — metadata is fit-static, so a
        #: metadata-less vector logs/counts its degradation ONCE per
        #: stage, not once per scored batch. The cache HOLDS the metadata
        #: object (identity compared with ``is``): an id()-keyed cache
        #: could serve stale groups after the id is recycled by GC
        self._groups_cache: tuple | None = None

    def get_params(self):
        return {
            "top_k": self.top_k,
            "strategy": self.strategy,
            "model_class": type(self.model).__name__,
            "model_params": self.model.get_params(),
        }

    def get_arrays(self):
        return {f"model__{k}": v for k, v in self.model.get_arrays().items()}

    @property
    def kernel_libraries(self) -> tuple[str, ...]:
        return tuple(getattr(self.model, "kernel_libraries", ()))

    def to(self, device) -> "RecordInsightsLOCO":
        self.model.to(device)
        return self

    @classmethod
    def from_params(cls, params: dict, arrays: dict) -> "RecordInsightsLOCO":
        from ..workflow.persistence import construct_stage

        params = dict(params)
        model = construct_stage(
            params.pop("model_class"),
            params.pop("model_params"),
            {k[len("model__"):]: v for k, v in arrays.items()
             if k.startswith("model__")},
        )
        return cls(model=model, **params)

    def transform_columns(self, *cols: Column, num_rows: int) -> MapColumn:
        from ..telemetry import spans as _tspans

        vec = cols[-1]
        assert isinstance(vec, VectorColumn)
        x = np.asarray(vec.values, dtype=np.float32)
        cached = self._groups_cache
        if (
            cached is None
            or cached[0] is not vec.metadata
            or cached[1] != x.shape[1]
        ):
            cached = self._groups_cache = (
                vec.metadata, x.shape[1],
                _column_groups(vec.metadata, x.shape[1]),
            )
        groups = cached[2]
        t0 = _tspans.clock()
        diffs, info = explain_batch(self.model, x, groups)
        names = [name for name, _ in groups]
        values, hits = top_k_maps(
            diffs[:num_rows], names, self.top_k, self.strategy
        )
        led = _ledger.stats()
        led.record_explain(
            num_rows, _tspans.clock() - t0, lanes=info["lanes"],
            deduped=info["deduped"], padded=info["padded"],
        )
        led.record_groups(names, diffs[:num_rows], hits)
        return MapColumn(TextMap, values)
