"""Per-row local scoring: ``row dict -> result dict``.

The fitted DAG is walked once, when the closure is built, into a flat stage
plan; each call builds the raw columns from the rows and runs the plan's
columnar transforms over them. Result keys are the result-feature names;
a Prediction result expands to the reference's map keys (``prediction``,
``probability_<j>``, ``rawPrediction_<j>``). ``.batch(rows)`` scores a list
of rows as one columnar batch; every batch, whatever its size, runs the
predictor on the closure's device.
"""
from __future__ import annotations

from typing import Any, Callable

from ..types.columns import column_from_values
from ..utils.device import resolve_device
from ..workflow.workflow import WorkflowModel


def score_function(
    model: WorkflowModel, device=None,
) -> Callable[[dict[str, Any]], dict[str, Any]]:
    """The scoring closure for ``model`` on ``device`` (``None`` means
    ``cuda``, which must be present; the model is moved there)."""
    dev = resolve_device(device)
    model.to(dev)
    plan = model.stage_plan()
    raw_features = list(model.raw_features)
    result_names = [f.name for f in model.result_features]

    def _raw_columns(rows: list[dict[str, Any]]) -> dict[str, Any]:
        cols = {}
        for f in raw_features:
            vals = [row.get(f.name) for row in rows]
            if f.is_response and all(v is None for v in vals):
                vals = [0] * len(rows)  # score-time null labels
            cols[f.name] = column_from_values(f.ftype, vals)
        return cols

    def score_batch(rows: list[dict[str, Any]]) -> list[dict[str, Any]]:
        n = len(rows)
        if n == 0:
            return []
        cols = _raw_columns(rows)
        for stage in plan:
            cols[stage.output_name] = stage.transform_columns(
                *[cols[name] for name in stage.input_names], num_rows=n
            )
        rendered = [cols[name].to_list() for name in result_names]
        return [
            {name: r[i] for name, r in zip(result_names, rendered)}
            for i in range(n)
        ]

    def score_one(row: dict[str, Any]) -> dict[str, Any]:
        return score_batch([row])[0]

    score_one.batch = score_batch
    return score_one
