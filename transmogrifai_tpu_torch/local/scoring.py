"""Per-row local scoring: ``row dict -> result dict``.

The fitted DAG is walked once, when the closure is built, into a flat stage
plan; each call builds the raw columns from the rows and runs the plan's
columnar transforms over them. Result keys are the result-feature names;
a Prediction result expands to the reference's map keys (``prediction``,
``probability_<j>``, ``rawPrediction_<j>``). ``.batch(rows)`` scores a list
of rows as one columnar batch and ``.columns(dataset)`` a dataset's columns
(``{result name: column}`` back); the predictor runs on the closure's
device.

A batch whose bucketed row count (``bucket``: powers of two up to 8192,
then multiples of 8192) exceeds ``TPTPU_HOST_PREDICT_MAX`` (default
16384, read per batch as the reference reads it) takes the fused scoring
graph (``compiler/fused.py``): its rows padded to the bucket with copies of
row 0, one upload of the members' ingest arrays, the whole plan from the
members to the predictor's core on the device, one download of the core's
real rows. Every other batch, a batch of a plan that cannot be fused, and
every batch under ``TPTPU_FUSED=0`` take the staged loop over its own rows.
A batch the fused graph refuses at ingest (text over the token cap) goes
staged and is counted; any other error in a fused dispatch propagates, a
kernel fault included (the reference degrades on any error).
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Any, Callable

import numpy as np

from ..featurize import stats as fstats
from ..featurize.engine import FusionPlanner
from ..types import Prediction
from ..types.columns import PredictionColumn, column_from_values
from ..utils.device import resolve_device
from ..workflow.workflow import WorkflowModel

log = logging.getLogger(__name__)

#: the reference's scoring bucket cap
BUCKET_CAP = 8192


def bucket(n: int) -> int:
    """The smallest power of two >= n up to the cap, else the next multiple
    of the cap."""
    if n >= BUCKET_CAP:
        return -(-n // BUCKET_CAP) * BUCKET_CAP
    b = 1
    while b < n:
        b *= 2
    return b


def score_function(
    model: WorkflowModel, device=None, quantized: bool | None = None,
) -> Callable[[dict[str, Any]], dict[str, Any]]:
    """The scoring closure for ``model`` on ``device`` (``None`` means
    ``cuda``, which must be present; the model is moved there).
    ``quantized=True`` builds the fused program over the quantized plane
    (``featurize/quantize.py``); ``None`` defers to ``TPTPU_FUSED_QUANT``."""
    dev = resolve_device(device)
    model.to(dev)
    plan = model.stage_plan()
    # one fusion planner per closure: after the first batch learns each
    # vectorizer's width (or ``prime_fused`` reads them from the fit),
    # later batches assemble the whole plane into ONE [N, width] buffer
    fusion = FusionPlanner(plan)
    raw_features = list(model.raw_features)
    result_names = [f.name for f in model.result_features]
    fused_quantized = (
        quantized if quantized is not None
        else os.environ.get("TPTPU_FUSED_QUANT", "0") == "1"
    )
    #: ``reason`` holds the build's obstruction only; the TPTPU_FUSED=0
    #: opt-out is read per batch, so lifting it erases nothing
    fused_holder: dict[str, Any] = {
        "program": None, "built": False, "reason": None,
    }
    fused_counters: dict[str, Any] = {
        "dispatches": 0, "fallbacks": 0, "lastFallback": None,
        "fallbackReasons": {},
    }
    fused_lock = threading.Lock()

    def fused_reason() -> str | None:
        if os.environ.get("TPTPU_FUSED", "1") == "0":
            return "TPTPU_FUSED=0"
        return fused_holder["reason"]

    def fused_program():
        """The fused program, built once, or None (opted out, or the plan
        cannot be fused: ``fused_reason``)."""
        if os.environ.get("TPTPU_FUSED", "1") == "0":
            return None
        with fused_lock:
            if not fused_holder["built"]:
                from ..compiler import fused

                try:
                    fused_holder["program"] = fused.build_fused_plan(
                        plan, result_names, quantize=fused_quantized,
                        device=dev, fusion=fusion,
                    )
                except fused.Unfuseable as e:
                    fused_holder["reason"] = str(e)
                    log.info("fused scoring graph unavailable: %s", e)
                fused_holder["built"] = True
            return fused_holder["program"]

    def count_unfuseable() -> None:
        why = fused_reason()
        if why is not None and why != "TPTPU_FUSED=0":
            with fused_lock:
                reasons = fused_counters["fallbackReasons"]
                reasons["unfuseable"] = reasons.get("unfuseable", 0) + 1

    def count_dispatch() -> None:
        with fused_lock:
            fused_counters["dispatches"] += 1

    def count_fallback(reason: str, exc: Exception) -> None:
        with fused_lock:
            fused_counters["fallbacks"] += 1
            fused_counters["lastFallback"] = reason
            reasons = fused_counters["fallbackReasons"]
            reasons[reason] = reasons.get(reason, 0) + 1
        log.warning("fused dispatch went to the staged loop (%s: %s)",
                    reason, exc)

    def fused_eligible(b: int):
        """The program a batch of ``b`` bucketed rows takes, or None."""
        if b <= int(os.environ.get("TPTPU_HOST_PREDICT_MAX", "16384")):
            return None
        prog = fused_program()
        if prog is None and fused_holder["built"]:
            count_unfuseable()
        return prog

    def run_stages(cols: dict[str, Any], stages, num_rows: int) -> None:
        for stage in stages:
            cols[stage.output_name] = stage.transform_columns(
                *[cols[name] for name in stage.input_names], num_rows=num_rows
            )

    def run_plan(cols: dict[str, Any], prog, b: int, n: int) -> None:
        """The plan over raw columns of ``b`` rows: the fused program when
        ``prog`` is given (then the first ``n`` rows are real), else the
        staged loop."""
        with fusion.batch(b):
            run_plan_batch(cols, prog, b, n)

    def run_plan_batch(cols: dict[str, Any], prog, b: int, n: int) -> None:
        if prog is None:
            run_stages(cols, plan, b)
            return
        from ..compiler.fused import Unfuseable

        run_stages(cols, prog.prefix, b)
        try:
            core, _ = prog.run(cols, b, n)
        except Unfuseable as e:  # the text cap: a property of the batch
            count_fallback("dispatch_error", e)
            run_stages(cols, prog.fused_stages, b)
            return
        pred, prob, raw = prog.epilogue(core)
        cols[prog.predictor.output_name] = PredictionColumn(
            Prediction,
            np.asarray(pred, dtype=np.float64),
            None if prob is None else np.asarray(prob, dtype=np.float64),
            None if raw is None else np.asarray(raw, dtype=np.float64),
        )
        count_dispatch()

    def raw_columns(rows: list[dict[str, Any]], b: int) -> dict[str, Any]:
        """Raw columns of the rows, padded to ``b`` with copies of row 0."""
        cols = {}
        for f in raw_features:
            vals = [row.get(f.name) for row in rows]
            if f.is_response and all(v is None for v in vals):
                vals = [0] * len(rows)  # score-time null labels
            vals += [vals[0]] * (b - len(rows))
            cols[f.name] = column_from_values(f.ftype, vals)
        return cols

    def result_column(cols: dict[str, Any], name: str, n: int):
        col = cols[name]
        return col if len(col) == n else col.take(np.arange(n))

    def score_batch(rows: list[dict[str, Any]]) -> list[dict[str, Any]]:
        n = len(rows)
        if n == 0:
            return []
        b = bucket(n)
        prog = fused_eligible(b)
        rows_run = b if prog is not None else n
        cols = raw_columns(rows, rows_run)
        run_plan(cols, prog, rows_run, n)
        rendered = [result_column(cols, name, n).to_list()
                    for name in result_names]
        return [
            {name: r[i] for name, r in zip(result_names, rendered)}
            for i in range(n)
        ]

    def score_columns(dataset) -> dict[str, Any]:
        """Columnar scoring: a dataset in, ``{result name: column}`` out,
        with no row-dict codec either way. Raw features absent from the
        dataset score as all-null (an absent or all-null response as the
        null label 0)."""
        n = len(dataset)
        if n == 0:
            return {}
        b = bucket(n)
        prog = fused_eligible(b)
        rows_run = b if prog is not None else n
        pad = (np.concatenate([np.arange(n), np.zeros(b - n, np.int64)])
               if rows_run > n else None)
        cols: dict[str, Any] = {}
        for f in raw_features:
            c = dataset[f.name] if f.name in dataset else None
            if c is None or (f.is_response and _all_null(c)):
                fill = 0 if f.is_response else None
                cols[f.name] = column_from_values(f.ftype, [fill] * rows_run)
            else:
                cols[f.name] = c if pad is None else c.take(pad)
        run_plan(cols, prog, rows_run, n)
        return {name: result_column(cols, name, n) for name in result_names}

    def score_one(row: dict[str, Any]) -> dict[str, Any]:
        return score_batch([row])[0]

    def prime_fused() -> bool:
        """Learn the fusion planner's widths from the fit and build the
        fused program now rather than at the first eligible batch; whether
        one is available."""
        fusion.prime()
        return fused_program() is not None

    def metadata() -> dict[str, Any]:
        """The fused graph's state and counters, under the reference's
        ``metadata()["fused"]`` keys, and the program's host prefix stages
        (``hostPrefixStages``, the reference's ``describe()`` key; ``None``
        without a program); ``featurizeStats``, the featurize plane's
        process-wide ledger."""
        with fused_lock:
            prog = fused_holder["program"]
            snap = dict(fused_counters)
            snap["fallbackReasons"] = dict(fused_counters["fallbackReasons"])
        return {"fused": {
            "active": prog is not None,
            "reason": fused_reason(),
            "fingerprint": None if prog is None else prog.fingerprint,
            "quantized": prog is not None and prog.quantized,
            "hostPrefixStages": None if prog is None
            else [t.output_name for t in prog.prefix],
            **snap,
        }, "featurizeStats": fstats.snapshot()}

    score_one.batch = score_batch
    score_one.columns = score_columns
    score_one.prime_fused = prime_fused
    score_one.metadata = metadata
    score_one.fused_state = fused_holder
    score_one.fusion = fusion
    return score_one


def _all_null(col) -> bool:
    """Whether every row of the column is missing."""
    mask = getattr(col, "mask", None)
    if mask is not None:
        return not np.asarray(mask, dtype=bool).any()
    return all(v is None for v in col.to_list())
