"""Dynamic micro-batch assembly over the admission queue.

One executed batch amortizes the fixed costs of the scoring closure —
the schema sentinel's type census, the fused ``[N, width]`` featurize
plane (``featurize/engine.py``), and the bucketed compiled predict — so
the batcher greedily assembles the largest batch available up to
``max_rows``, without holding latency hostage: it never WAITS for a
fuller batch beyond the (real-time, worker-mode) ``max_wait``; the
synchronous pump path takes whatever is queued right now.

Assembly also performs the second deadline gate: members whose budget
expired while queuing, or whose remaining time no longer covers the
pipeline p95 (:func:`serving.deadline.pipeline_p95`), are split out as
``expired`` — the service sheds them with typed ``DeadlineExceeded``
outcomes instead of spending a dispatch on them. The survivors' queue
wait lands as one ``serve/queue`` span per assembled batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from ..telemetry import spans as _tspans
from . import deadline as _deadline
from .queue import AdmissionQueue

__all__ = ["BatchPlan", "MicroBatcher"]


@dataclasses.dataclass
class BatchPlan:
    """One assembled micro-batch: live members, their flattened rows, and
    the members shed at assembly time."""

    requests: list[Any]
    rows: list[dict]
    expired: list[Any]
    #: tightest member budget (installed around the batch execution)
    budget: Any | None
    max_wait_s: float = 0.0

    @property
    def empty(self) -> bool:
        return not self.requests and not self.expired


class MicroBatcher:
    """Assembles :class:`BatchPlan`\\ s from an :class:`AdmissionQueue`."""

    def __init__(
        self,
        queue: AdmissionQueue,
        max_rows: int = 256,
        clock: Callable[[], float] | None = None,
    ):
        import time

        self.queue = queue
        self.max_rows = max(1, max_rows)
        self.clock = clock if clock is not None else time.monotonic
        self.batches_assembled = 0
        self.rows_assembled = 0

    def next_batch(self, wait: float = 0.0) -> BatchPlan | None:
        """One batch off the queue head, or None when nothing is queued
        (after at most ``wait`` real seconds in worker mode)."""
        popped = self.queue.pop_many(self.max_rows, wait=wait)
        if not popped:
            return None
        now = self.clock()
        live: list[Any] = []
        rows: list[dict] = []
        expired: list[Any] = []
        budget = None
        max_wait = 0.0
        # one p95 lookup per assembled batch, not per member
        required = _deadline.pipeline_p95()
        for req in popped:
            enq = getattr(req, "enqueued_at", None)
            if enq is not None:
                max_wait = max(max_wait, now - enq)
            b = getattr(req, "budget", None)
            if b is not None and not b.covers(required=required):
                expired.append(req)
                continue
            live.append(req)
            rows.extend(req.rows)
            if b is not None and (
                budget is None or b.remaining() < budget.remaining()
            ):
                budget = b
        if live:
            self.batches_assembled += 1
            self.rows_assembled += len(rows)
            # queue-wait observability: one span per assembled batch, timed
            # on the service clock (virtual under the loadtest harness)
            _tspans.record_span(
                "serve/queue", now - max_wait, max_wait,
                rows=len(rows), requests=len(live),
            )
        return BatchPlan(
            requests=live, rows=rows, expired=expired, budget=budget,
            max_wait_s=max_wait,
        )

    def stats(self) -> dict:
        return {
            "batchesAssembled": self.batches_assembled,
            "rowsAssembled": self.rows_assembled,
            "maxBatchRows": self.max_rows,
            "pipelineP95Ms": round(_deadline.pipeline_p95() * 1e3, 3),
        }
