"""Bounded admission queue — the service's only intake.

A standing scorer's first defense against overload is refusing work it
cannot hold: the queue is bounded in ROWS (requests carry 1..k rows), an
offer against a full queue raises the typed
:class:`RejectedByAdmission` instead of growing memory, and every depth
change lands in the ``tptpu_serve_queue_depth`` gauge so backpressure is
observable the moment it starts. FIFO order is preserved; the service's
micro-batcher pops contiguous runs of requests off the head.

The queue never sleeps on the caller's behalf in tests: ``pop_many``
takes an optional real-time wait (worker mode); the synchronous pump
path passes ``wait=0`` and the loadtest harness drives everything on a
virtual clock.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any

from ..analysis import schedule as _schedule
from ..telemetry import metrics as _tm

__all__ = ["AdmissionQueue", "RejectedByAdmission"]

#: admission-rejection reasons (the typed taxonomy)
REJECT_REASONS = ("queue_full", "shedding", "stopped")


class RejectedByAdmission(RuntimeError):
    """The service refused to accept a request: the queue is full, the
    load shedder is in its reject tier, or the service is stopping.
    ``reason`` is one of ``queue_full`` / ``shedding`` / ``stopped``."""

    def __init__(self, reason: str, detail: str = ""):
        if reason not in REJECT_REASONS:
            raise ValueError(f"unknown rejection reason {reason!r}")
        self.reason = reason
        super().__init__(
            f"rejected by admission ({reason})" + (f": {detail}" if detail else "")
        )


class AdmissionQueue:
    """Bounded FIFO of scoring requests, measured in rows.

    ``item_rows(item)`` must return the item's row count; anything with
    ``.rows`` works by default."""

    def __init__(self, max_rows: int = 2048):
        if max_rows < 1:
            raise ValueError("max_rows must be >= 1")
        self.max_rows = max_rows
        self._lock = _schedule.make_lock(
            "serving/queue.py:AdmissionQueue._lock"
        )
        # the Condition WRAPS the queue lock: one lock, one graph node
        self._not_empty = threading.Condition(self._lock)
        self._items: deque[Any] = deque()
        self._rows = 0
        self._closed = False
        self.peak_rows = 0
        self._gauge = _tm.REGISTRY.gauge("tptpu_serve_queue_depth")

    @staticmethod
    def item_rows(item: Any) -> int:
        rows = getattr(item, "rows", None)
        return len(rows) if rows is not None else 1

    # -------------------------------------------------------------- intake
    def offer(self, item: Any) -> None:
        """Enqueue or raise :class:`RejectedByAdmission`."""
        n = self.item_rows(item)
        with self._not_empty:
            if self._closed:
                raise RejectedByAdmission("stopped")
            if self._rows + n > self.max_rows:
                raise RejectedByAdmission(
                    "queue_full",
                    f"{self._rows}+{n} rows > bound {self.max_rows}",
                )
            self._items.append(item)
            self._rows += n
            if self._rows > self.peak_rows:
                self.peak_rows = self._rows
            self._gauge.set(self._rows)
            self._not_empty.notify()

    # ------------------------------------------------------------- drain
    def pop_many(self, max_rows: int, wait: float = 0.0) -> list[Any]:
        """Pop a FIFO run of requests totalling at most ``max_rows`` rows
        (always at least one request when the queue is non-empty, so a
        single oversized request can still make progress). Blocks up to
        ``wait`` REAL seconds for the first item (worker mode); ``wait=0``
        returns immediately (pump mode)."""
        out: list[Any] = []
        with self._not_empty:
            if not self._items and wait > 0:
                self._not_empty.wait(timeout=wait)
            taken = 0
            while self._items:
                n = self.item_rows(self._items[0])
                if out and taken + n > max_rows:
                    break
                out.append(self._items.popleft())
                taken += n
            if out:
                self._rows -= taken
                self._gauge.set(self._rows)
        return out

    def drain(self) -> list[Any]:
        """Everything still queued, atomically (service shutdown)."""
        with self._lock:
            out = list(self._items)
            self._items.clear()
            self._rows = 0
            self._gauge.set(0)
        return out

    # ------------------------------------------------------------- state
    def depth_rows(self) -> int:
        return self._rows

    def depth_requests(self) -> int:
        return len(self._items)

    def close(self) -> None:
        """Refuse further offers; queued items stay for draining. Wakes
        blocked poppers so worker threads can observe shutdown."""
        with self._not_empty:
            self._closed = True
            self._not_empty.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed
