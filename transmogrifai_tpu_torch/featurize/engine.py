"""Featurize planner, the port of the JAX package's
``featurize/engine.py``: fused block assembly over the fitted DAG.

``ops.base._assemble_values`` already assembles each SEQUENCE STAGE into
one buffer; the remaining full-plane copy is ``VectorsCombiner``
concatenating every stage's matrix into the final feature vector. The
:class:`FusionPlanner` kills that copy for dense planes:

* the plan owner (DAG fit ingest, the serving closure) builds one planner
  over its ordered fitted stage list; the planner walks it, finds the
  ``VectorsCombiner`` and the vectorizer sequence stages feeding it;
* the first batch runs unfused and *learns* each member's dense width;
* every later batch allocates ONE ``[N, total_width]`` float32 buffer;
  each member's ``transform_columns`` writes its blocks straight into its
  column slice (``ops.base._Vectorizer`` asks
  :func:`current_sink`), and the combiner returns the shared buffer
  wholesale — zero per-stage output temporaries, zero concat.

A member that would emit a sparse block (wide hashed text of a batch of
``SPARSE_MIN_ROWS`` rows or more, the COO path) assembles dense while its
slot in an active sink exists (:func:`sink_active`): the plane is
densified for the predictor anyway, so a scoring batch of the bucket cap
(8192 rows) fuses too. Here the port departs from the reference, whose
first sparse member output disables fusion for the closure; outside a
fused batch the sparse plane is kept. The sink is thread-local, so
concurrent scoring closures can't cross-write. The fused scoring graph
(``compiler/fused.py``) cross-checks its members' widths against
:meth:`FusionPlanner.plane_width`'s parts."""
from __future__ import annotations

import threading

import numpy as np

from . import stats as fstats

_TLS = threading.local()


class _Sink:
    """One batch's shared assembly buffer."""

    __slots__ = ("buf", "layout", "written")

    def __init__(self, buf: np.ndarray, layout: dict):
        self.buf = buf
        self.layout = layout  # stage uid -> (col offset, width)
        self.written: set[str] = set()


class FusionPlanner:
    """Per-plan fusion state (owned by one DAG execution context)."""

    def __init__(self, plan) -> None:
        from ..ops.base import _Vectorizer
        from ..ops.combiner import VectorsCombiner

        self.disabled = True
        self.member_uids: list[str] = []
        self.combiner_uid: str | None = None
        #: uid -> width, learned from the first (unfused) batch
        self.widths: dict[str, int] = {}
        self._member_stages: list = []
        combiners = [t for t in plan if isinstance(t, VectorsCombiner)]
        if len(combiners) != 1:
            return
        combiner = combiners[0]
        by_output = {t.output_name: t for t in plan}
        members = []
        stages = []
        for name in combiner.input_names:
            t = by_output.get(name)
            if t is None or not isinstance(t, _Vectorizer):
                return  # passthrough vector / non-sequence producer
            members.append(t.uid)
            stages.append(t)
        if not members:
            return
        self.combiner_uid = combiner.uid
        self.member_uids = members
        self._member_stages = stages
        self.disabled = False

    def prime(self) -> bool:
        """Learn member widths from fit-static metadata (each vectorizer's
        populated ``_meta_cache``) without waiting for a first unfused
        batch — the scoring closure's ``prime_fused`` calls this so batch
        #1 already assembles into the single fused buffer. A member that
        has not transformed in this process yet (a loaded model) stays
        unlearned; its width arrives via :meth:`note_output`. Returns
        ``ready()``.

        Safe to over-prime: if a member's output ever bypasses the sink,
        ``fused_result`` sees an incomplete write set, and the combiner
        falls back to plain assembly."""
        if self.disabled:
            return False
        for t in self._member_stages:
            cached = t._meta_cache
            if t.uid not in self.widths and cached is not None:
                self.widths[t.uid] = int(cached[1].size)
        return self.ready()

    # ------------------------------------------------------------- learning
    def note_output(self, uid: str, column) -> None:
        """Record a member's width from its first unfused output, dense or
        sparse (under a sink every member assembles dense)."""
        if self.disabled or uid not in self.member_uids:
            return
        self.widths[uid] = int(column.values.shape[1])

    def ready(self) -> bool:
        return not self.disabled and all(
            u in self.widths for u in self.member_uids
        )

    def plane_width(self) -> int | None:
        """Total [N, width] plane width once every member width is known
        (the fused scoring graph cross-checks its statically-derived
        widths against this)."""
        if not self.ready():
            return None
        return sum(self.widths[u] for u in self.member_uids)

    # ------------------------------------------------------------- batches
    def batch(self, num_rows: int) -> "_BatchContext":
        return _BatchContext(self, num_rows)


class _BatchContext:
    def __init__(self, planner: FusionPlanner, num_rows: int):
        self.planner = planner
        self.num_rows = num_rows
        self.sink: _Sink | None = None

    def __enter__(self):
        p = self.planner
        if p.ready():
            total = p.plane_width()
            layout = {}
            off = 0
            for u in p.member_uids:
                layout[u] = (off, p.widths[u])
                off += p.widths[u]
            buf = np.empty((self.num_rows, total), dtype=np.float32)
            self.sink = _Sink(buf, layout)
            _TLS.sink = self.sink
            _TLS.planner = p
        else:
            _TLS.sink = None
            _TLS.planner = p
        return self

    def __exit__(self, *exc):
        _TLS.sink = None
        _TLS.planner = None
        return False


def sink_active(uid: str) -> bool:
    """Whether a fused batch is active with a slot for ``uid`` (recording
    no write): the member then assembles dense into the shared buffer."""
    sink: _Sink | None = getattr(_TLS, "sink", None)
    return sink is not None and uid in sink.layout


def current_sink(uid: str):
    """(buffer, col_offset, width) when a fused batch is active and the
    stage is a member, else None."""
    sink: _Sink | None = getattr(_TLS, "sink", None)
    if sink is None:
        return None
    got = sink.layout.get(uid)
    if got is None:
        return None
    sink.written.add(uid)
    return sink.buf, got[0], got[1]


def note_output(uid: str, column) -> None:
    planner = getattr(_TLS, "planner", None)
    if planner is not None:
        planner.note_output(uid, column)


def fused_result(uid: str, cols) -> np.ndarray | None:
    """The shared buffer, when ``uid`` is the combiner of the active sink
    and every member wrote its slice this batch (the combiner's zero-copy
    return)."""
    sink: _Sink | None = getattr(_TLS, "sink", None)
    planner = getattr(_TLS, "planner", None)
    if sink is None or planner is None or uid != planner.combiner_uid:
        return None
    if sink.written != set(sink.layout):
        return None
    # belt and braces: every input must be a view into the sink buffer
    for c in cols:
        vals = getattr(c, "values", None)
        if vals is None or getattr(vals, "base", None) is not sink.buf:
            return None
    fstats.stats().record_fused(sink.buf.nbytes)
    return sink.buf
