"""Serving plane of the port: the pieces the scoring closure consults.

* :mod:`.deadline` — per-request ``DeadlineBudget`` and the stage-family
  ``checkpoint`` of ``local/scoring.py``;
* :mod:`.shedding` — the process's explain-shed and drift-shed flags and
  the ``LoadShedder`` that raises them.

The queue, batcher, service, router, registry, fleet and load test are
not ported yet (``ROADMAP.md`` A8b).
"""
from .deadline import DeadlineBudget, DeadlineExceeded  # noqa: F401
from .shedding import LoadShedder, ShedConfig  # noqa: F401
