"""Analysis plane of the port: ``schedule``'s lock seam and the
``findings`` data types (``Severity``, ``Finding``, ``Report``) the
run diff builds its verdict from. The analyzers, the schedule reconciler,
``TracedLock`` and the lint directives are ``ROADMAP.md`` A14."""
from . import schedule  # noqa: F401
from .findings import Finding, PreflightError, Report, Severity  # noqa: F401
