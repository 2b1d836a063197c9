"""Analysis plane of the port. Only ``schedule``'s lock seam is ported;
the analyzers, the schedule reconciler and ``TracedLock`` are
``ROADMAP.md`` A14."""
