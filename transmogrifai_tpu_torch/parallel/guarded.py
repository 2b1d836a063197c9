"""The guarded-collective seam: ONE entry point for every collective of
the parallel plane, and its tapes (the port of the JAX package's
``parallel/guarded.py``).

Every collective of the port runs through :func:`guarded_collective`,
one call per ``torch.distributed`` operation: ``Mesh.all_reduce`` and
``Mesh.all_gather`` (``mesh.py``), which the reductions of
``reductions.py``, ``multihost.py`` and ``segments.py``, the sharded tree
grow, the data-parallel GLM and MLP fits and the lane gathers of
``fit.py`` call with their names, and the ring passes of ``ring.py``.
:func:`collective_scope` prefixes the names taped inside it (a sweep's
name over its solver's sums). Two duties, layered so the hot path stays
free:

* **resilience**: when a failover controller is installed
  (``resilience/distributed.py``), the call runs behind its collective
  guard. No controller can be installed yet (the guard and the controller
  are ``ROADMAP.md`` A13b), so every call is direct today.
* **tracing**: under ``TPTPU_COLLECTIVE_TRACE=1`` (latched at import;
  :func:`set_tracing` flips it in process) every call of a collective
  appends ``(sequence #, name)`` to this rank's tape. The port is SPMD,
  so each process records its own rank's tape (the reference's simulated
  hosts all record in one process). Ranks that make the same collectives
  in the same order have identical tapes; a divergence is the classic
  SPMD deadlock, one rank waiting in a collective the others never reach.

With ``TPTPU_COLLECTIVE_TRACE_OUT=<path>`` an atexit hook writes the tapes
as JSON for a parent process to compare (:func:`dump_tapes`,
:func:`load_tapes`).
"""
from __future__ import annotations

import atexit
import contextlib
import json
import os
import threading
from typing import Any, Callable

__all__ = [
    "TRACE_ENV", "TRACE_OUT_ENV", "guarded_collective", "collective_scope",
    "trace_enabled", "set_tracing", "collective_tapes", "reset_tapes",
    "mark_host_lost", "dump_tapes", "load_tapes",
]

TRACE_ENV = "TPTPU_COLLECTIVE_TRACE"
TRACE_OUT_ENV = "TPTPU_COLLECTIVE_TRACE_OUT"

#: rank -> [(seq, name), ...]; writes hold _TAPE_LOCK
_TAPES: dict[int, list] = {}
#: ranks whose tape stopped mid-run (a failover): a prefix of the others'
_LOST: set = set()
_TAPE_LOCK = threading.Lock()
_DUMP_REGISTERED = False
#: this thread's stack of collective_scope names
_SCOPES = threading.local()


def _env_on() -> bool:
    return os.environ.get(TRACE_ENV, "0").strip().lower() not in (
        "", "0", "false", "off",
    )


_TRACING = _env_on()


def trace_enabled() -> bool:
    """True when collective-tape recording is active."""
    return _TRACING


def set_tracing(on: bool) -> bool:
    """Flip tracing in process (the environment latch is read at import).
    Returns the previous state; tapes are kept (:func:`reset_tapes`)."""
    global _TRACING
    prev = _TRACING
    _TRACING = bool(on)
    if on:
        _register_dump()
    return prev


def _register_dump() -> None:
    global _DUMP_REGISTERED
    with _TAPE_LOCK:
        if not _DUMP_REGISTERED:
            out = os.environ.get(TRACE_OUT_ENV)
            if out:
                atexit.register(dump_tapes, out)
            _DUMP_REGISTERED = True


def _rank() -> int:
    from .mesh import world_rank

    return world_rank()


@contextlib.contextmanager
def collective_scope(name: str):
    """Tape the collectives called inside the block, in this thread, as
    ``"<name>/<collective>"`` (scopes nest)."""
    stack = _SCOPES.__dict__.setdefault("stack", [])
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


def _record(name: str) -> None:
    stack = getattr(_SCOPES, "stack", None)
    if stack:
        name = "/".join([*stack, name])
    rank = _rank()
    with _TAPE_LOCK:
        if rank in _LOST:
            return
        tape = _TAPES.setdefault(rank, [])
        tape.append((len(tape), name))


def mark_host_lost(host: Any) -> None:
    """Close ``host``'s tape (a failover under tracing): it stops
    advancing, and must be a prefix of every survivor's."""
    if not _TRACING:
        return
    with _TAPE_LOCK:
        try:
            _LOST.add(int(host))
        except (TypeError, ValueError):
            return


def guarded_collective(name: str, fn: Callable, *args: Any) -> Any:
    """Run one collective through the seam: a direct call when no
    controller is installed and tracing is off; with tracing on every
    attempt is taped (the recorder sits below a guard's retries, as real
    transports send them)."""
    from ..resilience import distributed

    run = fn
    if _TRACING:
        def run(*a):  # noqa: E306 - the traced twin of fn
            _record(name)
            return fn(*a)

    guard = distributed.active_collective_guard()
    if guard is None:
        return run(*args)
    return guard.run(name, run, *args)


# ------------------------------------------------------------------ tapes
def collective_tapes() -> dict[str, Any]:
    """JSON-able snapshot of this process's tapes."""
    from .mesh import world_size

    with _TAPE_LOCK:
        hosts = {str(h): [[s, n] for s, n in tape]
                 for h, tape in sorted(_TAPES.items())}
        lost = sorted(_LOST)
    return {"traced": _TRACING, "nHosts": world_size(), "hosts": hosts,
            "lost": lost}


def tape_names(doc: dict | None = None, rank: int | None = None) -> list:
    """The names on one rank's tape, in order (this rank's by default)."""
    doc = collective_tapes() if doc is None else doc
    key = str(_rank() if rank is None else rank)
    return [n for _, n in doc["hosts"].get(key, [])]


def reset_tapes() -> None:
    """Drop every recorded tape."""
    with _TAPE_LOCK:
        _TAPES.clear()
        _LOST.clear()


def dump_tapes(path: str) -> None:
    """Write the tape snapshot as JSON."""
    doc = collective_tapes()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)


def load_tapes(path: str) -> dict[str, Any]:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


if _TRACING:
    _register_dump()
