"""UID generation (reference: utils/.../op/UID.scala:42).

UIDs have the form ``ClassName_%012x``, from a process-wide counter.
"""
from __future__ import annotations

import itertools
import re
import threading

_counter = itertools.count(1)
_lock = threading.Lock()

_UID_RE = re.compile(r"^(.*)_([0-9a-f]{12})$")


def make_uid(cls_or_name: type | str) -> str:
    name = cls_or_name if isinstance(cls_or_name, str) else cls_or_name.__name__
    with _lock:
        n = next(_counter)
    return f"{name}_{n:012x}"


def reset(start: int = 1) -> None:
    """Restart the counter (UID.scala reset), for deterministic tests."""
    global _counter
    with _lock:
        _counter = itertools.count(start)


def from_string(uid: str) -> tuple[str, str]:
    """Parse a UID into (stage class name, hex suffix) (UID.scala fromString)."""
    m = _UID_RE.match(uid)
    if not m:
        raise ValueError(f"Invalid UID: {uid!r}")
    return m.group(1), m.group(2)
