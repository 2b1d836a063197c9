"""Callables as stage params: pickled to base64 for a saved model.

The reference serializes stage lambdas by class name (Scala lambdas are
classes, OpPipelineStageReaderWriter.scala). Here a module-level callable
is pickled to base64, the format of ``transmogrifai_tpu/utils/serial.py``,
so a callable saved by either package loads in the other where both import
it by the same dotted name. Lambdas and closures are refused when the
model is saved (the reference's checkSerializable gate,
OpWorkflow.scala:280-287): refusing at load time would strand the model.
"""
from __future__ import annotations

import base64
import pickle
from typing import Any, Callable


def encode_callable(fn: Callable | None, owner: str, param: str) -> str | None:
    """``fn`` pickled to base64; ``None`` passes through."""
    if fn is None:
        return None
    try:
        blob = pickle.dumps(fn)
        pickle.loads(blob)  # round trip: catches definitions not importable
    except Exception as e:
        raise ValueError(
            f"{owner}: param '{param}' is not serializable ({e}). Use a "
            "module-level function instead of a lambda/closure so the saved "
            "workflow can be loaded."
        ) from None
    return base64.b64encode(blob).decode("ascii")


def decode_callable(value: Any) -> Any:
    """The inverse of ``encode_callable``; a value that is not a string
    (a callable, ``None``) passes through."""
    if isinstance(value, str):
        return pickle.loads(base64.b64decode(value.encode("ascii")))
    return value
