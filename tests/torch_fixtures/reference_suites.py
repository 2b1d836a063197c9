"""Run a test suite of the JAX package against the port.

``translate(name)`` reads ``tests/<name>.py``, points every import of the
JAX package at the port (``transmogrifai_tpu`` -> ``transmogrifai_tpu_torch``
as a whole word) and executes the result as a module of its own; the
suite's file is read, never changed. ``cases(module, leave_out)`` names
its tests (``func``, ``Class::method``, ``func[i]`` for the i-th case of a
``pytest.mark.parametrize``), and ``run(module, case, request)`` calls one
with the pytest fixtures it asks for. ``fixtures(module)`` gathers the
suite's own fixtures, autouse ones among them, so a port test module that
puts them in its namespace runs them as the suite does.

The port's entry points default to the card; ``cpu_default()`` makes
``device=None`` mean the CPU for the block (every port module's
``resolve_device`` is patched), since a translated suite builds estimators
without a device. The same cases run through the JAX package in the
suite's own file, so a case that passes on both holds the port to the
reference's own assertions: exact values where the reference asserts
them, its invariants elsewhere.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import inspect
import os
import pkgutil
import re
import types

import pytest

TESTS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def translate(name: str) -> types.ModuleType:
    path = os.path.join(TESTS, f"{name}.py")
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    src = re.sub(r"\btransmogrifai_tpu\b", "transmogrifai_tpu_torch", src)
    mod = types.ModuleType(f"ported_{name}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def _is_fixture(v) -> bool:
    return hasattr(v, "_fixture_function_marker")


def fixtures(mod: types.ModuleType) -> dict:
    """The suite's module-level pytest fixtures, by name."""
    return {k: v for k, v in vars(mod).items() if _is_fixture(v)}


def _parametrized(fn) -> list:
    """[(argnames, values)] of a test's parametrize marks."""
    out = []
    for m in getattr(fn, "pytestmark", []):
        if m.name == "parametrize":
            names, values = m.args[0], m.args[1]
            if isinstance(names, str):
                names = [n.strip() for n in names.split(",")]
            out.append((list(names), list(values)))
    return out


def cases(mod: types.ModuleType, leave_out=()) -> list[str]:
    names = []
    for k, v in vars(mod).items():
        if k.startswith("test_") and inspect.isfunction(v):
            names += _expand(k, v)
        elif k.startswith("Test") and inspect.isclass(v):
            for m, fn in vars(v).items():
                if m.startswith("test_") and inspect.isfunction(fn):
                    names += _expand(f"{k}::{m}", fn)
    return [n for n in names if n.split("[")[0] not in leave_out]


def _expand(name, fn) -> list[str]:
    params = _parametrized(fn)
    if not params:
        return [name]
    (_, values), = params
    return [f"{name}[{i}]" for i in range(len(values))]


def run(mod: types.ModuleType, case: str, request) -> None:
    base, _, idx = case.partition("[")
    class_fixtures: dict = {}
    if "::" in base:
        cls_name, meth = base.split("::")
        cls = getattr(mod, cls_name)
        fn = getattr(cls, meth)
        inst = cls()
        bound = getattr(inst, meth)
        # a fixture method of the class: called on the instance (once per
        # case, where pytest would share a class-scoped one)
        class_fixtures = {
            k: v._get_wrapped_function() for k, v in vars(cls).items()
            if _is_fixture(v)
        }
    else:
        fn = bound = getattr(mod, base)
    given: dict = {}
    if idx:
        (names, values), = _parametrized(fn)
        value = values[int(idx.rstrip("]"))]
        if hasattr(value, "values") and hasattr(value, "marks"):
            value = value.values
        if len(names) == 1:
            value = (value,)
        given = dict(zip(names, value))
    def call(f, *lead):
        kwargs = {}
        params = list(inspect.signature(f).parameters.values())[len(lead):]
        for p in params:
            if p.name in given:
                kwargs[p.name] = given[p.name]
            elif p.name in class_fixtures:
                kwargs[p.name] = call(class_fixtures[p.name], inst)
            elif p.default is inspect.Parameter.empty and p.kind in (
                    p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY):
                kwargs[p.name] = request.getfixturevalue(p.name)
        return f(*lead, **kwargs)

    call(bound)


@functools.lru_cache(maxsize=None)
def port_modules() -> tuple[types.ModuleType, ...]:
    """Every module of the port, imported (once a process)."""
    import transmogrifai_tpu_torch as pkg

    mods = [pkg]
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        mods.append(importlib.import_module(info.name))
    return tuple(mods)


@contextlib.contextmanager
def cpu_default():
    """``device=None`` means the CPU in every port module for the block."""
    from transmogrifai_tpu_torch.utils import device as D

    orig = D.resolve_device

    def resolve(device=None):
        return orig("cpu" if device is None else device)

    mp = pytest.MonkeyPatch()
    try:
        for m in port_modules():
            if getattr(m, "resolve_device", None) is orig:
                mp.setattr(m, "resolve_device", resolve)
        yield
    finally:
        mp.undo()
