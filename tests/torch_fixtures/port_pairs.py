"""Run one feature stage in both packages on the same seeded columns, for
the port's per-type tests (``tests/test_torch_dates_phone.py``,
``tests/test_torch_lists_maps.py``, ``tests/test_torch_math_scalers.py``,
``tests/test_torch_bucketizers.py``).

``columns(make, n, seed)`` draws ``make(testkit)``'s generator with each
package's testkit (the same numpy draws, so the same rows);
``run(pkg, stage, type_name, cols)`` wires ``stage`` to features of
``type_name`` named ``f0``, ``f1``, ... over ``cols``, fits it if it is an
estimator, and returns its output column (``run_typed`` takes a type and a
name per input); ``metas(col)`` is a vector column's metadata as plain
records; ``saved_entry`` / ``load_entry`` carry a fitted stage through one
package's saved manifest entry into the other's loader; ``same_columns``
asserts two columns EQUAL.
"""
from __future__ import annotations

import dataclasses


def testkits():
    from transmogrifai_tpu import testkit as JTK
    from transmogrifai_tpu_torch import testkit as PTK

    return {"jax": JTK, "port": PTK}


def columns(make, n: int, seed: int, count: int = 1) -> dict:
    """{"jax": [col, ...], "port": [col, ...]}: ``count`` columns of
    ``make(testkit)`` per package, the i-th drawn with seed ``seed + i``."""
    return {pkg: [make(tk).with_seed(seed + i).to_column(n)
                  for i in range(count)]
            for pkg, tk in testkits().items()}


def run(pkg: str, stage, type_name: str, cols: list):
    """``stage``'s output column over ``cols`` (features f0, f1, ...)."""
    return run_typed(pkg, stage, [type_name] * len(cols), cols)


def metas(col) -> list[dict]:
    return [{k: (list(v) if isinstance(v, tuple) else v)
             for k, v in dataclasses.asdict(c).items()}
            for c in col.metadata.columns]


def values(col) -> list:
    """A column's rows as comparable plain values (sets sorted)."""
    return [sorted(v) if isinstance(v, (set, frozenset)) else v
            for v in col.to_list()]


def run_typed(pkg: str, stage, type_names: list, cols: list, names=None):
    """``stage``'s output column and fitted stage over ``cols``, its inputs
    features of ``type_names`` named ``names`` (default ``f0``, ``f1``,
    ...)."""
    if pkg == "jax":
        from transmogrifai_tpu.dataset import Dataset
        from transmogrifai_tpu.features import FeatureBuilder
        from transmogrifai_tpu.stages.base import Estimator
    else:
        from transmogrifai_tpu_torch.dataset import Dataset
        from transmogrifai_tpu_torch.features import FeatureBuilder
        from transmogrifai_tpu_torch.stages.base import Estimator
    names = names or [f"f{i}" for i in range(len(cols))]
    feats = [getattr(FeatureBuilder, t)(nm).as_predictor()
             for t, nm in zip(type_names, names)]
    stage.set_input(*feats)
    out = stage.get_output()
    ds = Dataset.of(dict(zip(names, cols)))
    model = stage.fit(ds) if isinstance(stage, Estimator) else stage
    return model.transform(ds)[out.name], model


def saved_entry(pkg: str, stage) -> tuple[dict, dict]:
    """(manifest entry through JSON, arrays) of a fitted ``stage`` as
    ``pkg``'s saver writes them."""
    import json

    import numpy as np

    if pkg == "jax":
        from transmogrifai_tpu.workflow import persistence as P
    else:
        from transmogrifai_tpu_torch.workflow import persistence as P
    arrays: dict = {}
    entry = P.stage_to_entry(stage.uid, stage, arrays)
    entry = json.loads(json.dumps(entry, default=P._json_default))
    prefix = f"{stage.uid}__"
    return entry, {k[len(prefix):]: np.asarray(v) for k, v in arrays.items()}


def load_entry(pkg: str, entry: dict, arrays: dict, inputs: tuple):
    """The stage ``pkg``'s loader builds from a saved ``entry``, wired to
    ``inputs`` (features of ``pkg``) as the loader wires it."""
    if pkg == "jax":
        from transmogrifai_tpu.workflow.persistence import construct_stage
    else:
        from transmogrifai_tpu_torch.workflow.persistence import construct_stage
    stage = construct_stage(entry["class"], entry["params"], arrays)
    stage.uid = entry["uid"]
    stage.operation_name = entry["operationName"]
    stage.metadata = entry.get("metadata", {})
    stage.input_features = tuple(inputs)
    stage._fixed_output_name = entry["outputName"]
    stage.get_output()
    return stage


def same_columns(a, b) -> None:
    """Two columns (either package's) hold EQUAL values, masks, metadata
    and prediction arrays; NaN equals NaN."""
    import numpy as np

    assert type(a).__name__ == type(b).__name__
    assert a.feature_type.__name__ == b.feature_type.__name__
    if hasattr(a, "prediction"):
        for k in ("prediction", "probability", "raw"):
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None), k
            if x is not None:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        return
    va, vb = a.values, b.values
    if isinstance(va, np.ndarray) and va.dtype != object:
        assert va.dtype == vb.dtype
        np.testing.assert_array_equal(va, vb)
    else:
        assert values(a) == values(b)
    if hasattr(a, "mask"):
        np.testing.assert_array_equal(a.mask, b.mask)
    if getattr(a, "metadata", None) is not None or \
            getattr(b, "metadata", None) is not None:
        assert metas(a) == metas(b)
