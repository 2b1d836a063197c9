"""Run one feature stage in both packages on the same seeded columns, for
the port's per-type tests (``tests/test_torch_dates_phone.py``,
``tests/test_torch_lists_maps.py``).

``columns(make, n, seed)`` draws ``make(testkit)``'s generator with each
package's testkit (the same numpy draws, so the same rows);
``run(pkg, stage, type_name, cols)`` wires ``stage`` to features of
``type_name`` named ``f0``, ``f1``, ... over ``cols``, fits it if it is an
estimator, and returns its output column; ``metas(col)`` is a vector
column's metadata as plain records.
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
    if pkg == "jax":
        from transmogrifai_tpu.dataset import Dataset
        from transmogrifai_tpu.features import FeatureBuilder
        from transmogrifai_tpu.stages.base import Estimator
    else:
        from transmogrifai_tpu_torch.dataset import Dataset
        from transmogrifai_tpu_torch.features import FeatureBuilder
        from transmogrifai_tpu_torch.stages.base import Estimator
    feats = [getattr(FeatureBuilder, type_name)(f"f{i}").as_predictor()
             for i in range(len(cols))]
    stage.set_input(*feats)
    ds = Dataset.of({f"f{i}": c for i, c in enumerate(cols)})
    model = stage.fit(ds) if isinstance(stage, Estimator) else stage
    return model.transform(ds)[stage.output_name], model


def metas(col) -> list[dict]:
    return [{k: (list(v) if isinstance(v, tuple) else v)
             for k, v in dataclasses.asdict(c).items()}
            for c in col.metadata.columns]


def values(col) -> list:
    """A column's rows as comparable plain values (sets sorted)."""
    return [sorted(v) if isinstance(v, (set, frozenset)) else v
            for v in col.to_list()]
