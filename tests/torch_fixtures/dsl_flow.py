"""The DSL flows: the feature stages off the default dispatch and the raw
feature filter, built with numpy alone so that both packages, the fixture
generator and ``chip_smoke.py`` build the same rows without JAX.

``dsl_table(n, seed, score=False)`` is ``fit_side_tables.wide_table(n,
seed)`` (1423 vector columns) with four more columns:

* ``r_sparse``: Real, about 99.95% empty (blocklisted for its fill rate);
* ``r_leak``: Real ``normal(0, 1)``, empty where ``label`` is 1, with about
  1% of the rows flipped (blocklisted for its null indicator's correlation
  with the label);
* ``r_drift``: Real ``normal(0, 1)``, or ``normal(8, 1)`` where ``score``
  (the scoring rows): blocklisted for its JS divergence. It also feeds a
  fixed-arity stage (``r_drift * r7``), which dies with it;
* ``m_real``: RealMap over ``home`` / ``work`` / ``other``, each key empty
  in about 20% of the rows, ``home`` tied to the label.

``build_f1(pkg, ds, score_ds, grids, device)`` is flow F1 (``dsl_rff``):
the derived features ``(r3 - r4) / (i0 + 1)``,
``r0.fill_missing_with_mean().z_normalize()``, ``r1.log()``, ``r5.sqrt()``,
``r2.bucketize(splits=SPLITS)``, ``r6.auto_bucketize(label)``,
``m_real.auto_bucketize(label)``,
``r8.fill_missing_with_mean().calibrate_percentile()`` and ``r_drift * r7``;
``transmogrify`` over the raw predictors and the derived features;
``sanity_check``; the default tree candidates of
``BinaryClassificationModelSelector`` (at ``all_types``' ``RF_GRID`` /
``XGB_GRID`` where ``grids``); ``Workflow().with_raw_feature_filter(
score_dataset=score_ds)``. Its plan holds bucketizer members, so the fused
planner refuses it.

``build_f2(pkg, ds, grids, device)`` is flow F2 (``dsl_fused``):
``fit_side_tables.wide_hash_table``'s predictors and the arithmetic, scaler
and log features above, with no bucketizer: the plan fuses, those stages
its host prefix.

``is_null_indicator`` and the predicates below are module-level, so a stage
that holds one saves and loads in both packages (the pickle names
``dsl_flow.<name>``; put this directory on ``sys.path``).
"""
from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import fit_side_tables as FT  # noqa: E402

ROWS = FT.WIDE_ROWS
SEED = FT.WIDE_SEED
#: the CPU tests' rows (the table's first rows) and fresh rows
SMALL_ROWS = 4096
FRESH_ROWS, FRESH_SEED = 1000, 77
MAP_KEYS = ("home", "work", "other")
SPLITS = (-np.inf, -1.0, 0.0, 1.0, 2.0, np.inf)
SPARSE_FILL = 0.0005
LEAK_FLIP = 0.01
DRIFT_MEAN = 8.0


def dsl_table(n: int = ROWS, seed: int = SEED, score: bool = False):
    """(schema, columns) of ``wide_table(n, seed)`` with ``r_sparse``,
    ``r_leak``, ``r_drift`` and ``m_real``; ``score`` draws ``r_drift``
    around ``DRIFT_MEAN``."""
    schema, columns = FT.wide_table(n, seed)
    rng = np.random.default_rng(seed + 7919)
    label = np.asarray(columns["label"], dtype=float)
    sparse = rng.normal(5.0, 2.0, n)
    present = rng.random(n) < SPARSE_FILL
    schema["r_sparse"] = "Real"
    columns["r_sparse"] = [float(v) if p else None
                           for v, p in zip(sparse.tolist(), present.tolist())]
    leak = rng.normal(0.0, 1.0, n)
    flip = rng.random(n) < LEAK_FLIP
    empty = (label == 1.0) ^ flip
    schema["r_leak"] = "Real"
    columns["r_leak"] = [None if e else float(v)
                         for v, e in zip(leak.tolist(), empty.tolist())]
    drift = rng.normal(DRIFT_MEAN if score else 0.0, 1.0, n)
    schema["r_drift"] = "Real"
    columns["r_drift"] = drift.tolist()
    vals = {k: rng.normal(0.0, 1.0, n) for k in MAP_KEYS}
    vals["home"] = vals["home"] + 1.5 * label
    gone = {k: rng.random(n) < 0.2 for k in MAP_KEYS}
    schema["m_real"] = "RealMap"
    columns["m_real"] = [
        {k: float(vals[k][i]) for k in MAP_KEYS if not gone[k][i]}
        for i in range(n)
    ]
    return schema, columns


def dataset(pkg: str, schema: dict, columns: dict):
    """The table as ``pkg``'s ("jax" or "port") Dataset."""
    if pkg == "jax":
        from transmogrifai_tpu import types as T
        from transmogrifai_tpu.dataset import Dataset
        from transmogrifai_tpu.types.columns import column_from_values
    else:
        from transmogrifai_tpu_torch import types as T
        from transmogrifai_tpu_torch.dataset import Dataset
        from transmogrifai_tpu_torch.types.columns import column_from_values
    return Dataset.of({
        k: column_from_values(T.feature_type_by_name(schema[k]), v)
        for k, v in columns.items()})


def tables(pkg: str, n: int = ROWS, seed: int = SEED, first: int | None = None):
    """(training Dataset, scoring Dataset) of F1: ``dsl_table(n, seed)``
    and ``dsl_table(n, seed + 1, score=True)``, each cut to its ``first``
    rows where given."""
    out = []
    for s, score in ((seed, False), (seed + 1, True)):
        schema, columns = dsl_table(n, s, score)
        if first is not None:
            columns = {k: v[:first] for k, v in columns.items()}
        out.append(dataset(pkg, schema, columns))
    return tuple(out)


def hash_tables(pkg: str, n: int = ROWS, seed: int = SEED,
                first: int | None = None):
    """F2's training Dataset: ``wide_hash_table(n, seed)``, cut to its
    ``first`` rows where given."""
    schema, columns = FT.wide_hash_table(n, seed)
    if first is not None:
        columns = {k: v[:first] for k, v in columns.items()}
    return dataset(pkg, schema, columns)


def fresh_rows(table, n: int = FRESH_ROWS, seed: int = FRESH_SEED) -> list:
    """``n`` fresh rows (dicts without the label) of ``table``
    (``dsl_table`` or ``fit_side_tables.wide_hash_table``)."""
    schema, columns = table(n, seed)
    return [{k: columns[k][i] for k in schema if k != "label"}
            for i in range(n)]


def _api(pkg: str):
    """The modules a flow needs, of ``pkg``."""
    import importlib

    root = "transmogrifai_tpu" if pkg == "jax" else "transmogrifai_tpu_torch"
    importlib.import_module(f"{root}.dsl")
    mods = {name: importlib.import_module(f"{root}.{name}") for name in (
        "features", "models.gbdt", "ops.defaults", "selector",
        "selector.model_selector", "utils.uid", "workflow.workflow")}
    mods["transmogrify"] = importlib.import_module(
        f"{root}.ops" if pkg == "jax" else f"{root}.ops.transmogrify"
    ).transmogrify
    return mods


def derived_numeric(f: dict) -> list:
    """The arithmetic, scaler and log features over ``f`` (features by
    name), in order: ratio, z-score, log, sqrt."""
    ratio = (f["r3"] - f["r4"]) / (f["i0"] + 1)
    zscore = f["r0"].fill_missing_with_mean().z_normalize()
    return [ratio, zscore, f["r1"].log(), f["r5"].sqrt()]


def _selector(api, label, checked, grids: bool, dev: dict):
    import all_types as AT

    gbdt = api["models.gbdt"]
    if grids:
        models = [(gbdt.RandomForestClassifier(**dev), AT.RF_GRID),
                  (gbdt.XGBoostClassifier(**dev), AT.XGB_GRID)]
    else:
        models = api["selector.model_selector"].make_candidates(
            "BinaryClassification",
            ("OpRandomForestClassifier", "OpXGBoostClassifier"), **dev)
    selector = api["selector"].BinaryClassificationModelSelector(models=models)
    return selector, selector.set_input(label, checked).get_output()


def _label_aware(feature):
    """``feature`` with its stage declaring input 0 (the label) as
    supervision, as the scalar ``DecisionTreeNumericBucketizer`` declares
    it. The JAX package's ``DecisionTreeNumericMapBucketizer`` does not, so
    its preflight refuses the label in the vector's lineage (TPA003)."""
    feature.origin_stage.label_inputs = (0,)
    return feature


def build_f1(pkg: str, ds, score_ds, grids: bool = True, device=None):
    """F1 (``dsl_rff``) of ``pkg``, with the uid counter reset first; the
    JAX package's on one device. Returns a dict: ``workflow``, ``pred``,
    ``checked``, ``vector``, ``selector``, ``derived`` (name -> feature)."""
    api = _api(pkg)
    dev = {} if pkg == "jax" else {"device": device}
    api["utils.uid"].reset()
    label, preds = api["features"].from_dataset(ds, response="label")
    f = {p.name: p for p in preds}
    ratio, zscore, log1, sqrt5 = derived_numeric(f)
    derived = {
        "ratio": ratio, "zscore": zscore, "log": log1, "sqrt": sqrt5,
        "bucketized": f["r2"].bucketize(splits=SPLITS),
        "auto": f["r6"].auto_bucketize(label),
        "auto_map": _label_aware(f["m_real"].auto_bucketize(label)),
        "percentile": f["r8"].fill_missing_with_mean().calibrate_percentile(),
        "drift_product": f["r_drift"] * f["r7"],
    }
    vec = api["transmogrify"](list(preds) + list(derived.values()))
    checked = label.sanity_check(vec, remove_bad_features=True, **dev)
    selector, pred = _selector(api, label, checked, grids, dev)
    wf = (api["workflow.workflow"].Workflow().set_result_features(pred)
          .set_input_dataset(ds).with_raw_feature_filter(score_dataset=score_ds))
    if pkg == "jax":
        wf = wf.set_parallelism(None)
    return {"workflow": wf, "pred": pred, "checked": checked, "vector": vec,
            "selector": selector, "derived": derived}


def build_f2(pkg: str, ds, grids: bool = True, device=None):
    """F2 (``dsl_fused``) of ``pkg``: the dict of ``build_f1`` (no filter,
    ``derived`` the four numeric features)."""
    api = _api(pkg)
    dev = {} if pkg == "jax" else {"device": device}
    api["utils.uid"].reset()
    label, preds = api["features"].from_dataset(ds, response="label")
    f = {p.name: p for p in preds}
    derived = dict(zip(("ratio", "zscore", "log", "sqrt"), derived_numeric(f)))
    vec = api["transmogrify"](list(preds) + list(derived.values()))
    checked = label.sanity_check(vec, remove_bad_features=True, **dev)
    selector, pred = _selector(api, label, checked, grids, dev)
    wf = api["workflow.workflow"].Workflow().set_result_features(
        pred).set_input_dataset(ds)
    if pkg == "jax":
        wf = wf.set_parallelism(None)
    return {"workflow": wf, "pred": pred, "checked": checked, "vector": vec,
            "selector": selector, "derived": derived}


#: the raw features F1's filter must blocklist, and the derived stage that
#: dies with ``r_drift``
BLOCKED_RAW = ("r_drift", "r_leak", "r_sparse")


# ------------------------------------------- module-level callables, pickled
def is_null_indicator(meta) -> bool:
    """``DropIndicesByTransformer``'s predicate: drop null indicators."""
    return meta.indicator_value == "NullIndicatorValue"


def is_positive(v) -> bool:
    return v is not None and v > 0


def is_long_text(v) -> bool:
    return v is not None and len(v) > 3


def above_half(v) -> bool:
    return v > 0.5
