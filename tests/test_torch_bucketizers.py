"""Bucketizers: the port's ``ops/bucketizers.py`` (``NumericBucketizer``,
``DecisionTreeNumericBucketizer``, ``DropIndicesByTransformer``) and
``ops/maps.py``'s ``DecisionTreeNumericMapBucketizer`` against the JAX
package's on the CPU.

Host numpy in float64 in both packages, so the tolerance is EQUALITY:
``_tree_splits`` on seeded arrays (ties, a multiclass label, too few rows,
one class); each stage's vectors, metadata and fitted state (splits,
``shouldSplit``, the keys) over seeded columns with empty rows, NaN and
values on the split edges, including the no-useful-split case; and each
fitted stage saved by either package, loaded by the other, scoring EQUAL.
``DropIndicesByTransformer`` holds a module-level predicate
(``dsl_flow.is_null_indicator``), pickled into the saved entry.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "torch_fixtures"))

import dsl_flow as D  # noqa: E402
import port_pairs as PP  # noqa: E402

from transmogrifai_tpu.ops.bucketizers import _tree_splits as j_tree_splits  # noqa: E402

from transmogrifai_tpu_torch.ops.bucketizers import _tree_splits  # noqa: E402

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

N = 300


def _mods(pkg: str):
    import importlib

    root = "transmogrifai_tpu" if pkg == "jax" else "transmogrifai_tpu_torch"
    return {name: importlib.import_module(f"{root}.{name}") for name in (
        "types", "types.columns", "ops.bucketizers", "ops.maps", "utils.uid")}


def _label(kind: str, x: np.ndarray, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "binary":
        return ((x + rng.normal(0.0, 0.7, len(x))) > 0.3).astype(np.float64)
    if kind == "multiclass":
        return np.digitize(x + rng.normal(0.0, 0.4, len(x)),
                           [-1.0, 0.0, 1.0]).astype(np.float64)
    if kind == "noise":  # no split gains past min_info_gain
        return np.zeros(len(x))
    raise KeyError(kind)


def columns(pkg: str, label_kind: str, seed: int = 3, nan: bool = True):
    """(label, numeric, map) columns of ``pkg``: the numeric one with
    empty rows, values on the fixed splits' edges and, where ``nan``,
    present NaN (a present NaN makes every tree candidate NaN: no split,
    in both packages)."""
    M = _mods(pkg)
    T, C = M["types"], M["types.columns"]
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.2, N)
    x[::25] = 0.0
    x[1::31] = 2.0
    label = _label(label_kind, np.nan_to_num(x), seed + 1)
    if nan:
        x[2::37] = np.nan
    mask = rng.random(N) > 0.15
    num = C.NumericColumn(T.Real, np.where(mask, x, 0.0), mask)
    maps = []
    for i in range(N):
        m = {}
        if rng.random() > 0.2:
            m["Home"] = float(np.round(x[i] if np.isfinite(x[i]) else 0.0, 4))
        if rng.random() > 0.3:
            m["work"] = float(np.round(rng.normal(), 4))
        if rng.random() > 0.9:
            m["rare"] = float(rng.normal())
        maps.append(m)
    return (C.NumericColumn(T.RealNN, label, np.ones(N, bool)), num,
            C.column_from_values(T.RealMap, maps))


# ------------------------------------------------------------ _tree_splits
TREE_CASES = {
    "binary": dict(kind="binary"),
    "multiclass": dict(kind="multiclass"),
    "ties": dict(kind="binary", ties=True),
    "depth2": dict(kind="multiclass", max_depth=2),
    "gain": dict(kind="binary", min_info_gain=0.05),
    "one_class": dict(kind="noise"),
    "too_few_rows": dict(kind="binary", rows=1),
}


@pytest.mark.parametrize("name", sorted(TREE_CASES))
def test_tree_splits_equal_the_reference(name):
    case = dict(TREE_CASES[name])
    rng = np.random.default_rng(len(name))
    n = case.pop("rows", 500)
    x = rng.normal(0.0, 1.0, n)
    if case.pop("ties", False):
        x = np.round(x * 2.0) / 2.0
    y = _label(case.pop("kind"), x, 9)
    got = _tree_splits(x, y, **case)
    want = j_tree_splits(x, y, **case)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- stages
CASES = [
    ("numeric_default", "NumericBucketizer", {}, "num"),
    ("numeric_splits", "NumericBucketizer",
     {"splits": [-1.0, 0.0, 1.0, 2.0], "track_invalid": True}, "num"),
    ("numeric_labels_no_nulls", "NumericBucketizer",
     {"splits": [-np.inf, 0.0, 2.0, np.inf], "track_nulls": False,
      "bucket_labels": ["low", "mid", "high"]}, "num"),
    ("tree_binary", "DecisionTreeNumericBucketizer", {}, "binary"),
    ("tree_nan", "DecisionTreeNumericBucketizer", {}, "binary_nan"),
    ("tree_multiclass", "DecisionTreeNumericBucketizer", {"max_depth": 3},
     "multiclass"),
    ("tree_no_split", "DecisionTreeNumericBucketizer", {}, "noise"),
    ("tree_no_split_no_nulls", "DecisionTreeNumericBucketizer",
     {"track_nulls": False}, "noise"),
    ("tree_untracked", "DecisionTreeNumericBucketizer",
     {"track_nulls": False, "track_invalid": False}, "binary"),
    ("map_binary", "DecisionTreeNumericMapBucketizer", {}, "map_binary"),
    ("map_multiclass", "DecisionTreeNumericMapBucketizer",
     {"max_depth": 2, "clean_keys": False}, "map_multiclass"),
    ("map_no_split", "DecisionTreeNumericMapBucketizer",
     {"track_invalid": False}, "map_noise"),
]


def _columns(pkg: str, inputs: str):
    kind = inputs.replace("map_", "")
    if kind == "num":
        return columns(pkg, "binary")
    if kind.endswith("_nan"):
        return columns(pkg, kind[:-4])
    return columns(pkg, kind, nan=False)


def _run(pkg: str, cls: str, kwargs: dict, inputs: str):
    M = _mods(pkg)
    M["utils.uid"].reset()
    module = M["ops.maps"] if "Map" in cls else M["ops.bucketizers"]
    stage = getattr(module, cls)(**kwargs)
    label, num, maps = _columns(pkg, inputs)
    if inputs == "num":
        return PP.run_typed(pkg, stage, ["Real"], [num])
    if inputs.startswith("map"):
        return PP.run_typed(pkg, stage, ["RealNN", "RealMap", "RealMap"],
                            [label, maps, maps], ["label", "m0", "m1"])
    return PP.run_typed(pkg, stage, ["RealNN", "Real"], [label, num],
                        ["label", "x"])


def _state(model) -> str:
    arrays = {k: np.asarray(v).tolist()
              for k, v in getattr(model, "get_arrays", dict)().items()}
    return json.dumps([type(model).__name__, model.get_params(), arrays,
                       model.metadata], sort_keys=True)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bucketizer_equals_the_reference(case):
    _, cls, kwargs, inputs = case
    jout, jmodel = _run("jax", cls, kwargs, inputs)
    pout, pmodel = _run("port", cls, kwargs, inputs)
    PP.same_columns(pout, jout)
    assert _state(pmodel) == _state(jmodel)
    if "no_split" in case[0] or case[0] == "tree_nan":
        should = pmodel.should_split
        assert not (any(map(any, should)) if isinstance(should, list)
                    else should)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_saved_bucketizer_loads_in_the_other_package(case):
    _, cls, kwargs, inputs = case
    jout, jmodel = _run("jax", cls, kwargs, inputs)
    pout, pmodel = _run("port", cls, kwargs, inputs)
    for src, dst, model, other, want in (("jax", "port", jmodel, pmodel, jout),
                                         ("port", "jax", pmodel, jmodel, pout)):
        entry, arrays = PP.saved_entry(src, model)
        loaded = PP.load_entry(dst, entry, arrays, other.input_features)
        assert _state(loaded) == _state(model)
        label, num, maps = _columns(dst, inputs)
        cols = ([num] if inputs == "num" else [label, maps, maps]
                if inputs.startswith("map") else [label, num])
        PP.same_columns(loaded.transform_columns(*cols, num_rows=N), want)


def test_tree_splits_differ_between_labels():
    """The binary and the multiclass label give different splits, and the
    tree bucketizer tracks the invalid values only where it splits."""
    _, bin_model = _run("port", "DecisionTreeNumericBucketizer", {}, "binary")
    _, multi_model = _run("port", "DecisionTreeNumericBucketizer", {},
                          "multiclass")
    _, none_model = _run("port", "DecisionTreeNumericBucketizer", {}, "noise")
    assert bin_model.should_split and multi_model.should_split
    assert not np.array_equal(bin_model.splits, multi_model.splits)
    assert bin_model.track_invalid and not none_model.track_invalid
    assert none_model.splits.tolist() == [-np.inf, np.inf]


@pytest.mark.parametrize("source", ["numeric_splits", "tree_binary",
                                    "map_binary"])
def test_drop_indices_by_pickled_predicate(source):
    """``DropIndicesByTransformer(dsl_flow.is_null_indicator)`` over a
    bucketizer's vector: the null indicators go, EQUAL in both packages,
    and the saved predicate loads in the other package."""
    _, cls, kwargs, inputs = next(c for c in CASES if c[0] == source)
    outs = {}
    for pkg in ("jax", "port"):
        vec, _ = _run(pkg, cls, kwargs, inputs)
        stage = getattr(_mods(pkg)["ops.bucketizers"],
                        "DropIndicesByTransformer")(D.is_null_indicator)
        outs[pkg] = PP.run_typed(pkg, stage, ["OPVector"], [vec])
    (jout, jstage), (pout, pstage) = outs["jax"], outs["port"]
    PP.same_columns(pout, jout)
    assert not any(m.indicator_value == "NullIndicatorValue"
                   for m in pout.metadata.columns)
    assert [m.index for m in pout.metadata.columns] == list(
        range(pout.values.shape[1]))
    for src, dst, stage, other in (("jax", "port", jstage, pstage),
                                   ("port", "jax", pstage, jstage)):
        entry, arrays = PP.saved_entry(src, stage)
        loaded = PP.load_entry(dst, entry, arrays, other.input_features)
        assert loaded.match_fn is D.is_null_indicator
        vec, _ = _run(dst, cls, kwargs, inputs)
        PP.same_columns(loaded.transform_columns(vec, num_rows=N), jout)


def test_drop_indices_refuses_a_lambda():
    from transmogrifai_tpu_torch.ops.bucketizers import DropIndicesByTransformer

    stage = DropIndicesByTransformer(lambda m: True)
    with pytest.raises(ValueError, match="not serializable"):
        stage.get_params()
