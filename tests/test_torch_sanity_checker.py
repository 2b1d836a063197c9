"""The port's SanityChecker (``transmogrifai_tpu_torch/prep/sanity_checker.py``)
against the JAX package's on the scenarios of ``tests/test_sanity_checker.py``
(the mini BadFeatureZoo), on the CPU (``device="cpu"``): the same seeded
vectors and labels give the same keep-set, drop reasons and summary.

Tolerances: keep-sets, reasons, names, parents, Cramér's V and the row
and drop counts are equal; the summary's means, variances and label
correlations are within ``F64_ATOL`` = 1e-12 (the float64 route: torch and
numpy reduce in different orders). The full-width table of the fit-side
fixture (16384 x 1423, the float32 route) is held to the keep-set and
reasons the JAX package stored, its label correlations within ``F32_ATOL``
= 2e-5 and its means and variances within 2e-5 relative (plus 2e-5 and
1e-12 absolute).
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import transmogrifai_tpu.types as T
from transmogrifai_tpu.dataset import Dataset
from transmogrifai_tpu.features import FeatureBuilder as JFeatureBuilder
from transmogrifai_tpu.prep import SanityChecker as JSanityChecker
from transmogrifai_tpu.stages.metadata import ColumnMeta as JColumnMeta
from transmogrifai_tpu.stages.metadata import VectorMetadata as JVectorMetadata
from transmogrifai_tpu.types.columns import NumericColumn, VectorColumn

from transmogrifai_tpu_torch import types as PT
from transmogrifai_tpu_torch.dataset import Dataset as PDataset
from transmogrifai_tpu_torch.features import FeatureBuilder, from_dataset
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.prep import SanityChecker
from transmogrifai_tpu_torch.stages.metadata import ColumnMeta, VectorMetadata
from transmogrifai_tpu_torch.types import columns as PCOL
from transmogrifai_tpu_torch.workflow.fit import fit_and_transform_dag

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

F64_ATOL = 1e-12
F32_ATOL = 2e-5
HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "torch_fit_side")
OTHER = "OTHER"


def _col(parent, **kw):
    return {"parent_names": (parent,), "parent_type": "Real", **kw}


def _pair(x, metas, y):
    """The same (label, vector) dataset in both packages."""
    x = np.asarray(x, dtype=np.float32)
    y = np.asarray(y, dtype=np.float64)
    jmeta = JVectorMetadata("vec", tuple(
        JColumnMeta(**{**m, "index": i}) for i, m in enumerate(metas)))
    pmeta = VectorMetadata("vec", tuple(
        ColumnMeta(**{**m, "index": i}) for i, m in enumerate(metas)))
    jds = Dataset.of({
        "label": NumericColumn(T.RealNN, y, np.ones(len(y), bool)),
        "vec": VectorColumn(T.OPVector, x, jmeta),
    })
    pds = PDataset.of({
        "label": PCOL.NumericColumn(PT.RealNN, y.copy(), np.ones(len(y), bool)),
        "vec": PCOL.VectorColumn(PT.OPVector, x.copy(), pmeta),
    })
    return jds, pds


def _fit_both(jds, pds, **kw):
    jest = JSanityChecker(**kw).set_input(
        JFeatureBuilder.RealNN("label").as_response(),
        JFeatureBuilder.OPVector("vec").as_predictor())
    pest = SanityChecker(device="cpu", **kw).set_input(
        FeatureBuilder.RealNN("label").as_response(),
        FeatureBuilder.OPVector("vec").as_predictor())
    jm, pm = jest.fit(jds), pest.fit(pds)
    js = jest.metadata["sanityCheckerSummary"]
    ps = pest.metadata["sanityCheckerSummary"]
    assert list(pm.indices_to_keep) == list(jm.indices_to_keep)
    assert {k: v for k, v in ps.items() if k != "columns"} == {
        k: v for k, v in js.items() if k != "columns"}
    for jc, pc in zip(js["columns"], ps["columns"], strict=True):
        for key in ("mean", "variance", "corr_label"):
            assert pc.pop(key) == pytest.approx(jc.pop(key), abs=F64_ATOL,
                                                nan_ok=True)
        assert pc == jc
    jout = jm.transform(jds)[jest.output_name]
    pout = pm.transform(pds)[pest.output_name]
    np.testing.assert_array_equal(pout.values, np.asarray(jout.values))
    if jout.metadata is None:
        assert pout.metadata is None
    else:
        assert [c.__dict__ for c in pout.metadata.columns] == [
            c.__dict__ for c in jout.metadata.columns]
    return list(pm.indices_to_keep), ps


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def test_leaky_label_copy_dropped(rng):
    y = rng.integers(0, 2, 400).astype(float)
    keep, summary = _fit_both(*_pair(np.stack([y, rng.normal(size=400)], 1),
                                     [_col("leak"), _col("good")], y),
                              remove_bad_features=True)
    assert keep == [1]
    dropped = [c for c in summary["columns"] if c["dropped"]][0]
    assert any("corrLabel" in r for r in dropped["reasons"])


def test_constant_column_dropped(rng):
    y = rng.integers(0, 2, 300).astype(float)
    x = np.stack([np.full(300, 7.0), rng.normal(size=300)], axis=1)
    assert _fit_both(*_pair(x, [_col("const"), _col("ok")], y),
                     remove_bad_features=True)[0] == [1]


def test_duplicate_feature_drops_later(rng):
    y = rng.integers(0, 2, 300).astype(float)
    a = rng.normal(size=300)
    x = np.stack([a, a.copy(), rng.normal(size=300)], axis=1)
    assert _fit_both(*_pair(x, [_col("a"), _col("a2"), _col("b")], y),
                     remove_bad_features=True)[0] == [0, 2]


def test_categorical_leak_drops_whole_group(rng):
    n = 400
    y = rng.integers(0, 2, n).astype(float)
    x = np.stack([(y == 0), (y == 1), np.zeros(n), rng.normal(size=n)], 1)
    metas = [
        _col("cat", grouping="cat", indicator_value="A", parent_type="PickList"),
        _col("cat", grouping="cat", indicator_value="B", parent_type="PickList"),
        _col("cat", grouping="cat", indicator_value=OTHER, parent_type="PickList"),
        _col("good"),
    ]
    assert _fit_both(*_pair(x, metas, y), remove_bad_features=True)[0] == [3]


def test_good_features_kept(rng):
    n = 500
    y = rng.integers(0, 2, n).astype(float)
    x = np.stack([y * 0.4 + rng.normal(size=n), rng.normal(size=n)], axis=1)
    assert _fit_both(*_pair(x, [_col("f1"), _col("f2")], y),
                     remove_bad_features=True)[0] == [0, 1]


def test_remove_bad_features_false_keeps_all(rng):
    y = rng.integers(0, 2, 200).astype(float)
    x = np.stack([y, rng.normal(size=200)], axis=1)
    jds, pds = _pair(x, [_col("leak"), _col("good")], y)
    keep, summary = _fit_both(jds, pds, remove_bad_features=False)
    assert keep == [1]
    assert summary["numDropped"] == 1


def test_sample_fraction_clamps():
    for kw, total in (({}, 500), ({}, 4_000_000), ({"check_sample": 0.0001}, 100_000),
                      ({"check_sample": 0.5}, 100_000)):
        assert (SanityChecker(**kw)._sample_fraction(total)
                == JSanityChecker(**kw)._sample_fraction(total))


def test_sampled_check_is_deterministic_and_bounded(rng):
    n = 5000
    y = rng.integers(0, 2, n).astype(float)
    x = np.stack([y + rng.normal(scale=1e-4, size=n), rng.normal(size=n)], 1)
    jds, pds = _pair(x, [_col("leak"), _col("good")], y)
    kw = dict(remove_bad_features=True, check_sample=0.1,
              sample_lower_limit=100, sample_upper_limit=1000)
    keep, summary = _fit_both(jds, pds, **kw)
    assert summary["numRows"] == 500
    assert keep == [1]


def _hash_block_with_leaky_pivot(rng, n=400):
    y = rng.integers(0, 2, n).astype(float)
    x = np.stack([(y == 0), rng.normal(size=n), rng.normal(size=n),
                  rng.normal(size=n)], axis=1)
    metas = [
        _col("desc", grouping="desc", indicator_value="A", parent_type="Text"),
        _col("desc", parent_type="Text", descriptor_value="hash_0"),
        _col("desc", parent_type="Text", descriptor_value="hash_1"),
        _col("good"),
    ]
    return _pair(x, metas, y)


@pytest.mark.parametrize("protect,want", [(False, [3]), (True, [1, 2, 3])])
def test_text_shared_hash_protection(rng, protect, want):
    assert _fit_both(*_hash_block_with_leaky_pivot(rng), remove_bad_features=True,
                     protect_text_shared_hash=protect)[0] == want


@pytest.mark.parametrize("exclusion,want", [("HashedText", [0, 1]),
                                            ("NoExclusion", [1])])
def test_correlation_exclusion_hashed_text(rng, exclusion, want):
    n = 400
    y = rng.integers(0, 2, n).astype(float)
    x = np.stack([y + rng.normal(scale=1e-4, size=n), rng.normal(size=n)], 1)
    metas = [_col("desc", parent_type="Text", descriptor_value="hash_0"),
             _col("good")]
    assert _fit_both(*_pair(x, metas, y), remove_bad_features=True,
                     correlation_exclusion=exclusion)[0] == want


def test_rule_confidence_and_spearman_and_continuous_label(rng):
    n = 600
    y = rng.integers(0, 3, n).astype(float)
    cat = rng.integers(0, 4, n)
    cat[y == 2] = 0  # category 0 predicts class 2 often
    x = np.stack([cat == 0, cat == 1, cat == 2, cat == 3,
                  rng.normal(size=n), rng.integers(0, 5, n)], 1)
    metas = [_col("c", grouping="c", indicator_value=v, parent_type="PickList")
             for v in ("a", "b", "c", OTHER)] + [_col("r"), _col("i")]
    jds, pds = _pair(x, metas, y)
    _fit_both(jds, pds, remove_bad_features=True, max_rule_confidence=0.5,
              min_required_rule_support=0.1)
    _fit_both(jds, pds, remove_bad_features=True, correlation_type="spearman")
    jds, pds = _pair(x, metas, rng.normal(size=n))  # no Cramér's V
    keep, summary = _fit_both(jds, pds, remove_bad_features=True)
    assert all(c["cramers_v"] is None for c in summary["columns"])


def test_without_metadata_columns_are_named_by_position(rng):
    y = rng.integers(0, 2, 300).astype(float)
    x = np.stack([y, rng.normal(size=300)], 1).astype(np.float32)
    jds, pds = _pair(x, [_col("a"), _col("b")], y)
    jds.columns["vec"].metadata = None
    pds.columns["vec"].metadata = None
    keep, summary = _fit_both(jds, pds, remove_bad_features=True)
    assert [c["name"] for c in summary["columns"]] == ["col_0", "col_1"]


def _wide_port():
    spec = importlib.util.spec_from_file_location(
        "fit_side_tables", os.path.join(HERE, "torch_fixtures", "fit_side_tables.py"))
    tables = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tables)
    schema, columns = tables.wide_table()
    return PDataset.of({
        k: PCOL.column_from_values(PT.feature_type_by_name(schema[k]), v)
        for k, v in columns.items()
    })


def test_full_width_table_matches_the_stored_reference():
    """16384 rows x 1423 vector columns: the float32 route. The port's
    keep-set and reasons equal the ones the JAX package stored; its
    statistics are within F32_ATOL of the stored ones."""
    ds = _wide_port()
    resp, preds = from_dataset(ds, response="label")
    vec = transmogrify(preds)
    checked = resp.sanity_check(vec, remove_bad_features=True, device="cpu")
    data, fitted = fit_and_transform_dag(ds, [checked])
    summary = fitted[checked.origin_stage.uid].metadata["sanityCheckerSummary"]
    with open(os.path.join(FIXTURE, "wide.json")) as fh:
        want = json.load(fh)
    arrays = np.load(os.path.join(FIXTURE, "wide.npz"))
    cols = summary["columns"]
    assert data[vec.name].values.shape == (16384, 1423)
    assert [c["name"] for c in cols] == want["names"]
    assert [j for j, c in enumerate(cols) if not c["dropped"]] == want["keep"]
    assert {str(j): c["reasons"] for j, c in enumerate(cols)
            if c["dropped"]} == want["reasons"]
    np.testing.assert_allclose([c["corr_label"] for c in cols],
                               arrays["corr_label"], rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose([c["mean"] for c in cols], arrays["mean"],
                               rtol=F32_ATOL, atol=F32_ATOL)
    np.testing.assert_allclose([c["variance"] for c in cols], arrays["variance"],
                               rtol=F32_ATOL, atol=1e-12)


def test_sanity_check_on_the_card():
    """The SanityChecker's statistics on the card: the flagship fixture's
    keep-set and reasons equal the CPU's, statistics within F64_ATOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(3)
    y = rng.integers(0, 2, 891).astype(float)
    x = np.stack([y + rng.normal(scale=0.01, size=891), rng.normal(size=891),
                  (y == 1) & (rng.random(891) < 0.5), np.zeros(891)], 1)
    metas = [_col("a"), _col("b"),
             _col("c", grouping="c", indicator_value="v", parent_type="PickList"),
             _col("z")]
    _, pds = _pair(x, metas, y)
    label = FeatureBuilder.RealNN("label").as_response()
    vec = FeatureBuilder.OPVector("vec").as_predictor()
    card = SanityChecker(remove_bad_features=True).set_input(label, vec)
    cpu = SanityChecker(remove_bad_features=True, device="cpu").set_input(label, vec)
    assert list(card.fit(pds).indices_to_keep) == list(cpu.fit(pds).indices_to_keep)
    a = card.metadata["sanityCheckerSummary"]["columns"]
    b = cpu.metadata["sanityCheckerSummary"]["columns"]
    assert [c["reasons"] for c in a] == [c["reasons"] for c in b]
    np.testing.assert_allclose([c["corr_label"] for c in a],
                               [c["corr_label"] for c in b], rtol=0, atol=F64_ATOL)
