"""The port's featurize plane (``transmogrifai_tpu_torch/featurize/``,
``types.columns.SparseMatrix``) against the JAX package's on the same
seeded inputs, on the CPU.

The JAX package's ``tests/test_featurize_engine.py`` cases that this plane
covers (its text stages run in ``tests/test_torch_text_stages.py``) run
here against the port:
interning (codes, offsets and vocabulary order, ASCII rows' tokens first
in a mixed column; first-occurrence order of whole values on tie-heavy
columns), the code kernels, ``SparseMatrix``, the chunked pool, fused
block assembly in the scoring closure, the ``FusionPlanner``'s widths,
the ``featurizeStats`` keys and the COO hash plane above
``SPARSE_MIN_ROWS``. Each route is held to the reference's same route:
the native route to the JAX package with its library, the Python route
(``TPTPU_DISABLE_NATIVE``) to the JAX package with its library withheld.
Every kernel here is integer work or float32 sums in one fixed order, so
the tolerance is EQUALITY; the flow case holds the plane on against the
plain routes on vectors, keep-sets, candidates and scores.
"""
import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from transmogrifai_tpu import native as JN
from transmogrifai_tpu.dataset import Dataset as JDataset
from transmogrifai_tpu.features import from_dataset as j_from_dataset
from transmogrifai_tpu.featurize import engine as JE
from transmogrifai_tpu.featurize import interning as JI
from transmogrifai_tpu.featurize import kernels as JK
from transmogrifai_tpu.featurize import parallel as JP
from transmogrifai_tpu.featurize import stats as JS
from transmogrifai_tpu.ops import text as JX
from transmogrifai_tpu.ops.transmogrify import transmogrify as j_transmogrify
from transmogrifai_tpu.types import columns as JCOL
from transmogrifai_tpu.types import feature_type_by_name as j_type
from transmogrifai_tpu.workflow.dag import compute_dag as j_compute_dag
from transmogrifai_tpu.workflow.fit import fit_and_transform_dag as j_fit

import transmogrifai_tpu_torch.types as T
from transmogrifai_tpu_torch.compiler.fused import Unfuseable, build_fused_plan
from transmogrifai_tpu_torch.dataset import Dataset
from transmogrifai_tpu_torch.features import from_dataset
from transmogrifai_tpu_torch.featurize import engine as PE
from transmogrifai_tpu_torch.featurize import interning as PI
from transmogrifai_tpu_torch.featurize import kernels as PK
from transmogrifai_tpu_torch.featurize import parallel as PP
from transmogrifai_tpu_torch.featurize import stats as PS
from transmogrifai_tpu_torch.local.scoring import score_function
from transmogrifai_tpu_torch.models.gbdt import XGBoostClassifier
from transmogrifai_tpu_torch.models.logistic import LogisticRegression
from transmogrifai_tpu_torch.ops import text as PX
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.selector import BinaryClassificationModelSelector
from transmogrifai_tpu_torch.types import columns as PCOL
from transmogrifai_tpu_torch.workflow.dag import compute_dag
from transmogrifai_tpu_torch.workflow.fit import (
    apply_transformations_dag,
    fit_and_transform_dag,
)
from transmogrifai_tpu_torch.workflow.workflow import Workflow

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

HERE = os.path.dirname(__file__)


def _tables():
    spec = importlib.util.spec_from_file_location(
        "fit_side_tables", os.path.join(HERE, "torch_fixtures", "fit_side_tables.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FT = _tables()

CORPORA = {
    "plain": ["the quick brown fox", "lazy dog", "fox fox fox", "the the"],
    "unicode": ["café au lait", "naïve Σigma ΣIGMA", "hello—world", "日本語 テスト"],
    "mixed": ["ascii only here", "déjà vu", None, "", "UPPER lower 42",
              "vu ascii déjà", "only"],
    "empty_rows": ["", None, "", None],
    "all_null": [None, None, None],
    "single": ["one lonely row of text"],
    "punct": ["a-b_c!d", "  spaces   everywhere  ", "1 2 3 4 5"],
    "ties": ["b a", "a b", "c", "b", "a", "c c", "B", "A"] * 5,
    "long_tokens": ["x" * 300 + " y", "Y " + "x" * 300, "z" * 256],
}


@pytest.fixture(params=["native", "plain"])
def route(request, monkeypatch):
    """Each package on the same route: its native library, or its Python
    route (the port's by ``TPTPU_DISABLE_NATIVE``, the reference's by
    withholding its library)."""
    if request.param == "plain":
        monkeypatch.setenv("TPTPU_DISABLE_NATIVE", "1")
        monkeypatch.setattr(JN, "_load", lambda: None)
    return request.param


def _same_codes(got, want) -> None:
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert got.vocab == want.vocab


# ---------------------------------------------------------------- interning
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_token_codes_equal_the_reference(corpus, route):
    vals = CORPORA[corpus]
    for lower, min_len in ((True, 1), (False, 2)):
        got = PI.tokenize_text_column(vals, lower, min_len)
        _same_codes(got, JI.tokenize_text_column(vals, lower, min_len))
        assert got.to_lists() == [
            PX.tokenize(v, lower, min_len) if v else [] for v in vals]


def test_mixed_columns_list_the_ascii_rows_vocabulary_first():
    tc = PI.tokenize_text_column(["déjà zed", "alpha beta", None, "zed"])
    assert tc.vocab == ["alpha", "beta", "zed", "déjà"]
    before = PS.snapshot()
    PI.tokenize_text_column(["déjà vu", "ascii"])
    d = PS.delta(before)
    assert d["internNativeBuilds"] == 1 and d["internFallbackBuilds"] == 1


@pytest.mark.parametrize("corpus", ["ties", "mixed", "unicode"])
def test_intern_values_order_equals_the_reference(corpus, route):
    """First-occurrence uniques with full counts: they decide which of
    equally counted values a top-K pivot keeps."""
    vals = [v for v in CORPORA[corpus] if v is not None] * 3
    codes, uniques, counts = PI.intern_values(vals)
    jcodes, juniques, jcounts = JI.intern_values(vals)
    np.testing.assert_array_equal(codes, jcodes)
    assert uniques == juniques == list(dict.fromkeys(vals))
    np.testing.assert_array_equal(counts, jcounts)


def test_interned_columns_take_slice_and_cache():
    tc = PI.tokenize_text_column(CORPORA["mixed"])
    col = PI.InternedTextList(T.TextList, tc)
    assert isinstance(col, PCOL.ListColumn) and PI.interned_of(col) is tc
    idx = np.array([3, 0, 0, 6, -1])
    want = JI.tokenize_text_column(CORPORA["mixed"]).take_rows(idx)
    _same_codes(col.take(idx).interned, want)
    plain = PCOL.ListColumn(T.TextList, [["x"], ["x", "y"], []])
    assert PI.interned_of(plain) is PI.interned_of(plain)
    assert PI.interned_of(plain).vocab == ["x", "y"]
    sliced = PP.slice_rows(col, 1, 5)
    assert sliced.to_list() == col.take(np.arange(1, 5)).to_list()


# ------------------------------------------------------------------ kernels
def _codes(seed: int):
    vals = CORPORA["ties"] + CORPORA["mixed"]
    rng = np.random.default_rng(seed)
    vals = [vals[i] for i in rng.integers(0, len(vals), 200)]
    return PI.tokenize_text_column(vals), JI.tokenize_text_column(vals)


@pytest.mark.parametrize("binary", [False, True])
def test_term_count_kernels_equal_the_reference(binary, route):
    ptc, jtc = _codes(1)
    index = {t: i for i, t in enumerate(sorted(ptc.vocab)[:5])}
    cmap = PK.map_vocab(ptc.vocab, index)
    np.testing.assert_array_equal(cmap, JK.map_vocab(jtc.vocab, index))
    hmap = PK.hash_vocab(ptc.vocab, 16, seed=42, prefix="3_")
    np.testing.assert_array_equal(hmap, JK.hash_vocab(jtc.vocab, 16, 42, "3_"))
    for code_to_col, width in ((cmap, 5), (hmap, 16)):
        block = PK.term_count_block(ptc, code_to_col, width, binary)
        np.testing.assert_array_equal(
            block, JK.term_count_block(jtc, code_to_col, width, binary))
        sp = PK.term_count_sparse(ptc, code_to_col, width, binary)
        jsp = JK.term_count_sparse(jtc, code_to_col, width, binary)
        np.testing.assert_array_equal(sp.rows, jsp.rows)
        np.testing.assert_array_equal(sp.cols, jsp.cols)
        np.testing.assert_array_equal(sp.toarray(), block)
    rows, cols = ptc.row_index(), hmap[ptc.codes]
    for got, want in zip(PK.unique_pairs(rows, cols, 16),
                         JK.unique_pairs(rows, cols, 16)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(PK.distinct_pair_bincount(rows, cols, 16),
                                  JK.distinct_pair_bincount(rows, cols, 16))


def test_segment_mean_equals_the_reference():
    ptc, _ = _codes(2)
    vectors = np.random.default_rng(3).standard_normal(
        (len(ptc.vocab), 8)).astype(np.float32)
    np.testing.assert_array_equal(
        PK.segment_mean_f32(vectors, ptc.codes, ptc.offsets),
        JK.segment_mean_f32(vectors, ptc.codes, ptc.offsets))


@pytest.mark.parametrize("period", ["HourOfDay", "DayOfWeek", "DayOfMonth",
                                    "DayOfYear", "MonthOfYear", "WeekOfMonth",
                                    "WeekOfYear"])
def test_calendar_periods_equal_the_reference(period):
    rng = np.random.default_rng(7)
    ms = np.concatenate([
        rng.integers(-4_000_000_000_000, 4_000_000_000_000, 2000),
        np.array([0, 1, -1, 86_400_000, -86_400_000, 3_600_000 * 25]),
    ])
    np.testing.assert_array_equal(PK.calendar_periods(ms, period),
                                  JK.calendar_periods(ms, period))


# ------------------------------------------------------------- SparseMatrix
def _sparse_pair(seed: int, vals: bool):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 30, 200).astype(np.int32)
    cols = rng.integers(0, 12, 200).astype(np.int32)
    v = rng.normal(size=200).astype(np.float32) if vals else None
    return (PCOL.SparseMatrix(rows, cols, (30, 12), v),
            JCOL.SparseMatrix(rows, cols, (30, 12), v))


@pytest.mark.parametrize("vals", [False, True])
@pytest.mark.parametrize("index", ["dups", "negative", "mask", "empty"])
def test_sparse_take_rows_equals_the_reference_and_dense(vals, index):
    p, j = _sparse_pair(4, vals)
    idx = {
        "dups": np.array([3, 3, 0, 29, 3]),
        "negative": np.array([-1, -30, 5]),
        "mask": np.arange(30) % 3 == 0,
        "empty": np.zeros(0, np.int64),
    }[index]
    got, want = p.take_rows(idx), j.take_rows(idx)
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.cols, want.cols)
    np.testing.assert_array_equal(got.toarray(), want.toarray())
    np.testing.assert_array_equal(got.toarray(), p.toarray()[idx])
    with pytest.raises(IndexError):
        p.take_rows(np.array([30]))


def test_sparse_dense_surface_hstack_and_from_dense_equal_the_reference():
    p, j = _sparse_pair(5, False)
    np.testing.assert_array_equal(p.toarray(), j.toarray())
    assert p.nnz == j.nnz and len(p) == 30 and p.shape == (30, 12)
    np.testing.assert_array_equal(np.asarray(p), j.toarray())
    assert np.asarray(p, dtype=np.float64).dtype == np.float64
    assert np.array(p, copy=True) is not p.toarray()
    np.testing.assert_array_equal(p.astype(np.float64), j.astype(np.float64))
    dense = np.random.default_rng(6).normal(size=(30, 4)).astype(np.float32)
    dense[dense < 0.5] = 0.0
    pv, jv = _sparse_pair(7, True)
    got = PCOL.SparseMatrix.hstack([p, dense, pv], [12, 4, 12], 30)
    want = JCOL.SparseMatrix.hstack([j, dense, jv], [12, 4, 12], 30)
    np.testing.assert_array_equal(got.toarray(), want.toarray())
    np.testing.assert_array_equal(got.vals, want.vals)
    fd = PCOL.SparseMatrix.from_dense(dense)
    np.testing.assert_array_equal(fd.toarray(), dense)
    np.testing.assert_array_equal(fd.vals, JCOL.SparseMatrix.from_dense(dense).vals)
    vec = PCOL.VectorColumn(T.OPVector, got)
    assert vec.is_sparse and vec.dim == 28
    np.testing.assert_array_equal(
        np.asarray(vec.take(np.array([2, 2, 1])).values), want.toarray()[[2, 2, 1]])
    np.testing.assert_array_equal(
        np.asarray(PP.slice_rows(vec, 4, 9).values), want.toarray()[4:9])


# ----------------------------------------------------------------- the pool
def test_chunk_ranges_equal_the_reference(monkeypatch):
    for threads, chunk in (("4", "10"), ("3", "7"), ("0", "10"), ("2", "50")):
        monkeypatch.setenv("TPTPU_FEATURIZE_THREADS", threads)
        monkeypatch.setenv("TPTPU_FEATURIZE_CHUNK", chunk)
        for n in (1, 19, 20, 35, 99, 1000):
            got = PP.chunk_ranges(n)
            assert got == JP.chunk_ranges(n)
            assert [r for a, b in got for r in range(a, b)] == list(range(n))
    monkeypatch.delenv("TPTPU_FEATURIZE_THREADS")
    assert PP.featurize_threads() == min(4, os.cpu_count() or 1)
    monkeypatch.delenv("TPTPU_FEATURIZE_CHUNK")
    assert PP.min_chunk_rows() == 8192


def test_run_tasks_keeps_order_and_nests(monkeypatch):
    monkeypatch.setenv("TPTPU_FEATURIZE_THREADS", "3")
    inner = [lambda i=i: i * i for i in range(4)]
    outer = [lambda k=k: (k, PP.run_tasks(inner)) for k in range(6)]
    before = PS.snapshot()
    assert PP.run_tasks(outer) == [(k, [0, 1, 4, 9]) for k in range(6)]
    assert PS.delta(before)["poolTasks"] == 6  # the nested calls ran inline
    assert list(PP.pipeline_tasks(iter(inner), 2)) == [0, 1, 4, 9]


def _port_ds(schema, columns) -> Dataset:
    return Dataset.of({k: PCOL.column_from_values(T.feature_type_by_name(schema[k]), v)
                       for k, v in columns.items()})


def _jax_ds(schema, columns) -> JDataset:
    return JDataset.of({k: JCOL.column_from_values(j_type(schema[k]), v)
                        for k, v in columns.items()})


def test_pool_on_equals_pool_off(monkeypatch):
    schema, columns = FT.wide_table(600, 3)
    ds = _port_ds(schema, columns)
    resp, preds = from_dataset(ds, response="label")
    vec = transmogrify(preds)
    monkeypatch.setenv("TPTPU_FEATURIZE_THREADS", "0")
    off, fitted = fit_and_transform_dag(ds, [vec])
    monkeypatch.setenv("TPTPU_FEATURIZE_THREADS", "4")
    monkeypatch.setenv("TPTPU_FEATURIZE_CHUNK", "64")
    before = PS.snapshot()
    on = apply_transformations_dag(ds, [vec], fitted)
    d = PS.delta(before)
    assert d["chunkedStages"] > 0 and d["poolTasks"] >= 2 * d["chunkedStages"]
    np.testing.assert_array_equal(on[vec.name].values, off[vec.name].values)
    assert on[vec.name].metadata == off[vec.name].metadata
    assert set(d) == set(JS.delta(JS.snapshot()))


# ---------------------------------------------------------- fused assembly
def _fitted_plans(n: int = 300):
    """The same table transmogrified and fitted by both packages: each
    package's fitted plan, vector feature and dataset."""
    schema, columns = FT.wide_table(n, 5)
    out = {}
    for pkg, ds, fd, tm, fit, dag in (
        ("port", _port_ds(schema, columns), from_dataset, transmogrify,
         fit_and_transform_dag, compute_dag),
        ("jax", _jax_ds(schema, columns), j_from_dataset, j_transmogrify,
         j_fit, j_compute_dag),
    ):
        resp, preds = fd(ds, response="label")
        vec = tm(preds)
        data, fitted = fit(ds, [vec])
        plan = [fitted.get(s.uid, s) for layer in dag([vec]) for s in layer]
        out[pkg] = (plan, vec, ds, data)
    return out


def test_fusion_planner_widths_equal_the_reference():
    plans = _fitted_plans()
    planners = {pkg: mod.FusionPlanner(plans[pkg][0])
                for pkg, mod in (("port", PE), ("jax", JE))}
    for p in planners.values():
        assert not p.disabled and p.prime()
    got = [planners["port"].widths[u] for u in planners["port"].member_uids]
    want = [planners["jax"].widths[u] for u in planners["jax"].member_uids]
    assert got == want and sum(got) == planners["port"].plane_width()
    assert planners["port"].plane_width() == plans["port"][3][plans["port"][1].name].dim


def _same_outputs(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for name in a:
        if isinstance(a[name], PCOL.VectorColumn):
            np.testing.assert_array_equal(np.asarray(a[name].values),
                                          np.asarray(b[name].values))
        else:
            assert a[name].to_list() == b[name].to_list(), name


@pytest.mark.parametrize("rows", [300, PX.SPARSE_MIN_ROWS])
def test_fused_batches_equal_the_first_unfused_batch(rows):
    """Every batch after the first assembles into one buffer, at the
    sparse plane's row count too (a member under a fused batch assembles
    dense), and equals the first, unfused batch."""
    schema, columns = FT.wide_table(rows, 5)
    ds = _port_ds(schema, columns)
    resp, preds = from_dataset(ds, response="label")
    vec = transmogrify(preds)
    pred = LogisticRegression(max_iter=5, device="cpu").set_input(
        resp, vec).get_output()
    model = Workflow().set_result_features(pred, vec).set_input_dataset(ds).train()
    fn = score_function(model, device="cpu")
    counts, outs = [], []
    for _ in range(3):
        before = PS.snapshot()
        outs.append(fn.columns(ds))
        counts.append(PS.delta(before)["fusedAssemblies"])
    assert counts == [0, 1, 1]
    assert outs[0][vec.name].is_sparse == (rows >= PX.SPARSE_MIN_ROWS)
    assert not outs[1][vec.name].is_sparse
    _same_outputs(outs[0], outs[1])
    _same_outputs(outs[0], outs[2])
    primed = score_function(model, device="cpu")
    assert primed.prime_fused() is False  # an LR over a pivot: staged
    before = PS.snapshot()
    _same_outputs(primed.columns(ds), outs[0])
    assert PS.delta(before)["fusedAssemblies"] == 1
    md = fn.metadata()["featurizeStats"]
    assert set(md) == set(JS.snapshot()) and md["rowsFeaturized"] > 0


def test_fused_planner_cross_checks_the_learned_widths():
    """The fused graph takes the closure's planner: a member width that
    disagrees with the planner's learned one refuses the plan, as in the
    reference."""
    schema, columns = FT.wide_hash_table(300, 5)
    ds = _port_ds(schema, columns)
    resp, preds = from_dataset(ds, response="label")
    vec = transmogrify(preds)
    pred = LogisticRegression(max_iter=5, device="cpu").set_input(
        resp, vec).get_output()
    model = Workflow().set_result_features(pred).set_input_dataset(ds).train()
    fn = score_function(model, device="cpu")
    fn.columns(ds)
    assert fn.fusion.ready()
    plan, names = model.stage_plan(), [pred.name]
    assert build_fused_plan(plan, names, fusion=fn.fusion) is not None
    uid = fn.fusion.member_uids[0]
    fn.fusion.widths[uid] += 1
    with pytest.raises(Unfuseable, match="learned width"):
        build_fused_plan(plan, names, fusion=fn.fusion)


# ------------------------------------------------------------ the COO plane
def _text_values(n: int, non_ascii: bool = False) -> list:
    vals = FT.names(np.random.default_rng(9), n)
    vals = [None if i % 17 == 0 else v for i, v in enumerate(vals)]
    if non_ascii:
        vals[5] = "Zoë, Mme. Hélène"
    return vals


@pytest.mark.parametrize("non_ascii", [False, True])
def test_hash_plane_above_sparse_min_rows_is_coo_and_densifies_to_the_reference(
    non_ascii, monkeypatch,
):
    n = PX.SPARSE_MIN_ROWS
    vals = _text_values(n, non_ascii)
    kw = dict(num_hashes=512, clean_text=True, track_nulls=True)
    pm = PX.SmartTextModel([PX.HASH, PX.PIVOT], [[], ["A", "B"]], **kw)
    jm = JX.SmartTextModel([JX.HASH, JX.PIVOT], [[], ["A", "B"]], **kw)
    cols = [np.array(vals, dtype=object),
            np.array(["a", "b", None, "c"] * (n // 4), dtype=object)]
    for m in (pm, jm):
        m.input_features = [SimpleNamespace(name=f"t{i}", ftype=T.Text)
                            for i in range(2)]
    (pb,), (pmeta,) = pm.blocks_for([PCOL.TextColumn(T.Text, c) for c in cols], n)
    (jb,), (jmeta,) = jm.blocks_for([JCOL.TextColumn(T.Text, c) for c in cols], n)
    assert isinstance(pb, PCOL.SparseMatrix) == (not non_ascii)
    np.testing.assert_array_equal(np.asarray(pb), np.asarray(jb))
    assert [m.descriptor_value for m in pmeta] == [m.descriptor_value for m in jmeta]
    monkeypatch.setenv("TPTPU_DISABLE_NATIVE", "1")
    (dense,), _ = pm.blocks_for([PCOL.TextColumn(T.Text, c) for c in cols], n)
    assert isinstance(dense, np.ndarray)
    np.testing.assert_array_equal(dense, np.asarray(pb))
    (small,), _ = pm.blocks_for(
        [PCOL.TextColumn(T.Text, c[:100]) for c in cols], 100)
    assert isinstance(small, np.ndarray)


def _flow_table(n: int):
    rng = np.random.default_rng(21)
    r0 = rng.normal(size=n)
    r1 = rng.lognormal(size=n)
    score = r0 + 0.3 * rng.normal(size=n)
    schema = {"label": "RealNN", "r0": "Real", "r1": "Real", "name": "Text",
              "kind": "PickList"}
    columns = {
        "label": (score > 0).astype(float).tolist(),
        "r0": r0.tolist(), "r1": r1.tolist(),
        "name": _text_values(n),
        "kind": [f"k{int(v)}" for v in rng.integers(0, 4, n)],
    }
    return _port_ds(schema, columns)


def _flow(ds, device="cpu"):
    resp, preds = from_dataset(ds, response="label")
    vec = transmogrify(preds)
    checked = resp.sanity_check(vec, remove_bad_features=True, device=device)
    selector = BinaryClassificationModelSelector(models=[
        (XGBoostClassifier(device=device), {"num_round": [3], "max_depth": [3]}),
    ])
    pred = selector.set_input(resp, checked).get_output()
    model = Workflow().set_result_features(pred, vec, checked) \
        .set_input_dataset(ds).train()
    scored = model.score(ds)
    return model, vec, checked, pred, scored


def test_sparse_plane_crosses_the_checker_and_the_tree_fit(monkeypatch):
    """transmogrify -> SanityChecker -> the selector's tree fit at
    SPARSE_MIN_ROWS rows: the hashed text plane is a SparseMatrix, every
    consumer densifies it, and the keep-set, candidates and scores equal
    the plain routes' (dense plane, Python hashing)."""
    ds = _flow_table(PX.SPARSE_MIN_ROWS)
    model, vec, checked, pred, scored = _flow(ds)
    assert scored[vec.name].is_sparse
    assert not scored[checked.name].is_sparse
    summary = model.summary_json()["modelSelectorSummary"]
    assert set(summary["featurizeStats"]) == set(JS.snapshot())
    assert summary["featurizeStats"]["rowsFeaturized"] > 0
    monkeypatch.setenv("TPTPU_DISABLE_NATIVE", "1")
    pmodel, pvec, pchecked, ppred, pscored = _flow(ds)
    assert not pscored[pvec.name].is_sparse
    np.testing.assert_array_equal(np.asarray(scored[vec.name].values),
                                  pscored[pvec.name].values)
    np.testing.assert_array_equal(scored[checked.name].values,
                                  pscored[pchecked.name].values)
    psummary = pmodel.summary_json()["modelSelectorSummary"]
    def results(s):
        return [{k: v for k, v in r.items() if k != "modelUID"}
                for r in s["validationResults"]]

    assert results(summary) == results(psummary)
    for a, b in (("prediction", "prediction"), ("probability", "probability")):
        np.testing.assert_array_equal(getattr(scored[pred.name], a),
                                      getattr(pscored[ppred.name], b))
