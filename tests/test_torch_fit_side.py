"""The flagship flow's feature side in the PyTorch port against the JAX
package: CSV reading, ``from_dataset``, ``transmogrify`` and
``sanity_check`` through ``fit_and_transform_dag``, on the CPU
(``device="cpu"``). The same seeded ``testkit`` or numpy tables go through
both packages.

Tolerances: none for the vectors (float32, equal bit for bit), their
metadata, the vocabularies, fills, smart-text decisions, hash buckets, the
SanityChecker's keep-set and drop reasons, and the scores of a JAX-saved
model with a ``SmartTextModel`` stage. The SanityChecker's statistics on
the float64 route (these twins: below 2^22 elements) are within
``STATS_ATOL_F64`` = 1e-12 (torch and numpy reduce in different orders).
The committed fixtures (``tests/fixtures/torch_fit_side/``, made by
``tests/torch_fixtures/make_fit_side_fixtures.py``) are held the same way,
so neither side can drift from them unnoticed.
"""
import csv
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import transmogrifai_tpu.dsl  # noqa: F401  (installs sanity_check)
import transmogrifai_tpu.types as T
from transmogrifai_tpu import testkit as TK
from transmogrifai_tpu.dataset import Dataset
from transmogrifai_tpu.features import FeatureBuilder as JFeatureBuilder
from transmogrifai_tpu.features import from_dataset as j_from_dataset
from transmogrifai_tpu.native import murmur3_scatter as j_native_scatter
from transmogrifai_tpu.ops import categorical as JC
from transmogrifai_tpu.ops import text as JX
from transmogrifai_tpu.ops import transmogrify as j_transmogrify
from transmogrifai_tpu.readers import CsvReader as JCsvReader
from transmogrifai_tpu.readers import csv as JR
from transmogrifai_tpu.types import columns as JCOL
from transmogrifai_tpu.utils import text as JT
from transmogrifai_tpu.utils import uid as j_uid
from transmogrifai_tpu.workflow.fit import fit_and_transform_dag as j_fit

import transmogrifai_tpu_torch.dsl  # noqa: F401
from transmogrifai_tpu_torch import types as PT
from transmogrifai_tpu_torch.dataset import Dataset as PDataset
from transmogrifai_tpu_torch.features import FeatureBuilder, from_dataset
from transmogrifai_tpu_torch.local.scoring import score_function
from transmogrifai_tpu_torch.featurize import stats as FSTATS
from transmogrifai_tpu_torch.ops import categorical as PC
from transmogrifai_tpu_torch.ops import text as PX
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.readers import CsvReader, infer_csv_dataset
from transmogrifai_tpu_torch.readers import csv as PR
from transmogrifai_tpu_torch.types import columns as PCOL
from transmogrifai_tpu_torch.utils import text as PTX
from transmogrifai_tpu_torch.workflow.dag import raw_features_of
from transmogrifai_tpu_torch.workflow.fit import (
    apply_transformations_dag, fit_and_transform_dag,
)
from transmogrifai_tpu_torch.workflow.persistence import load_workflow_model

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "torch_fit_side")
CSV_PATH = os.path.join(FIXTURE, "titanic_twin.csv")
STATS_ATOL_F64 = 1e-12


def _load_module(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "torch_fixtures", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MSF = _load_module("make_serving_fixtures")


# --------------------------------------------------------------- helpers
def port_dataset(ds: Dataset) -> PDataset:
    """The port's copy of a JAX-package dataset, column for column."""
    cols = {}
    for name, c in ds.columns.items():
        ftype = PT.feature_type_by_name(c.feature_type.__name__)
        if isinstance(c, JCOL.NumericColumn):
            cols[name] = PCOL.NumericColumn(ftype, c.values.copy(), c.mask.copy())
        elif isinstance(c, JCOL.TextColumn):
            cols[name] = PCOL.TextColumn(ftype, c.values.copy())
        else:
            raise TypeError(type(c).__name__)
    return PDataset.of(cols)


def jax_side(ds: Dataset, response: str):
    j_uid.reset()
    resp, preds = j_from_dataset(ds, response=response)
    vec = j_transmogrify(list(preds))
    checked = resp.sanity_check(vec, remove_bad_features=True)
    data, fitted = j_fit(ds, [checked])
    return data, fitted, vec, checked


def port_side(ds: PDataset, response: str):
    resp, preds = from_dataset(ds, response=response)
    vec = transmogrify(list(preds))
    checked = resp.sanity_check(vec, remove_bad_features=True, device="cpu")
    data, fitted = fit_and_transform_dag(ds, [checked])
    return data, fitted, vec, checked


def metas(vec_col) -> list[dict]:
    """Column metadata as JSON records (either package's ColumnMeta)."""
    return [
        {k: (list(v) if isinstance(v, tuple) else v)
         for k, v in dataclasses.asdict(c).items()}
        for c in vec_col.metadata.columns
    ]


def summary_of(fitted, checked) -> dict:
    return fitted[checked.origin_stage.uid].metadata["sanityCheckerSummary"]


def assert_same_checker(js: dict, ps: dict, atol: float) -> None:
    assert ps["numRows"] == js["numRows"]
    assert ps["numColumns"] == js["numColumns"]
    assert ps["numDropped"] == js["numDropped"]
    for jc, pc in zip(js["columns"], ps["columns"], strict=True):
        assert (pc["name"], pc["parent"], pc["dropped"], pc["reasons"]) == (
            jc["name"], jc["parent"], jc["dropped"], jc["reasons"])
        assert pc["cramers_v"] == jc["cramers_v"]
        for key in ("mean", "variance", "corr_label"):
            assert pc[key] == pytest.approx(jc[key], abs=atol, nan_ok=True)


def assert_same_flow(ref, port) -> None:
    jdata, jfit, jvec, jchk = ref
    pdata, pfit, pvec, pchk = port
    jv, pv = jdata[jvec.name], pdata[pvec.name]
    np.testing.assert_array_equal(pv.values, np.asarray(jv.values, np.float32))
    assert metas(pv) == metas(jv)
    np.testing.assert_array_equal(
        pdata[pchk.name].values, np.asarray(jdata[jchk.name].values, np.float32))
    assert metas(pdata[pchk.name]) == metas(jdata[jchk.name])
    assert_same_checker(summary_of(jfit, jchk), summary_of(pfit, pchk),
                        STATS_ATOL_F64)
    # the fitted summaries the vectorizers keep (fills, vocabs, text stats)
    jmeta = sorted((type(s).__name__, json.dumps(s.metadata, sort_keys=True))
                   for s in jfit.values() if type(s).__name__ != "FeatureRemovalModel")
    pmeta = sorted((type(s).__name__, json.dumps(s.metadata, sort_keys=True))
                   for s in pfit.values() if type(s).__name__ != "FeatureRemovalModel")
    assert pmeta == jmeta


# ------------------------------------------------ vectorizers, type by type
def _gen(ftype_name: str):
    """A seeded testkit generator of the type, ~15% empty where nullable."""
    ftype = getattr(T, ftype_name)
    if ftype_name in ("Real", "Currency", "Percent"):
        g = TK.RandomReal.normal(5.0, 3.0, ftype=ftype)
    elif ftype_name == "RealNN":
        return TK.RandomReal.normal(5.0, 3.0, ftype=T.RealNN)
    elif ftype_name == "Integral":
        g = TK.RandomIntegral.integrals(0, 6)
    elif ftype_name == "Binary":
        g = TK.RandomBinary.of(0.3)
    elif ftype_name == "Text":
        g = TK.RandomText.strings(1, 12)
    elif ftype_name == "TextArea":
        g = TK.RandomText.text_areas(1, 40)
    elif ftype_name == "Email":
        g = TK.RandomText.emails()
    elif ftype_name == "URL":
        g = TK.RandomText.urls()
    elif ftype_name == "ID":
        g = TK.RandomText.ids()
    elif ftype_name == "Base64":
        g = TK.RandomText.base64()
    elif ftype_name == "PostalCode":
        g = TK.RandomText.postal_codes()
    elif ftype_name == "Country":
        g = TK.RandomText.countries()
    elif ftype_name == "State":
        g = TK.RandomText.states()
    elif ftype_name == "City":
        g = TK.RandomText.cities()
    elif ftype_name == "Street":
        g = TK.RandomText.streets()
    else:  # PickList, ComboBox
        g = TK.RandomText.from_domain(
            ["a-b", "A B", "c", "d!", "e", "f", "G"],
            [5, 3, 3, 2, 1, 1, 0.2], ftype=ftype)
    return g.with_probability_of_empty(0.15)


VECTORIZED_TYPES = (
    "Real", "Currency", "Percent", "RealNN", "Integral", "Binary", "Text",
    "TextArea", "PickList", "ComboBox", "ID", "Email", "URL", "Base64",
    "Country", "State", "City", "PostalCode", "Street",
)


@pytest.mark.parametrize("ftype_name", VECTORIZED_TYPES)
def test_each_vectorizer_matches_the_reference(ftype_name):
    """Two features of the type (and a label) through both packages'
    transmogrify + sanity check: vectors, metadata, fitted summaries,
    keep-set and reasons equal."""
    ds = TK.random_dataset({
        "f1": _gen(ftype_name),
        "f2": _gen(ftype_name),
        "label": TK.RandomIntegral.integrals(0, 2, ftype=T.RealNN),
    }, n=700, seed=11)
    assert_same_flow(jax_side(ds, "label"), port_side(port_dataset(ds), "label"))


def test_each_vectorizer_type_is_in_the_dispatch():
    from transmogrifai_tpu_torch.ops.transmogrify import (
        _ONE_HOT_TYPES, _SMART_TEXT_TYPES,
    )

    covered = {"Real", "Currency", "Percent", "RealNN", "Integral", "Binary"}
    covered |= {t.__name__ for t in _ONE_HOT_TYPES + _SMART_TEXT_TYPES}
    assert covered == set(VECTORIZED_TYPES)


@pytest.mark.parametrize("ftype_name,item", [
    ("Date", "ops/dates.py"), ("DateTime", "ops/dates.py"),
    ("MultiPickList", "set pivot"), ("Phone", "ops/phone.py"),
    ("TextList", "ops/lists.py"), ("Geolocation", "ops/lists.py"),
    ("RealMap", "ops/maps.py"), ("TextMap", "ops/maps.py"),
])
def test_types_still_to_port_name_their_roadmap_item(ftype_name, item):
    """The types this test once found unported (each named the reference
    module, ``item``, that holds its vectorizer) are ported: transmogrify
    now builds the vectorizer of that module."""
    feat = getattr(FeatureBuilder, ftype_name)("f").as_predictor()
    stage = transmogrify([feat]).origin_stage
    module = {"set pivot": "ops/categorical.py"}.get(item, item)
    assert type(stage).__module__.replace(".", "/").endswith(module[:-3])


def test_groups_sorted_by_type_name_and_opvector_passes_through():
    real = FeatureBuilder.Real("r").as_predictor()
    pick = FeatureBuilder.PickList("p").as_predictor()
    binary = FeatureBuilder.Binary("b").as_predictor()
    vec = FeatureBuilder.OPVector("v").as_predictor()
    out = transmogrify([real, pick, vec, binary])
    stages = [f.origin_stage for f in out.origin_stage.input_features]
    assert [type(s).__name__ if s is not None else None for s in stages] == [
        "BinaryVectorizer", "FeatureGeneratorStage", "OneHotVectorizer",
        "RealVectorizer"]
    assert transmogrify([real]).origin_stage.operation_name == "vecReal"


def test_integral_mode_ties_go_to_the_smallest_value():
    ds = Dataset.of({"i": JCOL.column_from_values(T.Integral, [3, 1, 3, 1, None, 7])})
    f = JFeatureBuilder.Integral("i").as_predictor()
    jm = j_transmogrify([f]).origin_stage.fit(ds)
    pf = FeatureBuilder.Integral("i").as_predictor()
    pm = transmogrify([pf]).origin_stage.fit(port_dataset(ds))
    assert pm.fills == jm.fills == [1.0]
    assert pm.value_ranges == jm.value_ranges


def test_chunked_transform_equals_one_pass(monkeypatch):
    """Batches of at least two pool chunks run blocks_for over row chunks
    on the featurize pool, stacked into one output: the same values and
    metadata as a single pass."""
    ds = port_dataset(TK.random_dataset({
        "r": TK.RandomReal.normal().with_probability_of_empty(0.3),
        "t": TK.RandomText.strings(1, 9).with_probability_of_empty(0.2),
        "p": _gen("PickList"),
        "label": TK.RandomIntegral.integrals(0, 2, ftype=T.RealNN),
    }, n=1000, seed=5))
    resp, preds = from_dataset(ds, response="label")
    vec = transmogrify(preds)
    data, fitted = fit_and_transform_dag(ds, [vec])
    monkeypatch.setenv("TPTPU_FEATURIZE_THREADS", "4")
    monkeypatch.setenv("TPTPU_FEATURIZE_CHUNK", "96")
    for m in fitted.values():
        m._meta_cache = None
    before = FSTATS.snapshot()
    chunked = apply_transformations_dag(ds, [vec], fitted)
    assert FSTATS.delta(before)["chunkedStages"] > 0
    np.testing.assert_array_equal(chunked[vec.name].values, data[vec.name].values)
    assert chunked[vec.name].metadata == data[vec.name].metadata


# ------------------------------------------------------------ categorical
def test_top_values_ties_sort_by_value():
    from collections import Counter

    counts = Counter({"b": 5, "a": 5, "c": 9, "d": 1, "e": 5, "f": 4})
    for top_k, min_support in ((3, 1), (10, 5), (2, 5), (6, 2)):
        assert PC.top_values(counts, top_k, min_support) == JC.top_values(
            counts, top_k, min_support)
    assert PC.top_values(counts, 3, 1) == ["c", "a", "b"]


def test_onehot_fit_cleans_then_merges_counts():
    vals = ["New-York", "new york", "NEW YORK!", "Boston", None, "boston", "?!"]
    ds = Dataset.of({"c": JCOL.column_from_values(T.PickList, vals * 4)})
    jest = JC.OneHotVectorizer(min_support=1).set_input(
        JFeatureBuilder.PickList("c").as_predictor())
    pest = PC.OneHotVectorizer(min_support=1).set_input(
        FeatureBuilder.PickList("c").as_predictor())
    jm, pm = jest.fit(ds), pest.fit(port_dataset(ds))
    assert pm.vocabs == jm.vocabs
    np.testing.assert_array_equal(
        pm.transform(port_dataset(ds))[pm.output_name].values,
        jm.transform(ds)[jm.output_name].values)


# ------------------------------------------------------------ text hashing
TEXTS = [
    "Braund, Mr. Owen Harris", "", "x", "ab", "abc", "abcd", "abcde",
    "Müller, Mrs. Anna", "Ødegaard — Jon", "Nuñez, María José", "日本語 テキスト",
    "emoji 🚀 rocket", "tab\tand\nnewline", "UPPER lower MiXeD 123 4_5",
    "a" * 300, "é" * 7, "__init__ snake_case", "Ça-va?  très bien!!",
]


def test_murmur3_matches_the_reference():
    for seed in (0, 42, 2**31 + 5):
        for s in TEXTS:
            assert PTX.murmur3_32(s, seed) == JT.murmur3_32(s, seed)
            for nb in (7, 512):
                assert PTX.hash_to_index(s, nb, seed) == JT.hash_to_index(s, nb, seed)
    # the reference's native batch hash agrees as well (ASCII and not)
    from transmogrifai_tpu.native import murmur3_batch

    np.testing.assert_array_equal(
        murmur3_batch(TEXTS, 42),
        np.array([PTX.murmur3_32(s, 42) for s in TEXTS], np.uint32))


def test_tokenize_matches_the_reference():
    for s in TEXTS:
        for lower, min_len in ((True, 1), (False, 1), (True, 3)):
            assert PTX.tokenize(s, lower, min_len) == JT.tokenize(s, lower, min_len)
            assert PTX.clean_string(s) == JT.clean_string(s)


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("shared", [False, True])
def test_hash_block_matches_the_reference(binary, shared):
    """The port's Python hashing equals the reference's hash_block, which
    takes its native pass for ASCII rows and its Python pass for the
    others, empty strings and missing rows included."""
    rng = np.random.default_rng(3)
    values = [TEXTS[i] if i < len(TEXTS) else None
              for i in rng.integers(0, len(TEXTS) + 3, 400)]
    for nb in (16, 512):
        kw = dict(num_features=nb, feature_slot=2, shared=shared,
                  binary_freq=binary, to_lowercase=True, min_token_length=1,
                  seed=42, track_nulls=True)
        np.testing.assert_array_equal(
            PX.hash_block(values, **kw), JX.hash_block(values, **kw))


def test_hash_scatter_matches_the_native_scatter():
    tokens = [t for s in TEXTS for t in JT.tokenize(s)]
    rows = np.arange(len(tokens)) % 5
    for binary in (False, True):
        want = j_native_scatter(tokens, rows, 5, 64, seed=42, binary=binary)
        got = PX.murmur3_scatter(tokens, rows, 64, 42, binary,
                                 np.zeros((5, 64), np.float32))
        np.testing.assert_array_equal(got, want)


def test_text_stats_match_the_reference():
    """Value counts (first cap+1 distinct in row order, full counts), the
    token-length histogram (ASCII tokens past 255 characters in the last
    bin, as the reference's native pass counts them) and the decision."""
    rng = np.random.default_rng(9)
    values = [TEXTS[i] if i < len(TEXTS) else None
              for i in rng.integers(0, len(TEXTS) + 2, 500)]
    values += [f"name {i}" for i in range(60)]
    for cap, clean in ((30, True), (3, True), (30, False)):
        js = JX.batch_text_stats(values, cap, clean)
        ps = PX.batch_text_stats(values, cap, clean)
        assert list(ps.value_counts.items()) == list(js.value_counts.items())
        assert dict(ps.length_counts) == dict(js.length_counts)
        assert ps.length_std() == js.length_std()
        for args in ((30, 20, 10, 0.9, 0.0), (3, 2, 1, 0.5, 0.0),
                     (3, 2, 1, 0.5, 50.0)):
            assert PX.decide_method(ps, *args) == JX.decide_method(js, *args)


def test_hash_metas_match_the_reference():
    got = PX.hash_metas("name", PT.Text, 8, True)
    want = JX.hash_metas("name", T.Text, 8, True)
    assert [c.to_json() for c in got] == [c.to_json() for c in want]


def test_smart_text_ignore_tracks_nulls_only():
    ds = Dataset.of({"t": JCOL.column_from_values(
        T.Text, [f"w{i} x" if i % 3 else None for i in range(200)])})
    jf = JFeatureBuilder.Text("t").as_predictor()
    pf = FeatureBuilder.Text("t").as_predictor()
    jm = JX.SmartTextVectorizer(min_length_std_dev=5.0).set_input(jf).fit(ds)
    pm = PX.SmartTextVectorizer(min_length_std_dev=5.0).set_input(pf).fit(
        port_dataset(ds))
    assert pm.methods == jm.methods == ["Ignore"]
    jv = jm.transform(ds)[jm.output_name]
    pv = pm.transform(port_dataset(ds))[pm.output_name]
    np.testing.assert_array_equal(pv.values, np.asarray(jv.values))
    assert metas(pv) == metas(jv)


def test_smart_text_above_the_sparse_threshold_densifies_equal():
    """At 4096 rows or more the reference assembles a sparse hash plane;
    the port's dense plane equals it densified."""
    ds = TK.random_dataset({
        "t": TK.RandomText.strings(3, 30).with_probability_of_empty(0.1),
        "p": TK.RandomText.pick_lists(["a", "b", "c"]),
    }, n=max(JX.SPARSE_MIN_ROWS, 4096) + 5, seed=4)
    ds = Dataset.of({k: JCOL.TextColumn(T.Text, c.values) for k, c in ds.columns.items()})
    jf = [JFeatureBuilder.Text(n).as_predictor() for n in ("t", "p")]
    pf = [FeatureBuilder.Text(n).as_predictor() for n in ("t", "p")]
    jm = JX.SmartTextVectorizer().set_input(*jf).fit(ds)
    pm = PX.SmartTextVectorizer().set_input(*pf).fit(port_dataset(ds))
    assert pm.methods == jm.methods == ["Hash", "Pivot"]
    jv = jm.transform(ds)[jm.output_name]
    assert jv.is_sparse
    np.testing.assert_array_equal(
        pm.transform(port_dataset(ds))[pm.output_name].values,
        np.asarray(jv.values))


# ---------------------------------------------------------------- readers
def test_infer_type_on_the_csv_twin():
    with open(CSV_PATH, newline="", encoding="utf-8") as fh:
        rows = list(csv.reader(fh))
    header, body = rows[0], rows[1:]
    for j, name in enumerate(header):
        vals = [r[j] or None for r in body]
        assert PR._infer_type(vals) is PT.feature_type_by_name(
            JR._infer_type(vals).__name__), name
    cases = [["true", "f", None], ["1", "0"], ["1.5", "2"], ["x", "1"], [None],
             [" 3 ", "4"], ["yes", "1"], ["nan", "1"], ["1e3", "-2"]]
    for vals in cases:
        assert PR._infer_type(vals).__name__ == JR._infer_type(vals).__name__


def test_csv_reading_matches_the_reference():
    jds = JR.infer_csv_dataset(CSV_PATH)
    pds = infer_csv_dataset(CSV_PATH)
    assert list(pds.columns) == list(jds.columns)
    for name, jc in jds.columns.items():
        pc = pds[name]
        assert pc.feature_type.__name__ == jc.feature_type.__name__
        if isinstance(jc, JCOL.NumericColumn):
            np.testing.assert_array_equal(pc.values, jc.values)
            np.testing.assert_array_equal(pc.mask, jc.mask)
        else:
            assert list(pc.values) == list(jc.values)
    assert CsvReader(CSV_PATH).read_records() == JCsvReader(CSV_PATH).read_records()


def test_readers_extract_raw_features(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("a,b\n1,x\n,y\n3,\n")
    age = FeatureBuilder.Integral("a").as_predictor()
    upper = FeatureBuilder.Text("b").extract(
        lambda r: None if r["b"] is None else r["b"].upper()).as_predictor()
    ds = CsvReader(str(path)).generate_dataset([age, upper])
    assert ds["a"].to_list() == [1, None, 3]
    assert ds["b"].to_list() == ["X", "Y", None]
    with pytest.raises(KeyError, match="missing"):
        CsvReader(str(path)).generate_dataset([FeatureBuilder.Real("c").as_predictor()])


# ------------------------------------------------------------- the slice
@pytest.fixture(scope="module")
def flagship():
    return MSF.twin_dataset()


def test_flagship_twin_matches_the_reference(flagship):
    assert_same_flow(jax_side(flagship, "label"),
                     port_side(port_dataset(flagship), "label"))


def test_csv_twin_matches_the_reference():
    jds = JR.infer_csv_dataset(CSV_PATH)
    pds = infer_csv_dataset(CSV_PATH)
    assert_same_flow(jax_side(jds, "survived"), port_side(pds, "survived"))


def test_fit_side_fixture_tables_are_the_twins(flagship):
    """The committed tables are the ones both packages build: the typed
    twin column for column, and the CSV twin as the generator writes it."""
    msf = _load_module("make_fit_side_fixtures")
    with open(os.path.join(FIXTURE, "flagship_table.json")) as fh:
        assert json.load(fh) == json.loads(json.dumps(msf.table_json(flagship)))
    header, rows = msf.csv_twin_rows(flagship)
    with open(CSV_PATH, newline="", encoding="utf-8") as fh:
        assert list(csv.reader(fh)) == [header] + rows


def table_from_fixture() -> PDataset:
    """The typed twin as the fixture stores it, built by the port alone."""
    with open(os.path.join(FIXTURE, "flagship_table.json")) as fh:
        table = json.load(fh)
    return PDataset.of({
        k: PCOL.column_from_values(PT.feature_type_by_name(table["schema"][k]), v)
        for k, v in table["columns"].items()
    })


@pytest.mark.parametrize("name", ["flagship", "csv"])
def test_port_reproduces_the_fixture(name):
    if name == "flagship":
        ds, response = table_from_fixture(), "label"
    else:
        ds, response = infer_csv_dataset(CSV_PATH), "survived"
    data, fitted, vec, checked = port_side(ds, response)
    with open(os.path.join(FIXTURE, f"{name}.json")) as fh:
        want = json.load(fh)
    arrays = np.load(os.path.join(FIXTURE, f"{name}.npz"))
    np.testing.assert_array_equal(data[vec.name].values, arrays["vector"])
    assert metas(data[vec.name]) == want["metadata"]
    summary = summary_of(fitted, checked)
    cols = summary["columns"]
    assert [j for j, c in enumerate(cols) if not c["dropped"]] == want["keep"]
    assert {str(j): c["reasons"] for j, c in enumerate(cols)
            if c["dropped"]} == want["reasons"]
    assert [c["name"] for c in cols] == want["names"]
    for key in ("mean", "variance", "corr_label"):
        np.testing.assert_allclose([c[key] for c in cols], arrays[key],
                                   rtol=0, atol=STATS_ATOL_F64)
    text = [s.metadata["textStats"] for s in fitted.values()
            if "textStats" in s.metadata]
    assert json.loads(json.dumps(text)) == want["text_stats"]


def test_the_slice_runs_from_a_reader_and_replays():
    """Raw features through ``raw_features_of`` and a record reader give the
    same checked vector as the inferred dataset; the fitted DAG applied
    again, or fitted with every stage prefitted, gives it too."""
    ds = infer_csv_dataset(CSV_PATH)
    resp, preds = from_dataset(ds, response="survived")
    checked = resp.sanity_check(transmogrify(preds), remove_bad_features=True,
                                device="cpu")
    data, fitted = fit_and_transform_dag(ds, [checked])
    raw = CsvReader(CSV_PATH).generate_dataset(raw_features_of([checked]))
    from_records, _ = fit_and_transform_dag(raw, [checked])
    np.testing.assert_array_equal(from_records[checked.name].values,
                                  data[checked.name].values)
    again = apply_transformations_dag(ds, [checked], fitted)
    np.testing.assert_array_equal(again[checked.name].values,
                                  data[checked.name].values)
    prefit, _ = fit_and_transform_dag(ds, [checked], prefitted=fitted)
    np.testing.assert_array_equal(prefit[checked.name].values,
                                  data[checked.name].values)


def test_the_slice_on_the_card():
    """The CSV twin's feature side with the SanityChecker's statistics on
    the card: the vector and keep-set equal the stored JAX results."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ds = infer_csv_dataset(CSV_PATH)
    resp, preds = from_dataset(ds, response="survived")
    vec = transmogrify(preds)
    checked = resp.sanity_check(vec, remove_bad_features=True)
    data, fitted = fit_and_transform_dag(ds, [checked])
    with open(os.path.join(FIXTURE, "csv.json")) as fh:
        want = json.load(fh)
    np.testing.assert_array_equal(
        data[vec.name].values, np.load(os.path.join(FIXTURE, "csv.npz"))["vector"])
    cols = summary_of(fitted, checked)["columns"]
    assert [j for j, c in enumerate(cols) if not c["dropped"]] == want["keep"]


def test_jax_saved_smart_text_model_scores_equal():
    """A model the JAX package saved with a SmartTextModel stage (the CSV
    twin's hashed names and pivoted sex and embarked) loads in the port and
    scores the stored rows exactly as the JAX package did."""
    path = os.path.join(FIXTURE, "csv_model")
    model = load_workflow_model(path, device="cpu")
    classes = {type(s).__name__ for s in model.fitted.values()}
    assert "SmartTextModel" in classes
    with open(os.path.join(path, "rows.json")) as fh:
        rows = json.load(fh)
    out = score_function(model, device="cpu").batch(rows)
    want = np.load(os.path.join(path, "expected.npz"))
    name = model.result_features[0].name
    got = np.array([[r[name]["probability_0"], r[name]["probability_1"]]
                    for r in out])
    np.testing.assert_array_equal(got, want["probability"])
    np.testing.assert_array_equal([r[name]["prediction"] for r in out],
                                  want["prediction"])


# -------------------------------------------------------- columns, dataset
def test_columns_take_concat_and_empty_like_match_the_reference():
    vals = {"Real": [1.5, None, 3.0], "Integral": [1, 2, None],
            "Binary": [True, None, False], "Text": ["a", None, "c"]}
    idx = np.array([2, 0])
    for tname, raw in vals.items():
        jc = JCOL.column_from_values(getattr(T, tname), raw)
        pc = PCOL.column_from_values(PT.feature_type_by_name(tname), raw)
        assert pc.take(idx).to_list() == jc.take(idx).to_list()
        assert (PCOL.concat_columns([pc, pc.take(idx)]).to_list()
                == JCOL.concat_columns([jc, jc.take(idx)]).to_list())
        assert (PCOL.empty_like(PT.feature_type_by_name(tname), 2).to_list()
                == JCOL.empty_like(getattr(T, tname), 2).to_list())
    vec = PCOL.VectorColumn(PT.OPVector, np.arange(6, dtype=np.float32).reshape(3, 2))
    np.testing.assert_array_equal(
        PCOL.concat_columns([vec, vec.take(idx)]).values,
        np.concatenate([vec.values, vec.values[idx]]))
    assert PCOL.empty_like(PT.OPVector, 4).values.shape == (4, 0)
    assert PCOL.empty_like(PT.Prediction, 4).to_list() == [{"prediction": 0.0}] * 4
    pred = PCOL.PredictionColumn(PT.Prediction, np.zeros(2), np.ones((2, 2)), None)
    assert len(PCOL.concat_columns([pred, pred.take(np.array([1]))])) == 3
    ds = PDataset.of({"a": PCOL.column_from_values(PT.Real, [1.0, 2.0])})
    assert ds.take(np.array([1])).rows() == [{"a": 2.0}]
    with pytest.raises(ValueError, match="rows"):
        ds.with_column("b", PCOL.column_from_values(PT.Real, [1.0]))
