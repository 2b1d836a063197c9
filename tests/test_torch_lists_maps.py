"""Lists, sets and maps: the PyTorch port's set, list and map columns, the
set pivot of ``ops/categorical.py`` and its copies of ``ops/lists.py`` and
``ops/maps.py``, against the JAX package's, on the CPU.

The JAX package's ``tests/test_map_list_vectorizers.py`` cases for these
modules run here against the port (its phone cases run in
``test_torch_dates_phone.py``; ``DecisionTreeNumericMapBucketizer``'s in
``test_torch_bucketizers.py``). Every block is host numpy in both packages,
so the tolerance is EQUALITY: the same seeded testkit columns through both
packages' vectorizers give the same vectors, ``ColumnMeta`` lists and
fitted summaries (keys, fills, vocabularies, methods).
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from transmogrifai_tpu.ops import categorical as JC
from transmogrifai_tpu.ops import lists as JL
from transmogrifai_tpu.ops import maps as JM
from transmogrifai_tpu.types import columns as JCOL

import transmogrifai_tpu_torch.types as T
from transmogrifai_tpu_torch.dataset import Dataset
from transmogrifai_tpu_torch.features import FeatureBuilder, from_dataset
from transmogrifai_tpu_torch.features.builder import infer_feature_type
from transmogrifai_tpu_torch.ops import categorical as PC
from transmogrifai_tpu_torch.ops import lists as PL
from transmogrifai_tpu_torch.ops import maps as PM
from transmogrifai_tpu_torch.ops.lists import (
    MODE_DAY,
    SINCE_FIRST,
    DateListVectorizer,
    GeolocationVectorizer,
    TextListVectorizer,
)
from transmogrifai_tpu_torch.ops.maps import (
    DateMapVectorizer,
    GeolocationMapVectorizer,
    RealMapVectorizer,
    SmartTextMapVectorizer,
    TextMapPivotVectorizer,
)
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.stages.metadata import NULL_STRING
from transmogrifai_tpu_torch.types import columns as PCOL
from transmogrifai_tpu_torch.types.columns import (
    ListColumn,
    MapColumn,
    SetColumn,
    column_from_values,
)
from transmogrifai_tpu_torch.workflow.fit import fit_and_transform_dag

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "port_pairs", os.path.join(HERE, "torch_fixtures", "port_pairs.py"))
PAIRS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(PAIRS)

_DAY_MS = 86_400_000


def _ds(**cols):
    return Dataset.of({k: column_from_values(t, v) for k, (t, v) in cols.items()})


# ------------------------------- lists ---------------------------------------
def test_text_list_hashing_tf():
    f = FeatureBuilder.TextList("toks").as_predictor()
    stage = TextListVectorizer(num_terms=8, track_nulls=True).set_input(f)
    ds = _ds(toks=(T.TextList, [["a", "b", "a"], [], ["c"]]))
    model = stage.fit(ds)
    out = model.transform(ds)[stage.output_name]
    vals = np.asarray(out.values)
    assert vals.shape == (3, 9)
    assert vals[0].sum() == 3.0      # tf counts: a,b,a
    assert vals[1, 8] == 1.0         # empty list -> null indicator
    assert vals[2, :8].sum() == 1.0


def test_date_list_since_first_and_mode_day():
    f = FeatureBuilder.DateList("dates").as_predictor()
    ref = 10 * _DAY_MS
    stage = DateListVectorizer(
        pivot=SINCE_FIRST, reference_date_ms=ref
    ).set_input(f)
    ds = _ds(dates=(T.DateList, [[2 * _DAY_MS, 5 * _DAY_MS], []]))
    out = stage.transform(ds)[stage.output_name]
    vals = np.asarray(out.values)
    assert vals[0, 0] == 8.0  # since earliest (day 2) to day 10
    assert vals[1, 1] == 1.0  # null indicator

    f2 = FeatureBuilder.DateList("d2").as_predictor()
    stage2 = DateListVectorizer(pivot=MODE_DAY).set_input(f2)
    # epoch day 0 = Thursday 1970-01-01; weekday() Thursday = 3
    ds2 = _ds(d2=(T.DateList, [[0, 0, _DAY_MS]]))
    out2 = stage2.transform(ds2)[stage2.output_name]
    vals2 = np.asarray(out2.values)
    assert vals2.shape == (1, 8)  # 7 days + null
    assert vals2[0, 3] == 1.0     # Thursday is the mode
    assert out2.metadata.columns[3].indicator_value == "Thursday"


def test_geolocation_vectorizer_mean_fill():
    f = FeatureBuilder.Geolocation("geo").as_predictor()
    stage = GeolocationVectorizer().set_input(f)
    ds = _ds(geo=(T.Geolocation, [[10.0, 20.0, 1.0], [30.0, 40.0, 3.0], None]))
    model = stage.fit(ds)
    out = model.transform(ds)[stage.output_name]
    vals = np.asarray(out.values)
    np.testing.assert_allclose(vals[2, :3], [20.0, 30.0, 2.0])  # mean fill
    assert vals[2, 3] == 1.0  # null indicator


# -------------------------------- maps ---------------------------------------
def test_real_map_vectorizer_mean_fill_per_key():
    f = FeatureBuilder.RealMap("m").as_predictor()
    stage = RealMapVectorizer(fill="mean").set_input(f)
    ds = _ds(m=(T.RealMap, [{"a": 1.0, "b": 5.0}, {"a": 3.0}, {}]))
    model = stage.fit(ds)
    out = model.transform(ds)[stage.output_name]
    vals = np.asarray(out.values)
    # keys sorted: a, b; layout per key: [value, null]
    np.testing.assert_allclose(vals[:, 0], [1.0, 3.0, 2.0])  # a mean=2
    np.testing.assert_allclose(vals[:, 1], [0.0, 0.0, 1.0])  # a null flags
    np.testing.assert_allclose(vals[:, 2], [5.0, 5.0, 5.0])  # b mean=5 fills
    np.testing.assert_allclose(vals[:, 3], [0.0, 1.0, 1.0])
    assert out.metadata.columns[0].grouping == "a"


def test_integral_map_mode_fill():
    f = FeatureBuilder.IntegralMap("m").as_predictor()
    stage = RealMapVectorizer(fill="mode").set_input(f)
    ds = _ds(m=(T.IntegralMap, [{"k": 2}, {"k": 2}, {"k": 7}, {}]))
    model = stage.fit(ds)
    out = model.transform(ds)[stage.output_name]
    assert np.asarray(out.values)[3, 0] == 2.0  # mode fill


def test_text_map_pivot_vectorizer():
    f = FeatureBuilder.PickListMap("m").as_predictor()
    stage = TextMapPivotVectorizer(top_k=2, min_support=1).set_input(f)
    rows = [{"color": "red"}, {"color": "red", "size": "L"},
            {"color": "blue"}, {}]
    ds = _ds(m=(T.PickListMap, rows))
    model = stage.fit(ds)
    out = model.transform(ds)[stage.output_name]
    meta = out.metadata
    # keys sorted: color (Red, Blue by count desc then name), size
    groupings = {c.grouping for c in meta.columns}
    assert groupings == {"color", "size"}
    color_cols = [i for i, c in enumerate(meta.columns) if c.grouping == "color"]
    vals = np.asarray(out.values)
    # row 3 ({}): color null indicator set
    null_idx = [i for i in color_cols
                if meta.columns[i].indicator_value == NULL_STRING][0]
    assert vals[3, null_idx] == 1.0


def test_multipicklist_map_pivot_sets():
    f = FeatureBuilder.MultiPickListMap("m").as_predictor()
    stage = TextMapPivotVectorizer(top_k=3, min_support=1).set_input(f)
    rows = [{"tags": {"x", "y"}}, {"tags": {"x"}}, {}]
    ds = _ds(m=(T.MultiPickListMap, rows))
    model = stage.fit(ds)
    out = model.transform(ds)[stage.output_name]
    meta = out.metadata
    x_idx = [i for i, c in enumerate(meta.columns)
             if c.indicator_value == "X"][0]
    vals = np.asarray(out.values)
    np.testing.assert_allclose(vals[:, x_idx], [1.0, 1.0, 0.0])


def test_smart_text_map_vectorizer_decides_per_key():
    f = FeatureBuilder.TextMap("m").as_predictor()
    stage = SmartTextMapVectorizer(
        max_cardinality=3, top_k=2, min_support=1, num_hashes=16
    ).set_input(f)
    rows = []
    for i in range(40):
        rows.append({
            "cat": "yes" if i % 2 else "no",          # low card -> pivot
            "free": f"unique text value number {i}",  # high card -> hash
        })
    ds = _ds(m=(T.TextMap, rows))
    model = stage.fit(ds)
    assert model.methods[0][0] == "Pivot"  # cat
    assert model.methods[0][1] == "Hash"   # free
    out = model.transform(ds)[stage.output_name]
    assert np.asarray(out.values).shape[0] == 40


def test_date_map_vectorizer():
    f = FeatureBuilder.DateMap("m").as_predictor()
    ref = 10 * _DAY_MS
    stage = DateMapVectorizer(
        reference_date_ms=ref, circular_reps=("DayOfWeek",)
    ).set_input(f)
    ds = _ds(m=(T.DateMap, [{"start": 3 * _DAY_MS}, {}]))
    model = stage.fit(ds)
    out = model.transform(ds)[stage.output_name]
    vals = np.asarray(out.values)
    # per key: x_DayOfWeek, y_DayOfWeek, SinceLast, null
    assert vals.shape == (2, 4)
    assert vals[0, 2] == 7.0
    assert vals[1, 3] == 1.0


def test_geolocation_map_vectorizer():
    f = FeatureBuilder.GeolocationMap("m").as_predictor()
    stage = GeolocationMapVectorizer().set_input(f)
    ds = _ds(m=(T.GeolocationMap, [{"home": [1.0, 2.0, 3.0]}, {}]))
    model = stage.fit(ds)
    out = model.transform(ds)[stage.output_name]
    vals = np.asarray(out.values)
    np.testing.assert_allclose(vals[0], [1.0, 2.0, 3.0, 0.0])
    np.testing.assert_allclose(vals[1], [0.0, 0.0, 0.0, 1.0])


# --------------------------- transmogrify dispatch ---------------------------
def test_transmogrify_covers_lists_maps_phone():
    feats = [
        FeatureBuilder.Phone("phone").as_predictor(),
        FeatureBuilder.TextList("toks").as_predictor(),
        FeatureBuilder.DateList("dates").as_predictor(),
        FeatureBuilder.Geolocation("geo").as_predictor(),
        FeatureBuilder.RealMap("rm").as_predictor(),
        FeatureBuilder.PickListMap("plm").as_predictor(),
        FeatureBuilder.TextMap("tm").as_predictor(),
        FeatureBuilder.BinaryMap("bm").as_predictor(),
        FeatureBuilder.GeolocationMap("gm").as_predictor(),
    ]
    vector = transmogrify(feats)
    ds = _ds(
        phone=(T.Phone, ["5551234567", None]),
        toks=(T.TextList, [["a"], ["b", "c"]]),
        dates=(T.DateList, [[_DAY_MS], []]),
        geo=(T.Geolocation, [[1.0, 2.0, 0.0], None]),
        rm=(T.RealMap, [{"a": 1.0}, {}]),
        plm=(T.PickListMap, [{"k": "v"}, {}]),
        tm=(T.TextMap, [{"t": "hello"}, {}]),
        bm=(T.BinaryMap, [{"b": True}, {}]),
        gm=(T.GeolocationMap, [{"g": [1.0, 2.0, 0.0]}, {}]),
    )
    data, _ = fit_and_transform_dag(ds, [vector])
    out = data[vector.name]
    assert np.asarray(out.values).shape[0] == 2
    assert out.metadata.size == np.asarray(out.values).shape[1]
    # every input feature contributed columns
    parents = {p for c in out.metadata.columns for p in c.parent_names}
    assert parents == {f.name for f in feats}


# -------------------- round-3 completeness: small companion stages ----------
def test_text_map_null_and_len_estimators():
    from transmogrifai_tpu_torch.ops.maps import TextMapLenEstimator, TextMapNullEstimator

    ds = Dataset.of({
        "m": MapColumn(T.TextMap, [
            {"a": "hello world", "b": "x"},
            {"a": None, "b": "longer words here"},
            {},
        ]),
    })
    f = FeatureBuilder.TextMap("m").as_predictor()

    null_est = TextMapNullEstimator().set_input(f)
    model = null_est.fit(ds)
    out = model.transform(ds)[null_est.output_name]
    vals = np.asarray(out.values)
    # keys sorted [a, b]; row0 present/present, row1 a missing, row2 both
    np.testing.assert_array_equal(vals, [[0, 0], [1, 0], [1, 1]])

    len_est = TextMapLenEstimator().set_input(f)
    lmodel = len_est.fit(ds)
    lout = lmodel.transform(ds)[len_est.output_name]
    lvals = np.asarray(lout.values)
    # summed TOKEN lengths: "hello world" -> 10, "x" -> 1,
    # "longer words here" -> 15
    np.testing.assert_array_equal(lvals, [[10, 1], [0, 15], [0, 0]])


def test_text_list_null_transformer():
    from transmogrifai_tpu_torch.ops.lists import TextListNullTransformer

    ds = Dataset.of({
        "t": ListColumn(T.TextList, [["a", "b"], [], ["c"]]),
    })
    f = FeatureBuilder.TextList("t").as_predictor()
    stage = TextListNullTransformer().set_input(f)
    out = stage.transform(ds)[stage.output_name]
    np.testing.assert_array_equal(
        np.asarray(out.values), [[0.0], [1.0], [0.0]]
    )


# ------------------------------------------------ against the JAX package
N = 300
KEYS = ("home", "work", "other", "Mixed Key!")
WORDS = ("tree", "leaf", "root", "bark", "seed", "moss", "fern", "Oak!",
         "elm", "ash")


def _pair(make, n=N, seed=31, count=2):
    return PAIRS.columns(make, n, seed, count)


def _same(stage_j, stage_p, type_name, cols):
    jout, jmodel = PAIRS.run("jax", stage_j, type_name, cols["jax"])
    pout, pmodel = PAIRS.run("port", stage_p, type_name, cols["port"])
    assert pout.values.dtype == np.float32
    np.testing.assert_array_equal(pout.values,
                                  np.asarray(jout.values, np.float32))
    assert PAIRS.metas(pout) == PAIRS.metas(jout)
    assert json.dumps(pmodel.metadata, sort_keys=True, default=str) == \
        json.dumps(jmodel.metadata, sort_keys=True, default=str)
    return pout


def _words(tk):
    return tk.RandomText.from_domain(WORDS, seed=3)


LIST_CASES = {
    "TextList": lambda tk: tk.RandomList.of_texts(_words(tk), 0, 5)
    .with_probability_of_empty(0.2),
    "TextList_strings": lambda tk: tk.RandomList.of_texts(None, 0, 4),
    "DateList": lambda tk: tk.RandomList.of_dates(0, 4)
    .with_probability_of_empty(0.2),
    "Geolocation": lambda tk: tk.RandomList.of_geolocations()
    .with_probability_of_empty(0.2),
}


@pytest.mark.parametrize("min_doc_freq", [0, 3])
@pytest.mark.parametrize("case", ["TextList", "TextList_strings"])
def test_text_list_vectorizer_equals_the_reference(case, min_doc_freq):
    cols = _pair(LIST_CASES[case])
    out = _same(JL.TextListVectorizer(num_terms=64, min_doc_freq=min_doc_freq),
                TextListVectorizer(num_terms=64, min_doc_freq=min_doc_freq),
                "TextList", cols)
    assert out.values.shape == (N, 2 * 65)


@pytest.mark.parametrize("pivot", ["SinceFirst", "SinceLast", "ModeDay",
                                   "ModeMonth", "ModeHour"])
@pytest.mark.parametrize("type_name", ["DateList", "DateTimeList"])
def test_date_list_vectorizer_equals_the_reference(pivot, type_name):
    cols = _pair(LIST_CASES["DateList"])
    _same(JL.DateListVectorizer(pivot, 1_325_376_000_000),
          DateListVectorizer(pivot, 1_325_376_000_000), type_name, cols)


@pytest.mark.parametrize("fill_with_mean", [True, False])
def test_geolocation_vectorizer_equals_the_reference(fill_with_mean):
    cols = _pair(LIST_CASES["Geolocation"])
    _same(JL.GeolocationVectorizer(fill_with_mean, (1.0, -2.0, 3.0)),
          GeolocationVectorizer(fill_with_mean, (1.0, -2.0, 3.0)),
          "Geolocation", cols)


def test_text_list_null_transformer_equals_the_reference():
    cols = _pair(LIST_CASES["TextList"])
    _same(JL.TextListNullTransformer(), PL.TextListNullTransformer(),
          "TextList", cols)


def _map_of(source, map_type, keys=KEYS):
    return lambda tk: tk.RandomMap.of(source(tk), getattr(tk.T, map_type),
                                      keys).with_probability_of_empty(0.2)


MAP_CASES = {
    "RealMap": (_map_of(lambda tk: tk.RandomReal.normal(3.0, 2.0), "RealMap"),
                "mean"),
    "CurrencyMap": (_map_of(lambda tk: tk.RandomReal.log_normal(
        ftype=tk.T.Currency), "CurrencyMap"), "mean"),
    "PercentMap": (_map_of(lambda tk: tk.RandomReal.uniform(
        ftype=tk.T.Percent), "PercentMap"), "constant"),
    "IntegralMap": (_map_of(lambda tk: tk.RandomIntegral.integrals(0, 4),
                            "IntegralMap"), "mode"),
    "BinaryMap": (_map_of(lambda tk: tk.RandomBinary.of(0.3), "BinaryMap"),
                  "constant"),
}


@pytest.mark.parametrize("clean_keys", [False, True])
@pytest.mark.parametrize("type_name", sorted(MAP_CASES))
def test_numeric_map_vectorizers_equal_the_reference(type_name, clean_keys):
    make, fill = MAP_CASES[type_name]
    cols = _pair(make)
    _same(JM.RealMapVectorizer(fill, 0.5, clean_keys),
          RealMapVectorizer(fill, 0.5, clean_keys), type_name, cols)


@pytest.mark.parametrize("type_name", ["DateMap", "DateTimeMap"])
def test_date_map_vectorizer_equals_the_reference(type_name):
    cols = _pair(_map_of(lambda tk: tk.RandomIntegral.datetimes(), type_name))
    _same(JM.DateMapVectorizer(1_325_376_000_000),
          DateMapVectorizer(1_325_376_000_000), type_name, cols)


PIVOT_MAP_CASES = {
    "PickListMap": lambda tk: tk.RandomText.pick_lists(WORDS),
    "EmailMap": lambda tk: tk.RandomText.emails(),
    "CountryMap": lambda tk: tk.RandomText.countries(),
    "MultiPickListMap": lambda tk: tk.RandomSet.of(WORDS[:5], 0, 3),
}


@pytest.mark.parametrize("clean_text", [True, False])
@pytest.mark.parametrize("type_name", sorted(PIVOT_MAP_CASES))
def test_text_map_pivot_vectorizer_equals_the_reference(type_name, clean_text):
    cols = _pair(_map_of(PIVOT_MAP_CASES[type_name], type_name))
    _same(JM.TextMapPivotVectorizer(5, 3, clean_text),
          TextMapPivotVectorizer(5, 3, clean_text), type_name, cols)


@pytest.mark.parametrize("type_name", ["TextMap", "TextAreaMap"])
def test_smart_text_map_vectorizer_equals_the_reference(type_name):
    """Pivoted keys (few words), hashed keys (free strings) and ignored
    keys (one token length) in one map."""
    def make(tk):
        words, free = _words(tk), tk.RandomText.strings(1, 30)
        same_len = tk.RandomText.from_domain(["aaaa", "bbbb cccc", "dddd"] +
                                             [f"w{i:03d}" for i in range(60)])

        def producer(r):
            return {"cat": words.draw(r), "free": free.draw(r),
                    "fixed": same_len.draw(r)}
        return tk.RandomGenerator(getattr(tk.T, type_name), producer) \
            .with_probability_of_empty(0.2)

    cols = _pair(make)
    out = _same(JM.SmartTextMapVectorizer(max_cardinality=12, num_hashes=32,
                                          min_length_std_dev=0.5),
                SmartTextMapVectorizer(max_cardinality=12, num_hashes=32,
                                       min_length_std_dev=0.5),
                type_name, cols)
    assert out.values.shape[1] > 2 * 32


def test_smart_text_map_hashes_like_a_text_column():
    """A hashed map key's block is the hash block of the same values as a
    text column (``ops.text.hash_block``, key slot as the feature slot)."""
    from transmogrifai_tpu_torch.ops.text import hash_block

    vals = ["alpha beta", None, "gamma", "beta beta delta"] * 10
    rows = [{"k": v} if v is not None else {} for v in vals]
    stage = SmartTextMapVectorizer(max_cardinality=2, num_hashes=16)
    out, _ = PAIRS.run("port", stage, "TextMap",
                       [column_from_values(T.TextMap, rows)])
    want = hash_block(vals, 16, 0, shared=False, binary_freq=False,
                      to_lowercase=True, min_token_length=1, seed=42,
                      track_nulls=True)
    np.testing.assert_array_equal(out.values, want)


@pytest.mark.parametrize("track_nulls", [True, False])
def test_geolocation_map_vectorizer_equals_the_reference(track_nulls):
    cols = _pair(_map_of(lambda tk: tk.RandomList.of_geolocations(),
                         "GeolocationMap"))
    _same(JM.GeolocationMapVectorizer(track_nulls=track_nulls),
          GeolocationMapVectorizer(track_nulls=track_nulls), "GeolocationMap",
          cols)


@pytest.mark.parametrize("name", ["TextMapNullEstimator", "TextMapLenEstimator"])
def test_text_map_null_and_len_equal_the_reference(name):
    cols = _pair(_map_of(lambda tk: tk.RandomText.strings(0, 20), "TextMap"))
    _same(getattr(JM, name)(), getattr(PM, name)(), "TextMap", cols)


@pytest.mark.parametrize("clean_text", [True, False])
def test_set_pivot_equals_the_reference(clean_text):
    cols = _pair(lambda tk: tk.RandomSet.of(["Red", "red!", "green", "blue",
                                             "cyan", "x"], 0, 4)
                 .with_probability_of_empty(0.2))
    out = _same(JC.OneHotVectorizer(3, 5, clean_text),
                PC.OneHotVectorizer(3, 5, clean_text), "MultiPickList", cols)
    assert out.values.max() >= 2.0  # members count in OTHER


def test_set_pivot_refuses_the_fused_graph_with_the_reference_reason():
    from transmogrifai_tpu_torch.compiler.fused import Unfuseable

    cols = _pair(lambda tk: tk.RandomSet.of(["a", "b"], 0, 2), count=1)
    _, pmodel = PAIRS.run("port", PC.OneHotVectorizer(), "MultiPickList",
                          cols["port"])
    with pytest.raises(Unfuseable) as got:
        pmodel.fused_member_spec()
    _, jmodel = PAIRS.run("jax", JC.OneHotVectorizer(), "MultiPickList",
                          cols["jax"])
    with pytest.raises(Exception) as want:
        jmodel.fused_member_spec()
    assert str(got.value) == str(want.value)


# ------------------------------------------- columns, datasets, inference
RAW = {
    "MultiPickList": [["a", "b"], "c", None, [], ("b",), frozenset({"x"})],
    "TextList": [["a", "b"], [], None, ("c",), ["d"], ["e", "e"]],
    "DateList": [[1, 2], None, [], [3], [4, 5, 6], [0]],
    "Geolocation": [[1.0, 2.0, 3.0], None, [], [4.0, 5.0], [0.0, 0.0, 1.0],
                    [9.0, 9.0, 9.0]],
    "RealMap": [{"a": 1.0}, None, {}, {"b": 2.0, "a": 3.0}, {"c": None},
                {"a": 0.0}],
    "TextMap": [{"a": "x y"}, {}, None, {"b": "z"}, {"a": ""}, {"c": "w"}],
}


@pytest.mark.parametrize("type_name", sorted(RAW))
def test_columns_equal_the_reference(type_name):
    """``column_from_values``, ``take`` (indices, a mask, a slice),
    ``concat_columns``, ``empty_like`` and ``to_list`` over the set, list
    and map columns, and ``Dataset.take`` / ``rows`` / ``with_column``."""
    import transmogrifai_tpu.types as JT
    from transmogrifai_tpu.dataset import Dataset as JDataset

    raw = RAW[type_name]
    jcol = JCOL.column_from_values(getattr(JT, type_name), raw)
    pcol = column_from_values(getattr(T, type_name), raw)
    assert type(pcol).__name__ == type(jcol).__name__
    assert PAIRS.values(pcol) == PAIRS.values(jcol)
    idx = np.array([5, 0, 0, 3])
    assert PAIRS.values(pcol.take(idx)) == PAIRS.values(jcol.take(idx))
    mask = np.array([True, False, True, False, True, True])
    assert PAIRS.values(pcol.take(mask)) == PAIRS.values(jcol.take(
        np.nonzero(mask)[0]))
    assert PAIRS.values(pcol.take(slice(1, 4))) == PAIRS.values(jcol)[1:4]
    both = PCOL.concat_columns([pcol, pcol.take(idx)])
    assert PAIRS.values(both) == PAIRS.values(
        JCOL.concat_columns([jcol, jcol.take(idx)]))
    assert PAIRS.values(PCOL.empty_like(getattr(T, type_name), 3)) == \
        PAIRS.values(JCOL.empty_like(getattr(JT, type_name), 3))
    pds = Dataset.of({"c": pcol}).with_column("d", pcol.take(np.arange(6)))
    jds = JDataset.of({"c": jcol}).with_column("d", jcol.take(np.arange(6)))
    assert [{k: PAIRS.values(column_from_values(getattr(T, type_name), [v]))
             for k, v in r.items()} for r in pds.take(idx).rows()] == \
        [{k: PAIRS.values(JCOL.column_from_values(getattr(JT, type_name), [v]))
          for k, v in r.items()} for r in jds.take(idx).rows()]


def test_column_from_values_refuses_what_the_reference_refuses():
    with pytest.raises(TypeError):
        column_from_values(T.Prediction, [{}])
    assert column_from_values(T.MultiPickList, ["ab"]).values == [
        frozenset({"ab"})]


def test_infer_feature_type_over_the_new_columns():
    from transmogrifai_tpu.features.builder import \
        infer_feature_type as j_infer

    import transmogrifai_tpu.types as JT

    for type_name in ("MultiPickList", "TextList", "DateList", "DateTimeList",
                      "Geolocation", "RealMap", "PhoneMap", "GeolocationMap"):
        raw = [None, None]
        p = infer_feature_type(column_from_values(getattr(T, type_name), raw))
        j = j_infer(JCOL.column_from_values(getattr(JT, type_name), raw))
        assert p.__name__ == j.__name__
    ds = Dataset.of({"label": column_from_values(T.RealNN, [0.0, 1.0]),
                     "s": SetColumn(T.MultiPickList, [frozenset(), {"a"}]),
                     "l": ListColumn(T.DateList, [[1], []]),
                     "m": MapColumn(T.BinaryMap, [{}, {"k": True}])})
    _, preds = from_dataset(ds, "label")
    assert [p.ftype.__name__ for p in preds] == ["MultiPickList", "DateList",
                                                 "BinaryMap"]
