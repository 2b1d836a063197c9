"""The feature stages off the default dispatch: every class of the port's
``ops/math.py``, ``ops/scalers.py``, ``ops/simple.py`` and
``ops/prediction.py`` against the JAX package's on the CPU.

Each case wires the same stage (same params) in both packages over the
same seeded columns (``port_pairs.run_typed``): numeric columns with empty
rows, exact zeros, negatives, halves, present NaN and values that overflow;
text, list, set, map, vector and prediction columns where the stage reads
them. All of it is host numpy in float64 in both packages, so the tolerance
is EQUALITY: values, masks and metadata (``port_pairs.same_columns``), the
fitted state (params, arrays, the estimator's metadata), and the stage
saved by either package and loaded by the other scoring EQUAL
(``port_pairs.saved_entry`` / ``load_entry``, the manifest entry through
JSON); the JAX package's loader does not register
``PredictionFieldExtractor``, so that class loads in the port only. The
descaler finds the loaded scaler through its second input's origin stage
after a whole model's save and load.
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

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

N = 64


def _pkg(pkg: str):
    import importlib

    root = "transmogrifai_tpu" if pkg == "jax" else "transmogrifai_tpu_torch"
    return {name: importlib.import_module(f"{root}.{name}") for name in (
        "types", "types.columns", "ops.math", "ops.scalers", "ops.simple",
        "ops.prediction", "stages.metadata")}


def real_values(seed: int, n: int = N, nan: bool = True, empty: float = 0.2):
    """Seeded float64 values and mask: zeros, negatives, halves, values
    that overflow and (where ``nan``) present NaN among normal draws."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0.0, 3.0, n)
    v[::7] = 0.0
    v[1::9] = -np.abs(v[1::9])
    v[3::13] = 2.5
    v[5::19] = -0.5
    v[4::17] = 1e200
    if nan:
        v[2::11] = np.nan
    mask = rng.random(n) >= empty
    return np.where(mask, v, 0.0), mask


def make_column(pkg: str, spec: str):
    """The column ``spec`` names, of ``pkg``, drawn from fixed seeds."""
    M = _pkg(pkg)
    T, C = M["types"], M["types.columns"]
    if spec in ("real0", "real1"):
        v, m = real_values(11 if spec == "real0" else 12)
        return C.NumericColumn(T.Real, v, m)
    if spec == "integral":
        v, m = real_values(13, nan=False)
        v = np.where(np.abs(v) < 1e6, np.round(v), 7.0).astype(np.int64)
        return C.NumericColumn(T.Integral, v, m)
    if spec == "realnn":
        v, _ = real_values(14, nan=False, empty=0.0)
        return C.NumericColumn(T.RealNN, np.where(v > 1e6, 3.0, v),
                               np.ones(N, bool))
    if spec == "realnn_ties":
        v = np.random.default_rng(15).integers(0, 4, N).astype(np.float64)
        return C.NumericColumn(T.RealNN, v, np.ones(N, bool))
    words = ("Alpha", "beta", "ALPHABET", "bet", "", "gamma ray", "x")
    r = np.random.default_rng(16 if spec.endswith("0") else 17)
    if spec in ("text0", "text1"):
        vals = [None if r.random() < 0.2 else words[int(r.integers(0, 7))]
                for _ in range(N)]
        return C.column_from_values(T.Text, vals)
    if spec == "textlist":
        vals = [[words[int(j)] for j in r.integers(0, 7, int(r.integers(0, 4)))]
                for _ in range(N)]
        return C.column_from_values(T.TextList, vals)
    if spec == "multipicklist":
        vals = [set(words[int(j)] for j in r.integers(0, 7, int(r.integers(0, 3))))
                for _ in range(N)]
        return C.column_from_values(T.MultiPickList, vals)
    if spec == "realmap":
        vals = [{k: float(np.round(r.normal(), 3)) for k in D.MAP_KEYS
                 if r.random() > 0.3} for _ in range(N)]
        return C.column_from_values(T.RealMap, vals)
    if spec == "probs":
        p = np.random.default_rng(18).dirichlet((1.0, 1.0, 1.0), N)
        meta = M["stages.metadata"].VectorMetadata("probs", tuple(
            M["stages.metadata"].ColumnMeta(("probs",), "OPVector", index=j)
            for j in range(3)))
        return C.VectorColumn(T.OPVector, p.astype(np.float32), meta)
    if spec in ("pred", "pred_regression"):
        g = np.random.default_rng(19)
        raw = g.normal(0.0, 2.0, (N, 2))
        prob = 1.0 / (1.0 + np.exp(-raw))
        if spec == "pred_regression":
            return C.PredictionColumn(T.Prediction, raw[:, 0])
        return C.PredictionColumn(T.Prediction, (raw[:, 1] > 0).astype(float),
                                  prob, raw)
    raise KeyError(spec)


TYPE_OF = {"real0": "Real", "real1": "Real", "integral": "Integral",
           "realnn": "RealNN", "realnn_ties": "RealNN", "text0": "Text",
           "text1": "Text", "textlist": "TextList",
           "multipicklist": "MultiPickList", "realmap": "RealMap",
           "probs": "OPVector", "pred": "Prediction",
           "pred_regression": "Prediction"}

#: (id, module, class, kwargs, input columns)
CASES = [
    ("add", "ops.math", "AddTransformer", {}, ["real0", "real1"]),
    ("add_integral", "ops.math", "AddTransformer", {}, ["real0", "integral"]),
    ("subtract", "ops.math", "SubtractTransformer", {}, ["real0", "real1"]),
    ("multiply", "ops.math", "MultiplyTransformer", {}, ["real0", "real1"]),
    ("divide", "ops.math", "DivideTransformer", {}, ["real0", "real1"]),
    ("divide_integral", "ops.math", "DivideTransformer", {},
     ["real1", "integral"]),
    ("scalar_add", "ops.math", "ScalarAddTransformer", {"scalar": 1.5},
     ["real0"]),
    ("scalar_subtract", "ops.math", "ScalarSubtractTransformer",
     {"scalar": -2.0}, ["real0"]),
    ("scalar_multiply", "ops.math", "ScalarMultiplyTransformer",
     {"scalar": 1e200}, ["real0"]),
    ("scalar_divide", "ops.math", "ScalarDivideTransformer", {"scalar": 3.0},
     ["real0"]),
    ("scalar_divide_zero", "ops.math", "ScalarDivideTransformer",
     {"scalar": 0.0}, ["real0"]),
    ("abs", "ops.math", "AbsoluteValueTransformer", {}, ["real0"]),
    ("ceil", "ops.math", "CeilTransformer", {}, ["real0"]),
    ("floor", "ops.math", "FloorTransformer", {}, ["real1"]),
    ("round", "ops.math", "RoundTransformer", {}, ["real0"]),
    ("round_digits", "ops.math", "RoundDigitsTransformer", {"digits": 2},
     ["real1"]),
    ("round_digits_negative", "ops.math", "RoundDigitsTransformer",
     {"digits": -1}, ["real0"]),
    ("exp", "ops.math", "ExpTransformer", {}, ["real0"]),
    ("sqrt", "ops.math", "SqrtTransformer", {}, ["real0"]),
    ("log", "ops.math", "LogTransformer", {}, ["real1"]),
    ("log10", "ops.math", "LogTransformer", {"base": 10.0}, ["real0"]),
    ("log_integral", "ops.math", "LogTransformer", {"base": 2.0},
     ["integral"]),
    ("power", "ops.math", "PowerTransformer", {"power": 3.0}, ["real0"]),
    ("power_half", "ops.math", "PowerTransformer", {"power": 0.5}, ["real1"]),
    ("standard_scaler", "ops.scalers", "OpScalarStandardScaler", {},
     ["real0"]),
    ("standard_scaler_no_mean", "ops.scalers", "OpScalarStandardScaler",
     {"with_mean": False}, ["integral"]),
    ("standard_scaler_no_std", "ops.scalers", "OpScalarStandardScaler",
     {"with_std": False}, ["realnn"]),
    ("fill_missing_with_mean", "ops.scalers", "FillMissingWithMean", {},
     ["real1"]),
    ("fill_missing_with_mean_integral", "ops.scalers", "FillMissingWithMean",
     {"default": 4.0}, ["integral"]),
    ("scaler_linear", "ops.scalers", "ScalerTransformer",
     {"scaling_type": "Linear", "args": {"slope": 2.5, "intercept": -1.0}},
     ["real0"]),
    ("scaler_log", "ops.scalers", "ScalerTransformer",
     {"scaling_type": "Logarithmic"}, ["real1"]),
    ("percentile_calibrator", "ops.scalers", "PercentileCalibrator", {},
     ["realnn"]),
    ("percentile_calibrator_ties", "ops.scalers", "PercentileCalibrator",
     {"expected_num_buckets": 10}, ["realnn_ties"]),
    ("alias", "ops.simple", "AliasTransformer", {"name": "renamed"},
     ["real0"]),
    ("filter_real", "ops.simple", "FilterTransformer",
     {"predicate": D.is_positive}, ["real1"]),
    ("filter_text", "ops.simple", "FilterTransformer",
     {"predicate": D.is_long_text, "default": "short"}, ["text0"]),
    ("replace_text", "ops.simple", "ReplaceTransformer",
     {"old_value": "beta", "new_value": "BETA"}, ["text0"]),
    ("replace_real", "ops.simple", "ReplaceTransformer",
     {"old_value": 0.0, "new_value": 1.0}, ["real0"]),
    ("substring", "ops.simple", "SubstringTransformer", {},
     ["text0", "text1"]),
    ("to_occur_real", "ops.simple", "ToOccurTransformer", {}, ["real0"]),
    ("to_occur_text", "ops.simple", "ToOccurTransformer", {}, ["text1"]),
    ("to_occur_list", "ops.simple", "ToOccurTransformer", {}, ["textlist"]),
    ("to_occur_set", "ops.simple", "ToOccurTransformer", {},
     ["multipicklist"]),
    ("to_occur_map", "ops.simple", "ToOccurTransformer", {}, ["realmap"]),
    ("to_occur_match", "ops.simple", "ToOccurTransformer",
     {"match_fn": D.is_positive}, ["real1"]),
    ("exists_text", "ops.simple", "ExistsTransformer", {}, ["text0"]),
    ("exists_real", "ops.simple", "ExistsTransformer", {}, ["real1"]),
    ("exists_predicate", "ops.simple", "ExistsTransformer",
     {"predicate": D.is_long_text}, ["text1"]),
    ("text_len", "ops.simple", "TextLenTransformer", {},
     ["textlist", "text0"]),
    ("filter_map_allow", "ops.simple", "FilterMap",
     {"allow_keys": ["home", "work"]}, ["realmap"]),
    ("filter_map_block", "ops.simple", "FilterMap",
     {"block_keys": ["home"], "value_filter": D.above_half}, ["realmap"]),
    ("multi_label_joiner", "ops.simple", "MultiLabelJoiner",
     {"labels": ["a", "b", "c"]}, ["realnn", "probs"]),
    ("multi_label_joiner_index", "ops.simple", "MultiLabelJoiner", {},
     ["probs"]),
    ("top_n_label_prob_map", "ops.simple", "TopNLabelProbMap", {"top_n": 2},
     ["realmap"]),
    ("prediction_value", "ops.prediction", "PredictionFieldExtractor",
     {"field": "prediction"}, ["pred"]),
    ("prediction_probability", "ops.prediction", "PredictionFieldExtractor",
     {"field": "probability"}, ["pred"]),
    ("prediction_raw", "ops.prediction", "PredictionFieldExtractor",
     {"field": "rawPrediction"}, ["pred"]),
    ("prediction_raw_regression", "ops.prediction",
     "PredictionFieldExtractor", {"field": "rawPrediction"},
     ["pred_regression"]),
]


#: classes the JAX package's loader does not register (its registry leaves
#: ``ops/prediction.py`` out), so a saved model holding one loads in the
#: port only
JAX_UNLOADABLE = ("PredictionFieldExtractor",)


def _stage(pkg: str, module: str, cls: str, kwargs: dict):
    from transmogrifai_tpu_torch.utils import uid as PU
    from transmogrifai_tpu.utils import uid as JU

    (JU if pkg == "jax" else PU).reset()
    return getattr(_pkg(pkg)[module], cls)(**kwargs)


def _run(pkg: str, module: str, cls: str, kwargs: dict, specs: list):
    cols = [make_column(pkg, s) for s in specs]
    return PP.run_typed(pkg, _stage(pkg, module, cls, kwargs),
                        [TYPE_OF[s] for s in specs], cols)


def _state(model) -> str:
    arrays = {k: np.asarray(v).tolist()
              for k, v in getattr(model, "get_arrays", dict)().items()}
    params = model.get_params()
    return json.dumps([type(model).__name__, params, arrays, model.metadata,
                       model.operation_name, model.output_type.__name__],
                      sort_keys=True, default=str)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_stage_equals_the_reference(case):
    _, module, cls, kwargs, specs = case
    jout, jmodel = _run("jax", module, cls, kwargs, specs)
    pout, pmodel = _run("port", module, cls, kwargs, specs)
    PP.same_columns(pout, jout)
    assert _state(pmodel) == _state(jmodel)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_saved_stage_loads_in_the_other_package(case):
    """Each package's fitted stage, saved, loads in the other and scores
    EQUAL over the same columns."""
    _, module, cls, kwargs, specs = case
    jout, jmodel = _run("jax", module, cls, kwargs, specs)
    pout, pmodel = _run("port", module, cls, kwargs, specs)
    for src, dst, model, other, want in (("jax", "port", jmodel, pmodel, jout),
                                         ("port", "jax", pmodel, jmodel, pout)):
        entry, arrays = PP.saved_entry(src, model)
        if dst == "jax" and cls in JAX_UNLOADABLE:
            with pytest.raises(ValueError, match="Unknown stage class"):
                PP.load_entry(dst, entry, arrays, other.input_features)
            continue
        loaded = PP.load_entry(dst, entry, arrays, other.input_features)
        assert type(loaded).__name__ == type(model).__name__
        assert _state(loaded) == _state(model)
        cols = [make_column(dst, s) for s in specs]
        got = loaded.transform_columns(*cols, num_rows=N)
        PP.same_columns(got, want)


def test_math_empty_value_rules():
    """The reference's truth tables, read off the port's outputs: plus and
    minus pass a lone side through (minus negates a lone right side);
    multiply and divide need both; x / 0, log and sqrt out of domain and
    overflow are empty."""
    M = _pkg("port")["ops.math"]
    C, T = _pkg("port")["types.columns"], _pkg("port")["types"]
    x = C.NumericColumn(T.Real, np.array([1.0, 0.0, 4.0, -1.0, 1e200]),
                        np.array([True, False, True, True, True]))
    y = C.NumericColumn(T.Real, np.array([0.0, 2.0, 0.0, 1.0, 1e200]),
                        np.array([False, True, True, True, True]))
    plus = M.AddTransformer().transform_columns(x, y, num_rows=5)
    assert plus.mask.tolist() == [True] * 5
    assert plus.values.tolist()[:4] == [1.0, 2.0, 4.0, 0.0]
    minus = M.SubtractTransformer().transform_columns(x, y, num_rows=5)
    assert minus.values.tolist()[:2] == [1.0, -2.0]
    times = M.MultiplyTransformer().transform_columns(x, y, num_rows=5)
    assert times.mask.tolist() == [False, False, True, True, False]
    div = M.DivideTransformer().transform_columns(x, y, num_rows=5)
    assert div.mask.tolist() == [False, False, False, True, True]
    log = M.LogTransformer().transform_columns(x, num_rows=5)
    assert log.mask.tolist() == [True, False, True, False, True]
    sqrt = M.SqrtTransformer().transform_columns(x, num_rows=5)
    assert sqrt.mask.tolist() == [True, False, True, False, True]
    rnd = M.RoundTransformer().transform_columns(
        C.NumericColumn(T.Real, np.array([0.5, -0.5, 1.5, 2.5]),
                        np.ones(4, bool)), num_rows=4)
    assert rnd.values.tolist() == [1.0, -1.0, 2.0, 3.0]


def _descaler_flow(pkg: str):
    M = _pkg(pkg)
    from transmogrifai_tpu_torch.utils import uid as PU
    from transmogrifai_tpu.utils import uid as JU

    (JU if pkg == "jax" else PU).reset()
    if pkg == "jax":
        import transmogrifai_tpu.dsl  # noqa: F401
        from transmogrifai_tpu.features import FeatureBuilder
        from transmogrifai_tpu.workflow.workflow import Workflow
        from transmogrifai_tpu.dataset import Dataset
    else:
        import transmogrifai_tpu_torch.dsl  # noqa: F401
        from transmogrifai_tpu_torch.features import FeatureBuilder
        from transmogrifai_tpu_torch.workflow.workflow import Workflow
        from transmogrifai_tpu_torch.dataset import Dataset
    f0 = FeatureBuilder.Real("f0").as_predictor()
    f1 = FeatureBuilder.Real("f1").as_predictor()
    scaled = f0.scale(scaling_type="Linear", args={"slope": 4.0,
                                                    "intercept": 3.0})
    descaled = (f1 * 2.0).descale(scaled)
    log_scaled = f1.scale(scaling_type="Logarithmic")
    unlogged = f0.descale(log_scaled)
    ds = Dataset.of({"f0": make_column(pkg, "real0"),
                     "f1": make_column(pkg, "real1")})
    wf = Workflow().set_result_features(descaled, unlogged).set_input_dataset(ds)
    if pkg == "jax":
        wf = wf.set_parallelism(None)
    return wf.train(), ds, (descaled, unlogged), M


def test_descaler_finds_the_loaded_scaler(tmp_path):
    """Scaler and descaler through ``train()``, ``save`` and the other
    package's ``load``: the loaded descaler's second input's origin stage is
    the loaded scaler, and every way scores EQUAL."""
    from transmogrifai_tpu.workflow.persistence import load_workflow_model as jl

    from transmogrifai_tpu_torch.workflow.persistence import (
        load_workflow_model as pl,
    )

    jmodel, jds, jfeats, _ = _descaler_flow("jax")
    pmodel, pds, pfeats, _ = _descaler_flow("port")
    names = [f.name for f in pfeats]
    assert names == [f.name for f in jfeats]
    want = jmodel.score(jds)
    for f in names:
        PP.same_columns(pmodel.score(pds)[f], want[f])
    for src, model in (("jax", jmodel), ("port", pmodel)):
        path = str(tmp_path / src)
        model.save(path)
        for dst, load, ds in (("jax", jl, jds),
                              ("port", lambda p: pl(p, device="cpu"), pds)):
            loaded = load(path)
            for stage in loaded.fitted.values():
                if type(stage).__name__ == "DescalerTransformer":
                    origin = stage.input_features[1].origin_stage
                    assert type(origin).__name__ == "ScalerTransformer"
                    assert origin in loaded.fitted.values()
            got = loaded.score(ds)
            for f in names:
                PP.same_columns(got[f], want[f])


# ------------------------------------------------------------ the vocabulary
def _features(pkg: str):
    if pkg == "jax":
        import transmogrifai_tpu.dsl  # noqa: F401
        from transmogrifai_tpu.features import FeatureBuilder
        from transmogrifai_tpu.utils import uid
    else:
        import transmogrifai_tpu_torch.dsl  # noqa: F401
        from transmogrifai_tpu_torch.features import FeatureBuilder
        from transmogrifai_tpu_torch.utils import uid
    uid.reset()
    return {t: getattr(FeatureBuilder, t)(t.lower()).as_predictor()
            for t in ("Real", "Integral", "RealNN", "Text", "RealMap", "Email",
                      "URLMap", "Date", "DateList", "DateMap", "Phone",
                      "PhoneMap", "Prediction")}


#: (id, callable over the features by type) of every vocabulary entry with a
#: ported stage
VOCABULARY = [
    ("add_feature", lambda f: f["Real"] + f["Integral"]),
    ("add_scalar", lambda f: f["Real"] + 2),
    ("sub_feature", lambda f: f["Real"] - f["Integral"]),
    ("sub_scalar", lambda f: f["Real"] - 2.5),
    ("mul_feature", lambda f: f["Real"] * f["RealNN"]),
    ("mul_scalar", lambda f: f["Real"] * 3),
    ("div_feature", lambda f: f["Real"] / f["Integral"]),
    ("div_scalar", lambda f: f["Real"] / 4),
    ("abs", lambda f: f["Real"].abs()),
    ("ceil", lambda f: f["Real"].ceil()),
    ("floor", lambda f: f["Real"].floor()),
    ("round", lambda f: f["Real"].round()),
    ("round_digits", lambda f: f["Real"].round_digits(2)),
    ("exp", lambda f: f["Real"].exp()),
    ("sqrt", lambda f: f["Real"].sqrt()),
    ("log", lambda f: f["Real"].log(base=10.0)),
    ("power", lambda f: f["Real"].power(2.0)),
    ("z_normalize", lambda f: f["Real"].z_normalize()),
    ("fill_missing_with_mean", lambda f: f["Real"].fill_missing_with_mean()),
    ("bucketize", lambda f: f["Real"].bucketize(splits=(0.0, 1.0, 2.0))),
    ("scale", lambda f: f["Real"].scale(scaling_type="Logarithmic")),
    ("descale", lambda f: f["Real"].descale(f["Real"].scale())),
    ("calibrate_percentile", lambda f: f["RealNN"].calibrate_percentile()),
    ("auto_bucketize", lambda f: f["Real"].auto_bucketize(f["RealNN"])),
    ("auto_bucketize_map", lambda f: f["RealMap"].auto_bucketize(
        f["RealNN"], max_depth=3)),
    ("string_indexed", lambda f: f["Text"].string_indexed()),
    ("email_to_pick_list", lambda f: f["Email"].email_to_pick_list()),
    ("url_map_to_pick_list_map", lambda f: f["URLMap"].url_map_to_pick_list_map()),
    ("to_unit_circle", lambda f: f["Date"].to_unit_circle()),
    ("to_time_period", lambda f: f["Date"].to_time_period("DayOfWeek")),
    ("to_time_period_list", lambda f: f["DateList"].to_time_period_list(
        "MonthOfYear")),
    ("to_time_period_map", lambda f: f["DateMap"].to_time_period_map(
        "DayOfMonth")),
    ("alias", lambda f: f["Real"].alias("renamed")),
    ("filter_values", lambda f: f["Real"].filter_values(D.is_positive)),
    ("replace_values", lambda f: f["Text"].replace_values("a", "b")),
    ("substring_of", lambda f: f["Text"].substring_of(f["Text"])),
    ("occurs", lambda f: f["Text"].occurs()),
    ("exists", lambda f: f["Text"].exists()),
    ("filter_map", lambda f: f["RealMap"].filter_map(allow_keys=["a"])),
    ("vectorize", lambda f: f["RealMap"].vectorize(
        allow_keys=["a", "b"], track_nulls=False)),
    ("smart_vectorize", lambda f: f["Text"].smart_vectorize(top_k=3)),
    ("filter_keys", lambda f: f["RealMap"].filter_keys(block_keys=["c"])),
    ("is_valid_phone_map", lambda f: f["PhoneMap"].is_valid_phone_map()),
    ("parse_phone", lambda f: f["Phone"].parse_phone()),
    ("is_valid_phone", lambda f: f["Phone"].is_valid_phone()),
    ("prediction_value", lambda f: f["Prediction"].prediction_value()),
    ("probability_vector", lambda f: f["Prediction"].probability_vector()),
    ("raw_prediction_vector", lambda f: f["Prediction"].raw_prediction_vector()),
    ("tupled", lambda f: f["Prediction"].tupled()[1]),
    # the text vocabulary (RichTextFeature.scala)
    ("tokenize", lambda f: f["Text"].tokenize(min_token_length=2)),
    ("ngram", lambda f: f["Text"].tokenize().ngram(n=3)),
    ("remove_stop_words", lambda f: f["Text"].tokenize().remove_stop_words()),
    ("tf", lambda f: f["Text"].tokenize().tf(num_features=64)),
    ("count_vectorize", lambda f: f["Text"].tokenize().count_vectorize(
        vocab_size=50, min_df=2.0)),
    ("idf", lambda f: f["Text"].tokenize().tf(num_features=32).idf(
        min_doc_freq=1)),
    ("detect_languages", lambda f: f["Text"].detect_languages()),
    ("detect_mime_types", lambda f: f["Text"].detect_mime_types()),
    ("detect_mime_types_map", lambda f: f["URLMap"].detect_mime_types_map()),
    ("is_valid_email", lambda f: f["Email"].is_valid_email()),
    ("recognize_entities", lambda f: f["Text"].recognize_entities()),
    ("word2vec", lambda f: f["Text"].tokenize().word2vec(
        vector_size=8, min_count=1)),
    ("lda", lambda f: f["Text"].tokenize().count_vectorize().lda(k=3)),
    ("jaccard_similarity", lambda f: f["Text"].tokenize().jaccard_similarity(
        f["Text"].tokenize())),
    ("ngram_similarity", lambda f: f["Text"].ngram_similarity(f["Text"], n=2)),
    ("tf_idf", lambda f: f["Text"].tokenize().tf_idf(num_terms=8)),
]


def _lineage(feature) -> list:
    """Each stage above ``feature``: class, operation, params, inputs."""
    out = []
    for stage in sorted(feature.parent_stages(), key=lambda s: s.uid):
        if type(stage).__name__ == "FeatureGeneratorStage":
            continue
        out.append([type(stage).__name__, stage.operation_name,
                    stage.input_names, stage.output_name,
                    json.dumps(stage.get_params(), sort_keys=True, default=str),
                    feature.ftype.__name__])
    return out


@pytest.mark.parametrize("entry", VOCABULARY, ids=[v[0] for v in VOCABULARY])
def test_vocabulary_builds_the_reference_stages(entry):
    _, build = entry
    assert _lineage(build(_features("port"))) == _lineage(
        build(_features("jax")))


def test_vocabulary_has_every_reference_name():
    """Every name ``transmogrifai_tpu/dsl.py`` attaches to ``Feature`` is on
    the port's ``Feature`` and built by a case above (or is
    ``sanity_check``), the text vocabulary's among them."""
    import re

    import transmogrifai_tpu  # noqa: F401  (its dsl, to read its names)
    from transmogrifai_tpu_torch.features.feature import Feature as PF
    import transmogrifai_tpu_torch.dsl  # noqa: F401

    src = os.path.join(os.path.dirname(transmogrifai_tpu.__file__), "dsl.py")
    with open(src) as fh:
        names = set(re.findall(r"^Feature\.(\w+) = ", fh.read(), re.M))
    assert len(names) > 60
    assert names - set(dir(PF)) == set()
    covered = {v[0] for v in VOCABULARY} | {
        "__add__", "__sub__", "__mul__", "__truediv__", "sanity_check"}
    assert names - covered == set()
