"""The port's text stages (``transmogrifai_tpu_torch/ops/text_stages.py``)
against the JAX package's: the same numpy-seeded columns through both, on
the CPU.

Host numpy in both packages, so every output is held EQUAL: token lists and
their interned vocabularies, term vectors (dense and COO) with their
metadata, the fitted vocabularies, orders, tie-breaks and IDF weights, the
detectors' maps and the similarities; each fitted stage's metadata too.
Each fitted model also crosses over: saved by one package's manifest
writer, loaded by the other's loader, and run there EQUAL.
"""
import base64
import importlib.util
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "port_pairs", os.path.join(HERE, "torch_fixtures", "port_pairs.py"))
PP = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(PP)

WORDS = ("the a of and to is Data data science Model model learning tree "
         "trees forest gradient boosting résumé naïve café über straße "
         "James Mary Annabelle Thorsten Smith Johnson Acme Corp Inc river "
         "street London Paris 2024 x1 C++ e-mail o'brien").split()
EMAILS = ["a@b.co", "first.last@corp.example.com", "not-an-email", "",
          "user@nodot", "x+tag@gmail.com", "UPPER@CASE.COM", "@nouser.com"]
MAGIC = [b"%PDF-1.4 body", b"\x89PNG\r\n\x1a\nxxxx", b"\xff\xd8\xffjpeg",
         b"GIF89a...", b"PK\x03\x04zip", b"\x1f\x8bgz", b"plain text here",
         b"\x00\x01\x02\xff\xfe", b"<html><body>", b"<?xml version"]


def texts(n: int, seed: int, words=WORDS) -> list:
    """Rows of 0-12 words drawn from ``words``, with missing rows and
    sentence punctuation."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 13))
        if k == 0:
            out.append(None if rng.random() < 0.5 else "")
            continue
        toks = [words[i] for i in rng.integers(0, len(words), k)]
        s = " ".join(toks)
        out.append(s + (". " + s.capitalize() + "!" if rng.random() < 0.3 else ""))
    return out


def names_column(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    first = ["James", "Mary", "Annabelle", "Thorsten", "Svetlana", "Giuseppina",
             "Mr.", "Mrs.", "Jordan", "Georgia"]
    last = ["Smith", "Dupont", "Müller", "Petrova", "Rossi", "Brown", "Avenue",
            "Road", "Ecuador"]
    return [None if rng.random() < 0.05 else
            f"{first[rng.integers(len(first))]} {last[rng.integers(len(last))]}"
            for _ in range(n)]


def column(pkg: str, type_name: str, rows: list):
    if pkg == "jax":
        import transmogrifai_tpu.types as T
        from transmogrifai_tpu.types.columns import column_from_values
    else:
        import transmogrifai_tpu_torch.types as T
        from transmogrifai_tpu_torch.types.columns import column_from_values
    return column_from_values(getattr(T, type_name), rows)


def stages(pkg: str):
    if pkg == "jax":
        from transmogrifai_tpu.ops import text_stages as S
    else:
        from transmogrifai_tpu_torch.ops import text_stages as S
    return S


def same_out(a, b) -> None:
    """EQUAL columns; a COO plane's pairs, values and shape compared as
    stored."""
    va, vb = getattr(a, "values", None), getattr(b, "values", None)
    if type(va).__name__ == "SparseMatrix":
        assert type(vb).__name__ == "SparseMatrix"
        assert va.shape == vb.shape
        np.testing.assert_array_equal(va.rows, vb.rows)
        np.testing.assert_array_equal(va.cols, vb.cols)
        assert (va.vals is None) == (vb.vals is None)
        if va.vals is not None:
            np.testing.assert_array_equal(va.vals, vb.vals)
        assert PP.metas(a) == PP.metas(b)
        return
    PP.same_columns(a, b)
    if type(a).__name__ == "InternedTextList":
        assert a.interned.vocab == b.interned.vocab
        np.testing.assert_array_equal(a.interned.codes, b.interned.codes)
        np.testing.assert_array_equal(a.interned.offsets, b.interned.offsets)


def run_both(make, type_names, rows_list, names=None):
    """(jax output, port output, jax stage, port stage) of ``make(S)`` over
    the columns of ``rows_list``."""
    outs = {}
    for pkg in ("jax", "port"):
        cols = [column(pkg, t, r) if not callable(r) else r(pkg)
                for t, r in zip(type_names, rows_list)]
        outs[pkg] = PP.run_typed(pkg, make(stages(pkg)), type_names, cols, names)
    (ja, jm), (po, pm) = outs["jax"], outs["port"]
    same_out(ja, po)
    assert jm.metadata == pm.metadata
    return ja, po, jm, pm


def crossed(jm, pm, type_names, rows_list) -> None:
    """Each package's fitted stage, saved and loaded by the other, runs
    EQUAL to the original on the same columns."""
    for src, dst, stage in (("jax", "port", jm), ("port", "jax", pm)):
        entry, arrays = PP.saved_entry(src, stage)
        if dst == "jax":
            from transmogrifai_tpu.dataset import Dataset
            from transmogrifai_tpu.features import FeatureBuilder
        else:
            from transmogrifai_tpu_torch.dataset import Dataset
            from transmogrifai_tpu_torch.features import FeatureBuilder
        names = [f"f{i}" for i in range(len(type_names))]
        feats = [getattr(FeatureBuilder, t)(nm).as_predictor()
                 for t, nm in zip(type_names, names)]
        loaded = PP.load_entry(dst, entry, arrays, feats)
        assert type(loaded).__name__ == type(stage).__name__
        n = len(rows_list[0])
        got = loaded.transform_columns(
            *[column(dst, t, r) for t, r in zip(type_names, rows_list)],
            num_rows=n)
        want = stage.transform_columns(
            *[column(src, t, r) for t, r in zip(type_names, rows_list)],
            num_rows=n)
        same_out(got, want)


TEXT = texts(300, 7)
TEXT_B = texts(300, 8)


# ------------------------------------------------------------- tokenizers
@pytest.mark.parametrize("params", [
    {}, {"min_token_length": 3}, {"to_lowercase": False},
    {"language": "en"}, {"language": "de", "min_token_length": 2},
    {"auto_detect_language": True},
], ids=["default", "min3", "case", "en", "de", "auto"])
def test_text_tokenizer_equals_the_reference(params):
    run_both(lambda S: S.TextTokenizer(**params), ["Text"], [TEXT])


def tokenized(pkg: str, rows=TEXT):
    S = stages(pkg)
    out, _ = PP.run_typed(pkg, S.TextTokenizer(), ["Text"], [column(pkg, "Text", rows)])
    return out


@pytest.mark.parametrize("n", [1, 2, 3])
def test_ngram_equals_the_reference(n):
    run_both(lambda S: S.OpNGram(n=n), ["TextList"], [tokenized])


@pytest.mark.parametrize("params", [
    {}, {"case_sensitive": True},
    {"stop_words": ["data", "Model", "trees"], "case_sensitive": False},
], ids=["default", "case_sensitive", "custom"])
def test_stop_words_remover_equals_the_reference(params):
    ja, po, jm, pm = run_both(lambda S: S.OpStopWordsRemover(**params),
                              ["TextList"], [tokenized])
    crossed(jm, pm, ["TextList"], [[list(r) for r in ja.to_list()]])


# ----------------------------------------------------------- term vectors
@pytest.mark.parametrize("params", [
    {}, {"vocab_size": 10}, {"min_df": 3.0}, {"min_df": 0.05},
    {"binary": True, "vocab_size": 25},
], ids=["default", "vocab10", "min_df3", "min_df_frac", "binary"])
def test_count_vectorizer_equals_the_reference(params):
    ja, po, jm, pm = run_both(lambda S: S.OpCountVectorizer(**params),
                              ["TextList"], [tokenized])
    assert jm.vocab == pm.vocab
    crossed(jm, pm, ["TextList"], [[list(r) for r in tokenized("jax").to_list()]])


def test_count_vectorizer_sparse_plane_equals_the_reference(monkeypatch):
    """Past the dense width the plane is COO in both packages, and the IDF
    over it stays COO with EQUAL values."""
    from transmogrifai_tpu.featurize import kernels as JK
    from transmogrifai_tpu_torch.featurize import kernels as PK

    monkeypatch.setattr(JK, "DENSE_VOCAB_MAX", 8)
    monkeypatch.setattr(PK, "DENSE_VOCAB_MAX", 8)
    ja, po, _, _ = run_both(lambda S: S.OpCountVectorizer(), ["TextList"],
                            [tokenized])
    assert type(po.values).__name__ == "SparseMatrix"

    def counts(pkg):
        return (ja if pkg == "jax" else po)

    ja2, po2, jm, pm = run_both(lambda S: S.OpIDF(), ["OPVector"], [counts])
    assert type(po2.values).__name__ == "SparseMatrix"
    np.testing.assert_array_equal(jm.idf, pm.idf)


@pytest.mark.parametrize("params", [{}, {"num_features": 64},
                                    {"num_features": 16, "binary": True}],
                         ids=["default", "w64", "binary"])
def test_hashing_tf_equals_the_reference(params):
    run_both(lambda S: S.OpHashingTF(**params), ["TextList"], [tokenized])


@pytest.mark.parametrize("min_doc_freq", [0, 3])
def test_idf_equals_the_reference(min_doc_freq):
    def hashed(pkg):
        S = stages(pkg)
        out, _ = PP.run_typed(pkg, S.OpHashingTF(num_features=32),
                              ["TextList"], [tokenized(pkg)])
        return out

    ja, po, jm, pm = run_both(lambda S: S.OpIDF(min_doc_freq=min_doc_freq),
                              ["OPVector"], [hashed])
    assert jm.idf.dtype == pm.idf.dtype
    np.testing.assert_array_equal(jm.idf, pm.idf)
    for src, dst, stage in (("jax", "port", jm), ("port", "jax", pm)):
        entry, arrays = PP.saved_entry(src, stage)
        if dst == "jax":
            from transmogrifai_tpu.features import FeatureBuilder
        else:
            from transmogrifai_tpu_torch.features import FeatureBuilder
        loaded = PP.load_entry(dst, entry, arrays,
                               [FeatureBuilder.OPVector("f0").as_predictor()])
        same_out(loaded.transform_columns(hashed(dst), num_rows=len(TEXT)),
                 stage.transform_columns(hashed(src), num_rows=len(TEXT)))


# ------------------------------------------------------------ similarities
def test_jaccard_similarity_equals_the_reference():
    run_both(lambda S: S.JaccardSimilarity(), ["TextList", "TextList"],
             [tokenized, lambda pkg: tokenized(pkg, TEXT_B)])


@pytest.mark.parametrize("n", [2, 3])
def test_ngram_similarity_equals_the_reference(n):
    run_both(lambda S: S.NGramSimilarity(n=n), ["Text", "Text"], [TEXT, TEXT_B])
    run_both(lambda S: S.NGramSimilarity(n=n), ["TextList", "TextList"],
             [tokenized, lambda pkg: tokenized(pkg, TEXT_B)])


# --------------------------------------------------------------- detectors
def test_lang_detector_equals_the_reference():
    import json

    corpus = json.load(open(os.path.join(HERE, "fixtures",
                                         "langid_corpus.json")))
    rows = [s for k, v in sorted(corpus.items()) if not k.startswith("_")
            for s in v] + TEXT[:40] + [None, ""]
    run_both(lambda S: S.LangDetector(), ["Text"], [rows])


def test_mime_detectors_equal_the_reference():
    rng = np.random.default_rng(3)
    payloads = [base64.b64encode(MAGIC[i]).decode()
                for i in rng.integers(0, len(MAGIC), 60)]
    rows = payloads + ["not base64 !!", "", None, "AAAA"]
    run_both(lambda S: S.MimeTypeDetector(), ["Base64"], [rows])
    maps = [{f"k{j}": rows[(i + j) % len(rows)] for j in range(i % 4)
             if rows[(i + j) % len(rows)] is not None} for i in range(50)]
    run_both(lambda S: S.MimeTypeMapDetector(), ["Base64Map"], [maps])


def test_valid_email_equals_the_reference():
    rng = np.random.default_rng(4)
    rows = [EMAILS[i] for i in rng.integers(0, len(EMAILS), 80)] + [None]
    run_both(lambda S: S.ValidEmailTransformer(), ["Email"], [rows])


@pytest.mark.parametrize("params,rows", [
    ({}, names_column(200, 5)),
    ({"use_model": False}, names_column(200, 6)),
    ({"threshold": 0.9}, names_column(200, 7)),
    ({}, texts(200, 9)),
], ids=["names", "dictionary", "threshold", "free_text"])
def test_human_name_detector_equals_the_reference(params, rows):
    ja, po, jm, pm = run_both(lambda S: S.HumanNameDetector(**params),
                              ["Text"], [rows])
    assert jm.treat_as_name == pm.treat_as_name
    crossed(jm, pm, ["Text"], [rows])


def test_name_entity_recognizer_equals_the_reference():
    rows = texts(150, 11) + [
        "Mary Johnson visited the London office of Acme Corp.",
        "\"The dog barked.\" Then Annabelle van der Berg left for Paris.",
        "Ana García trabaja en Madrid. Sophie van Dijk reisde.", None]
    run_both(lambda S: S.NameEntityRecognizer(), ["Text"], [rows])
