"""The port's NLP plane (``transmogrifai_tpu_torch/nlp/`` and
``utils/analyzers.py``) against the JAX package's, on the CPU.

Host code in both packages, so every output is held EQUAL: language
identification over the labeled corpus ``tests/fixtures/langid_corpus.json``,
the sentence splitter, the POS tagger and noun-phrase chunker over the gold
corpora, the per-language analyzers and stemmers, and the name model's
probabilities. The golden cases of the JAX package's
``tests/test_nlp_fixture_agreement.py``, ``tests/test_langid.py`` and
``tests/test_pos.py`` run through the port with their own expectations.
"""
import filecmp
import importlib.util
import json
import os

import pytest
import torch

from transmogrifai_tpu.nlp import langid as JL
from transmogrifai_tpu.nlp import name_model as JN
from transmogrifai_tpu.nlp import pos as JP
from transmogrifai_tpu.nlp import sentences as JS
from transmogrifai_tpu.utils import analyzers as JA
from transmogrifai_tpu_torch.nlp import langid as PL
from transmogrifai_tpu_torch.nlp import name_model as PN
from transmogrifai_tpu_torch.nlp import pos as PP
from transmogrifai_tpu_torch.nlp import sentences as PS
from transmogrifai_tpu_torch.utils import analyzers as PA

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CORPUS = json.load(open(os.path.join(HERE, "fixtures", "langid_corpus.json")))
LANGS = sorted(k for k in CORPUS if not k.startswith("_"))
SENTENCES = [s for lang in LANGS for s in CORPUS[lang]]
POS_GOLD = json.load(open(os.path.join(HERE, "fixtures", "pos_gold.json")))


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the JAX package's golden data, read from its own tests and harness
GOLD = _module(os.path.join(HERE, "test_nlp_fixture_agreement.py"),
               "torch_nlp_reference_goldens")
AGREE = _module(os.path.join(ROOT, "tools", "nlp_agreement.py"),
                "torch_nlp_reference_harness")

LANGUAGE_GOLDEN = [
    ("da", "jeg spiser kagerne og æblerne", ["spis", "kag", "æbl"]),
    ("sv", "bilarna och husen är stora", ["bil", "hus", "stor"]),
    ("de", "die Häusern und Kinder", ["haus", "kind"]),
    ("es", "las casas y los libros", ["cas", "libr"]),
    ("pt", "os livros e as casas", ["livr", "cas"]),
    ("nl", "de katten en de honden", ["kat", "hond"]),
]


def test_name_model_resource_is_the_reference_copy():
    """The port reads its own resource, byte-equal to the JAX package's."""
    assert PN._RESOURCE.startswith(os.path.join(ROOT, "transmogrifai_tpu_torch"))
    assert filecmp.cmp(PN._RESOURCE, JN._RESOURCE, shallow=False)


# ------------------------------------------------------------ language id
@pytest.mark.parametrize("lang", LANGS)
def test_langid_equals_the_reference_per_language(lang):
    """Every labeled sentence: ``detect`` and ``detect_scores`` EQUAL, and
    the port wins the language's majority as the JAX package's test asks."""
    sents = CORPUS[lang]
    for s in sents:
        assert PL.detect(s) == JL.detect(s), s
        assert PL.detect_scores(s) == JL.detect_scores(s), s
    assert sum(PL.detect(s) == lang for s in sents) * 2 >= len(sents)


def test_langid_reference_goldens():
    assert len(PL.SUPPORTED_LANGUAGES) >= 50
    assert PL.SUPPORTED_LANGUAGES == JL.SUPPORTED_LANGUAGES
    hits = sum(PL.detect(s) == lang for lang in LANGS for s in CORPUS[lang])
    assert hits / len(SENTENCES) >= 0.9
    scores = PL.detect_scores("le chat est sur la table avec les enfants")
    assert list(scores)[0] == "fr"
    assert abs(sum(scores.values()) - 1.0) < 1e-9 and len(scores) <= 3
    assert PL.detect_scores("") == {} and PL.detect_scores("12345 !!!") == {}
    assert PL.detect("Η επιτροπή απέρριψε την πρόταση") == "el"
    assert PL.detect("委員会はその提案を拒否した") == "ja"
    assert PL.detect("委员会拒绝了这个提议") == "zh"
    assert PL.detect("위원회는 그 제안을 거절했다") == "ko"


# -------------------------------------------------------------- sentences
def test_sentence_splitter_equals_the_reference():
    """Paragraphs of each language's sentences, and the abbreviation,
    initial, decimal and ordinal cases, split EQUAL in every language."""
    cases = [" ".join(CORPUS[lang]) for lang in LANGS] + [
        "Mr. Smith met Dr. J. K. Rowling at 3.14 p.m. today. It rained!",
        "Am 3. Oktober kam er z.B. nach Berlin. Dann ging er...",
        "\"The dog barked.\" Then it slept? Yes… it did.",
    ]
    for text in cases:
        for lang in ("en", "de", "es", "fr", "nl", "pt", None):
            kw = {} if lang is None else {"language": lang}
            assert PS.split_sentences(text, **kw) == JS.split_sentences(
                text, **kw), (lang, text)


# -------------------------------------------------------------------- POS
@pytest.mark.parametrize("lang", sorted(POS_GOLD))
def test_pos_tags_and_chunks_equal_the_reference(lang):
    hits = total = 0
    for toks, gold in POS_GOLD[lang]:
        tags = PP.pos_tag(toks, language=lang)
        assert tags == JP.pos_tag(toks, language=lang), toks
        assert PP.chunk_noun_phrases(toks, language=lang) == \
            JP.chunk_noun_phrases(toks, language=lang)
        hits += sum(a == b for a, b in zip(tags, gold))
        total += len(gold)
    assert hits / total >= 0.9


def test_pos_reference_goldens():
    hits = total = 0
    for toks, gold in AGREE.POS_GOLD:
        tags = PP.pos_tag(toks)
        assert tags == JP.pos_tag(toks)
        hits += sum(a == b for a, b in zip(tags, gold))
        total += len(gold)
    assert hits / total >= 0.9
    assert PP.pos_tag(["the"]) == ["DT"] and PP.pos_tag(["would"]) == ["MD"]
    tags = PP.pos_tag(["He", "sadly", "watched", "the", "sinking", "ship"])
    assert tags[1] == "RB" and tags[2] == "VBD" and tags[4] in ("VBG", "JJ")
    assert PP.pos_tag(["the", "building"])[-1] == "NN"
    assert PP.pos_tag(["they", "must", "report"])[-1] == "VB"
    assert PP.pos_tag(["Stop", "!"])[-1] == "."
    assert PP.pos_tag(["the", "dog"], language="zz") == ["DT", "NN"]
    assert "The old house" in PP.chunk_noun_phrases(
        "The old house had a beautiful garden".split())
    nps = PP.chunk_noun_phrases(
        "Die Lehrerin las eine interessante Geschichte .".split(), language="de")
    assert "Die Lehrerin" in nps and "eine interessante Geschichte" in nps
    nps = PP.chunk_noun_phrases(
        "Ella compró una casa nueva en la ciudad .".split(), language="es")
    assert "una casa nueva" in nps and "la ciudad" in nps
    assert "ett stort hus" in PP.chunk_noun_phrases(
        "Hon köpte ett stort hus i staden .".split(), language="sv")


# -------------------------------------------------------------- analyzers
@pytest.mark.parametrize("lang", sorted(JA.ANALYZERS))
def test_analyzer_equals_the_reference(lang):
    """Each analyzer over every corpus sentence (and its stemmer over every
    token) EQUAL the JAX package's."""
    assert PA.analyzer_for(lang).language == JA.analyzer_for(lang).language
    for s in SENTENCES:
        assert PA.analyze(s, language=lang) == JA.analyze(s, language=lang)
        for tok in PA.analyze(s):
            assert PA.ANALYZERS[lang].stem(tok) == JA.ANALYZERS[lang].stem(tok)


def test_analyzer_reference_goldens():
    for word, want in GOLD.PORTER_GOLDEN:
        assert PA.porter_stem(word) == want == JA.porter_stem(word)
    assert PA.ANALYZERS["en"].analyze(
        "The quick brown foxes are jumping over the dogs") == [
            "quick", "brown", "fox", "jump", "over", "dog"]
    assert PA.ANALYZERS["en"].analyze("John's houses") == ["john", "hous"]
    for lang, text, want in LANGUAGE_GOLDEN:
        assert PA.ANALYZERS[lang].analyze(text) == want
    for golden in (GOLD.ANALYZER_GOLDEN_V2, GOLD.ANALYZER_GOLDEN_V3):
        for lang, cases in golden.items():
            for text, want in cases:
                assert PA.analyze(text, language=lang) == want, (lang, text)
    assert len(PA.ANALYZERS) == len(JA.ANALYZERS) >= 35
    assert PA.analyzer_for("se").language == "sv"
    assert PA.analyzer_for("xx").language == ""
    assert PA.detect_language(
        "das ist ein sehr schönes Haus und wir sind hier") == "de"
    assert PA.analyze("the dogs are running", auto_detect=True) == ["dog", "run"]
    assert PA.analyze("The Cats Are Here", language="xx") == [
        "the", "cats", "are", "here"]
    assert PA.analyze("İstanbul'daki yeni kitapları", language="tr") == [
        "istanbul", "yen", "kitap"]
    assert PA.analyze("图书馆", language="zh") == ["图书", "书馆"]
    assert PA.analyze("新しい本", language="ja") == ["新し", "しい", "い本"]
    toks = PA.analyze("ห้องสมุดใหม่", language="th")
    assert toks and all(1 <= len(t) <= 2 for t in toks)
    for lang, a, b in [("bg", "котка", "котките"), ("id", "membaca", "baca"),
                       ("fa", "كتاب", "کتاب"), ("uk", "бібліотека",
                                                "бібліотеках")]:
        assert PA.ANALYZERS[lang].stem(a) == PA.ANALYZERS[lang].stem(b)


# ------------------------------------------------------------- name model
def test_name_model_equals_the_reference():
    """P(name) EQUAL over the dictionary, the golden unseen and novel
    names, the non-names and every corpus token."""
    tokens = sorted(set(
        list(GOLD._COMMON_NAMES) + GOLD._UNSEEN_NAMES + GOLD._NON_NAMES
        + ["bartholomew", "gwendolyn", "thaddeus", "ingeborg", "vladislava",
           "marisella", "o'brien", "x1", ""]
        + [t for s in SENTENCES for t in s.lower().split()]))
    for t in tokens:
        assert PN.name_probability(t) == JN.name_probability(t), t
    assert sum(PN.name_probability(n) >= 0.5
               for n in GOLD._UNSEEN_NAMES) >= len(GOLD._UNSEEN_NAMES) - 1
    assert all(PN.name_probability(w) < 0.5 for w in GOLD._NON_NAMES)
