"""Sentence splitting, the OpenNLP SentenceDetector replacement: the port's
copy of the JAX package's ``nlp/sentences.py`` (host regex code, the same
rules and lexicons).

The reference's NER pipeline runs sentence-split -> tokenize -> name-finder
(NameEntityRecognizer.scala) over OpenNLP sentence models for 7 languages.
The binary Maxent models are replaced by a rule engine with per-language
abbreviation lexicons:

  * split after [.!?…] (plus any closing quotes/brackets) when followed by
    whitespace and an uppercase/digit sentence opener;
  * never split after a known abbreviation (Mr., z.B., Sr., etc.), a
    single-letter initial (J. K. Rowling), or inside a decimal (3.14),
    an ordinal-number dot (German "3. Oktober"), or an ellipsis run.
"""
from __future__ import annotations

import re

#: per-language abbreviation lexicons (lowercase, no trailing dot) — the
#: high-frequency sets the OpenNLP models implicitly learn
_ABBREV: dict[str, frozenset[str]] = {
    "en": frozenset("""
        mr mrs ms dr prof rev gen sen rep st jr sr messrs mmes capt col
        lt cmdr sgt hon pres gov amb sec treas vs etc al eg ie cf ca approx
        dept univ assn bros inc ltd co corp llc pp
        u.s u.k u.n a.m p.m b.c a.d
    """.split()),
    "de": frozenset("""
        dr prof hr fr frl nr z.b u.a d.h bzw usw ca evtl ggf inkl zzgl
        str mio mrd tel abs bd hrsg jh jhd o.ä u.ä vgl s.o s.u
    """.split()),
    "fr": frozenset("""
        m mm mme mmes mlle mlles dr me pr st ste etc cf p.ex env min max
        tel vol art chap fig réf
    """.split()),
    "es": frozenset("""
        sr sra srta d da dr dra prof lic ing etc p.ej pág cap art núm tel
        av avda gral cía ud uds vd vds
    """.split()),
    "nl": frozenset("""
        dhr mevr dr drs prof ir mr bv nv enz bijv o.a m.b.t t.a.v d.w.z
        e.d blz nr tel
    """.split()),
    "pt": frozenset("""
        sr sra srta dr dra prof eng etc p.ex pág cap art núm tel av gal cia
    """.split()),
    "it": frozenset("""
        sig sigra dott dssa prof ing avv ecc p.es pag cap art num tel
    """.split()),
}

#: abbreviations that are also ordinary words (months, weekdays,
#: no./vol./fig./ed./p.) — they suppress a split ONLY when a digit
#: follows ("Jan. 5", "no. 3"), since "The cat sat. The dog..." must split
_NUMERIC_FOLLOW = frozenset("""
    jan feb mar apr jun jul aug sep sept oct nov dec mon tue wed thu fri
    sat sun no nos vol vols p fig figs ed eds art cap pag núm
""".split())

#: sentence-terminal punctuation + optional closers
_BOUNDARY = re.compile(
    r"""([.!?…]+)            # terminal run
        ([\"'»”’\)\]]*)      # optional closing quotes/brackets
        (\s+)                # whitespace gap
        (?=[\"'«“‘\(\[]*[A-ZÀ-ÖØ-Þ0-9А-ЯΑ-Ω])  # opener: uppercase or digit
    """,
    re.VERBOSE,
)

_WORD_BEFORE = re.compile(r"([\w.'-]+)\Z")


def _abbrevs(language: str | None) -> frozenset[str]:
    return _ABBREV.get((language or "en").lower(), _ABBREV["en"])


def split_sentences(text: str, language: str | None = "en") -> list[str]:
    """Split ``text`` into sentences (whitespace between them consumed;
    original punctuation retained). Empty/whitespace input → []."""
    if not text or not text.strip():
        return []
    abbrevs = _abbrevs(language)
    # ordinal dots after numbers ("3. Oktober") are a German-family
    # convention; in English "on Jan. 5. Dr. White came." the digit ends
    # the sentence
    ordinal_dots = (language or "en").lower() in (
        "de", "cs", "sk", "hu", "fi", "et", "lv", "sl", "hr", "sr",
    )
    out: list[str] = []
    start = 0
    for m in _BOUNDARY.finditer(text):
        dot_run, closers, _gap = m.group(1), m.group(2), m.group(3)
        end = m.start(3)  # sentence ends before the whitespace
        if dot_run == ".":
            before = _WORD_BEFORE.search(text, 0, m.start(1))
            if before:
                w = before.group(1).lower().rstrip(".")
                next_is_digit = text[m.end(3):m.end(3) + 1].isdigit()
                is_number = w.replace(".", "").isdigit()
                if (
                    w in abbrevs
                    or (w in _NUMERIC_FOLLOW and next_is_digit)
                    or len(w) == 1 and w.isalpha()   # initials: J. K.
                    or (ordinal_dots and is_number)  # German "3. Oktober"
                    # dotted acronym (U.S.) — but a decimal like 3.5 ending
                    # a sentence is a REAL boundary
                    or ("." in w and not is_number)
                ):
                    continue
        out.append(text[start:end].strip())
        start = m.end(3)
    tail = text[start:].strip()
    if tail:
        out.append(tail)
    return [s for s in out if s]
