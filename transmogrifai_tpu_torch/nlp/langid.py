"""Language identification, the OptimaizeLanguageDetector replacement: the
port's copy of the JAX package's ``nlp/langid.py`` (host code, the same
profiles and votes).

Reference: core/.../utils/text/OptimaizeLanguageDetector.scala (Optimaize
ships char-n-gram profiles for ~70 languages). This detector covers ~55
ISO-639-1 codes in two tiers, compact enough to live in source:

  1. SCRIPT tier — a Unicode block census decides non-Latin languages
     outright (Hangul → ko, kana → ja, Thai → th, ...); Cyrillic and
     Arabic scripts disambiguate via marker characters + function words.
  2. LATIN tier — weighted voting: function-word (stopword) hits count 1
     per token, language-specific diacritics add fractional evidence
     (breaks en/nl, es/pt, da/no/sv style ties on short inputs).

The labeled corpus ``tests/fixtures/langid_corpus.json`` measures it.
"""
from __future__ import annotations

from functools import lru_cache

# --------------------------------------------------------------------------
# script tier
# --------------------------------------------------------------------------
#: unicode block → script bucket (start, end, tag) — coarse, covers the
#: blocks the detector cares about
_SCRIPT_RANGES: list[tuple[int, int, str]] = [
    (0x0370, 0x03FF, "greek"),
    (0x0400, 0x04FF, "cyrillic"),
    (0x0530, 0x058F, "armenian"),
    (0x0590, 0x05FF, "hebrew"),
    (0x0600, 0x06FF, "arabic"),
    (0x0750, 0x077F, "arabic"),
    (0x0900, 0x097F, "devanagari"),
    (0x0980, 0x09FF, "bengali"),
    (0x0A00, 0x0A7F, "gurmukhi"),
    (0x0A80, 0x0AFF, "gujarati"),
    (0x0B80, 0x0BFF, "tamil"),
    (0x0C00, 0x0C7F, "telugu"),
    (0x0C80, 0x0CFF, "kannada"),
    (0x0D00, 0x0D7F, "malayalam"),
    (0x0D80, 0x0DFF, "sinhala"),
    (0x0E00, 0x0E7F, "thai"),
    (0x0E80, 0x0EFF, "lao"),
    (0x10A0, 0x10FF, "georgian"),
    (0x1200, 0x137F, "ethiopic"),
    (0x1780, 0x17FF, "khmer"),
    (0x1000, 0x109F, "myanmar"),
    (0x3040, 0x309F, "kana"),      # hiragana
    (0x30A0, 0x30FF, "kana"),      # katakana
    (0xAC00, 0xD7AF, "hangul"),
    (0x4E00, 0x9FFF, "han"),
    (0x3400, 0x4DBF, "han"),
]

#: scripts that map to one language directly
_SCRIPT_LANG = {
    "greek": "el", "armenian": "hy", "hebrew": "he", "devanagari": "hi",
    "bengali": "bn", "gurmukhi": "pa", "gujarati": "gu", "tamil": "ta",
    "telugu": "te", "kannada": "kn", "malayalam": "ml", "sinhala": "si",
    "thai": "th", "lao": "lo", "georgian": "ka", "ethiopic": "am",
    "khmer": "km", "myanmar": "my", "hangul": "ko",
}


def _script_census(text: str) -> dict[str, int]:
    counts: dict[str, int] = {}
    for ch in text:
        if not ch.isalpha():
            # digits/punctuation carry no language evidence even when they
            # live inside a script block (Arabic-Indic or Thai digits)
            continue
        cp = ord(ch)
        if cp < 0x370:
            counts["latin"] = counts.get("latin", 0) + 1
            continue
        for lo, hi, tag in _SCRIPT_RANGES:
            if lo <= cp <= hi:
                counts[tag] = counts.get(tag, 0) + 1
                break
        else:
            counts["latin"] = counts.get("latin", 0) + 1
    return counts


# Cyrillic disambiguation: marker characters unique (or near) per language
_CYRILLIC_MARKERS = {
    "uk": set("іїєґ"),
    "sr": set("ђћџљњј"),
    "mk": set("ѓќѕј"),
    "bg": set("ъщ"),   # ъ far more frequent than in ru running text
}
_CYRILLIC_STOPS = {
    "ru": {"и", "в", "не", "на", "что", "он", "как", "это", "его", "но",
           "из", "был", "она", "или", "же", "мы", "от", "для"},
    "uk": {"і", "в", "не", "на", "що", "він", "як", "це", "його", "але",
           "із", "був", "вона", "або", "ми", "від", "для", "та"},
    "bg": {"и", "в", "не", "на", "че", "той", "как", "това", "но", "от",
           "за", "се", "да", "са", "като", "със"},
    "sr": {"и", "у", "не", "на", "што", "он", "као", "то", "али", "из",
           "био", "она", "или", "ми", "од", "за", "је", "су"},
    "mk": {"и", "во", "не", "на", "што", "тој", "како", "тоа", "но", "од",
           "за", "се", "да", "со", "беше", "е"},
}

# Arabic-script disambiguation
_ARABIC_MARKERS = {
    "fa": set("پچژگ"),
    "ur": set("ٹڈڑےھں"),
}
_ARABIC_STOPS = {
    "ar": {"في", "من", "على", "إلى", "عن", "هذا", "أن", "هو", "مع", "كان",
           "التي", "الذي", "لا", "ما", "هي"},
    "fa": {"در", "از", "به", "که", "این", "است", "را", "با", "آن", "برای",
           "بود", "شد", "تا", "می", "های"},
    "ur": {"میں", "سے", "کے", "کی", "کا", "کو", "ہے", "اور", "یہ", "پر",
           "نے", "تھا", "ہیں", "لیے"},
}


# --------------------------------------------------------------------------
# latin tier — function words + diacritic evidence
# --------------------------------------------------------------------------
#: per-language high-frequency function words (compact; the voting only
#: needs relative evidence, not full stopword coverage)
_LATIN_STOPS: dict[str, set[str]] = {
    "en": {"the", "and", "of", "to", "in", "is", "that", "it", "was", "for",
           "with", "his", "they", "this", "have", "from", "not", "are"},
    "fr": {"le", "la", "les", "des", "est", "dans", "que", "qui", "une",
           "pour", "pas", "sur", "avec", "sont", "mais", "nous", "vous",
           "été", "cette", "aux"},
    "de": {"der", "die", "das", "und", "ist", "nicht", "ein", "eine", "mit",
           "auf", "für", "sich", "dem", "den", "von", "auch", "werden",
           "sind", "einer", "zu"},
    "es": {"el", "la", "los", "las", "que", "en", "una", "por", "con",
           "para", "está", "como", "pero", "más", "sus", "este", "ser",
           "son", "del"},
    "pt": {"o", "os", "das", "dos", "que", "em", "uma", "por", "com",
           "para", "não", "como", "mas", "mais", "seus", "este", "ser",
           "são", "foi", "você"},
    "it": {"il", "lo", "gli", "che", "di", "una", "per", "con", "non",
           "come", "ma", "più", "sono", "della", "nel", "questo", "essere",
           "anche", "del", "ha", "già", "questa", "alla", "dalla",
           "queste", "degli", "hanno"},
    "nl": {"de", "het", "een", "van", "en", "is", "dat", "niet", "met",
           "voor", "zijn", "maar", "ook", "deze", "wordt", "naar", "hebben",
           "aan", "bij"},
    "da": {"og", "det", "er", "en", "af", "til", "ikke", "der", "på", "med",
           "han", "for", "den", "som", "var", "hun", "vil", "havde", "men",
           "at", "har", "deres", "denne", "alligevel", "uge", "hvad",
           "hvor", "blev", "efter", "også", "kunne", "skulle"},
    "sv": {"och", "det", "är", "en", "ett", "av", "till", "inte", "som",
           "på", "med", "han", "för", "den", "var", "hon", "ska", "hade",
           "från"},
    "no": {"og", "det", "er", "en", "et", "av", "til", "ikke", "som", "på",
           "med", "han", "for", "den", "var", "hun", "skal", "hadde",
           "fra", "å", "har", "denne", "sine", "seg", "etter", "ble",
           "noen", "bare", "eller", "uken", "mot"},
    "fi": {"ja", "on", "ei", "että", "se", "hän", "oli", "mutta", "kun",
           "niin", "myös", "ovat", "joka", "tämä", "olla", "jos", "mitä"},
    "et": {"ja", "on", "ei", "et", "see", "ta", "oli", "aga", "kui", "ka",
           "seda", "mis", "oma", "siis", "või", "ning"},
    "hu": {"és", "a", "az", "hogy", "nem", "egy", "van", "volt", "de",
           "is", "ez", "amely", "meg", "csak", "már", "mint", "vagy"},
    "pl": {"i", "w", "nie", "na", "się", "jest", "że", "do", "z", "to",
           "jak", "ale", "był", "jego", "przez", "tym", "oraz", "które"},
    "cs": {"a", "v", "se", "na", "je", "že", "do", "to", "jak", "ale",
           "byl", "jeho", "před", "této", "který", "jsou", "nebo", "už",
           "si", "od", "kde", "co", "není", "byla", "bylo", "také",
           "ještě", "při", "než"},
    "sk": {"a", "v", "sa", "na", "je", "že", "do", "to", "ako", "ale",
           "bol", "jeho", "pred", "tejto", "ktorý", "sú", "alebo", "už",
           "si", "od", "kde", "čo", "aj", "som", "nie", "bola", "bolo",
           "ešte", "podľa"},
    "sl": {"in", "je", "se", "na", "da", "za", "so", "ki", "bil", "ali",
           "tudi", "kot", "pa", "bi", "ne", "ta", "ni", "to", "kje",
           "še", "bilo", "tak", "prav"},
    "hr": {"i", "u", "se", "na", "je", "da", "za", "su", "bio", "ili",
           "kako", "ali", "što", "koji", "nije", "ovo", "biti"},
    "ro": {"și", "în", "nu", "la", "este", "că", "din", "cu", "pentru",
           "dar", "fost", "mai", "care", "sunt", "sau", "această", "prin"},
    "ca": {"el", "els", "que", "en", "una", "per", "amb", "no", "com",
           "però", "més", "són", "aquest", "ser", "també", "dels", "és",
           "on", "va", "ha", "havia", "aquesta", "seva", "pel", "als"},
    "tr": {"ve", "bir", "bu", "için", "ile", "de", "da", "ne", "gibi",
           "daha", "çok", "ama", "olarak", "olan", "var", "değil", "sonra"},
    "vi": {"và", "của", "là", "có", "không", "được", "trong", "một",
           "người", "này", "cho", "với", "các", "đã", "những", "để"},
    "id": {"dan", "yang", "di", "itu", "dengan", "untuk", "tidak", "ini",
           "dari", "dalam", "akan", "pada", "juga", "ke", "karena", "ada"},
    "sq": {"dhe", "në", "një", "për", "me", "nuk", "që", "është", "të",
           "nga", "por", "kjo", "janë", "ka", "si", "më"},
    "lt": {"ir", "yra", "ne", "kad", "į", "su", "bet", "tai", "buvo",
           "kaip", "jis", "iš", "ar", "apie", "jos", "per", "ji", "kur",
           "kai", "jau", "dar", "tik", "prie", "nuo", "savo"},
    "lv": {"un", "ir", "ne", "ka", "uz", "ar", "bet", "tas", "bija", "kā",
           "viņš", "no", "vai", "par", "tā", "pēc", "nav", "jau", "vēl",
           "kad", "šī", "tomēr", "viņa", "savas"},
    "is": {"og", "að", "er", "í", "á", "ekki", "sem", "það", "var", "hann",
           "en", "hún", "við", "um", "til", "þetta"},
    "ga": {"agus", "an", "na", "is", "i", "ar", "go", "ní", "sé", "le",
           "bhí", "sí", "ach", "do", "tá", "seo"},
    "eu": {"eta", "da", "ez", "bat", "du", "ere", "baina", "hori", "zen",
           "dira", "izan", "dute", "egin", "honen"},
    "cy": {"a", "yn", "y", "yr", "i", "o", "mae", "ei", "ar", "nid", "oedd",
           "gan", "hyn", "wedi", "am", "fod"},
    "af": {"en", "die", "is", "nie", "van", "het", "dat", "met", "vir",
           "om", "was", "hy", "sy", "maar", "ook", "aan"},
    "sw": {"na", "ya", "wa", "ni", "kwa", "katika", "hii", "si", "la",
           "kuwa", "kama", "lakini", "pia", "hiyo", "yake"},
    "tl": {"ang", "ng", "sa", "na", "ay", "mga", "at", "ito", "hindi",
           "para", "siya", "niya", "kanyang", "may", "din"},
    "mt": {"u", "li", "ta", "fil", "ma", "huwa", "din", "kien", "dan",
           "għal", "mill", "biex", "hija", "iktar"},
}

#: diacritics that are strong evidence for specific languages (fractional
#: weight per occurrence — ties on short texts break the right way)
_LATIN_MARKERS: dict[str, str] = {
    "fr": "àâçèêëîïôùûœ",
    "de": "äöüß",
    "es": "ñá",
    "pt": "ãõâêç",
    "it": "àèìòù",
    "da": "æø",
    "no": "æø",
    "sv": "äö",
    "fi": "äö",
    "et": "õäö",
    "hu": "őűáé",
    "pl": "ąćęłńśźż",
    "cs": "ěřůčšž",
    "sk": "ľĺŕäô",
    "sl": "čšž",
    "hr": "čćđšž",
    "ro": "ăâîșț",
    "ca": "çèé",
    "tr": "ğışçö",
    "vi": "ăâđêôơưạảấầẩậắằẵặẹẻẽếềểễệịọỏốồổỗộớờởỡợụủứừửữựỳỵỷỹ",
    "is": "ðþæö",
    "ga": "áéíóú",
    "eu": "",
    "sq": "ëç",
    "lt": "ėęįųūž",
    "lv": "āēīņļķģ",
    "cy": "ŵŷ",
    "mt": "ħġż",
}

#: every language this detector can emit
SUPPORTED_LANGUAGES: frozenset[str] = frozenset(
    set(_LATIN_STOPS)
    | set(_CYRILLIC_STOPS)
    | set(_ARABIC_STOPS)
    | set(_SCRIPT_LANG.values())
    | {"ja", "zh"}
)


def _tokens(text: str) -> list[str]:
    """Lowercased word tokens — utils.text.tokenize with digit-bearing
    tokens kept intact (one tokenizer for stage + langid semantics)."""
    from ..utils.text import tokenize

    return tokenize(text, to_lowercase=True, min_token_length=1)


def detect_scores(text: str) -> dict[str, float]:
    """language → confidence (descending, top 3, normalized to sum 1) —
    the LangDetector stage's RealMap payload. Empty dict when nothing
    matches."""
    return dict(_detect_scores_cached(text))


@lru_cache(maxsize=4096)
def _detect_scores_cached(text: str) -> tuple[tuple[str, float], ...]:
    return tuple(_detect_scores_impl(text).items())


def _detect_scores_impl(text: str) -> dict[str, float]:
    if not text:
        return {}
    census = _script_census(text)
    if not census:
        return {}
    script, script_n = max(census.items(), key=lambda kv: kv[1])
    total_alpha = sum(census.values())
    if script != "latin" and script_n / total_alpha >= 0.3:
        # non-Latin script: decided by the block census
        if script == "kana":
            return {"ja": 1.0}
        if script == "han":
            # Han + kana = Japanese; pure Han = Chinese
            return {"ja" if census.get("kana") else "zh": 1.0}
        if script == "cyrillic":
            return _disambiguate(text, _CYRILLIC_STOPS, _CYRILLIC_MARKERS,
                                 default="ru")
        if script == "arabic":
            return _disambiguate(text, _ARABIC_STOPS, _ARABIC_MARKERS,
                                 default="ar")
        lang = _SCRIPT_LANG.get(script)
        return {lang: 1.0} if lang else {}
    toks = _tokens(text)
    if not toks:
        return {}
    # ONE pass over the text builds the char histogram; per-language marker
    # evidence is then a table sum (the per-marker str.count form scanned
    # the text ~200x per call)
    char_counts: dict[str, int] = {}
    for ch in text.lower():
        if ord(ch) > 127:
            char_counts[ch] = char_counts.get(ch, 0) + 1
    scores: dict[str, float] = {}
    for lang, stops in _LATIN_STOPS.items():
        s = sum(1.0 for t in toks if t in stops) / len(toks)
        markers = _LATIN_MARKERS.get(lang, "")
        if markers:
            hits = sum(char_counts.get(c, 0) for c in markers)
            s += 0.4 * min(hits, 5) / len(toks)
        if s > 0:
            scores[lang] = s
    if not scores:
        return {}
    top = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))[:3]
    norm = sum(v for _, v in top)
    return {k: v / norm for k, v in top}


def _disambiguate(text, stop_sets, marker_sets, default) -> dict[str, float]:
    toks = _tokens(text)
    n = max(len(toks), 1)
    scores: dict[str, float] = {}
    for lang, stops in stop_sets.items():
        s = sum(1.0 for t in toks if t in stops) / n
        markers = marker_sets.get(lang, set())
        if markers:
            # normalized + capped like the Latin tier: one stray foreign
            # marker char (a quoted word, a name) must not outvote a whole
            # sentence of function-word evidence; lowercase first so
            # all-caps headlines keep their marker evidence
            hits = sum(1 for ch in text.lower() if ch in markers)
            s += 0.4 * min(hits, 5) / n
        if s > 0:
            scores[lang] = s
    if not scores:
        return {default: 1.0}
    top = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))[:3]
    norm = sum(v for _, v in top)
    return {k: v / norm for k, v in top}


def detect(text: str) -> str | None:
    """Best language for ``text`` (None when undecidable). Caching lives in
    _detect_scores_cached — a second cache layer here would just pin more
    row strings in memory."""
    scores = _detect_scores_cached(text)
    if not scores:
        return None
    return scores[0][0]  # items are sorted descending
