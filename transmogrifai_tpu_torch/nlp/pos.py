"""Part-of-speech tagging + noun-phrase chunking, the OpenNLP
``*-pos-maxent.bin`` / ``*-chunker.bin`` replacement: the port's copy of the
JAX package's ``nlp/pos.py`` (host code, the same lexicons and rules).

The Maxent models are replaced by a transparent three-layer rule tagger:

  1. closed-class lexicon — determiners, prepositions, pronouns,
     conjunctions, modals, auxiliaries, numbers (closed classes ARE a
     lexicon; no model needed);
  2. open-class suffix/shape rules — -ly → RB, -ing → VBG, -ed → VBD,
     -tion/-ment/-ness → NN, -ous/-ful/-ive → JJ, capitalized → NNP,
     digits → CD;
  3. contextual patches (Brill-style) — e.g. after a determiner or
     adjective, a verb-shaped token is re-tagged noun ("the building"),
     after "to" a base verb wins, after a modal a base verb wins.

Tags are the familiar Penn coarse set; ``tests/fixtures/pos_gold.json``
measures the accuracy.
"""
from __future__ import annotations

import re

# ---------------------------------------------------------------- lexicons
_CLOSED: dict[str, str] = {}
for _w in "the a an this that these those each every some any no".split():
    _CLOSED[_w] = "DT"
for _w in ("in on at by for with from of to about into over under between "
           "through during against among without within across behind "
           "below above near before after since until").split():
    _CLOSED[_w] = "IN"
for _w in "i you he she it we they me him us them".split():
    _CLOSED[_w] = "PRP"
for _w in "my your his its our their her".split():
    # 'her' defaults possessive (determiner position dominates noun-phrase
    # text); the contextual patch below flips clause-final/pre-verb uses
    _CLOSED[_w] = "PRP$"
for _w in "and or but nor yet so".split():
    _CLOSED[_w] = "CC"
for _w in "can could may might must shall should will would".split():
    _CLOSED[_w] = "MD"
for _w in ("is am are was were be been being has have had do does did "
           "doing").split():
    _CLOSED[_w] = "VB"      # auxiliaries tag as verbs (coarse)
for _w in "not n't never".split():
    _CLOSED[_w] = "RB"
for _w in ("one two three four five six seven eight nine ten hundred "
           "thousand million billion").split():
    _CLOSED[_w] = "CD"
for _w in "who what when where why how which whose whom".split():
    _CLOSED[_w] = "WP"
for _w in "there here".split():
    _CLOSED[_w] = "RB"
_CLOSED["to"] = "TO"

#: frequent open-class words whose suffix shape misleads
_OPEN: dict[str, str] = {}
for _w in ("time year day man woman people child world life hand part "
           "place work week case point company number house water money "
           "story month lot right study book eye job word business issue "
           "side kind head far group problem fact price market result "
           "morning weather plan report meeting dog cat car park").split():
    _OPEN[_w] = "NN"
for _w in ("said says go went gone come came get got make made know knew "
           "think thought take took see saw want use find found give gave "
           "tell told ask asked seem felt leave left call put mean kept "
           "let begin began show showed hear heard run ran move moved "
           "like live lived believe bring brought happen happened write "
           "wrote sit sat stand stood lose lost pay paid meet met include "
           "set learn learned stayed arrived explained barked failed "
           "decided talked stopped walked rose fell").split():
    _OPEN[_w] = "VBD" if _w.endswith("ed") or _w in (
        "went", "came", "got", "made", "knew", "thought", "took", "saw",
        "gave", "told", "found", "felt", "began", "heard", "ran", "wrote",
        "sat", "stood", "lost", "paid", "met", "said", "kept", "left",
        "brought", "rose", "fell",
    ) else "VB"
for _w in ("good new first last long great little own other old big high "
           "small large next early young important few public bad same "
           "able cold hot warm late red blue green dark bright").split():
    _OPEN[_w] = "JJ"
for _w in ("very also just now then even still too well really quite "
           "always never often already yesterday today tomorrow soon "
           "maybe perhaps again later").split():
    _OPEN[_w] = "RB"

_NUM_RE = re.compile(r"^\d[\d.,]*$")


def _shape_tag(tok: str, sentence_initial: bool) -> str:
    low = tok.lower()
    if _NUM_RE.match(tok):
        return "CD"
    if tok[:1].isupper() and not sentence_initial:
        return "NNP"
    if low.endswith("ly"):
        return "RB"
    if low.endswith("ing") and len(low) > 4:
        return "VBG"
    if low.endswith("ed") and len(low) > 3:
        return "VBD"
    if low.endswith(("tion", "sion", "ment", "ness", "ity", "ance", "ence",
                     "ship", "ism", "er", "or", "ist")):
        return "NN"
    if low.endswith(("ous", "ful", "ive", "able", "ible", "al", "ic")):
        return "JJ"
    if low.endswith("s") and not low.endswith(("ss", "us", "is")) and len(low) > 3:
        return "NNS"
    return "NN"


def pos_tag(tokens: list[str], language: str = "en") -> list[str]:
    """Penn-style coarse tags for a tokenized sentence. ``language`` covers
    the seven languages whose OpenNLP POS binaries the reference ships
    (models/README.md: da, de, en, es, nl, pt, sv — 'se' there is Swedish);
    unknown codes fall back to the English rule layers."""
    if language != "en":
        lang = _LANGS.get(language)
        if lang is not None:
            return _tag_lang(tokens, lang)
    tags: list[str] = []
    for i, tok in enumerate(tokens):
        low = tok.lower()
        if not any(c.isalnum() for c in tok):
            tags.append(".")
            continue
        tag = _CLOSED.get(low) or _OPEN.get(low) or _shape_tag(tok, i == 0)
        tags.append(tag)
    # Brill-style contextual patches
    for i in range(len(tags)):
        prev = tags[i - 1] if i else None
        nxt = tags[i + 1] if i + 1 < len(tags) else None
        if prev in ("DT", "JJ", "PRP$") and tags[i] in ("VB", "VBD"):
            tags[i] = "NN"           # "the building", "his work"
        elif (
            prev in ("DT", "PRP$") and tags[i] == "VBG"
            and nxt not in ("NN", "NNS", "NNP")
        ):
            tags[i] = "NN"           # "the building stood" vs "the sinking ship"
        elif (
            tags[i] == "JJ" and prev in ("DT", "JJ", "PRP$")
            and nxt not in ("NN", "NNS", "NNP", "JJ", "VBG", "CD")
        ):
            tags[i] = "NN"           # headless adjective = -al noun
                                     # ("a new proposal", "the arrival")
        elif prev == "TO" and tags[i] in ("NN", "VBD"):
            tags[i] = "VB"           # "to work"
        elif prev == "MD" and tags[i] in ("NN", "VBD"):
            tags[i] = "VB"           # "will report"
        elif prev == "PRP" and tags[i] == "NN" and i == 1:
            tags[i] = "VB"           # "I work ..."
        if (
            tokens[i].lower() == "her"
            and (nxt is None or nxt in ("VB", "VBD", "MD", "IN", "."))
        ):
            tags[i] = "PRP"          # object 'her': "saw her", "told her."
    return tags


# ---------------------------------------------------------------------
# non-English rule taggers (da, de, es, nl, pt, sv — the other six
# languages whose OpenNLP POS binaries the reference ships). Same
# three-layer design as English: closed-class lexicon → shape/suffix
# rules → contextual patches, emitting the shared coarse Penn-style
# tagset so the NP chunker works across languages.
# ---------------------------------------------------------------------


def _lex(pairs: dict[str, str]) -> dict[str, str]:
    out: dict[str, str] = {}
    for words, tag in pairs.items():
        for w in words.split():
            out[w] = tag
    return out


_LANGS: dict[str, dict] = {
    "da": dict(
        closed=_lex({
            "en et den det de denne dette disse nogle hver al alle": "DT",
            "i på til fra med om under over ved af efter før mellem mod "
            "uden gennem hos bag": "IN",
            "jeg du han hun vi mig dig ham hende os dem man": "PRP",
            "min mit mine din dit dine hans hendes vores jeres deres sin "
            "sit sine": "PRP$",
            "og eller men": "CC",
            "kan kunne skal skulle vil ville må bør": "MD",
            "er var har havde bliver blev være have blive": "VB",
            "ikke aldrig også meget nu her altid ofte igen snart allerede "
            "stadig kun bare godt imorgen": "RB",
            "to tre fire fem seks syv otte ni ti hundrede tusind": "CD",
            "hvem hvad hvor hvornår hvorfor hvordan hvilken som der": "WP",
        }),
        suffixes=[
            ("hederne", "NNS"), ("ningerne", "NNS"),
            ("ende", "VBG"), ("erede", "VBD"), ("ede", "VBD"), ("te", "VBD"),
            ("hed", "NN"), ("else", "NN"), ("ning", "NN"), ("skab", "NN"),
            ("tion", "NN"), ("ør", "NN"),
            ("lige", "JJ"), ("lig", "JJ"), ("iske", "JJ"), ("isk", "JJ"),
            ("somme", "JJ"), ("som", "JJ"), ("bar", "JJ"), ("ige", "JJ"),
            ("ig", "JJ"),
            ("ere", "VB"), ("er", "VB"),
        ],
        open=_lex({
            "stor store stort ny nye nyt god gode godt gammel gamle "
            "lille lang lange kort korte ung unge smuk smukke varm varme "
            "kold kolde koldt interessant vigtig vigtige": "JJ",
            "gerne": "RB",
            "bor komme hjælpe spise gå se høre tale købe bo": "VB",
            "lå sad gik kom fik tog så skrev": "VBD",
            "bøger fugle børn huse biler": "NN",
        }),
    ),
    "de": dict(
        noun_cap=True,  # German capitalizes every noun
        closed=_lex({
            "der die das den dem des ein eine einen einem einer eines "
            "dieser diese dieses diesen jeder jede jedes alle einige kein "
            "keine keinen": "DT",
            "in an auf mit von zu aus bei nach über unter vor hinter "
            "zwischen durch für gegen ohne um seit während am im zum zur "
            "beim vom ins": "IN",
            "ich du er es wir ihr mich dich ihn uns euch ihnen ihm sich "
            "sie": "PRP",
            "mein meine meinen meinem dein deine seine seinen seinem ihre "
            "ihren ihrem unser unsere unseren euer": "PRP$",
            "und oder aber sondern denn": "CC",
            "kann kannst konnte können muss musste müssen soll sollte "
            "will wollte wollen darf mag möchte würde wird werden": "MD",
            "ist sind war waren hat habe haben hatte hatten bin bist "
            "sein gewesen worden wurde wurden": "VB",
            "nicht nie auch sehr jetzt hier dort immer oft schon wieder "
            "heute morgen gestern bald dann nur noch": "RB",
            "zwei drei vier fünf sechs sieben acht neun zehn hundert "
            "tausend": "CD",
            "wer was wann wo warum wie welche": "WP",
        }),
        suffixes=[
            ("ungen", "NNS"), ("heiten", "NNS"), ("keiten", "NNS"),
            ("schaften", "NNS"),
            ("ung", "NN"), ("heit", "NN"), ("keit", "NN"), ("schaft", "NN"),
            ("tät", "NN"), ("chen", "NN"), ("lein", "NN"), ("nis", "NN"),
            ("lichen", "JJ"), ("liche", "JJ"), ("lich", "JJ"),
            ("igen", "JJ"), ("ige", "JJ"), ("ig", "JJ"),
            ("ischen", "JJ"), ("ische", "JJ"), ("isch", "JJ"),
            ("bar", "JJ"), ("sam", "JJ"), ("los", "JJ"),
            ("end", "VBG"), ("te", "VBD"), ("ten", "VBD"), ("en", "VB"),
        ],
        open=_lex({
            "läuft geht kommt sieht spielt kauft liest schreibt wohnt "
            "arbeitet arbeiten lernt sagt macht gibt steht fährt": "VB",
            "ging kam sah aß schrieb las fuhr sprach stand lief traf "
            "nahm gab fand blieb lagen sahen gingen kamen standen "
            "nahmen": "VBD",
            "klein kleine kleinen groß große großen gut gute guten alt "
            "alte alten neu neue neues neuen jung schön schöne warm kalt "
            "rot blau grün lang lange langen kurz hoch interessant "
            "interessante wichtig wichtige": "JJ",
        }),
    ),
    "es": dict(
        closed=_lex({
            "el la los las un una unos unas este esta estos estas ese esa "
            "esos esas cada todo toda todos todas algunos algunas ningún "
            "ninguna": "DT",
            "en de a con por para sin sobre entre desde hasta contra "
            "durante bajo tras según al del": "IN",
            "yo tú él ella ellos ellas nosotros usted ustedes me te se "
            "nos le les lo": "PRP",
            "mi mis tu tus su sus nuestro nuestra nuestros nuestras": "PRP$",
            "y e o u pero sino ni": "CC",
            "puede pueden podía podían debe deben debía quiere quieren "
            "quería va van iba iban suele": "MD",
            "es son era eran está están estaba estaban fue fueron ha han "
            "había habían hay ser estar soy eres somos tengo tiene tienen "
            "tenía vamos voy": "VB",
            "no nunca también muy ahora aquí allí siempre ya hoy mañana "
            "ayer luego solo bien mal más menos todavía después antes "
            "entonces casi": "RB",
            "dos tres cuatro cinco seis siete ocho nueve diez cien mil "
            "uno": "CD",
            "quién qué cuándo dónde cómo cuál que": "WP",
            "habla come vive trabaja estudia escribe lee corre juega "
            "canta hablan comen viven trabajan estudian escriben leen "
            "corren juegan cantan compra compran vende venden abre "
            "abren leemos vivimos hablamos comemos trabajamos "
            "estudiamos": "VB2",  # frequent present-tense verbs (suffix-opaque)
        }),
        suffixes=[
            ("ciones", "NNS"), ("siones", "NNS"), ("dades", "NNS"),
            ("mientos", "NNS"),
            ("ción", "NN"), ("sión", "NN"), ("dad", "NN"), ("tad", "NN"),
            ("miento", "NN"), ("aje", "NN"), ("eza", "NN"), ("ura", "NN"),
            ("mente", "RB"),
            ("ando", "VBG"), ("iendo", "VBG"),
            ("aron", "VBD"), ("ieron", "VBD"), ("aba", "VBD"),
            ("aban", "VBD"), ("ía", "VBD"), ("ían", "VBD"), ("ó", "VBD"),
            ("ar", "VB"), ("er", "VB"), ("ir", "VB"),
            ("osos", "JJ"), ("osas", "JJ"), ("oso", "JJ"), ("osa", "JJ"),
            ("ivos", "JJ"), ("ivas", "JJ"), ("ivo", "JJ"), ("iva", "JJ"),
            ("ables", "JJ"), ("able", "JJ"), ("ibles", "JJ"), ("ible", "JJ"),
            ("ales", "JJ"), ("al", "JJ"),
        ],
        plural=("s",),
        open=_lex({
            "pequeño pequeña pequeños pequeñas grande grandes bueno "
            "buena buenos buenas nuevo nueva nuevos nuevas viejo vieja "
            "joven bonito bonita bonitos bonitas blanco blanca rojo roja "
            "verde azul largo corto alto alta frío fría caliente "
            "importante importantes interesante interesantes feliz": "JJ",
        }),
    ),
    "nl": dict(
        closed=_lex({
            "de het een deze dit die dat elke elk alle sommige geen "
            "iedere": "DT",
            "in op aan met van naar uit bij over onder voor achter tussen "
            "door tegen zonder om sinds tijdens na": "IN",
            "ik jij je hij wij we jullie u mij me jou hem ons hen zij "
            "ze": "PRP",
            "mijn jouw onze hun": "PRP$",
            "en of maar want dus": "CC",
            "kan kunnen kon moet moeten moest zal zullen zou wil willen "
            "wilde mag mocht gaat gaan ging": "MD",
            "is ben bent was waren heeft heb hebben had hadden wordt werd "
            "worden zijn geweest": "VB",
            "niet nooit ook erg heel nu hier daar altijd vaak al weer "
            "vandaag morgen gisteren dan zeer nog alleen goed snel": "RB",
            "twee drie vier vijf zes zeven acht negen tien honderd "
            "duizend één": "CD",
            "wie wat wanneer waar waarom hoe welke": "WP",
        }),
        suffixes=[
            ("heden", "NNS"), ("ingen", "NNS"), ("ties", "NNS"),
            ("heid", "NN"), ("ing", "NN"), ("schap", "NN"), ("tie", "NN"),
            ("teit", "NN"), ("tje", "NN"), ("je", "NN"),
            ("lijke", "JJ"), ("lijk", "JJ"), ("ige", "JJ"), ("ig", "JJ"),
            ("ische", "JJ"), ("isch", "JJ"), ("bare", "JJ"), ("baar", "JJ"),
            ("zame", "JJ"), ("zaam", "JJ"), ("loze", "JJ"), ("loos", "JJ"),
            ("end", "VBG"), ("ende", "VBG"),
            ("de", "VBD"), ("den", "VBD"), ("te", "VBD"), ("ten", "VBD"),
            ("en", "VB"),
        ],
        open=_lex({
            "loopt komt ziet speelt koopt leest schrijft woont werkt "
            "leert zegt maakt geeft staat eet rijdt": "VB",
            "kocht ging kwam zag at schreef las reed sprak stond liep "
            "nam gaf vond bleef lagen zagen gingen kwamen stonden": "VBD",
            "klein kleine groot grote goed goede oud oude nieuw nieuwe "
            "jong jonge mooi mooie warm koud koude rood blauw groen lang "
            "kort hoog belangrijk belangrijke interessant "
            "interessante": "JJ",
            "boeken vogels kinderen huizen": "NN",
        }),
    ),
    "pt": dict(
        closed=_lex({
            "o a os as um uma uns umas este esta estes estas esse essa "
            "aquele aquela cada todo toda todos todas alguns algumas "
            "nenhum nenhuma": "DT",
            "em de com por para sem sobre entre desde até contra durante "
            "sob após do da dos das no na nos nas ao à aos às pelo "
            "pela": "IN",
            "eu tu ele ela nós eles elas você vocês me te se lhe lhes "
            "mim": "PRP",
            "meu minha meus minhas teu tua seu sua seus suas nosso nossa "
            "nossos nossas": "PRP$",
            "e ou mas nem porém": "CC",
            "pode podem podia deve devem devia quer querem queria vai vão "
            "ia iam costuma": "MD",
            "é são era eram está estão estava estavam foi foram há tem "
            "têm tinha tinham ser estar sou és somos tenho vamos vou": "VB",
            "não nunca também muito agora aqui ali sempre já hoje amanhã "
            "ontem depois antes bem mal mais menos ainda só quase "
            "então": "RB",
            "dois duas três quatro cinco seis sete oito nove dez cem "
            "mil": "CD",
            "quem quando onde como qual que": "WP",
            "fala come mora trabalha estuda escreve lê corre gosta joga "
            "canta falam comem moram trabalham estudam escrevem correm "
            "gostam jogam cantam compra compram vende vendem abre "
            "abrem lemos moramos falamos comemos trabalhamos "
            "estudamos": "VB2",
        }),
        suffixes=[
            ("ções", "NNS"), ("sões", "NNS"), ("dades", "NNS"),
            ("mentos", "NNS"),
            ("ção", "NN"), ("são", "NN"), ("dade", "NN"), ("mento", "NN"),
            ("agem", "NN"), ("eza", "NN"), ("ura", "NN"),
            ("mente", "RB"),
            ("ando", "VBG"), ("endo", "VBG"), ("indo", "VBG"),
            ("aram", "VBD"), ("eram", "VBD"), ("iram", "VBD"),
            ("ava", "VBD"), ("avam", "VBD"), ("ou", "VBD"), ("eu", "VBD"),
            ("iu", "VBD"),
            ("ar", "VB"), ("er", "VB"), ("ir", "VB"),
            ("osos", "JJ"), ("osas", "JJ"), ("oso", "JJ"), ("osa", "JJ"),
            ("ivos", "JJ"), ("ivas", "JJ"), ("ivo", "JJ"), ("iva", "JJ"),
            ("ável", "JJ"), ("áveis", "JJ"), ("ível", "JJ"), ("íveis", "JJ"),
            ("ais", "JJ"), ("al", "JJ"),
        ],
        plural=("s",),
        open=_lex({
            "leu deu viu fez disse veio": "VBD",
            "pequeno pequena pequenos pequenas grande grandes bom boa "
            "bons boas novo nova novos novas velho velha jovem bonito "
            "bonita bonitos bonitas branco branca vermelho verde azul "
            "longo curto alto alta frio fria quente importante "
            "importantes interessante interessantes feliz": "JJ",
        }),
    ),
    "sv": dict(
        closed=_lex({
            "en ett den det de denna detta dessa varje alla några ingen "
            "inget inga": "DT",
            "i på till från med om under över vid av efter före mellan "
            "mot utan genom hos bakom": "IN",
            "jag du han hon vi ni dem mig dig honom henne oss man": "PRP",
            "min mitt mina din ditt dina hans hennes vår vårt våra deras "
            "sin sitt sina er ert": "PRP$",
            "och eller men": "CC",
            "kan kunde ska skulle vill ville måste bör får": "MD",
            "är var har hade blir blev vara ha bli varit": "VB",
            "inte aldrig också mycket nu här där alltid ofta redan igen "
            "idag imorgon igår sedan snart bara väl ännu": "RB",
            "två tre fyra fem sex sju åtta nio tio hundra tusen": "CD",
            "vem vad när varför hur vilken som": "WP",
        }),
        suffixes=[
            ("heterna", "NNS"), ("ningarna", "NNS"), ("heter", "NNS"),
            ("ningar", "NNS"),
            ("het", "NN"), ("ning", "NN"), ("else", "NN"), ("skap", "NN"),
            ("tion", "NN"), ("are", "NN"),
            ("ande", "VBG"), ("ende", "VBG"),
            ("erade", "VBD"), ("ade", "VBD"), ("dde", "VBD"), ("te", "VBD"),
            ("liga", "JJ"), ("lig", "JJ"), ("iska", "JJ"), ("isk", "JJ"),
            ("samma", "JJ"), ("sam", "JJ"), ("bara", "JJ"), ("bar", "JJ"),
            ("iga", "JJ"), ("ig", "JJ"),
            ("ar", "VB"), ("er", "VB"),
        ],
        open=_lex({
            "åt gick kom såg skrev for stod sprang tog gav fann blev "
            "låg satt fick": "VBD",
            "snäll snälla stor stora stort ny nya nytt god goda gammal "
            "gamla liten litet små lång långa kort hög ung vacker vackra "
            "varm kall kallt röd blå grön vit svart intressant "
            "viktig viktiga": "JJ",
            "bor komma hjälpa se höra tala köpa åka bo": "VB",
            "fåglar böcker hundar bilar barn": "NN",
        }),
    ),
}


def _tag_lang(tokens: list[str], lang: dict) -> list[str]:
    closed = lang["closed"]
    open_lex = lang.get("open", {})
    noun_cap = lang.get("noun_cap", False)
    plural = lang.get("plural")
    tags: list[str] = []
    for i, tok in enumerate(tokens):
        low = tok.lower()
        if not any(c.isalnum() for c in tok):
            tags.append(".")
            continue
        t = closed.get(low) or open_lex.get(low)
        if t == "VB2":
            t = "VB"
        if t is None and _NUM_RE.match(tok):
            t = "CD"
        if t is None and tok[:1].isupper() and i > 0:
            # German capitalizes common nouns; elsewhere mid-sentence
            # capitals read proper
            t = "NN" if noun_cap else "NNP"
        if t is None:
            for suf, st in lang["suffixes"]:
                if low.endswith(suf) and len(low) > len(suf) + 1:
                    t = st
                    break
        if t is None:
            t = "NN"
            if plural and low.endswith(plural) and len(low) > 3:
                t = "NNS"
        tags.append(t)
    # shared contextual patches (mirror the English Brill layer)
    for i in range(len(tags)):
        prev = tags[i - 1] if i else None
        if prev in ("DT", "PRP$") and tags[i] in ("VB", "VBD"):
            tags[i] = "NN"      # article + verb-shaped token = noun
        elif prev == "MD" and tags[i] in ("NN", "NNS", "VBD"):
            tags[i] = "VB"      # modal + anything verb-positioned
        elif prev == "PRP" and tags[i] in ("NN",) and i == 1:
            tags[i] = "VB"      # subject pronoun + noun-shaped = verb
    return tags


#: NP := (DT)? (JJ|VBG|CD|NNP)* (NN|NNS|NNP)+   — the classic regexp chunk
_NP_RE = re.compile(r"(DT )?((?:JJ |VBG |CD |NNP )*)((?:NN[SP]? )+)")
#: Romance NP adds postnominal adjectives: "una casa blanca"
_NP_RE_POSTNOM = re.compile(
    r"(DT )?((?:JJ |VBG |CD |NNP )*)((?:NN[SP]? )+)((?:JJ )*)"
)
_POSTNOMINAL = frozenset({"es", "pt"})


def chunk_noun_phrases(tokens: list[str], tags: list[str] | None = None,
                       language: str = "en") -> list[str]:
    """Noun phrases as token strings (OpenNLP chunker stand-in: the
    classic tag-regexp NP grammar over the rule tagger's output; es/pt
    include postnominal adjectives)."""
    if tags is None:
        tags = pos_tag(tokens, language=language)
    tag_str = "".join(t + " " for t in tags)
    out: list[str] = []
    # map char offsets in tag_str back to token indices
    starts = []
    off = 0
    for t in tags:
        starts.append(off)
        off += len(t) + 1
    np_re = _NP_RE_POSTNOM if language in _POSTNOMINAL else _NP_RE
    for m in np_re.finditer(tag_str):
        first = starts.index(m.start())
        last_char = m.end() - 1
        last = next(
            i for i in range(len(starts) - 1, -1, -1)
            if starts[i] < last_char
        )
        out.append(" ".join(tokens[first:last + 1]))
    return out
