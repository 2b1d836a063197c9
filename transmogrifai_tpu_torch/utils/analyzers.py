"""Per-language text analyzers — tokenize → lowercase → stopword filter →
stem, per language: the port's copy of the JAX package's
``utils/analyzers.py`` (host code).

Reference: core/.../utils/text/LuceneTextAnalyzer.scala:1-236 wires a Lucene
analyzer per detected language under TextTokenizer and every smart-text
path; the reference ships pretrained model support for 7 languages
(models/README.md — da, de, en, es, nl, pt, sv). This module reimplements
those seven analyzers' observable behavior without the JVM:

  * en — Porter stemmer (Lucene EnglishAnalyzer: possessive strip,
    lowercase, stop filter, PorterStemFilter);
  * da / sv — Snowball Danish / Swedish stemmers (suffix stripping over the
    R1 region, per the published Snowball definitions);
  * de — German normalization (ä→a … ß→ss) + German light stemmer;
  * es / pt — Spanish / Portuguese light stemmers (plural + gender
    suffixes);
  * nl — Dutch Snowball-style suffix stripping (e/en removal with
    undoubling, heden→heid, -ing/-end in R2).

The stemmers are implementations of the published public-domain algorithms
(snowballstem.org; Savoy's light stemmers) — behavior, not code, is ported.
Stopword sets are the standard per-language lists those analyzers use.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable

from .text import tokenize

# --------------------------------------------------------------------------
# stopwords (standard snowball/Lucene lists, condensed to the high-frequency
# cores those filters actually remove in practice)
# --------------------------------------------------------------------------
STOPWORDS: dict[str, frozenset[str]] = {
    # the exact Lucene/StandardAnalyzer English stop set (33 words) —
    # EnglishAnalyzer filters precisely these, nothing more
    "en": frozenset(
        """a an and are as at be but by for if in into is it no not of on or
        such that the their then there these they this to was will
        with""".split()
    ),
    "da": frozenset(
        """og i jeg det at en den til er som på de med han af for ikke der
        var mig sig men et har om vi min havde ham hun nu over da fra du ud
        sin dem os op man hans hvor eller hvad skal selv her alle vil blev
        kunne ind når være dog noget ville jo deres efter ned skulle denne
        end dette mit også under have dig anden hende mine alt meget sit sine
        vor mod disse hvis din nogle hos blive mange ad bliver hendes været
        thi jer sådan""".split()
    ),
    "de": frozenset(
        """aber alle allem allen aller alles als also am an ander andere
        anderem anderen anderer anderes auch auf aus bei bin bis bist da
        damit dann das dass dasselbe dein deine dem den denn der des dessen
        die dies diese diesem diesen dieser dieses dir doch dort du durch
        ein eine einem einen einer eines einig einige er es etwas euer für
        gegen gewesen hab habe haben hat hatte hatten hier hin hinter ich
        ihm ihn ihnen ihr ihre im in indem ins ist ja jede jedem jeden jeder
        jedes jene kann kein keine können könnte machen man manche mein
        meine mich mir mit muss musste nach nicht nichts noch nun nur ob
        oder ohne sehr sein seine sich sie sind so solche soll sollte
        sondern sonst über um und uns unser unter viel vom von vor während
        war waren warst was weg weil weiter welche wenn werde werden wie
        wieder will wir wird wirst wo wollen wollte würde würden zu zum zur
        zwar zwischen""".split()
    ),
    "es": frozenset(
        """de la que el en y a los del se las por un para con no una su al
        lo como más pero sus le ya o este sí porque esta entre cuando muy
        sin sobre también me hasta hay donde quien desde todo nos durante
        todos uno les ni contra otros ese eso ante ellos e esto mí antes
        algunos qué unos yo otro otras otra él tanto esa estos mucho
        quienes nada muchos cual poco ella estar estas algunas algo
        nosotros mi mis tú te ti tu tus ellas nosotras vosotros vosotras os
        mío mía míos mías tuyo tuya tuyos tuyas suyo suya suyos suyas
        nuestro nuestra nuestros nuestras vuestro vuestra vuestros vuestras
        esos esas es soy eres somos sois está estás estamos estáis están
        fue fui son era eras éramos eran ser""".split()
    ),
    "nl": frozenset(
        """de en van ik te dat die in een hij het niet zijn is was op aan
        met als voor had er maar om hem dan zou of wat mijn men dit zo door
        over ze zich bij ook tot je mij uit der daar haar naar heb hoe heeft
        hebben deze u want nog zal me zij nu ge geen omdat iets worden
        toch al waren veel meer doen toen moet ben zonder kan hun dus alles
        onder ja eens hier wie werd altijd doch wordt wezen kunnen ons zelf
        tegen na reeds wil kon niets uw iemand geweest andere""".split()
    ),
    "pt": frozenset(
        """de a o que e do da em um para é com não uma os no se na por mais
        as dos como mas foi ao ele das tem à seu sua ou ser quando muito há
        nos já está eu também só pelo pela até isso ela entre era depois
        sem mesmo aos ter seus quem nas me esse eles estão você tinha foram
        essa num nem suas meu às minha têm numa pelos elas havia seja qual
        será nós tenho lhe deles essas esses pelas este fosse dele tu te
        vocês vos lhes meus minhas teu tua teus tuas nosso nossa nossos
        nossas dela delas esta estes estas aquele aquela aqueles aquelas
        isto aquilo estou está estamos estão estive esteve estivemos
        estiveram era éramos eram fui foi fomos foram seja sejamos sou
        somos são""".split()
    ),
    "sv": frozenset(
        """och det att i en jag hon som han på den med var sig för så till
        är men ett om hade de av icke mig du henne då sin nu har inte hans
        honom skulle hennes där min man ej vid kunde något från ut när
        efter upp vi dem vara vad över än dig kan sina här ha mot alla
        under någon eller allt mycket sedan ju denna själv detta åt utan
        varit hur ingen mitt ni bli blev oss din dessa några deras blir
        mina samma vilken er sådan vår blivit dess inom mellan sådant
        varför varje vilka ditt vem vilket sitta sådana vart dina vars
        vårt våra ert era vilkas""".split()
    ),
    "fr": frozenset(
        """au aux avec ce ces dans de des du elle en et eux il ils je la le
        les leur lui ma mais me même mes moi mon ne nos notre nous on ou où
        par pas pour qu que qui sa se ses son sur ta te tes toi ton tu un
        une vos votre vous c d j l à m n s t y été étée étées étés étant
        suis es est sommes êtes sont serai sera seront étais était étions
        fus fut ai as avons avez ont aurai aura auront avais avait avions
        eus eut""".split()
    ),
    "it": frozenset(
        """ad al allo ai agli alla alle con col coi da dal dallo dai dagli
        dalla dalle di del dello dei degli della delle in nel nello nei
        negli nella nelle su sul sullo sui sugli sulla sulle per tra fra io
        tu lui lei noi voi loro mio mia miei mie tuo tua tuoi tue suo sua
        suoi sue nostro nostra nostri nostre vostro vostra vostri vostre
        che chi cui non come dove quale quanto quanti quanta quante questo
        questi questa queste quello quelli quella quelle si tutto tutti a e
        ed o ho hai ha abbiamo avete hanno è sono sei siamo siete era erano
        sarà sia ma se perché anche più""".split()
    ),
    "ru": frozenset(
        """и в во не что он на я с со как а то все она так его но да ты к у
        же вы за бы по ее мне было вот от меня еще нет о из ему теперь
        когда даже ну ли если уже или ни быть был него до вас нибудь вам
        сказал себя ей может они есть надо ней для мы тебя их чем была сам
        чтоб без будто чего раз тоже себе под будет тогда кто этот того
        потому этого какой ним здесь этом один почти мой тем чтобы нее
        были куда зачем всех можно при об хоть после над больше тот через
        эти нас про всего них какая много разве эту моя свою этой перед
        иногда лучше чуть том такой им более всегда конечно всю между
        это""".split()
    ),
}

_VOWELS = {
    "en": "aeiouy",
    "da": "aeiouyæåø",
    "sv": "aeiouyäåö",
    "nl": "aeiouyè",
    "de": "aeiouyäöü",
    "es": "aeiouáéíóúü",
    "pt": "aeiouáéíóúâêôãõ",
}


def _r1(word: str, vowels: str) -> int:
    """Snowball R1: position after the first non-vowel following a vowel."""
    for i in range(len(word) - 1):
        if word[i] in vowels and word[i + 1] not in vowels:
            return i + 2
    return len(word)


# --------------------------------------------------------------------------
# English — Porter stemmer (the classic 1980 algorithm, as PorterStemFilter)
# --------------------------------------------------------------------------
def _porter_is_cons(w: str, i: int) -> bool:
    c = w[i]
    if c in "aeiou":
        return False
    if c == "y":
        return i == 0 or not _porter_is_cons(w, i - 1)
    return True


def _porter_m(w: str) -> int:
    """Measure: number of VC sequences."""
    forms = []
    for i in range(len(w)):
        forms.append("c" if _porter_is_cons(w, i) else "v")
    s = "".join(forms)
    s = re.sub(r"c+", "C", s)
    s = re.sub(r"v+", "V", s)
    return s.count("VC")


def _porter_has_vowel(w: str) -> bool:
    return any(not _porter_is_cons(w, i) for i in range(len(w)))


def _porter_cvc(w: str) -> bool:
    if len(w) < 3:
        return False
    return (
        _porter_is_cons(w, len(w) - 3)
        and not _porter_is_cons(w, len(w) - 2)
        and _porter_is_cons(w, len(w) - 1)
        and w[-1] not in "wxy"
    )


def porter_stem(w: str) -> str:
    if len(w) <= 2:
        return w
    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]
    # step 1b
    if w.endswith("eed"):
        if _porter_m(w[:-3]) > 0:
            w = w[:-1]
    else:
        flag = False
        if w.endswith("ed") and _porter_has_vowel(w[:-2]):
            w = w[:-2]
            flag = True
        elif w.endswith("ing") and _porter_has_vowel(w[:-3]):
            w = w[:-3]
            flag = True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif (
                len(w) >= 2
                and w[-1] == w[-2]
                and _porter_is_cons(w, len(w) - 1)
                and w[-1] not in "lsz"
            ):
                w = w[:-1]
            elif _porter_m(w) == 1 and _porter_cvc(w):
                w += "e"
    # step 1c
    if w.endswith("y") and _porter_has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2
    for suf, rep in (
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
        ("anci", "ance"), ("izer", "ize"), ("abli", "able"), ("alli", "al"),
        ("entli", "ent"), ("eli", "e"), ("ousli", "ous"), ("ization", "ize"),
        ("ation", "ate"), ("ator", "ate"), ("alism", "al"),
        ("iveness", "ive"), ("fulness", "ful"), ("ousness", "ous"),
        ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _porter_m(stem) > 0:
                w = stem + rep
            break
    # step 3
    for suf, rep in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _porter_m(stem) > 0:
                w = stem + rep
            break
    # step 4
    for suf in (
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    ):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _porter_m(stem) > 1:
                w = stem
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st":
            if _porter_m(w[:-3]) > 1:
                w = w[:-3]
    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _porter_m(stem)
        if m > 1 or (m == 1 and not _porter_cvc(stem)):
            w = stem
    # step 5b
    if len(w) >= 2 and w[-1] == "l" and w[-2] == "l" and _porter_m(w) > 1:
        w = w[:-1]
    return w


# --------------------------------------------------------------------------
# Danish / Swedish — Snowball stemmers (R1-bounded suffix stripping)
# --------------------------------------------------------------------------
_DA_STEP1 = sorted(
    """hed ethed ered e erede ende erende ene erne ere en heden heder heds
    ed hederne erets eret hedens erendes endes enes er ernes eres ens ers
    ets es et s""".split(),
    key=len, reverse=True,
)
_DA_S_ENDINGS = set("abcdfghjklmnoprtvyzå")


def danish_stem(w: str) -> str:
    r1 = max(_r1(w, _VOWELS["da"]), 3)
    # step 1: longest suffix in the list, delete if in R1 ("s" needs a
    # valid s-ending before it)
    for suf in _DA_STEP1:
        if w.endswith(suf) and len(w) - len(suf) >= r1:
            if suf == "s":
                if len(w) >= 2 and w[-2] in _DA_S_ENDINGS:
                    w = w[:-1]
                break
            w = w[: -len(suf)]
            break
    # step 2: gd, dt, gt, kt → drop last letter
    if len(w) >= r1 + 1 and w[-2:] in ("gd", "dt", "gt", "kt"):
        w = w[:-1]
    # step 3: igst → drop st; lig/elig/els in R1 → delete (+repeat step 2);
    # løst → løs
    if w.endswith("igst"):
        w = w[:-2]
    for suf in ("elig", "lig", "els", "ig"):
        if w.endswith(suf) and len(w) - len(suf) >= r1:
            w = w[: -len(suf)]
            if len(w) >= r1 + 1 and w[-2:] in ("gd", "dt", "gt", "kt"):
                w = w[:-1]
            break
    else:
        if w.endswith("løst"):
            w = w[:-1]
    # step 4: undouble a final double consonant in R1
    if (
        len(w) >= 2
        and len(w) - 1 >= r1
        and w[-1] == w[-2]
        and w[-1] not in _VOWELS["da"]
    ):
        w = w[:-1]
    return w


_SV_STEP1 = sorted(
    """a arna erna heterna orna ad e ade ande arne are aste en anden aren
    heten ern ar er heter or as arnas ernas ornas es ades andes ens arens
    hetens erns at andet het ast""".split(),
    key=len, reverse=True,
)
_SV_S_ENDINGS = set("bcdfghjklmnoprtvy")


def swedish_stem(w: str) -> str:
    r1 = max(_r1(w, _VOWELS["sv"]), 3)
    for suf in _SV_STEP1:
        if w.endswith(suf) and len(w) - len(suf) >= r1:
            w = w[: -len(suf)]
            break
    else:
        if w.endswith("s") and len(w) >= 2 and w[-2] in _SV_S_ENDINGS \
                and len(w) - 1 >= r1:
            w = w[:-1]
    # step 2: dd, gd, nn, dt, gt, kt, tt → drop last letter
    if len(w) - 1 >= r1 and w[-2:] in ("dd", "gd", "nn", "dt", "gt", "kt", "tt"):
        w = w[:-1]
    # step 3
    for suf, rep in (("lig", ""), ("ig", ""), ("els", ""), ("löst", "lös"),
                     ("fullt", "full")):
        if w.endswith(suf) and len(w) - len(suf) >= r1:
            w = w[: -len(suf)] + rep
            break
    return w


# --------------------------------------------------------------------------
# German — normalization + light stemmer (GermanLightStemFilter behavior)
# --------------------------------------------------------------------------
_DE_NORM = str.maketrans({"ä": "a", "ö": "o", "ü": "u"})


_DE_S_ENDINGS = set("bdfghklmnt")


def german_stem(w: str) -> str:
    w = w.replace("ß", "ss").translate(_DE_NORM)
    # step 1: case/plural endings
    if len(w) > 5 and w.endswith("ern"):
        w = w[:-3]
    elif len(w) > 4 and w[-2:] in ("em", "en", "er", "es"):
        w = w[:-2]
    elif len(w) > 3 and w[-1] == "e":
        w = w[:-1]
    elif len(w) > 3 and w[-1] == "s" and w[-2] in _DE_S_ENDINGS:
        w = w[:-1]
    # step 2: superlative/inflection remnants
    if len(w) > 5 and w.endswith("est"):
        w = w[:-3]
    elif len(w) > 4 and w.endswith("st") and w[-3] in _DE_S_ENDINGS:
        w = w[:-2]
    return w


# --------------------------------------------------------------------------
# Spanish / Portuguese — light stemmers (plural + gender endings)
# --------------------------------------------------------------------------
def spanish_stem(w: str) -> str:
    if len(w) < 5:
        return w
    for a, b in (("á", "a"), ("é", "e"), ("í", "i"), ("ó", "o"), ("ú", "u")):
        w = w.replace(a, b)
    if w.endswith(("eses", "eces")):
        return w[:-2]
    if w.endswith("ces"):
        return w[:-3] + "z"
    if w.endswith(("os", "as", "es")):
        return w[:-2]
    if w.endswith(("o", "a", "e")):
        return w[:-1]
    return w


def portuguese_stem(w: str) -> str:
    if len(w) < 4:
        return w
    if w.endswith("ões") or w.endswith("ães"):
        return w[:-3] + "ão"
    if w.endswith("res") and len(w) > 5:
        return w[:-2]
    if w.endswith(("eis",)):
        return w[:-3] + "el"
    if w.endswith(("ais",)):
        return w[:-2] + "l"
    if w.endswith(("os", "as", "es", "is")):
        return w[:-2]
    if w.endswith(("o", "a", "e")):
        return w[:-1]
    return w


# --------------------------------------------------------------------------
# Dutch — Snowball-style suffix stripping
# --------------------------------------------------------------------------
def _nl_undouble(w: str) -> str:
    if len(w) >= 2 and w[-1] == w[-2] and w[-1] in "kdt":
        return w[:-1]
    return w


def dutch_stem(w: str) -> str:
    r1 = max(_r1(w, _VOWELS["nl"]), 3)
    # step 1
    if w.endswith("heden") and len(w) - 5 >= r1:
        w = w[:-5] + "heid"
    elif w.endswith("ene") and len(w) - 3 >= r1:
        w = _nl_undouble(w[:-3])
    elif w.endswith("en") and len(w) - 2 >= r1 and not w[:-2].endswith("gem"):
        stem = w[:-2]
        if stem and stem[-1] not in _VOWELS["nl"]:
            w = _nl_undouble(stem)
    elif w.endswith("se") and len(w) - 2 >= r1:
        w = w[:-2]
    elif w.endswith("s") and len(w) - 1 >= r1 and len(w) >= 2 \
            and w[-2] not in _VOWELS["nl"] + "j":
        w = w[:-1]
    # step 2: -e in R1 after a consonant
    if w.endswith("e") and len(w) - 1 >= r1 and len(w) >= 2 \
            and w[-2] not in _VOWELS["nl"]:
        w = _nl_undouble(w[:-1])
    # step 3a: heid → delete in R2-ish, c before
    if w.endswith("heid") and len(w) - 4 >= r1 and len(w) >= 5 \
            and w[-5] != "c":
        w = w[:-4]
        if w.endswith("en") and len(w) - 2 >= r1:
            stem = w[:-2]
            if stem and stem[-1] not in _VOWELS["nl"]:
                w = _nl_undouble(stem)
    # step 3b: -ing/-end
    for suf in ("end", "ing"):
        if w.endswith(suf) and len(w) - len(suf) >= r1:
            w = _nl_undouble(w[: -len(suf)])
            break
    return w


# --------------------------------------------------------------------------
# analyzer registry
# --------------------------------------------------------------------------
_POSSESSIVE_RE = re.compile(r"['’][sS]?(?=\W|$)")


@dataclass(frozen=True)
class LanguageAnalyzer:
    language: str
    stopwords: frozenset[str]
    stem: Callable[[str], str]
    #: custom tokenizer (CJK bigrams, Thai script runs); None = standard
    tokenizer: Callable[[str, bool, int], list[str]] | None = None

    def analyze(
        self,
        text: str,
        to_lowercase: bool = True,
        min_token_length: int = 1,
        remove_stopwords: bool = True,
        stemming: bool = True,
    ) -> list[str]:
        if self.language == "en":
            # EnglishPossessiveFilter: strip trailing 's / trailing
            # apostrophe BEFORE tokenization (the regex tokenizer would
            # otherwise split "john's" into "john", "s")
            text = _POSSESSIVE_RE.sub("", text)
        if self.tokenizer is not None:
            toks = self.tokenizer(text, to_lowercase, min_token_length)
        else:
            toks = tokenize(text, to_lowercase, min_token_length)
        # the Lucene analyzers this mirrors always lowercase before their
        # stop filter and stemmer, so those steps compare/operate on the
        # casefolded token even when to_lowercase=False preserves case in
        # the emitted tokens of non-stemmed runs
        if remove_stopwords:
            toks = [t for t in toks if t.lower() not in self.stopwords]
        if stemming:
            toks = [self.stem(t.lower()) for t in toks]
        return [t for t in toks if len(t) >= min_token_length]


# --------------------------------------------------------------------------
# French / Italian / Russian — light Snowball-style suffix stripping
# (round-4 breadth: the reference's Lucene FrenchLightStemFilter /
# ItalianLightStemFilter / RussianLightStemFilter equivalents)
# --------------------------------------------------------------------------
def french_stem(w: str) -> str:
    if len(w) < 5:
        return w
    for a, b in (("à", "a"), ("â", "a"), ("è", "e"), ("é", "e"), ("ê", "e"),
                 ("î", "i"), ("ô", "o"), ("û", "u"), ("ç", "c")):
        w = w.replace(a, b)
    if w.endswith(("issements", "issement")):
        return w[:-9 if w.endswith("issements") else -8] + "i"
    for suf in ("ements", "ement"):
        if w.endswith(suf) and len(w) > len(suf) + 3:
            return w[: -len(suf)]
    for suf in ("ations", "ation"):
        if w.endswith(suf) and len(w) > len(suf) + 2:
            return w[: -len(suf)]
    if w.endswith("eaux"):
        return w[:-1]          # chateaux -> chateau (plural x)
    if w.endswith("aux") and len(w) > 4:
        return w[:-3] + "al"   # journaux -> journal
    if w.endswith("eux"):
        return w[:-1]
    if w.endswith("ées"):
        return w[:-3]
    if w.endswith(("ée", "és", "er", "ez")):
        return w[:-2]
    if w.endswith("es"):
        return w[:-2]
    if w.endswith(("s", "e")):
        return w[:-1]
    return w


def italian_stem(w: str) -> str:
    if len(w) < 5:
        return w
    for a, b in (("à", "a"), ("è", "e"), ("é", "e"), ("ì", "i"), ("ò", "o"),
                 ("ù", "u")):
        w = w.replace(a, b)
    for suf in ("azioni", "azione"):
        if w.endswith(suf) and len(w) > len(suf) + 2:
            return w[: -len(suf)]
    for suf in ("amenti", "amento", "imenti", "imento"):
        if w.endswith(suf) and len(w) > len(suf) + 2:
            return w[: -len(suf)]
    if w.endswith(("che", "chi")):
        return w[:-2]
    if w.endswith(("ie", "ii")):
        return w[:-2] + "i"
    if w.endswith(("i", "e", "o", "a")):
        return w[:-1]
    return w


def russian_stem(w: str) -> str:
    if len(w) < 5:
        return w
    w = w.replace("ё", "е")
    # verb/participle endings first (longest match), then case endings
    for suf in ("ировать", "ованный", "ующий", "ывать", "ивать", "уется",
                "ается", "яется"):
        if w.endswith(suf) and len(w) > len(suf) + 2:
            return w[: -len(suf)]
    for suf in ("иями", "ями", "ами", "ием", "ией", "иях",
                "ого", "его", "ому", "ему", "ыми", "ими"):
        if w.endswith(suf) and len(w) > len(suf) + 2:
            return w[: -len(suf)]
    for suf in ("ов", "ев", "ей", "ий", "ый", "ой", "ая", "яя", "ое", "ее",
                "ие", "ые", "ом", "ем", "ам", "ым", "им", "ах", "ях", "ую",
                "юю"):
        if w.endswith(suf) and len(w) > len(suf) + 2:
            return w[: -len(suf)]
    if w.endswith(("а", "я", "о", "е", "и", "ы", "у", "ю", "ь")):
        return w[:-1]
    return w


# --------------------------------------------------------------------------
# round-5 breadth toward Lucene's ~35-analyzer set: ar, cs, el, fi, hu, no,
# ro, tr (light stemmers over the published Lucene/Snowball suffix sets) +
# th (script-run segmentation) + CJK bigrams (zh/ja/ko — the Lucene
# CJKAnalyzer behavior). The langid plane already routes all of these.
# --------------------------------------------------------------------------
_AR_DIAC = re.compile("[ً-ٰٟـ]")  # harakat + tatweel


def arabic_stem(w: str) -> str:
    """Lucene ArabicNormalizer + light10-style stemmer: normalize alef/yaa
    forms, strip diacritics, strip the definite-article prefixes and the
    common suffixes."""
    w = _AR_DIAC.sub("", w)
    w = (w.replace("أ", "ا").replace("إ", "ا").replace("آ", "ا")
          .replace("ى", "ي").replace("ة", "ه"))
    for pre in ("وال", "بال", "كال", "فال", "لل", "ال"):
        if w.startswith(pre) and len(w) > len(pre) + 2:
            w = w[len(pre):]
            break
    for suf in ("ها", "ان", "ات", "ون", "ين", "يه", "يه", "ه", "ي"):
        if w.endswith(suf) and len(w) > len(suf) + 2:
            return w[: -len(suf)]
    return w


def czech_stem(w: str) -> str:
    """CzechStemmer (light): longest-match case/possessive endings."""
    if len(w) < 4:
        return w
    for suf in ("atech", "ětem", "etem", "atům", "ových", "ovém", "ovým",
                "ách", "ata", "aty", "ých", "ama", "ami", "ové", "ovi",
                "ými", "ech", "ich", "ích", "ého", "ěmi", "emi", "ému",
                "ete", "eti", "iho", "ího", "ími", "imu",
                "em", "es", "ém", "ím", "ům", "at", "ám", "os", "us", "ým",
                "mi", "ou"):
        if w.endswith(suf) and len(w) > len(suf) + 2:
            return w[: -len(suf)]
    if w[-1] in "eiíěuyůaoáéý" and len(w) > 3:
        return w[:-1]
    return w


_EL_ACCENTS = str.maketrans("άέήίόύώϊΐϋΰ", "αεηιουωιιυυ")


def greek_stem(w: str) -> str:
    """GreekStemmer (light): final-sigma + accent normalization, common
    nominal/verbal endings."""
    w = w.replace("ς", "σ").translate(_EL_ACCENTS)
    if len(w) < 4:
        return w
    for suf in ("ματων", "ματα", "ματοσ", "ουσα", "ουμε", "ουνε", "ησεισ",
                "εισ", "ουσ", "εων", "ων", " οσ", "οσ", "ησ", "ασ", "εσ",
                "οι", "ου", "α", "ο", "η", "ι", "ε", "υ"):
        suf = suf.strip()
        if w.endswith(suf) and len(w) > len(suf) + 2:
            return w[: -len(suf)]
    return w


def finnish_stem(w: str) -> str:
    """FinnishLightStemFilter-style: strip the productive case endings."""
    if len(w) < 5:
        return w
    for suf in ("issa", "issä", "ista", "istä", "illa", "illä", "ilta",
                "iltä", "ille", "iksi", "tten", "ssa", "ssä", "sta", "stä",
                "lla", "llä", "lta", "ltä", "lle", "ksi", "den", "ien",
                "ina", "inä", "ia", "iä", "in", "en", "an", "än", "on"):
        if w.endswith(suf) and len(w) > len(suf) + 2:
            w = w[: -len(suf)]
            break
    if w.endswith(("t", "n")) and len(w) > 4:
        w = w[:-1]
    if w and w[-1] in "aä" and len(w) > 4:
        w = w[:-1]
    return w


def hungarian_stem(w: str) -> str:
    """HungarianLightStemFilter-style: case endings + plural/possessive."""
    if len(w) < 4:
        return w
    for suf in ("okkal", "ekkel", "akkal", "ükkel", "okból", "ekből",
                "nak", "nek", "val", "vel", "ban", "ben", "ból", "ből",
                "hoz", "hez", "höz", "tól", "től", "ról", "ről", "nál",
                "nél", " okat", "eket", "akat", "okat",
                "ra", "re", "ba", "be", "on", "en", "ön", "ok", "ek", "ak",
                "ot", "et", "at", "öt", "ig"):
        suf = suf.strip()
        if w.endswith(suf) and len(w) > len(suf) + 2:
            w = w[: -len(suf)]
            break
    if w and w[-1] in "tk" and len(w) > 3:
        w = w[:-1]
    if w and w[-1] in "aáeéoóöőuúüű" and len(w) > 3:
        w = w[:-1]
    return w


def norwegian_stem(w: str) -> str:
    """Snowball Norwegian-style suffix stripping (bokmål endings)."""
    if len(w) < 4:
        return w
    for suf in ("hetenes", "hetene", "hetens", "heten", "heter", "endes",
                "edes", "enes", "ende", "ande", "else", "este", "eren",
                "erne", "ane", "ene", "ens", "ers", "ets", "ast",
                "en", "ar", "er", "as", "es", "et", "st", "te",
                "a", "e", "s"):
        if w.endswith(suf) and len(w) > len(suf) + 2:
            return w[: -len(suf)]
    return w


_RO_NORM = str.maketrans("ăâîșşțţ", "aaisstt")


def romanian_stem(w: str) -> str:
    """RomanianStemmer (light): diacritic folding + nominal endings."""
    w = w.translate(_RO_NORM)
    if len(w) < 4:
        return w
    for suf in ("urilor", "ului", "elor", "ilor", "iilor", "atie", "atii",
                "aties", "ele", "ile", "uri", "iei", "ul", "ua", "ea",
                "ii", "ie", "ei", "le", "a", "e", "i", "u"):
        if w.endswith(suf) and len(w) > len(suf) + 2:
            return w[: -len(suf)]
    return w


def turkish_lower(w: str) -> str:
    """Turkish casefold: dotted/dotless i are DISTINCT letters (İ→i, I→ı);
    python lower() would fold both to 'i'."""
    return w.replace("İ", "i").replace("I", "ı").lower()


def turkish_stem(w: str) -> str:
    """TurkishLightStemmer-style: agglutinative case/plural/possessive
    suffixes, longest first."""
    w = turkish_lower(w)
    if len(w) < 4:
        return w
    for suf in ("larından", "lerinden", "larına", "lerine", "larını",
                "lerini", "ların", "lerin", "ları", "leri", "ından",
                "inden", "undan", "ünden", "lar", "ler", "ında", "inde",
                "unda", "ünde", "dan", "den", "tan", "ten", "nın", "nin",
                "nun", "nün", "ın", "in", "un", "ün", "da", "de", "ta",
                "te", "ı", "i", "u", "ü", "a", "e"):
        if w.endswith(suf) and len(w) > len(suf) + 2:
            return w[: -len(suf)]
    return w


# ---- tier 3 (round 5): the rest of the Lucene per-language analyzer set
# (LuceneTextAnalyzer.scala wires ~35; langid already routes these codes).
# Light approximations of the published Lucene stemmers, same approach as
# the tier-2 set above: longest-match suffix strips with minimum-stem
# guards.


def bulgarian_stem(w: str) -> str:
    """BulgarianStemmer (light, Nakov): definite article THEN plural —
    sequential, so 'котките' (article те + plural и) meets 'котка'
    (plural а) at the same stem."""
    if len(w) < 4:
        return w
    for suf in ("ията", "ият", "ът", "ят", "та", "то", "те"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            w = w[: -len(suf)]
            break
    for suf in ("овци", "ища", "ове", "еве", "йки", "ия", "а", "я", "о",
                "е", "и"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            w = w[: -len(suf)]
            break
    return w


def catalan_stem(w: str) -> str:
    """Catalan light stemmer (Snowball-Catalan approximation): plurals,
    verbal/derivational endings."""
    if len(w) < 4:
        return w
    for suf in ("aments", "ament", "adora", "adors", "ances", "atges",
                "esses", "etes", "eres", "ança", "ques", "osos", "oses",
                "ista", "able", "ible", "isme", "ció", "ats", "ades",
                "ers", "era", "es", "os", "a", "s"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: -len(suf)]
    return w


def basque_stem(w: str) -> str:
    """Basque light stemmer (Snowball-Basque approximation): case endings
    (ergative/genitive/locative) and determiners."""
    if len(w) < 4:
        return w
    for suf in ("arekin", "etako", "etara", "aren", "ekin", "etan", "eta",
                "ari", "ak", "ek", "en", "an", "ra", "a", "k"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: -len(suf)]
    return w


_FA_NORM = str.maketrans({
    "ي": "ی", "ك": "ک", "ة": "ه", "آ": "ا", "أ": "ا", "إ": "ا",
    "ۀ": "ه", "‌": " ",  # zero-width non-joiner -> space
})


def persian_normalize(w: str) -> str:
    """PersianAnalyzer behavior: orthographic normalization, NO stemming
    (Lucene ships PersianNormalizationFilter + stopwords only)."""
    return w.translate(_FA_NORM).strip()


def galician_stem(w: str) -> str:
    """Galician light stemmer (RSLP-style plural/gender reduction)."""
    if len(w) < 4:
        return w
    if w.endswith("ns") and len(w) > 4:
        return w[:-2] + "n"
    if (w.endswith("ais") or w.endswith("eis")) and len(w) > 5:
        return w[:-2] + "l"
    for suf in ("cións", "ción", "mente", "ista", "ismo", "es", "as", "os",
                "a", "o", "s"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: -len(suf)]
    return w


def hindi_stem(w: str) -> str:
    """HindiStemmer (light; Ramanathan & Rao) — the Lucene filter: strip
    the longest of the published suffix list."""
    if len(w) < 3:
        return w
    for suf in ("ियों", "ाओं", "ियां", "ताओं", "नाओं", "ियाँ", "ाएं",
                "ुओं", "ुएं", "ुआं", "ों", "ें", "ीं", "ाँ", "ां", "ता",
                "ते", "ना", "ती", "ी", "ू", "ु", "ा", "े", "ो", "ि"):
        if w.endswith(suf) and len(w) - len(suf) >= 2:
            return w[: -len(suf)]
    return w


def armenian_stem(w: str) -> str:
    """Armenian light stemmer (Snowball-Armenian approximation): plural +
    case endings."""
    if len(w) < 4:
        return w
    for suf in ("ությունների", "ություններ", "ության", "ություն",
                "ներում", "ներին", "ներով", "ները", "ների", "երին",
                "երից", "երով", "երը", "ներ", "ում", "երի", "ով", "եր",
                "ին", "ից", "ը", "ի", "ն"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: -len(suf)]
    return w


def indonesian_stem(w: str) -> str:
    """IndonesianStemmer (light; Asian et al.): particle/possessive
    suffixes, derivational -kan/-an/-i, prefixes di-/ke-/se-/me*/be*/pe*/
    te*."""
    if len(w) < 4:
        return w
    for suf in ("kah", "lah", "pun", "nya", "ku", "mu"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            w = w[: -len(suf)]
            break
    for pre in ("meng", "meny", "men", "mem", "me", "peng", "peny", "pen",
                "pem", "di", "ter", "ke", "se", "ber", "be", "per", "pe"):
        if w.startswith(pre) and len(w) - len(pre) >= 3:
            w = w[len(pre):]
            break
    for suf in ("kan", "an", "i"):
        # >= 4 remaining: root words like 'makan' must not lose their
        # final syllable (the full Asian-et-al stemmer checks derivation
        # conditions; the length guard is the light equivalent)
        if w.endswith(suf) and len(w) - len(suf) >= 4:
            w = w[: -len(suf)]
            break
    return w


def irish_lower(w: str) -> str:
    """IrishLowerCaseFilter: strip prothetic n-/t- before a vowel-initial
    word ('n-athair' → 'athair', 'tAthair' → 'athair') before folding."""
    if len(w) > 2 and w[0] in "nt" and w[1] == "-":
        w = w[2:]
    elif len(w) > 1 and w[0] in "nt" and w[1] in "AEIOUÁÉÍÓÚ":
        w = w[1:]
    return w.lower()


def irish_stem(w: str) -> str:
    """Irish light stemmer (Snowball-Irish approximation): plural/case
    endings after Irish-specific lowercasing."""
    w = irish_lower(w)
    if len(w) < 4:
        return w
    for suf in ("aíocht", "eanna", "eacha", "acha", "anna", "anta",
                "íocht", "acht", "aí", "ta", "te", "e", "a"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: -len(suf)]
    return w


def bengali_stem(w: str) -> str:
    """Bengali light stemmer (Lucene BengaliStemmer family): case/plural
    particles and vowel-sign endings, longest first."""
    if len(w) < 3:
        return w
    for suf in ("দেরকে", "গুলোর", "গুলির", "গুলো", "গুলি", "খানা",
                "দের", "েরা", "দিকে", "টির", "টার", "ছিল", "বেন",
                "ের", "কে", "রা", "টা", "টি", "তে", "েই", "ে", "ি",
                "া", "ী", "ো"):
        if w.endswith(suf) and len(w) - len(suf) >= 2:
            return w[: -len(suf)]
    return w


def lithuanian_stem(w: str) -> str:
    """Lithuanian light stemmer (Snowball-Lithuanian approximation): noun/
    adjective declension endings."""
    if len(w) < 4:
        return w
    for suf in ("iausias", "iausia", "uosiuose", "uose", "iams", "ams",
                "ose", "ėse", "yse", "uje", "oje", "ėje", "iai", "ius",
                "ių", "ais", "oms", "ėms", "as", "is", "ys", "us",
                "ai", "os", "ės", "ų", "ą", "ę", "į", "ė", "a", "e", "i",
                "o", "u", "s"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: -len(suf)]
    return w


def ukrainian_stem(w: str) -> str:
    """Ukrainian light stemmer (the Lucene build uses a morfologik
    dictionary; this is the standard Slavic-light suffix reduction, same
    approach as the Russian light stemmer above)."""
    if len(w) < 4:
        return w
    for suf in ("ськими", "ського", "ському", "істю", "ення", "іння",
                "ість", "ами", "ями", "ових", "ого", "ому", "ими", "іми",
                "ах", "ях", "ів", "ей", "ом", "ем", "ою", "ею",
                "ий", "ій", "ії", "ія", "ію", "и", "і", "а", "я", "у",
                "ю", "о", "е", "ь"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: -len(suf)]
    return w


def latvian_stem(w: str) -> str:
    """LatvianStemmer (light): noun/adjective declension endings, longest
    first."""
    if len(w) < 4:
        return w
    for suf in ("ajiem", "ajām", "ajam", "ajai", "iem", "ajā", "ais",
                "ai", "ei", "ij", "am", "ām", "ie", "as", "es", "os",
                "is", "us", "a", "e", "i", "u", "o", "s", "š"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: -len(suf)]
    return w


_CJK_RUN = re.compile(
    "[一-鿿㐀-䶿぀-ゟ゠-ヿ가-힯"
    "豈-﫿]+"
)
_THAI_RUN = re.compile("[฀-๿]+")


def _script_bigram_tokenizer(run_re):
    """Tokenizer factory: script runs become overlapping character bigrams
    (the Lucene CJKAnalyzer bigram behavior; Thai gets the same treatment —
    without an ICU/dictionary segmenter, bigrams are the standard
    segmentation-free indexing unit). Non-script spans go through the
    standard tokenizer."""
    def tok(text: str, to_lowercase: bool, min_token_length: int):
        out: list[str] = []
        pos = 0
        for m in run_re.finditer(text):
            before = text[pos:m.start()]
            if before.strip():
                out.extend(tokenize(before, to_lowercase, min_token_length))
            run = m.group(0)
            if len(run) == 1:
                out.append(run)
            else:
                out.extend(run[i:i + 2] for i in range(len(run) - 1))
            pos = m.end()
        tail = text[pos:]
        if tail.strip():
            out.extend(tokenize(tail, to_lowercase, min_token_length))
        return out

    return tok


_cjk_tokenize = _script_bigram_tokenizer(_CJK_RUN)
_thai_tokenize = _script_bigram_tokenizer(_THAI_RUN)

_APOSTROPHE_TAIL = re.compile(r"['’][^\s]*")


#: Devanagari vowel signs are combining marks (category Mn) — \W to the
#: regex engine — so the standard tokenizer would split every Hindi word
#: at its matras; keep Devanagari runs (letters + marks + virama) whole
#: the non-Devanagari alternative must EXCLUDE the Devanagari block, or a
#: digit/Latin-led token swallows the following consonant and strands its
#: matra ("5वीं" → "5व", "ीं")
_DEVANAGARI_TOKEN = re.compile(r"[ऀ-ॿ]+|[^\s\W_ऀ-ॿ]+", re.UNICODE)


def _hindi_tokenize(text: str, to_lowercase: bool, min_token_length: int):
    if to_lowercase:
        text = text.lower()
    return [
        t for t in _DEVANAGARI_TOKEN.findall(text)
        if len(t) >= min_token_length
    ]


#: Bengali script (U+0980–U+09FF) has the same combining-vowel-sign issue
#: as Devanagari — keep script runs whole
_BENGALI_TOKEN = re.compile(r"[ঀ-৿]+|[^\s\W_ঀ-৿]+", re.UNICODE)


def _bengali_tokenize(text: str, to_lowercase: bool, min_token_length: int):
    if to_lowercase:
        text = text.lower()
    return [
        t for t in _BENGALI_TOKEN.findall(text)
        if len(t) >= min_token_length
    ]


_GA_PROTHESIS = re.compile(r"\b[nt]-(?=[aeiouáéíóú])|\b[nt](?=[AEIOUÁÉÍÓÚ])")


def _irish_tokenize(text: str, to_lowercase: bool, min_token_length: int):
    """Irish prothesis (IrishLowerCaseFilter behavior) must run BEFORE
    tokenization: the word regex would split 'n-athair' at the hyphen and
    the lowercased token stream can no longer tell 'nAthair' from a word
    that begins with n."""
    text = _GA_PROTHESIS.sub("", text)
    return tokenize(text, to_lowercase, min_token_length)


def _turkish_tokenize(text: str, to_lowercase: bool, min_token_length: int):
    """Turkish pipeline order matters: ApostropheFilter (drop the
    apostrophe and everything after it — "İstanbul'daki" → "İstanbul")
    then TurkishLowerCaseFilter (İ→i, I→ı) BEFORE the standard tokenizer —
    python str.lower() turns İ into i + combining-dot, which the word
    regex then splits."""
    text = _APOSTROPHE_TAIL.sub("", text)
    if to_lowercase:
        text = turkish_lower(text)
    return tokenize(text, False, min_token_length)

STOPWORDS.update({
    "ar": frozenset(
        """في من على ان أن إلى الى عن مع هذا هذه ذلك التي الذي و او أو ثم
        لا ما لم لن هو هي هم كان كانت يكون قد كل بعض غير بين حتى اذا إذا
        كما عند لدى منذ أي اي نحن انا أنا انت هناك ولا وما وهو وهي به له
        لها فيه عليه اليوم ايضا أيضا""".split()
    ),
    "cs": frozenset(
        """a aby ale ani ano az bez bude budem budes by byl byla byli bylo
        být co což či dalsi do ho i jak jake je jeho jej jeji jejich jen
        jeste ji jine jiz jsem jses jsme jsou jste k kam kde kdo kdyz ke
        ktera ktere kteri kterou ktery ma mate me mezi mi mit muj muze my
        na nad nam napiste nas nasi ne nebo nejsou neni nez nic nove novy o
        od ode on pak po pod podle pokud pouze prave pred pres pri pro proc
        proto protoze prvni pta re s se si sve svych svym svymi ta tak take
        takze tato tedy tento teto tim timto to tohle toho tomto tomu tu
        tuto ty tyto u uz v vam vas vase ve vice vsak za zde ze""".split()
    ),
    "el": frozenset(
        """ο η το οι τα του της των τον την και κι κ ειμαι εισαι ειναι
        ειμαστε ειστε στο στον στη στην μα αλλα απο για προσ με σε ωσ παρα
        αντι κατα μετα θα να δε δεν μη μην επι ενω εαν αν τοτε που πωσ ποιοσ
        ποια ποιο ποιοι ποιεσ ποιων ποιουσ αυτοσ αυτη αυτο αυτοι αυτων
        αυτουσ αυτεσ αυτα εκεινοσ εκεινη εκεινο εκεινοι εκεινεσ εκεινα
        εκεινων εκεινουσ οπωσ ομωσ ισωσ οσο οτι""".split()
    ),
    "fi": frozenset(
        """ja ei että on oli joka jonka jossa jotka se ne hän he minä sinä
        me te tämä nämä tuo mikä mitä missä mutta kun niin vain myös jos
        sitä siitä sen ovat olen olet olemme olette ollut olla kuin vielä
        jo nyt sitten koska mukaan ilman kanssa kautta yli ali ennen
        jälkeen""".split()
    ),
    "hu": frozenset(
        """a az és egy ez az hogy nem is van volt lesz lehet csak már még
        el fel le ki be meg át ha de vagy mert mint ezt azt ezek azok en
        én te ő mi ti ők engem téged őt minket titeket őket ami aki amely
        amelyek ahol amikor miért hogyan mit mik kik ilyen olyan minden
        mindig soha most itt ott akkor úgy így nagyon több kevés sok
        kell""".split()
    ),
    "no": frozenset(
        """og i jeg det at en et den til er som på de med han av ikke der
        så var meg seg men ett har om vi min mitt ha hadde hun nå over da
        ved fra du ut sin dem oss opp man kan hans hvor eller hva skal selv
        sjøl her alle vil bli ble blitt kunne inn når være kom noen noe
        ville dere som deres kun ja etter ned skulle denne for deg si sine
        sitt mot å meget hvorfor dette disse uten hvordan ingen din ditt
        blir samme hvilken hvilke sånn inni mellom vår både bare enn fordi
        før mange også slik vært""".split()
    ),
    "ro": frozenset(
        """de la si și în un o a al ale cu pe ce care este sunt era au fost
        fi nu se sa să mai dar din ar fi prin despre după dupa pentru spre
        între intre ca că dacă daca atunci cand când unde cum cine cât cat
        acest aceasta această acestui acestei acestor el ea ei ele eu tu
        noi voi lui iar ori sau avea are am ai aveti aveți fara fără
        foarte tot toate toți toti""".split()
    ),
    "tr": frozenset(
        """ve bir bu da de için ile ben sen o biz siz onlar ama fakat ancak
        ki ne gibi daha çok en az mi mı mu mü değil her şey kendi ise veya
        ya hem sonra önce şimdi burada orada nasıl neden niçin kim hangi
        bütün bazı diğer aynı böyle şöyle öyle olarak olan oldu olur
        olduğu üzere kadar göre arasında vardı var yok idi""".split()
    ),
    "th": frozenset(
        """ที่ การ และ ใน ของ มี ได้ ให้ ไป มา เป็น ว่า จะ ไม่ กับ แต่ หรือ ก็ นี้ นั้น
        อยู่ อย่าง จาก ถึง ด้วย แล้ว ยัง ต้อง เมื่อ ความ""".split()
    ),
    "cjk": frozenset(),
    # ---- tier 3 (round 5)
    "bg": frozenset(
        """а и в на с за не се да по от е са ще това той тя то те ние вие
        аз ти ни ви го я му ѝ им ми ли но или ако като който която което
        които кой коя кое кои защото защо кога къде как там тук при до из
        над под пред след без че бил била било били съм си сме сте е беше
        бяха има няма може трябва още вече само също така тези този тази
        това му ги""".split()
    ),
    "ca": frozenset(
        """de la el els les un una uns unes i o a en amb per què que es el
        al del dels no sí és són era eren ser estar ha han he hem heu hi
        ho aquest aquesta aquests aquestes aquell aquella allò això jo tu
        ell ella nosaltres vosaltres ells elles em et es ens us li com més
        molt poc tot tots tota totes també ja encara quan on si doncs
        però sense sobre sota entre fins des com""".split()
    ),
    "eu": frozenset(
        """eta edo ez da dira zen ziren izan du dute zuen zuten bat batzuk
        hau hori hura hauek horiek haiek ni zu gu zuek bera beraiek nire
        zure gure haren baina ere oso asko gutxi guztiak dena zer nor non
        noiz nola zergatik zein baldin gero orain hemen hor han arte kontra
        gabe bezala baino ondoren aurretik artean""".split()
    ),
    "fa": frozenset(
        """و در به از که این آن را با برای است بود شد های می ها او ما شما
        آنها من تو خود هم نیز یا اما اگر تا بر هر چه چرا کجا چگونه کی
        بین روی زیر پیش پس بدون درباره مانند باید شاید هست نیست بودند
        هستند کرد کردند کند کنند شود شده دارد دارند داشت یک دو
        آیا""".split()
    ),
    "gl": frozenset(
        """de a o as os un unha uns unhas e ou en con por para que non si
        é son era eran ser estar hai ha han ao aos á ás do da dos das no
        na nos nas este esta estes estas ese esa eses esas aquel aquela eu
        ti el ela nós vós eles elas me te se nos vos lle lles como máis
        moi pouco todo todos toda todas tamén xa aínda cando onde entre
        ata desde sen sobre baixo despois antes""".split()
    ),
    "hi": frozenset(
        """का की के में है हैं को से पर और या नहीं यह वह ये वे मैं तुम आप हम
        उसका उसकी उनके इस उस इन उन एक दो था थी थे हो होता होती होते
        किया करना करता करती करते गया गयी गये हुआ हुई हुए भी तो ही अब
        जब तब कब क्यों कैसे कौन क्या जो कि अगर लेकिन फिर बहुत कुछ सब
        अपना साथ बाद पहले लिए द्वारा""".split()
    ),
    "hy": frozenset(
        """և եւ ու է են էր էին եմ ես ենք եք չի չեն չէր այս այդ այն սա դա
        նա մենք դուք նրանք ես դու իմ քո իր մեր ձեր նրանց որ ով ինչ երբ
        որտեղ ինչպես ինչու քանի թե եթե բայց կամ նաև միայն շատ քիչ բոլոր
        ամեն մեջ վրա տակ մոտ հետ առանց մասին համար ըստ դեպի մինչև
        այնտեղ այստեղ""".split()
    ),
    "id": frozenset(
        """yang dan di ke dari untuk pada dengan adalah ini itu tidak ada
        akan telah sudah belum bisa dapat harus juga atau tetapi tapi
        karena jika kalau saya aku kamu anda dia kami kita mereka nya ya
        bukan saja hanya lebih sangat semua setiap antara dalam luar atas
        bawah sebagai seperti sampai hingga ketika saat oleh bagi tentang
        maka lalu kemudian masih pernah sedang""".split()
    ),
    "ga": frozenset(
        """agus an na is ní tá bhí níl sé sí mé tú muid sibh siad a ar as
        ag do de i le go chun faoi ó roimh thar trí gan mar nach má dá cé
        cad conas cathain cá fáth seo sin siúd é í iad ach nó más bheith
        raibh beidh bhfuil dom duit dó di dúinn daoibh dóibh mo do a ár
        bhur ina sa san leis len lena ag""".split()
    ),
    "lv": frozenset(
        """un ir nav bija būs es tu viņš viņa mēs jūs viņi viņas tas tā
        šis šī tie tās kas ko kam par ar uz no pie pēc pirms bez virs zem
        starp pret līdz kā kad kur kāpēc vai bet ja tad jo arī vēl tikai
        ļoti daudz maz viss visi visas katrs savs mans tavs mūsu jūsu
        sava""".split()
    ),
    "bn": frozenset(
        """এই ও এবং যে যা কি না হয় হবে ছিল করে করা হতে থেকে জন্য সঙ্গে সাথে
        মধ্যে উপর নিচে আগে পরে কিন্তু অথবা যদি তবে তাই আমি তুমি আপনি সে
        তারা আমরা তোমরা তার তাদের আমার আমাদের এক দুই আর এটা সেটা কোন কেন
        কীভাবে কখন কোথায় কেউ কিছু সব অনেক আরও শুধু এখন তখন এখানে সেখানে
        দিয়ে নিয়ে হয়ে গিয়ে""".split()
    ),
    "lt": frozenset(
        """ir yra nėra buvo bus aš tu jis ji mes jūs jie jos tai šis ši
        tas ta kas ką kam su iš į ant po prie per nuo iki be prieš už virš
        tarp kaip kada kur kodėl ar bet jei tada nes taip pat dar tik
        labai daug mažai visas visi visos kiekvienas savo mano tavo mūsų
        jūsų apie""".split()
    ),
    "uk": frozenset(
        """і й та в у на з із зі до від за під над при про через для без
        між це цей ця ці той та те ті він вона воно вони ми ви я ти мій
        твій наш ваш свій його її їх що як коли де чому хто або але якщо
        то тому так ні не є був була було були буде бути може треба вже
        ще тільки дуже багато мало весь вся все всі кожен інший""".split()
    ),
})

_LIGHT_STEMMERS: dict[str, Callable[[str], str]] = {
    "ar": arabic_stem,
    "cs": czech_stem,
    "el": greek_stem,
    "fi": finnish_stem,
    "hu": hungarian_stem,
    "no": norwegian_stem,
    "ro": romanian_stem,
    "tr": turkish_stem,
    # tier 3
    "bg": bulgarian_stem,
    "ca": catalan_stem,
    "eu": basque_stem,
    "fa": persian_normalize,  # PersianAnalyzer: normalization, no stemming
    "gl": galician_stem,
    "hi": hindi_stem,
    "hy": armenian_stem,
    "id": indonesian_stem,
    "ga": irish_stem,
    "lv": latvian_stem,
    "bn": bengali_stem,
    "lt": lithuanian_stem,
    "uk": ukrainian_stem,
}

_STEMMERS: dict[str, Callable[[str], str]] = {
    "en": porter_stem,
    "da": danish_stem,
    "sv": swedish_stem,
    "de": german_stem,
    "es": spanish_stem,
    "pt": portuguese_stem,
    "nl": dutch_stem,
    "fr": french_stem,
    "it": italian_stem,
    "ru": russian_stem,
    **_LIGHT_STEMMERS,
}

ANALYZERS: dict[str, LanguageAnalyzer] = {
    lang: LanguageAnalyzer(lang, STOPWORDS[lang], _STEMMERS[lang])
    for lang in _STEMMERS
}
#: Turkish: apostrophe filter + Turkish casefold before tokenization
ANALYZERS["tr"] = LanguageAnalyzer(
    "tr", STOPWORDS["tr"], turkish_stem, tokenizer=_turkish_tokenize
)
#: Irish: prothetic n-/t- stripping must precede tokenization
ANALYZERS["ga"] = LanguageAnalyzer(
    "ga", STOPWORDS["ga"], irish_stem, tokenizer=_irish_tokenize
)
#: Hindi: Devanagari-run tokenizer (matras are combining marks)
ANALYZERS["hi"] = LanguageAnalyzer(
    "hi", STOPWORDS["hi"], hindi_stem, tokenizer=_hindi_tokenize
)
#: Bengali: same script-run treatment as Devanagari
ANALYZERS["bn"] = LanguageAnalyzer(
    "bn", STOPWORDS["bn"], bengali_stem, tokenizer=_bengali_tokenize
)
#: Thai: script-run bigram tokenization (no ICU segmenter), no stemming
ANALYZERS["th"] = LanguageAnalyzer(
    "th", STOPWORDS["th"], lambda t: t, tokenizer=_thai_tokenize
)
#: CJK bigrams (Lucene CJKAnalyzer behavior) — one analyzer serves zh/ja/ko
_CJK_ANALYZER = LanguageAnalyzer(
    "cjk", STOPWORDS["cjk"], lambda t: t, tokenizer=_cjk_tokenize
)
for _code in ("zh", "ja", "ko"):
    ANALYZERS[_code] = _CJK_ANALYZER

#: the "standard" analyzer (LuceneTextAnalyzer falls back to
#: StandardAnalyzer when the language has no dedicated analyzer):
#: tokenize + lowercase only
STANDARD = LanguageAnalyzer("", frozenset(), lambda t: t)


def analyzer_for(language: str | None) -> LanguageAnalyzer:
    """Analyzer for an ISO-639-1 code ('se' — the reference's Swedish model
    directory name — is accepted as an alias of 'sv'); unknown → STANDARD."""
    if not language:
        return STANDARD
    lang = language.lower()
    if lang == "se":
        lang = "sv"
    return ANALYZERS.get(lang, STANDARD)


def detect_language(text: str) -> str | None:
    """Language detection (OptimaizeLanguageDetector stand-in) — delegates
    to nlp/langid.py's ~55-language script-census + function-word voter;
    languages without a shipped analyzer fall back to STANDARD downstream."""
    from ..nlp.langid import detect

    return detect(text)


def analyze(
    text: str,
    language: str | None = None,
    auto_detect: bool = False,
    to_lowercase: bool = True,
    min_token_length: int = 1,
) -> list[str]:
    """TextTokenizer.analyze parity: pick the analyzer by explicit language
    or auto-detection, fall back to the standard analyzer."""
    lang = language
    if auto_detect and lang is None:
        lang = detect_language(text)
    return analyzer_for(lang).analyze(
        text, to_lowercase=to_lowercase, min_token_length=min_token_length
    )
