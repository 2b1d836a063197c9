"""Phone parsing + validation + vectorization.

Reference: core/.../stages/impl/feature/PhoneNumberParser.scala (566 LoC over
Google libphonenumber). The transformer set is reproduced 1:1:

  * ``ParsePhoneNumber``          (Phone, Text region) → Phone (E.164-ish)
  * ``ParsePhoneDefaultCountry``  Phone → Phone
  * ``IsValidPhoneNumber``        (Phone, Text region) → Binary
  * ``IsValidPhoneDefaultCountry``Phone → Binary
  * ``IsValidPhoneMapDefaultCountry`` PhoneMap → BinaryMap
  * ``PhoneVectorizer``           transmogrify default (is-valid + null cols)

The libphonenumber metadata is condensed per region into (country calling
code, allowed national-number lengths, leading-digit pattern) — the three
facts ``isValidNumber`` checks that matter for tabular feature engineering.
Semantics mirrored from PhoneNumberParser.scala:

  * ``clean_number``: strip everything but digits and '+' (:cleanNumber)
  * numbers with < 2 chars are invalid → None (:validate)
  * a leading '+' switches to international parsing (region "ZZ"); the
    country code is matched longest-prefix against the metadata
  * ``strictValidation=false`` (default) truncates a too-long number one
    trailing digit at a time until it validates (phoneUtil
    truncateTooLongNumber semantics)
  * region selection (:validCountryCode): an explicit region code wins;
    otherwise the closest country NAME by Jaccard similarity over character
    bigrams (JaccardSim over ``sliding(2)`` sets); otherwise the default
"""
from __future__ import annotations

import re
from typing import Sequence

import numpy as np

from ..stages.base import Transformer
from ..stages.metadata import NULL_STRING, ColumnMeta
from ..types import Binary, BinaryMap, Phone, PhoneMap, Text
from ..types.columns import Column, MapColumn, TextColumn, column_from_values
from .base import VectorizerTransformer
from .defaults import DEFAULTS

DEFAULT_REGION = "US"
INTERNATIONAL_CODE = "ZZ"  # libphonenumber's unknown-region marker
STRICT_VALIDATION = False

_NANP = re.compile(r"^[2-9]\d{9}$")  # area code starts [2-9], 10 digits

#: region → (country calling code, national lengths, leading-digit pattern).
#: Patterns are condensed from libphonenumber's generalDesc/fixedLine/mobile
#: metadata; None = length check only.
_REGION_RULES: dict[str, tuple[str, tuple[int, ...], re.Pattern | None]] = {
    # NANP (country code 1): US rules apply to every NANP territory
    **{
        r: ("1", (10,), _NANP)
        for r in (
            "US CA BS BB AI AG VG VI KY BM GD TC MS MP GU AS SX LC DM VC "
            "TT KN JM DO PR"
        ).split()
    },
    "GB": ("44", (9, 10), re.compile(r"^[1-9]\d*$")),
    "DE": ("49", (6, 7, 8, 9, 10, 11), re.compile(r"^[1-9]\d*$")),
    "FR": ("33", (9,), re.compile(r"^[1-9]\d{8}$")),
    "ES": ("34", (9,), re.compile(r"^[5-9]\d{8}$")),
    "IT": ("39", (6, 7, 8, 9, 10, 11), None),
    "NL": ("31", (9,), re.compile(r"^[1-9]\d{8}$")),
    "BE": ("32", (8, 9), re.compile(r"^[1-9]\d*$")),
    "CH": ("41", (9,), re.compile(r"^[1-9]\d{8}$")),
    "AT": ("43", (4, 5, 6, 7, 8, 9, 10, 11, 12, 13), None),
    "SE": ("46", (7, 8, 9, 10), re.compile(r"^[1-9]\d*$")),
    "NO": ("47", (8,), re.compile(r"^[2-9]\d{7}$")),
    "DK": ("45", (8,), re.compile(r"^[2-9]\d{7}$")),
    "FI": ("358", (5, 6, 7, 8, 9, 10, 11, 12), None),
    "PT": ("351", (9,), re.compile(r"^[2-9]\d{8}$")),
    "GR": ("30", (10,), re.compile(r"^[2-9]\d{9}$")),
    "IE": ("353", (7, 8, 9), None),
    "PL": ("48", (9,), re.compile(r"^[1-9]\d{8}$")),
    "CZ": ("420", (9,), re.compile(r"^[1-9]\d{8}$")),
    "RU": ("7", (10,), re.compile(r"^[3489]\d{9}$")),
    "UA": ("380", (9,), re.compile(r"^[1-9]\d{8}$")),
    "TR": ("90", (10,), re.compile(r"^[2-5]\d{9}$")),
    "IL": ("972", (8, 9), None),
    "SA": ("966", (8, 9), None),
    "AE": ("971", (8, 9), None),
    "EG": ("20", (8, 9, 10), None),
    "ZA": ("27", (9,), re.compile(r"^[1-9]\d{8}$")),
    "NG": ("234", (7, 8, 10), None),
    "KE": ("254", (9, 10), None),
    "IN": ("91", (10,), re.compile(r"^[6-9]\d{9}$")),
    "PK": ("92", (9, 10), None),
    "BD": ("880", (8, 9, 10), None),
    "LK": ("94", (9,), None),
    "CN": ("86", (10, 11), re.compile(r"^[1-9]\d*$")),
    "JP": ("81", (9, 10), re.compile(r"^[1-9]\d*$")),
    "KR": ("82", (8, 9, 10), None),
    "TW": ("886", (8, 9), None),
    "HK": ("852", (8,), re.compile(r"^[2-9]\d{7}$")),
    "SG": ("65", (8,), re.compile(r"^[3689]\d{7}$")),
    "MY": ("60", (7, 8, 9, 10), None),
    "TH": ("66", (8, 9), None),
    "VN": ("84", (9, 10), None),
    "PH": ("63", (8, 9, 10), None),
    "ID": ("62", (7, 8, 9, 10, 11, 12), None),
    "AU": ("61", (9,), re.compile(r"^[1-9]\d{8}$")),
    "NZ": ("64", (8, 9, 10), None),
    "BR": ("55", (10, 11), re.compile(r"^[1-9]{2}\d*$")),
    "MX": ("52", (10,), re.compile(r"^[1-9]\d{9}$")),
    "AR": ("54", (10,), None),
    "CL": ("56", (8, 9), None),
    "CO": ("57", (8, 10), None),
    "PE": ("51", (8, 9), None),
    "VE": ("58", (10,), None),
    # libphonenumber ZW plan: fixed lines lead with 2 (area codes 24x-29x),
    # mobiles 71/73/77/78, VoIP/toll 8x — nothing leads with 5, so a
    # US-shaped local ('5105556666' or any truncation) must NOT validate
    # under default region ZW (PhoneNumberParserTest "need a country
    # identifyer when the local does not match the default")
    "ZW": ("263", (7, 8, 9, 10), re.compile(
        r"^(?:2\d{6,9}|7[1378]\d{7}|8\d{8,9})$"
    )),
    "CD": ("243", (9,), None),
}

#: generic fallback for regions without condensed metadata (ITU E.164
#: national significant number bounds)
_GENERIC_LENGTHS = tuple(range(5, 15))

#: country calling code → merged (lengths, patterns) across its regions,
#: for international ('+') parsing where only the cc is known
_CC_RULES: dict[str, list[tuple[tuple[int, ...], re.Pattern | None]]] = {}
for _r, (_cc, _lens, _pat) in _REGION_RULES.items():
    _CC_RULES.setdefault(_cc, [])
    if (_lens, _pat) not in _CC_RULES[_cc]:
        _CC_RULES[_cc].append((_lens, _pat))

#: ITU country-code first digits — every assigned 1-3 digit calling code
#: (for recognizing the cc prefix of unknown regions)
_ALL_CCS = sorted(
    set(_CC_RULES)
    | {
        # remaining assigned codes without condensed metadata
        "212", "213", "216", "218", "220", "221", "222", "223", "224",
        "225", "226", "227", "228", "229", "230", "231", "232", "233",
        "235", "236", "237", "238", "239", "240", "241", "242", "244",
        "245", "246", "248", "249", "250", "251", "252", "253", "255",
        "256", "257", "258", "260", "261", "262", "264", "265", "266",
        "267", "268", "269", "290", "291", "297", "298", "299", "350",
        "352", "354", "355", "356", "357", "359", "370", "371", "372",
        "373", "374", "375", "376", "377", "378", "380", "381", "382",
        "383", "385", "386", "387", "389", "420", "421", "423", "500",
        "501", "502", "503", "504", "505", "506", "507", "508", "509",
        "590", "591", "592", "593", "594", "595", "596", "597", "598",
        "599", "670", "672", "673", "674", "675", "676", "677", "678",
        "679", "680", "681", "682", "683", "685", "686", "687", "688",
        "689", "690", "691", "692", "850", "853", "855", "856", "870",
        "880", "881", "882", "883", "886", "960", "961", "962", "963",
        "964", "965", "967", "968", "970", "973", "974", "975", "976",
        "977", "992", "993", "994", "995", "996", "998", "40", "95",
        "93", "98", "36", "211", "247", "800", "808", "878", "888", "979",
    },
    key=lambda c: (-len(c), c),  # longest-prefix match first
)

#: ISO-3166 alpha-2 region codes libphonenumber supports (its
#: getSupportedRegions — an explicit region code that is a real region is
#: honored even when outside the configured regionCodes list)
SUPPORTED_REGIONS = frozenset("""
AC AD AE AF AG AI AL AM AO AR AS AT AU AW AX AZ BA BB BD BE BF BG BH BI BJ
BL BM BN BO BQ BR BS BT BW BY BZ CA CC CD CF CG CH CI CK CL CM CN CO CR CU
CV CW CX CY CZ DE DJ DK DM DO DZ EC EE EG EH ER ES ET FI FJ FK FM FO FR GA
GB GD GE GF GG GH GI GL GM GN GP GQ GR GT GU GW GY HK HN HR HT HU ID IE IL
IM IN IO IQ IR IS IT JE JM JO JP KE KG KH KI KM KN KP KR KW KY KZ LA LB LC
LI LK LR LS LT LU LV LY MA MC MD ME MF MG MH MK ML MM MN MO MP MQ MR MS MT
MU MV MW MX MY MZ NA NC NE NF NG NI NL NO NP NR NU NZ OM PA PE PF PG PH PK
PL PM PR PS PT PW PY QA RE RO RS RU RW SA SB SC SD SE SG SH SI SJ SK SL SM
SN SO SR SS ST SV SX SY SZ TC TD TG TH TJ TK TL TM TN TO TR TT TV TW TZ UA
UG US UY UZ VA VC VE VG VI VN VU WF WS XK YE YT ZA ZM ZW
""".split())

_NON_PHONE = re.compile(r"[^+\d]")


def clean_number(pn: str) -> str:
    """PhoneNumberParser.cleanNumber: trim, strip all non-[+digit]."""
    return _NON_PHONE.sub("", pn.strip())


def _national_valid(national: str, rules) -> bool:
    for lengths, pat in rules:
        if len(national) in lengths and (pat is None or pat.match(national)):
            return True
    return False


def _region_rules(region: str):
    rule = _REGION_RULES.get(region.upper())
    if rule is None:
        return None, [(_GENERIC_LENGTHS, None)]
    cc, lengths, pat = rule
    return cc, [(lengths, pat)]


def _match_cc(digits: str) -> tuple[str, str] | None:
    """(country code, national rest) by longest-prefix match."""
    for cc in _ALL_CCS:
        if digits.startswith(cc):
            return cc, digits[len(cc):]
    return None


def _truncate_valid(national: str, rules, min_len: int) -> str | None:
    """phoneUtil.truncateTooLongNumber: drop trailing digits until the
    national number validates (non-strict mode only)."""
    s = national
    while len(s) >= min_len:
        if _national_valid(s, rules):
            return s
        s = s[:-1]
    return None


def parse_phone(
    value: str | None,
    region: str = DEFAULT_REGION,
    strict: bool = STRICT_VALIDATION,
) -> str | None:
    """PhoneNumberParser.parse: returns "+{cc}{national}" when the number is
    valid (after optional truncation), else None."""
    if value is None or len(value) < 2:
        return None
    s = clean_number(value)
    if not s:
        return None
    if s.startswith("+"):
        digits = s[1:]
        if not digits.isdigit():
            return None  # stray '+' inside → parse failure
        m = _match_cc(digits)
        if m is None:
            return None
        cc, national = m
        rules = _CC_RULES.get(cc) or [(_GENERIC_LENGTHS, None)]
    else:
        if not s.isdigit():
            return None
        cc, rules = _region_rules(region)
        national = s
        # a national number carrying its own country-code prefix
        # (e.g. '1 510 555 6666' in the US) parses as cc + national
        if (
            cc
            and national.startswith(cc)
            and not _national_valid(national, rules)
            and _national_valid(national[len(cc):], rules)
        ):
            national = national[len(cc):]
        if cc is None:
            cc = ""
    if _national_valid(national, rules):
        return f"+{cc}{national}"
    if not strict:
        min_len = min(l for lengths, _ in rules for l in lengths)
        t = _truncate_valid(national, rules, min_len)
        if t is not None:
            return f"+{cc}{t}"
    return None


def validate_phone(
    value: str | None,
    region: str = DEFAULT_REGION,
    strict: bool = STRICT_VALIDATION,
) -> bool | None:
    """PhoneNumberParser.validate: None for missing/unparseable input,
    True/False validity otherwise. Unparseable (= parse raises in the
    reference, e.g. a stray '+') maps to None, not False."""
    if value is None or len(value) < 2:
        return None
    s = clean_number(value)
    digits = s[1:] if s.startswith("+") else s
    if not digits.isdigit() or len(digits) < 2:
        # NOT_A_NUMBER / TOO_SHORT_NSN parse exceptions →
        # Try.toOption → None (not False)
        return None
    return parse_phone(value, region, strict) is not None


def _bigrams(s: str) -> set:
    return {s[i:i + 2] for i in range(len(s) - 1)}


def jaccard_sim(a: set, b: set) -> float:
    if not a and not b:
        return 1.0
    union = len(a | b)
    return len(a & b) / union if union else 0.0


def valid_country_code(
    phone: str | None,
    region_code: str | None,
    default_region: str = DEFAULT_REGION,
    region_codes: Sequence[str] = (),
    country_names: Sequence[str] = (),
) -> str:
    """PhoneNumberParser.validCountryCode: '+' numbers are international;
    a known region code wins; otherwise the closest country NAME by
    Jaccard bigram similarity; otherwise the default region."""
    if phone and phone.startswith("+"):
        return INTERNATIONAL_CODE
    if region_code:
        rc = region_code.upper()
        if rc in region_codes:
            return rc
        if rc in SUPPORTED_REGIONS:
            return rc
        if region_codes:
            rc_bi = _bigrams(rc.strip())
            best, best_sim = None, -1.0
            for code, names in zip(region_codes, country_names):
                for name in str(names).split(","):
                    sim = jaccard_sim(rc_bi, _bigrams(name.strip()))
                    if sim > best_sim:
                        best, best_sim = code, sim
            if best is not None:
                return best
    return default_region


#: country code → canonical country name(s) (reference DefaultCountryCodes —
#: the ITU region list; names comma-separate known variants)
DEFAULT_COUNTRY_CODES: dict[str, str] = {
    "US": "USA, United States of America",
    "CA": "Canada",
    "DO": "Dominican Republic",
    "PR": "Puerto Rico",
    "BS": "Bahamas",
    "BB": "Barbados",
    "JM": "Jamaica",
    "TT": "Trinidad & Tobago",
    "MX": "Mexico",
    "BR": "Brazil",
    "AR": "Argentina",
    "CL": "Chile",
    "CO": "Colombia",
    "PE": "Peru",
    "VE": "Venezuela",
    "GB": "United Kingdom, Great Britain",
    "IE": "Ireland",
    "FR": "France",
    "DE": "Germany, Deutschland",
    "ES": "Spain, España",
    "PT": "Portugal",
    "IT": "Italy, Italia",
    "NL": "Netherlands",
    "BE": "Belgium",
    "CH": "Switzerland",
    "AT": "Austria",
    "SE": "Sweden",
    "NO": "Norway",
    "DK": "Denmark",
    "FI": "Finland",
    "PL": "Poland",
    "CZ": "Czech Republic",
    "GR": "Greece",
    "RU": "Russia",
    "UA": "Ukraine",
    "TR": "Turkey",
    "IL": "Israel",
    "SA": "Saudi Arabia",
    "AE": "United Arab Emirates",
    "EG": "Egypt",
    "ZA": "South Africa",
    "NG": "Nigeria",
    "KE": "Kenya",
    "ZW": "Zimbabwe",
    "CD": "Democratic Republic of Congo",
    "IN": "India",
    "PK": "Pakistan",
    "BD": "Bangladesh",
    "LK": "Sri Lanka",
    "CN": "China",
    "JP": "Japan",
    "KR": "South Korea",
    "TW": "Taiwan",
    "HK": "Hong Kong",
    "SG": "Singapore",
    "MY": "Malaysia",
    "TH": "Thailand",
    "VN": "Vietnam",
    "PH": "Philippines",
    "ID": "Indonesia",
    "AU": "Australia",
    "NZ": "New Zealand",
}


# ------------------------------------------------------------- transformers
class ParsePhoneDefaultCountry(Transformer):
    """Phone → Phone: stripped "+{cc}{national}" when valid, None otherwise
    (ParsePhoneDefaultCountry in PhoneNumberParser.scala)."""

    input_types = (Phone,)
    output_type = Phone

    def __init__(
        self,
        default_region: str = DEFAULT_REGION,
        strict_validation: bool = STRICT_VALIDATION,
        uid: str | None = None,
    ):
        super().__init__("parsePhoneNoCC", uid=uid)
        self.default_region = default_region
        self.strict_validation = strict_validation

    def get_params(self):
        return {
            "default_region": self.default_region,
            "strict_validation": self.strict_validation,
        }

    def transform_columns(self, *cols: Column, num_rows: int) -> TextColumn:
        col = cols[0]
        out = np.empty(num_rows, dtype=object)
        out[:] = [
            parse_phone(v, self.default_region, self.strict_validation)
            for v in col.to_list()
        ]
        return TextColumn(Phone, out)


class ParsePhoneNumber(Transformer):
    """(Phone, Text region-or-country) → Phone (ParsePhoneNumber)."""

    input_types = (Phone, Text)
    output_type = Phone

    def __init__(
        self,
        default_region: str = DEFAULT_REGION,
        strict_validation: bool = STRICT_VALIDATION,
        region_codes: Sequence[str] | None = None,
        country_names: Sequence[str] | None = None,
        uid: str | None = None,
    ):
        super().__init__("parsePhone", uid=uid)
        self.default_region = default_region
        self.strict_validation = strict_validation
        if region_codes is None:
            region_codes = [c.upper() for c in DEFAULT_COUNTRY_CODES]
            country_names = [
                DEFAULT_COUNTRY_CODES[c].upper() for c in DEFAULT_COUNTRY_CODES
            ]
        self.region_codes = list(region_codes)
        self.country_names = list(country_names or [])

    def set_codes_and_countries(self, mapping: dict[str, str]) -> "ParsePhoneNumber":
        """setCodesAndCountries: region code → country name (upper-cased);
        unknown region codes are rejected like the reference's param
        validator."""
        for code in mapping:
            if code.upper() not in SUPPORTED_REGIONS:
                raise ValueError(f"unsupported region code {code!r}")
        self.region_codes = [c.upper() for c in mapping]
        self.country_names = [str(v).upper() for v in mapping.values()]
        return self

    def get_params(self):
        return {
            "default_region": self.default_region,
            "strict_validation": self.strict_validation,
            "region_codes": self.region_codes,
            "country_names": self.country_names,
        }

    def transform_columns(self, *cols: Column, num_rows: int) -> TextColumn:
        phones = cols[0].to_list()
        regions = cols[1].to_list()
        out = np.empty(num_rows, dtype=object)
        out[:] = [
            parse_phone(
                p,
                valid_country_code(
                    p, r, self.default_region,
                    self.region_codes, self.country_names,
                ),
                self.strict_validation,
            )
            for p, r in zip(phones, regions)
        ]
        return TextColumn(Phone, out)


class IsValidPhoneDefaultCountry(Transformer):
    """Phone → Binary validity (IsValidPhoneDefaultCountry)."""

    input_types = (Phone,)
    output_type = Binary

    def __init__(
        self,
        default_region: str = DEFAULT_REGION,
        strict_validation: bool = STRICT_VALIDATION,
        uid: str | None = None,
    ):
        super().__init__("validatePhoneNoCC", uid=uid)
        self.default_region = default_region
        self.strict_validation = strict_validation

    def get_params(self):
        return {
            "default_region": self.default_region,
            "strict_validation": self.strict_validation,
        }

    def transform_columns(self, *cols: Column, num_rows: int):
        vals = [
            validate_phone(v, self.default_region, self.strict_validation)
            for v in cols[0].to_list()
        ]
        return column_from_values(Binary, vals)


class IsValidPhoneNumber(Transformer):
    """(Phone, Text region-or-country) → Binary (IsValidPhoneNumber)."""

    input_types = (Phone, Text)
    output_type = Binary

    def __init__(
        self,
        default_region: str = DEFAULT_REGION,
        strict_validation: bool = STRICT_VALIDATION,
        region_codes: Sequence[str] | None = None,
        country_names: Sequence[str] | None = None,
        uid: str | None = None,
    ):
        super().__init__("validatePhone", uid=uid)
        self.default_region = default_region
        self.strict_validation = strict_validation
        if region_codes is None:
            region_codes = [c.upper() for c in DEFAULT_COUNTRY_CODES]
            country_names = [
                DEFAULT_COUNTRY_CODES[c].upper() for c in DEFAULT_COUNTRY_CODES
            ]
        self.region_codes = list(region_codes)
        self.country_names = list(country_names or [])

    get_params = ParsePhoneNumber.get_params
    set_codes_and_countries = ParsePhoneNumber.set_codes_and_countries

    def transform_columns(self, *cols: Column, num_rows: int):
        phones = cols[0].to_list()
        regions = cols[1].to_list()
        vals = [
            validate_phone(
                p,
                valid_country_code(
                    p, r, self.default_region,
                    self.region_codes, self.country_names,
                ),
                self.strict_validation,
            )
            for p, r in zip(phones, regions)
        ]
        return column_from_values(Binary, vals)


class IsValidPhoneMapDefaultCountry(Transformer):
    """PhoneMap → BinaryMap (IsValidPhoneMapDefaultCountry): keys whose
    value is None/unparseable are dropped (reference collects only
    SomeValue results)."""

    input_types = (PhoneMap,)
    output_type = BinaryMap

    def __init__(
        self,
        default_region: str = DEFAULT_REGION,
        strict_validation: bool = STRICT_VALIDATION,
        uid: str | None = None,
    ):
        super().__init__("validatePhoneMapNoCC", uid=uid)
        self.default_region = default_region
        self.strict_validation = strict_validation

    def get_params(self):
        return {
            "default_region": self.default_region,
            "strict_validation": self.strict_validation,
        }

    def transform_columns(self, *cols: Column, num_rows: int) -> MapColumn:
        out = []
        for m in cols[0].to_list():
            if not m:
                out.append({})
                continue
            row = {}
            for k, v in m.items():
                res = validate_phone(
                    v, self.default_region, self.strict_validation
                )
                if res is not None:
                    row[k] = res
            out.append(row)
        return MapColumn(BinaryMap, out)


def is_valid_phone(value: str | None, region: str = DEFAULT_REGION) -> bool | None:
    """None for missing OR unparseable (the reference's Binary(None) —
    parse exceptions collapse to None, not False), True/False otherwise."""
    if value is None:
        return None
    return validate_phone(value, region)


class PhoneVectorizer(VectorizerTransformer):
    """One is-valid indicator column per phone feature (+ null indicator) —
    the Transmogrifier default for Phone features."""

    def __init__(
        self,
        default_region: str = DEFAULT_REGION,
        track_nulls: bool = DEFAULTS.TrackNulls,
        uid: str | None = None,
    ):
        super().__init__("vecPhone", uid=uid)
        self.default_region = default_region
        self.track_nulls = track_nulls

    def get_params(self):
        return {
            "default_region": self.default_region,
            "track_nulls": self.track_nulls,
        }

    def blocks_for(self, cols: Sequence[Column], num_rows: int):
        blocks, metas = [], []
        for col, feat in zip(cols, self.input_features):
            out = np.zeros(
                (num_rows, 1 + (1 if self.track_nulls else 0)), dtype=np.float64
            )
            for r, v in enumerate(col.to_list()):
                valid = is_valid_phone(v, self.default_region)
                if valid is None:
                    if self.track_nulls:
                        out[r, 1] = 1.0
                elif valid:
                    out[r, 0] = 1.0
            blocks.append(out)
            metas_f = [
                ColumnMeta((feat.name,), feat.ftype.__name__,
                           descriptor_value="isValidPhone")
            ]
            if self.track_nulls:
                metas_f.append(
                    ColumnMeta((feat.name,), feat.ftype.__name__,
                               grouping=feat.name, indicator_value=NULL_STRING)
                )
            metas.append(metas_f)
        return blocks, metas
