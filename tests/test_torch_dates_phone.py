"""Dates, time periods, phones and domains: the PyTorch port's copies of
``ops/{dates,time_period,phone,domains}.py`` against the JAX package's, on
the CPU.

The JAX package's ``tests/test_phone.py`` cases (the reference's
PhoneNumberParserTest vectors) run here against the port's module, and
the map and vector phone cases of ``tests/test_map_list_vectorizers.py``
with them. Every block below is host numpy in both packages, so the
tolerance is EQUALITY: the same seeded testkit columns through both
packages' transformers and vectorizers give the same values, masks,
vectors and ``ColumnMeta`` lists.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import transmogrifai_tpu.types as JT
from transmogrifai_tpu import testkit as JTK
from transmogrifai_tpu.featurize import kernels as JFK
from transmogrifai_tpu.ops import dates as JD
from transmogrifai_tpu.ops import domains as JDOM
from transmogrifai_tpu.ops import phone as JP
from transmogrifai_tpu.ops import time_period as JTP

from transmogrifai_tpu_torch.dataset import Dataset
from transmogrifai_tpu_torch.features import FeatureBuilder
from transmogrifai_tpu_torch.ops import dates as PD
from transmogrifai_tpu_torch.ops import domains as PDOM
from transmogrifai_tpu_torch.ops import phone as PP
from transmogrifai_tpu_torch.ops import time_period as PTP
from transmogrifai_tpu_torch.ops.maps import PhoneMapVectorizer
from transmogrifai_tpu_torch.ops.phone import (
    DEFAULT_COUNTRY_CODES,
    INTERNATIONAL_CODE,
    IsValidPhoneMapDefaultCountry,
    IsValidPhoneNumber,
    ParsePhoneDefaultCountry,
    ParsePhoneNumber,
    PhoneVectorizer,
    clean_number,
    is_valid_phone,
    parse_phone,
    valid_country_code,
    validate_phone,
)
from transmogrifai_tpu_torch.stages.metadata import NULL_STRING
from transmogrifai_tpu_torch.types import BinaryMap, Phone, PhoneMap, Text
from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.types.columns import (
    MapColumn,
    column_from_values,
)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "port_pairs", os.path.join(HERE, "torch_fixtures", "port_pairs.py"))
PAIRS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(PAIRS)

pytestmark = [pytest.mark.torch_port]

_CODES = [c.upper() for c in DEFAULT_COUNTRY_CODES]
_NAMES = [DEFAULT_COUNTRY_CODES[c].upper() for c in DEFAULT_COUNTRY_CODES]

# PhoneNumberParserTest.scala reference vectors
PNS = ["+15105556666", "510 555 6666", "+1+3456", "+1510334455667788", None]
ANSWER_PARSE = ["+15105556666", "+15105556666", None, "+15103344556", None]
ANSWER_VALID = [True, True, None, True, None]


def test_clean_number_printable_ascii():
    all_ascii = "".join(chr(c) for c in range(32, 127))
    assert clean_number(all_ascii) == "+0123456789"


def test_parse_reference_vectors():
    got = [parse_phone(p, "US") for p in PNS]
    # "+1+3456" parse: reference raises inside Try → None
    assert got == ANSWER_PARSE


def test_validate_reference_vectors():
    got = [validate_phone(p, "US") for p in PNS]
    assert got == ANSWER_VALID


def test_validate_short_and_empty():
    assert validate_phone("1", "US") is None      # < 2 chars
    assert validate_phone("ab", "US") is None     # NOT_A_NUMBER → None
    assert validate_phone(None, "US") is None


def test_international_code_constant():
    assert INTERNATIONAL_CODE == "ZZ"


def test_valid_country_code_explicit_supported_region():
    # an explicit SUPPORTED region outside the configured list is honored
    assert valid_country_code("", "AF", "US", _CODES, _NAMES) == "AF"


def test_valid_country_code_not_found_falls_to_default():
    assert valid_country_code("", "FooBar", "US", (), ()) == "US"


def test_valid_country_code_closest_name_match():
    countries = ["uS", "United St America", "States of America", "Grece",
                 "Switzland", "USA"]
    got = [
        valid_country_code("", c, "US", _CODES, _NAMES) for c in countries
    ]
    assert got == ["US", "US", "US", "GR", "CH", "US"]


def test_valid_country_code_international_overrides():
    assert (
        valid_country_code("+1234566", "CN", "US", _CODES, _NAMES)
        == INTERNATIONAL_CODE
    )


def test_valid_country_code_user_mapping():
    codes = ["US", "CA", "ZW"]
    names = ["UNITED STATES", "CANADA", "ZIMBABWE"]
    cases = ["uS", "CD", "United", "Zimbwe", "USA"]
    got = [valid_country_code("", c, "US", codes, names) for c in cases]
    assert got == ["US", "CD", "US", "ZW", "US"]


def test_region_rules_spot_checks():
    # libphonenumber-documented validity facts
    assert validate_phone("5105556666", "US") is True
    assert validate_phone("15105556666", "US") is True    # own cc prefix
    assert validate_phone("1234567890", "US") is False    # area code 1xx
    assert validate_phone("0612345678", "US") is False    # area code 0xx
    assert validate_phone("+4915123456789", "DE") is True   # DE mobile, 11
    assert validate_phone("+33612345678", "FR") is True     # FR, 9 national
    assert validate_phone("+3361234567", "FR") is False     # FR, 8 national
    assert validate_phone("+919876543210", "IN") is True    # IN mobile
    assert validate_phone("+911234543210", "IN") is False   # IN must start 6-9
    assert validate_phone("+6591234567", "SG") is True      # SG 8 digits
    assert validate_phone("+659123456", "SG") is False


def test_truncate_too_long_non_strict_vs_strict():
    long_num = "+1510334455667788"
    assert parse_phone(long_num, "US", strict=False) == "+15103344556"
    assert parse_phone(long_num, "US", strict=True) is None
    assert validate_phone(long_num, "US", strict=True) is False


def test_parse_phone_default_country_transformer():
    col = column_from_values(Phone, PNS)
    out = ParsePhoneDefaultCountry().transform_columns(
        col, num_rows=len(PNS)
    )
    assert list(out.values) == ANSWER_PARSE


def test_is_valid_phone_transformer_with_region_column():
    phones = column_from_values(Phone, ["510 555 6666", "+15105556666"])
    regions = column_from_values(Text, ["United St America", "CN"])
    stage = IsValidPhoneNumber()
    out = stage.transform_columns(phones, regions, num_rows=2)
    assert out.to_list() == [True, True]


def test_is_valid_phone_map_transformer():
    maps = MapColumn(
        PhoneMap,
        [
            {"home": "5105556666", "bad": "12", "none": None},
            {},
        ],
    )
    stage = IsValidPhoneMapDefaultCountry()
    out = stage.transform_columns(maps, num_rows=2)
    rows = out.to_list()
    # 'bad' parses but is invalid → False kept; None (unparseable) drops
    # (reference collects only SomeValue results)
    assert rows[0] == {"home": True, "bad": False}
    assert rows[1] == {}
    assert out.feature_type is BinaryMap


def test_set_codes_and_countries_rejects_garbage():
    with pytest.raises(ValueError):
        ParsePhoneNumber().set_codes_and_countries({"foo": "bar"})


def test_parse_zw_default_region_reference_vector():
    """PhoneNumberParserTest 'need a country identifyer when the local does
    not match the default': under default region ZW, a bare US-shaped local
    number must NOT validate — only explicit +1 numbers survive."""
    got = [parse_phone(p, "ZW") for p in PNS]
    assert got == ["+15105556666", None, None, "+15103344556", None]


# ------------------- the phone cases of tests/test_map_list_vectorizers.py
def test_phone_validation():
    assert is_valid_phone("(555) 123-4567") is True          # 10-digit US
    assert is_valid_phone("1-555-123-4567") is True          # with country code
    assert is_valid_phone("+15551234567") is True            # E.164 US
    assert is_valid_phone("+44 20 7946 0958") is True        # GB, 10-digit national
    assert is_valid_phone("+1234") is False                  # too short for E.164
    assert is_valid_phone("12345") is False
    # no digits at all: parse raises in the reference → None, not False
    assert is_valid_phone("not a phone") is None
    assert is_valid_phone(None) is None


def test_phone_vectorizer_block():
    f = FeatureBuilder.Phone("p").as_predictor()
    stage = PhoneVectorizer().set_input(f)
    ds = Dataset.of({"p": column_from_values(T.Phone, ["5551234567", "123", None])})
    out = stage.transform(ds)[stage.output_name]
    np.testing.assert_allclose(
        np.asarray(out.values), [[1, 0], [0, 0], [0, 1]]
    )
    assert out.metadata.columns[1].indicator_value == NULL_STRING


def test_phone_map_vectorizer():
    f = FeatureBuilder.PhoneMap("m").as_predictor()
    stage = PhoneMapVectorizer().set_input(f)
    ds = Dataset.of({"m": column_from_values(
        T.PhoneMap, [{"cell": "5551234567"}, {"cell": "12"}, {}])})
    model = stage.fit(ds)
    out = model.transform(ds)[stage.output_name]
    vals = np.asarray(out.values)
    np.testing.assert_allclose(vals[:, 0], [1.0, 0.0, 0.0])
    np.testing.assert_allclose(vals[:, 1], [0.0, 0.0, 1.0])


# ------------------------------------------------ against the JAX package
N = 300

ODD_PHONES = ["+15105556666", "510 555 6666", "+1+3456", "+1510334455667788",
              "1", "ab", "(020) 7946-0958", "+4915123456789", "0612345678",
              "+919876543210", "+659123456", "++", "+", "  +33 6 12 34 56 78 ",
              "5105556666x12", "+2637712345678", "+85221234567"]
REGIONS = ["US", "GB", "DE", "FR", "IN", "SG", "ZW", "CN", "BR", "XX"]


def test_parse_and_validate_equal_the_reference():
    phones = JTK.RandomText.phones_with_errors(0.3, seed=5).limit(N) \
        + ODD_PHONES
    for region in REGIONS:
        for strict in (False, True):
            for p in phones:
                assert parse_phone(p, region, strict) == JP.parse_phone(
                    p, region, strict), (p, region, strict)
                assert validate_phone(p, region, strict) == \
                    JP.validate_phone(p, region, strict), (p, region, strict)
    for region in ("uS", "United", "Grece", "Zimbwe", "AF", "FooBar", None):
        for p in ("", "+1234566", "5105556666"):
            assert valid_country_code(p, region, "US", PP.SUPPORTED_REGIONS,
                                      ()) == JP.valid_country_code(
                p, region, "US", JP.SUPPORTED_REGIONS, ())


def _pair(make, n=N, seed=21, count=2):
    return PAIRS.columns(make, n, seed, count)


def _same_vectors(stage_j, stage_p, type_name, cols):
    jout, _ = PAIRS.run("jax", stage_j, type_name, cols["jax"])
    pout, _ = PAIRS.run("port", stage_p, type_name, cols["port"])
    assert pout.values.dtype == np.float32
    np.testing.assert_array_equal(pout.values,
                                  np.asarray(jout.values, np.float32))
    assert PAIRS.metas(pout) == PAIRS.metas(jout)
    return pout


@pytest.mark.parametrize("region", ["US", "GB", "ZW"])
def test_phone_vectorizer_equals_the_reference(region):
    cols = _pair(lambda tk: tk.RandomText.phones_with_errors(0.3)
                 .with_probability_of_empty(0.2))
    out = _same_vectors(JP.PhoneVectorizer(region), PhoneVectorizer(region),
                        "Phone", cols)
    assert out.values.shape == (N, 4)


@pytest.mark.parametrize("track_nulls", [True, False])
def test_phone_map_vectorizer_equals_the_reference(track_nulls):
    from transmogrifai_tpu.ops.maps import PhoneMapVectorizer as JPMV

    cols = _pair(lambda tk: tk.RandomMap.of(
        tk.RandomText.phones_with_errors(0.3), tk.T.PhoneMap,
        ("home", "work", "cell")).with_probability_of_empty(0.2))
    _same_vectors(JPMV(track_nulls=track_nulls),
                  PhoneMapVectorizer(track_nulls=track_nulls), "PhoneMap",
                  cols)


@pytest.mark.parametrize("name", ["ParsePhoneDefaultCountry",
                                  "IsValidPhoneDefaultCountry"])
def test_phone_transformers_equal_the_reference(name):
    cols = _pair(lambda tk: tk.RandomText.phones_with_errors(0.3)
                 .with_probability_of_empty(0.2), count=1)
    jout, _ = PAIRS.run("jax", getattr(JP, name)("GB"), "Phone", cols["jax"])
    pout, _ = PAIRS.run("port", getattr(PP, name)("GB"), "Phone", cols["port"])
    assert PAIRS.values(pout) == PAIRS.values(jout)
    assert pout.feature_type.__name__ == jout.feature_type.__name__


@pytest.mark.parametrize("name", ["ParsePhoneNumber", "IsValidPhoneNumber"])
def test_phone_region_transformers_equal_the_reference(name):
    jphones = JTK.RandomText.phones_with_errors(0.3, seed=3).limit(N)
    regions = [["US", "CN", "United St America", "Grece", None, "AF"][i % 6]
               for i in range(N)]
    jcols = [JTK.column_from_values(JT.Phone, jphones),
             JTK.column_from_values(JT.Text, regions)]
    pcols = [column_from_values(T.Phone, jphones),
             column_from_values(T.Text, regions)]
    jout = getattr(JP, name)().transform_columns(*jcols, num_rows=N)
    pout = getattr(PP, name)().transform_columns(*pcols, num_rows=N)
    assert pout.to_list() == jout.to_list()


def test_phone_map_transformer_equals_the_reference():
    cols = _pair(lambda tk: tk.RandomMap.of(
        tk.RandomText.phones_with_errors(0.3), tk.T.PhoneMap,
        ("home", "work")), count=1)
    jout = JP.IsValidPhoneMapDefaultCountry().transform_columns(
        cols["jax"][0], num_rows=N)
    pout = IsValidPhoneMapDefaultCountry().transform_columns(
        cols["port"][0], num_rows=N)
    assert pout.to_list() == jout.to_list()


# ------------------------------------------------------ dates and periods
PERIODS = ("HourOfDay", "DayOfWeek", "DayOfMonth", "DayOfYear",
           "MonthOfYear", "WeekOfMonth", "WeekOfYear")
#: epoch millis over +-5000 years, the epoch's neighbourhood and leap days
SWEEP = np.concatenate([
    np.random.default_rng(0).integers(-157_000_000_000_000,
                                      157_000_000_000_000, 4000),
    np.arange(-3, 4) * 43_200_000,
    np.array([951_782_400_000, 951_868_800_000, 4_107_456_000_000,
              -2_203_891_200_000]),
]).astype(np.int64)


@pytest.mark.parametrize("period", PERIODS)
def test_calendar_periods_equal_the_reference(period):
    got = PTP.calendar_periods(SWEEP, period)
    np.testing.assert_array_equal(got, JFK.calendar_periods(SWEEP, period))
    assert [PTP.period_value(int(m), period) for m in SWEEP[-11:]] == \
        got[-11:].tolist()


@pytest.mark.parametrize("period", PERIODS)
def test_unit_circle_equals_the_reference(period):
    ms = SWEEP[np.abs(SWEEP) < 4_000_000_000_000]
    mask = np.arange(len(ms)) % 5 != 0
    np.testing.assert_array_equal(PD.unit_circle(ms, mask, period),
                                  JD.unit_circle(ms, mask, period))


@pytest.mark.parametrize("type_name", ["Date", "DateTime"])
@pytest.mark.parametrize("reps", [("HourOfDay", "DayOfWeek", "DayOfMonth",
                                   "DayOfYear"), ("MonthOfYear", "WeekOfYear")])
def test_date_vectorizer_equals_the_reference(type_name, reps):
    gen = "dates" if type_name == "Date" else "datetimes"
    cols = _pair(lambda tk: getattr(tk.RandomIntegral, gen)()
                 .with_probability_of_empty(0.2))
    out = _same_vectors(JD.DateVectorizer(1_325_376_000_000, reps),
                        PD.DateVectorizer(1_325_376_000_000, reps), type_name,
                        cols)
    assert out.values.shape == (N, 2 * (2 * len(reps) + 2))


@pytest.mark.parametrize("period", PERIODS)
def test_date_to_unit_circle_equals_the_reference(period):
    cols = _pair(lambda tk: tk.RandomIntegral.datetimes()
                 .with_probability_of_empty(0.2))
    _same_vectors(JD.DateToUnitCircleTransformer(period),
                  PD.DateToUnitCircleTransformer(period), "DateTime", cols)


@pytest.mark.parametrize("period", PERIODS)
def test_time_period_transformers_equal_the_reference(period):
    for name, type_name, make in (
        ("TimePeriodTransformer", "Date",
         lambda tk: tk.RandomIntegral.dates().with_probability_of_empty(0.2)),
        ("TimePeriodListTransformer", "DateList",
         lambda tk: tk.RandomList.of_dates(0, 4)),
        ("TimePeriodMapTransformer", "DateMap",
         lambda tk: tk.RandomMap.of(tk.RandomIntegral.dates(), tk.T.DateMap)),
    ):
        cols = _pair(make, count=1)
        jout, _ = PAIRS.run("jax", getattr(JTP, name)(period), type_name,
                            cols["jax"])
        pout, _ = PAIRS.run("port", getattr(PTP, name)(period), type_name,
                            cols["port"])
        assert PAIRS.values(pout) == PAIRS.values(jout), name
        assert pout.feature_type.__name__ == jout.feature_type.__name__
        if name == "TimePeriodTransformer":
            np.testing.assert_array_equal(pout.mask, jout.mask)


# ---------------------------------------------------------------- domains
DOMAIN_ODD = ["a@b.c", "@b.c", "a@", "a@@b.c", "x@y@z", "", None,
              "HTTP://Example.COM/x", "ftp://h.org", "https://", "mailto:x",
              "https://[::1]:80/p", "http://[bad", "www.no-scheme.com"]


def test_domains_equal_the_reference():
    emails = JTK.RandomText.emails(seed=2).limit(100) + DOMAIN_ODD
    urls = JTK.RandomText.urls(seed=2).limit(100) + DOMAIN_ODD
    assert [PDOM.email_domain(v) for v in emails] == \
        [JDOM.email_domain(v) for v in emails]
    assert [PDOM.url_domain(v) for v in urls] == \
        [JDOM.url_domain(v) for v in urls]


def test_domain_transformers_equal_the_reference():
    cols = _pair(lambda tk: tk.RandomText.emails()
                 .with_probability_of_empty(0.2), count=1)
    jout, _ = PAIRS.run("jax", JDOM.EmailToPickListTransformer(), "Email",
                        cols["jax"])
    pout, _ = PAIRS.run("port", PDOM.EmailToPickListTransformer(), "Email",
                        cols["port"])
    assert PAIRS.values(pout) == PAIRS.values(jout)
    cols = _pair(lambda tk: tk.RandomMap.of(tk.RandomText.urls(), tk.T.URLMap),
                 count=1)
    jout, _ = PAIRS.run("jax", JDOM.UrlMapToPickListMapTransformer(), "URLMap",
                        cols["jax"])
    pout, _ = PAIRS.run("port", PDOM.UrlMapToPickListMapTransformer(), "URLMap",
                        cols["port"])
    assert PAIRS.values(pout) == PAIRS.values(jout)
    assert pout.feature_type.__name__ == "PickListMap"
