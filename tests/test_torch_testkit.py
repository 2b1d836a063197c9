"""testkit: the PyTorch port's copy of ``transmogrifai_tpu/testkit.py``.

The JAX package's ``tests/test_testkit.py`` cases run here against the
port's generators (but its end-to-end case, marked slow there, which the
all-types flow of ``test_torch_all_types.py`` covers). Every generator of
both packages then draws, from the same seed, the same values and masks
(EQUAL), ``random_dataset`` assembles the same dataset, and the fault
harness names the item that ports it.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from transmogrifai_tpu import testkit as JTK

import transmogrifai_tpu_torch.types as T
from transmogrifai_tpu_torch import testkit as PTK
from transmogrifai_tpu_torch.testkit import (
    RandomBinary,
    RandomIntegral,
    RandomList,
    RandomMap,
    RandomReal,
    RandomSet,
    RandomText,
    RandomVector,
    random_dataset,
)

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "port_pairs", os.path.join(HERE, "torch_fixtures", "port_pairs.py"))
PAIRS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(PAIRS)


class TestRandomGenerators:
    def test_deterministic_with_seed(self):
        a = RandomReal.normal(seed=7).limit(10)
        b = RandomReal.normal(seed=7).limit(10)
        assert a == b
        c = RandomReal.normal(seed=8).limit(10)
        assert a != c

    def test_probability_of_empty(self):
        vals = RandomReal.uniform(seed=1).with_probability_of_empty(0.5).limit(400)
        empties = sum(1 for v in vals if v is None)
        assert 120 < empties < 280

    def test_distributions_plausible(self):
        n = RandomReal.normal(mean=10, sigma=0.1, seed=2).limit(500)
        assert abs(np.mean(n) - 10) < 0.05
        u = RandomReal.uniform(2.0, 4.0, seed=2).limit(500)
        assert 2.0 <= min(u) and max(u) <= 4.0
        p = RandomReal.poisson(mean=3.0, seed=2).limit(500)
        assert abs(np.mean(p) - 3.0) < 0.4
        e = RandomReal.exponential(mean=2.0, seed=2).limit(1000)
        assert abs(np.mean(e) - 2.0) < 0.3

    def test_integrals_and_dates(self):
        ints = RandomIntegral.integrals(5, 10, seed=3).limit(100)
        assert all(5 <= v < 10 for v in ints)
        dates = RandomIntegral.dates(seed=3).limit(10)
        assert all(isinstance(v, int) and v >= 1_300_000_000_000 for v in dates)

    def test_binary(self):
        vals = RandomBinary.of(0.8, seed=4).limit(500)
        assert 0.7 < np.mean([1.0 if v else 0.0 for v in vals]) < 0.9

    def test_text_domains(self):
        picks = RandomText.pick_lists(["a", "b"], distribution=[0.9, 0.1], seed=5)
        vals = picks.limit(300)
        assert vals.count("a") > 200
        assert set(vals) <= {"a", "b"}
        countries = RandomText.countries(seed=5).limit(20)
        assert all(isinstance(c, str) and c for c in countries)

    def test_emails_phones_urls(self):
        emails = RandomText.emails("corp.co", seed=6).limit(5)
        assert all(e.endswith("@corp.co") for e in emails)
        phones = RandomText.phones(seed=6).limit(5)
        assert all(p.startswith("+1") and len(p) >= 11 for p in phones)
        urls = RandomText.urls(seed=6).limit(5)
        assert all(u.startswith("https://") for u in urls)
        bad = RandomText.phones_with_errors(1.0, seed=6).limit(5)
        assert all(len(p) <= 3 for p in bad)

    def test_unique_ids(self):
        ids = RandomText.unique_ids(seed=7).limit(100)
        assert len(set(ids)) == 100

    def test_collections(self):
        lists = RandomList.of_texts(min_len=1, max_len=3, seed=8).limit(50)
        assert all(1 <= len(x) <= 3 for x in lists)
        sets_ = RandomSet.of(["x", "y", "z"], seed=8).limit(50)
        assert all(isinstance(s, frozenset) for s in sets_)
        geos = RandomList.of_geolocations(seed=8).limit(10)
        assert all(len(g) == 3 and -90 <= g[0] <= 90 for g in geos)

    def test_maps(self):
        m = RandomMap.of(RandomReal.uniform(seed=9), T.RealMap, keys=["a", "b"], seed=9)
        vals = m.limit(50)
        assert all(set(v) <= {"a", "b"} for v in vals)

    def test_vectors(self):
        col = RandomVector.dense(4, seed=10).to_column(6)
        assert np.asarray(col.values).shape == (6, 4)

    def test_random_dataset_assembly(self):
        ds = random_dataset(
            {
                "age": RandomReal.uniform(18, 80, ftype=T.Real),
                "city": RandomText.pick_lists(["sf", "la"]),
                "active": RandomBinary.of(0.5),
            },
            n=25,
            seed=11,
        )
        assert len(ds) == 25
        assert ds["age"].feature_type is T.Real
        assert ds["city"].feature_type is T.PickList


class TestReproducibilityFixes:
    def test_unique_ids_reproducible_per_stream(self):
        g = RandomText.unique_ids(seed=7)
        assert g.limit(3) == g.limit(3) == ["id_00000001", "id_00000002", "id_00000003"]

    def test_map_source_probability_of_empty_respected(self):
        src = RandomReal.uniform(seed=9).with_probability_of_empty(0.8)
        m = RandomMap.of(src, T.RealMap, keys=["a", "b", "c"], min_size=3, seed=9)
        vals = m.limit(200)
        sizes = [len(v) for v in vals]
        assert min(sizes) < 3  # empties removed keys

    def test_list_source_probability_of_empty_respected(self):
        src = RandomText.strings(seed=9).with_probability_of_empty(0.9)
        lists = RandomList.of_texts(src, min_len=5, max_len=5, seed=9).limit(100)
        assert np.mean([len(x) for x in lists]) < 2.0


# ------------------------------------------------ against the JAX package
GENERATORS = {
    "uniform": lambda tk: tk.RandomReal.uniform(-2.0, 5.0),
    "normal": lambda tk: tk.RandomReal.normal(3.0, 2.0, ftype=tk.T.Currency),
    "poisson": lambda tk: tk.RandomReal.poisson(4.0),
    "exponential": lambda tk: tk.RandomReal.exponential(2.0),
    "gamma": lambda tk: tk.RandomReal.gamma(2.0, 3.0, ftype=tk.T.Percent),
    "log_normal": lambda tk: tk.RandomReal.log_normal(1.0, 0.5),
    "weibull": lambda tk: tk.RandomReal.weibull(1.5, 2.0),
    "integrals": lambda tk: tk.RandomIntegral.integrals(-5, 50),
    "dates": lambda tk: tk.RandomIntegral.dates(),
    "datetimes": lambda tk: tk.RandomIntegral.datetimes(),
    "binary": lambda tk: tk.RandomBinary.of(0.3),
    "strings": lambda tk: tk.RandomText.strings(0, 12),
    "text_areas": lambda tk: tk.RandomText.text_areas(),
    "pick_lists": lambda tk: tk.RandomText.pick_lists(["a", "b", "c"],
                                                      (3, 2, 1)),
    "combo_boxes": lambda tk: tk.RandomText.combo_boxes(["x", "y"]),
    "countries": lambda tk: tk.RandomText.countries(),
    "states": lambda tk: tk.RandomText.states(),
    "cities": lambda tk: tk.RandomText.cities(),
    "streets": lambda tk: tk.RandomText.streets(),
    "emails": lambda tk: tk.RandomText.emails("corp.co"),
    "urls": lambda tk: tk.RandomText.urls(),
    "phones": lambda tk: tk.RandomText.phones(),
    "phones_with_errors": lambda tk: tk.RandomText.phones_with_errors(0.4),
    "postal_codes": lambda tk: tk.RandomText.postal_codes(),
    "ids": lambda tk: tk.RandomText.ids(),
    "unique_ids": lambda tk: tk.RandomText.unique_ids(),
    "base64": lambda tk: tk.RandomText.base64(),
    "text_lists": lambda tk: tk.RandomList.of_texts(
        tk.RandomText.strings().with_probability_of_empty(0.3), 0, 5),
    "date_lists": lambda tk: tk.RandomList.of_dates(0, 6),
    "geolocations": lambda tk: tk.RandomList.of_geolocations(),
    "sets": lambda tk: tk.RandomSet.of(["p", "q", "r", "s"], 0, 3),
    "real_maps": lambda tk: tk.RandomMap.of(
        tk.RandomReal.normal().with_probability_of_empty(0.3), tk.T.RealMap,
        ("a", "b", "c")),
    "pick_list_maps": lambda tk: tk.RandomMap.of(
        tk.RandomText.pick_lists(["u", "v"]), tk.T.PickListMap, ("k", "j"),
        min_size=1),
    "geolocation_maps": lambda tk: tk.RandomMap.of(
        tk.RandomList.of_geolocations(), tk.T.GeolocationMap),
    "vectors": lambda tk: tk.RandomVector.dense(3, 1.0, 2.0),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_draw_what_the_reference_draws(name):
    """Same seed, same values and masks: each stream and its column, with
    and without a probability of empty."""
    make = GENERATORS[name]
    for p in (0.0, 0.25):
        jg = make(JTK).with_probability_of_empty(p).with_seed(17)
        pg = make(PTK).with_probability_of_empty(p).with_seed(17)
        jv, pv = jg.limit(200), pg.limit(200)
        if name == "vectors":
            assert [None if v is None else v.tolist() for v in pv] == \
                [None if v is None else v.tolist() for v in jv]
            continue
        assert pv == jv
        jcol, pcol = jg.to_column(200), pg.to_column(200)
        assert type(pcol).__name__ == type(jcol).__name__
        assert pcol.feature_type.__name__ == jcol.feature_type.__name__
        assert PAIRS.values(pcol) == PAIRS.values(jcol)
        if hasattr(jcol, "mask"):
            np.testing.assert_array_equal(pcol.mask, jcol.mask)
            np.testing.assert_array_equal(pcol.values, jcol.values)


def test_draw_composes_as_the_reference_composes():
    for tk in (JTK, PTK):
        rng = np.random.default_rng(5)
        ids = tk.RandomText.unique_ids()
        got = [ids.draw(rng) for _ in range(3)]
        assert got == ["id_00000001", "id_00000002", "id_00000003"]


def test_random_dataset_equals_the_reference():
    gens = {"r": "normal", "s": "sets", "m": "real_maps", "t": "text_lists",
            "p": "phones_with_errors", "d": "dates"}
    jds = JTK.random_dataset({k: GENERATORS[v](JTK) for k, v in gens.items()},
                             n=150, seed=9)
    pds = PTK.random_dataset({k: GENERATORS[v](PTK) for k, v in gens.items()},
                             n=150, seed=9)
    assert list(pds.columns) == list(jds.columns) and len(pds) == len(jds)
    for k in gens:
        assert PAIRS.values(pds[k]) == PAIRS.values(jds[k])


def test_drifted_equals_the_reference():
    jg = JTK.drifted(JTK.RandomReal.normal(seed=4), 2.5)
    pg = PTK.drifted(PTK.RandomReal.normal(seed=4), 2.5)
    assert pg.limit(50) == jg.limit(50)
    with pytest.raises(TypeError):
        PTK.drifted(PTK.RandomText.unique_ids(), 1.0)


@pytest.mark.parametrize("name", ["fault_plan", "install_faults"])
def test_fault_harness_names_its_item(name):
    """The fault harness is ported (``resilience/faults.py``): ``fault_plan``
    gives a fresh seeded plan of the port's, ``install_faults`` installs it
    over a block, as the JAX package's testkit does with its own."""
    from transmogrifai_tpu.resilience import faults as jax_faults
    from transmogrifai_tpu_torch.resilience import faults

    if name == "fault_plan":
        plan, ref = PTK.fault_plan(seed=7), JTK.fault_plan(seed=7)
        assert isinstance(plan, faults.FaultPlan) and plan.seed == ref.seed
        assert plan.fired == ref.fired == []
        return
    plan, ref = PTK.fault_plan(), JTK.fault_plan()
    with PTK.install_faults(plan), JTK.install_faults(ref):
        assert faults.active() is plan and jax_faults.active() is ref
    assert faults.active() is None and jax_faults.active() is None
