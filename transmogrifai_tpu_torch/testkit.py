"""testkit — deterministic random generators for every feature type
(the reference's testkit/src/main/scala/com/salesforce/op/testkit/:
RandomReal, RandomText, RandomBinary, RandomIntegral, RandomMap,
RandomList, RandomSet, RandomVector, ProbabilityOfEmpty, InfiniteStream,
RandomData). Each generator is an infinite, seeded stream of typed values
with a probability-of-empty control; ``limit(n)`` materializes n values and
``to_column(n)`` / ``random_dataset`` produce the columnar form directly.
The draws are numpy ``default_rng`` draws in the same order as
``transmogrifai_tpu.testkit``'s, so a seed gives the same values and
masks in both packages. ``fault_plan`` and ``install_faults`` are the
fault harness (``resilience/faults.py``).
"""
from __future__ import annotations

import base64
import string
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from . import types as T
from .dataset import Dataset
from .types.columns import Column, column_from_values


class _StatefulProducer:
    """Marks a producer that carries per-stream state (e.g. a counter):
    ``factory()`` builds a fresh producer for each stream so repeated
    ``limit``/``to_column`` calls stay reproducible."""

    def __init__(self, factory: Callable[[], Callable]):
        self.factory = factory


class RandomGenerator:
    """Base: infinite seeded stream with probability-of-empty
    (ProbabilityOfEmpty.scala, InfiniteStream.scala)."""

    def __init__(
        self,
        ftype: type,
        producer: Callable[[np.random.Generator], Any] | _StatefulProducer,
        probability_of_empty: float = 0.0,
        seed: int = 42,
    ):
        self.ftype = ftype
        self._producer = producer
        self.probability_of_empty = probability_of_empty
        self.seed = seed

    def with_probability_of_empty(self, p: float) -> "RandomGenerator":
        """ProbabilityOfEmpty.withProbabilityOfEmpty."""
        return RandomGenerator(self.ftype, self._producer, p, self.seed)

    def with_seed(self, seed: int) -> "RandomGenerator":
        return RandomGenerator(
            self.ftype, self._producer, self.probability_of_empty, seed
        )

    def stream(self) -> Iterator[Any]:
        rng = np.random.default_rng(self.seed)
        producer = (
            self._producer.factory()
            if isinstance(self._producer, _StatefulProducer)
            else self._producer
        )
        while True:
            if self.probability_of_empty and rng.random() < self.probability_of_empty:
                yield None
            else:
                yield producer(rng)

    def draw(self, rng: np.random.Generator) -> Any:
        """One value using an external rng — honors probability_of_empty.
        For composing generators (RandomMap/RandomList sources). Stateful
        producers (unique_ids) keep ONE instance across draws so state
        advances rather than resetting per element."""
        if self.probability_of_empty and rng.random() < self.probability_of_empty:
            return None
        if isinstance(self._producer, _StatefulProducer):
            cached = getattr(self, "_draw_producer", None)
            if cached is None:
                cached = self._producer.factory()
                self._draw_producer = cached
            return cached(rng)
        return self._producer(rng)

    def limit(self, n: int) -> list:
        it = self.stream()
        return [next(it) for _ in range(n)]

    def to_column(self, n: int) -> Column:
        return column_from_values(self.ftype, self.limit(n))


# ------------------------------------------------------------------- numerics
class RandomReal:
    """RandomReal.scala:85-157 — distributions over Real subtypes."""

    @staticmethod
    def uniform(
        min_value: float = 0.0, max_value: float = 1.0,
        ftype: type = T.Real, seed: int = 42,
    ) -> RandomGenerator:
        return RandomGenerator(
            ftype, lambda r: float(r.uniform(min_value, max_value)), seed=seed
        )

    @staticmethod
    def normal(
        mean: float = 0.0, sigma: float = 1.0,
        ftype: type = T.Real, seed: int = 42,
    ) -> RandomGenerator:
        return RandomGenerator(
            ftype, lambda r: float(r.normal(mean, sigma)), seed=seed
        )

    @staticmethod
    def poisson(mean: float = 0.0, ftype: type = T.Real, seed: int = 42):
        return RandomGenerator(
            ftype, lambda r: float(r.poisson(mean)), seed=seed
        )

    @staticmethod
    def exponential(mean: float = 1.0, ftype: type = T.Real, seed: int = 42):
        return RandomGenerator(
            ftype, lambda r: float(r.exponential(mean)), seed=seed
        )

    @staticmethod
    def gamma(shape: float = 1.0, scale: float = 1.0, ftype: type = T.Real, seed: int = 42):
        return RandomGenerator(
            ftype, lambda r: float(r.gamma(shape, scale)), seed=seed
        )

    @staticmethod
    def log_normal(mean: float = 0.0, sigma: float = 1.0, ftype: type = T.Real, seed: int = 42):
        return RandomGenerator(
            ftype, lambda r: float(r.lognormal(mean, sigma)), seed=seed
        )

    @staticmethod
    def weibull(shape: float = 1.0, scale: float = 1.0, ftype: type = T.Real, seed: int = 42):
        return RandomGenerator(
            ftype, lambda r: float(scale * r.weibull(shape)), seed=seed
        )


class RandomIntegral:
    """RandomIntegral.scala."""

    @staticmethod
    def integrals(low: int = 0, high: int = 100, ftype: type = T.Integral, seed: int = 42):
        return RandomGenerator(
            ftype, lambda r: int(r.integers(low, high)), seed=seed
        )

    @staticmethod
    def dates(
        start_ms: int = 1_300_000_000_000, step_ms: int = 86_400_000, seed: int = 42
    ):
        """Random dates within ~1000 steps after start."""
        return RandomGenerator(
            T.Date,
            lambda r: int(start_ms + r.integers(0, 1000) * step_ms),
            seed=seed,
        )

    @staticmethod
    def datetimes(start_ms: int = 1_300_000_000_000, seed: int = 42):
        return RandomGenerator(
            T.DateTime,
            lambda r: int(start_ms + r.integers(0, 1_000_000_000)),
            seed=seed,
        )


class RandomBinary:
    """RandomBinary.scala: Bernoulli(p)."""

    @staticmethod
    def of(probability_of_success: float = 0.5, seed: int = 42) -> RandomGenerator:
        return RandomGenerator(
            T.Binary,
            lambda r: bool(r.random() < probability_of_success),
            seed=seed,
        )


# ----------------------------------------------------------------------- text
_COUNTRIES = (
    "Afghanistan Albania Algeria Argentina Australia Austria Belgium Brazil "
    "Canada Chile China Colombia Denmark Egypt Finland France Germany Greece "
    "India Indonesia Ireland Israel Italy Japan Kenya Mexico Netherlands "
    "Nigeria Norway Pakistan Peru Poland Portugal Romania Russia Spain "
    "Sweden Switzerland Thailand Turkey Ukraine Uruguay Venezuela Vietnam"
).split()
_STATES = (
    "Alabama Alaska Arizona Arkansas California Colorado Connecticut Delaware "
    "Florida Georgia Hawaii Idaho Illinois Indiana Iowa Kansas Kentucky "
    "Louisiana Maine Maryland Massachusetts Michigan Minnesota Mississippi "
    "Missouri Montana Nebraska Nevada Ohio Oklahoma Oregon Pennsylvania "
    "Tennessee Texas Utah Vermont Virginia Washington Wisconsin Wyoming"
).split()
_CITIES = (
    "Sacramento SanFrancisco SanJose LosAngeles SanDiego Fresno Oakland "
    "Bakersfield Anaheim Stockton Riverside Irvine Fremont Berkeley"
).split()
_STREETS = (
    "FirstStreet SecondStreet MarketStreet AlmadenBoulevard SantaClaraStreet "
    "TheAlameda LincolnAvenue MeridianAvenue CamdenAvenue BlossomHillRoad"
).split()


def _rand_string(rng: np.random.Generator, min_len: int, max_len: int) -> str:
    n = int(rng.integers(min_len, max_len + 1))
    letters = np.array(list(string.ascii_lowercase))
    return "".join(rng.choice(letters, n))


class RandomText:
    """RandomText.scala — typed text streams."""

    @staticmethod
    def strings(min_len: int = 1, max_len: int = 20, ftype: type = T.Text, seed: int = 42):
        return RandomGenerator(
            ftype, lambda r: _rand_string(r, min_len, max_len), seed=seed
        )

    @staticmethod
    def text_areas(min_len: int = 1, max_len: int = 80, seed: int = 42):
        return RandomText.strings(min_len, max_len, T.TextArea, seed)

    @staticmethod
    def from_domain(
        domain: Sequence[str],
        distribution: Sequence[float] = (),
        ftype: type = T.Text,
        seed: int = 42,
    ):
        """textFromDomain / pickLists / comboBoxes with optional weights."""
        domain = list(domain)
        p = np.asarray(distribution, dtype=np.float64) if distribution else None
        if p is not None:
            p = p / p.sum()

        def producer(r: np.random.Generator) -> str:
            return str(r.choice(domain, p=p))

        return RandomGenerator(ftype, producer, seed=seed)

    @staticmethod
    def pick_lists(domain: Sequence[str], distribution: Sequence[float] = (), seed: int = 42):
        return RandomText.from_domain(domain, distribution, T.PickList, seed)

    @staticmethod
    def combo_boxes(domain: Sequence[str], distribution: Sequence[float] = (), seed: int = 42):
        return RandomText.from_domain(domain, distribution, T.ComboBox, seed)

    @staticmethod
    def countries(seed: int = 42):
        return RandomText.from_domain(_COUNTRIES, ftype=T.Country, seed=seed)

    @staticmethod
    def states(seed: int = 42):
        return RandomText.from_domain(_STATES, ftype=T.State, seed=seed)

    @staticmethod
    def cities(seed: int = 42):
        return RandomText.from_domain(_CITIES, ftype=T.City, seed=seed)

    @staticmethod
    def streets(seed: int = 42):
        return RandomText.from_domain(_STREETS, ftype=T.Street, seed=seed)

    @staticmethod
    def emails(domain: str = "example.com", seed: int = 42):
        return RandomGenerator(
            T.Email,
            lambda r: f"{_rand_string(r, 3, 10)}@{domain}",
            seed=seed,
        )

    @staticmethod
    def urls(seed: int = 42):
        return RandomGenerator(
            T.URL,
            lambda r: f"https://www.{_rand_string(r, 3, 10)}.com/{_rand_string(r, 1, 8)}",
            seed=seed,
        )

    @staticmethod
    def phones(seed: int = 42):
        """Valid-shaped US phones (RandomText.phones)."""
        return RandomGenerator(
            T.Phone,
            lambda r: f"+1{r.integers(200, 999)}{r.integers(200, 999)}{r.integers(1000, 9999)}",
            seed=seed,
        )

    @staticmethod
    def phones_with_errors(probability_of_error: float = 0.2, seed: int = 42):
        def producer(r: np.random.Generator) -> str:
            if r.random() < probability_of_error:
                return str(r.integers(0, 999))  # too short to be valid
            return f"+1{r.integers(200, 999)}{r.integers(200, 999)}{r.integers(1000, 9999)}"

        return RandomGenerator(T.Phone, producer, seed=seed)

    @staticmethod
    def postal_codes(seed: int = 42):
        return RandomGenerator(
            T.PostalCode, lambda r: f"{r.integers(10000, 99999)}", seed=seed
        )

    @staticmethod
    def ids(seed: int = 42):
        return RandomGenerator(
            T.ID, lambda r: _rand_string(r, 8, 12), seed=seed
        )

    @staticmethod
    def unique_ids(seed: int = 42):
        def factory() -> Callable:
            counter = {"i": 0}

            def producer(r: np.random.Generator) -> str:
                counter["i"] += 1
                return f"id_{counter['i']:08d}"

            return producer

        return RandomGenerator(T.ID, _StatefulProducer(factory), seed=seed)

    @staticmethod
    def base64(min_len: int = 4, max_len: int = 32, seed: int = 42):
        def producer(r: np.random.Generator) -> str:
            n = int(r.integers(min_len, max_len + 1))
            return base64.b64encode(bytes(r.integers(0, 256, n).tolist())).decode()

        return RandomGenerator(T.Base64, producer, seed=seed)


# ---------------------------------------------------------- collections, maps
class RandomList:
    """RandomList.scala."""

    @staticmethod
    def of_texts(
        source: RandomGenerator | None = None,
        min_len: int = 0,
        max_len: int = 5,
        seed: int = 42,
    ):
        src = source or RandomText.strings(seed=seed)

        def producer(r: np.random.Generator) -> list:
            n = int(r.integers(min_len, max_len + 1))
            drawn = (src.draw(r) for _ in range(n))
            return [v for v in drawn if v is not None]

        return RandomGenerator(T.TextList, producer, seed=seed)

    @staticmethod
    def of_dates(min_len: int = 0, max_len: int = 5, seed: int = 42):
        def producer(r: np.random.Generator) -> list:
            n = int(r.integers(min_len, max_len + 1))
            return [
                int(1_300_000_000_000 + r.integers(0, 1_000_000_000))
                for _ in range(n)
            ]

        return RandomGenerator(T.DateList, producer, seed=seed)

    @staticmethod
    def of_geolocations(seed: int = 42):
        def producer(r: np.random.Generator) -> list:
            return [
                float(r.uniform(-90, 90)),
                float(r.uniform(-180, 180)),
                float(r.integers(1, 10)),
            ]

        return RandomGenerator(T.Geolocation, producer, seed=seed)


class RandomSet:
    """RandomSet.scala: MultiPickList streams."""

    @staticmethod
    def of(domain: Sequence[str], min_size: int = 0, max_size: int = 3, seed: int = 42):
        domain = list(domain)

        def producer(r: np.random.Generator) -> frozenset:
            n = int(r.integers(min_size, min(max_size, len(domain)) + 1))
            return frozenset(
                str(v) for v in r.choice(domain, size=n, replace=False)
            )

        return RandomGenerator(T.MultiPickList, producer, seed=seed)


class RandomMap:
    """RandomMap.scala: map streams built from a scalar generator."""

    @staticmethod
    def of(
        source: RandomGenerator,
        map_type: type,
        keys: Sequence[str] = ("k0", "k1", "k2"),
        min_size: int = 0,
        seed: int = 42,
    ):
        keys = list(keys)

        def producer(r: np.random.Generator) -> dict:
            n = int(r.integers(min_size, len(keys) + 1))
            chosen = r.choice(len(keys), size=n, replace=False)
            # a None draw (source probability_of_empty) leaves the key absent
            drawn = {keys[i]: source.draw(r) for i in sorted(chosen)}
            return {k: v for k, v in drawn.items() if v is not None}

        return RandomGenerator(map_type, producer, seed=seed)


class RandomVector:
    """RandomVector.scala: dense vectors from a scalar distribution."""

    @staticmethod
    def dense(dim: int, mean: float = 0.0, sigma: float = 1.0, seed: int = 42):
        def producer(r: np.random.Generator):
            return r.normal(mean, sigma, dim).astype(np.float32)

        return RandomGenerator(T.OPVector, producer, seed=seed)


# -------------------------------------------------------------- fault testkit
def fault_plan(seed: int = 42) -> "Any":
    """A fresh resilience ``FaultPlan`` — the deterministic fault-injection
    harness (raise on the Nth fit, fail a candidate, NaN a stage output,
    tear a file; serving side: malform incoming rows, fail or slow a
    scoring stage, tear a training profile, shift a feature's observed
    stream). Install it over a block with ``install_faults``::

        plan = (testkit.fault_plan()
                .malform_row("age", rows=(2,))         # quarantine row 2
                .fail_stage_transform("pred", times=3)  # trip the breaker
                .shift_feature("age", offset=50.0))     # drifted stream
        with testkit.install_faults(plan):
            fn = score_function(model)
            fn.batch(rows)

    Training faults script the checkpointed and streamed train
    (``crash_after_layer``, ``crash_after_chunk``, ``tear_stream_chunk``)
    and the retrain loop (``crash_retrain``, ``corrupt_new_chunk``); the
    distributed faults wait for distributed resilience (``ROADMAP.md``
    A13b)."""
    from .resilience.faults import FaultPlan

    return FaultPlan(seed=seed)


def install_faults(plan: "Any"):
    """Context manager installing a FaultPlan process-globally (see
    ``resilience.faults.installed``)."""
    from .resilience.faults import installed

    return installed(plan)


def drifted(generator: RandomGenerator, offset: float) -> RandomGenerator:
    """A shifted copy of a numeric generator — the covariate-shifted serve
    stream for drift-sentinel tests (same seed, same draw sequence, every
    value offset by ``offset``)."""
    inner = generator._producer
    if isinstance(inner, _StatefulProducer):
        raise TypeError("drifted() supports stateless numeric generators")

    def producer(r: np.random.Generator):
        return float(inner(r)) + offset

    return RandomGenerator(
        generator.ftype, producer,
        generator.probability_of_empty, generator.seed,
    )


# ----------------------------------------------------------------- RandomData
def random_dataset(
    generators: dict[str, RandomGenerator], n: int, seed: int | None = None
) -> Dataset:
    """RandomData.scala: assemble a typed Dataset from named generators.
    Per-column seeds are derived from the dataset seed so columns are
    independent but the whole dataset is reproducible."""
    cols = {}
    for i, (name, gen) in enumerate(generators.items()):
        g = gen if seed is None else gen.with_seed(seed + 1000 * i)
        cols[name] = g.to_column(n)
    return Dataset.of(cols)
