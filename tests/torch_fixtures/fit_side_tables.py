"""Seeded tables of the fit-side fixtures, built with numpy alone so that
both packages, the fixture generator and ``chip_smoke.py`` build the same
rows without JAX.

``wide_table(n, seed)`` is the full-width fit-side table (16384 rows, the
training table's count, by default):

* ``label``: RealNN 0/1, ``1`` where a linear score of ``r3``, ``r4``,
  ``i0``, ``p00``'s level, ``t_sex`` and ``normal(0, 1)`` noise is > 0;
* ``r0`` .. ``r9``: Real; ``r0``-``r2`` are about 20% empty;
* ``i0`` (0-9) and ``i1`` (0-99): Integral;
* ``b0``: Binary, about 5% empty;
* ``p00`` .. ``p39``: PickList of 25 levels ``"p<k>_v<l>"`` drawn with
  Zipf-like weights (l + 1)^-0.6, about 3% empty;
* ``t_sex``: Text, ``"male"`` / ``"female"``;
* ``t_name``: Text, near-unique ``"<Surname>, <Title>. <Given> <Given>"``.

``transmogrify`` makes 1423 vector columns of it (2 Binary, 4 Integral,
40 x 22 PickList, 20 Real, 4 + 513 Text: ``t_sex`` pivoted, ``t_name``
hashed into 512 buckets), so the correlation input holds 16384 x 1424
elements, above the reference's 2^22-element float32 threshold.

``wide_hash_table(n, seed)`` makes ``wide_table``'s draws unchanged, the
label included, and leaves the ``t_sex`` column out of the schema and the
columns. Its SmartText member is then hash-only, the fused scoring graph
can serve it (a member that mixes Pivot and Hash slots cannot be fused), and
``transmogrify`` makes 1419 vector columns of it: 2 Binary, 4 Integral,
20 Real, 40 x 22 PickList and 513 hashed text (512 buckets and a null
indicator).

``wide_hash_multiclass_table(n, seed)`` makes ``wide_table``'s draws
unchanged but ``t_sex``, left out as ``wide_hash_table`` leaves it, and
replaces the label by four classes, the quartiles of the same score, as a
``PickList`` of strings (``WIDE_CLASSES``).

Each builder returns ``(schema, columns)``: feature type name and list of
row values (``None`` for missing) per column name, in column order.
"""
from __future__ import annotations

import numpy as np

WIDE_ROWS = 16384
WIDE_SEED = 2024
N_REAL, N_EMPTY_REAL, N_PICK, N_LEVELS = 10, 3, 40, 25

_SYLLABLES = (
    "an", "ber", "cor", "dal", "en", "fal", "gor", "han", "ist", "jor",
    "kel", "lan", "mor", "nel", "or", "per", "quin", "ros", "sel", "tor",
    "ul", "ven", "wil", "xan", "yor", "zel",
)
_TITLES = ("Mr", "Mrs", "Miss", "Master", "Dr", "Rev")
_GIVEN = (
    "John", "Mary", "William", "Anna", "James", "Elizabeth", "George",
    "Margaret", "Thomas", "Helen", "Charles", "Alice", "Edward", "Ellen",
    "Henry", "Bertha", "Arthur", "Ida", "Frederick", "Hilda",
)


def names(rng: np.random.Generator, n: int) -> list[str]:
    """Near-unique passenger-style names."""
    syl = np.array(_SYLLABLES)
    out = []
    for _ in range(n):
        k = int(rng.integers(2, 4))
        surname = "".join(syl[rng.integers(0, len(syl), k)]).capitalize()
        title = _TITLES[int(rng.integers(0, len(_TITLES)))]
        g1, g2 = rng.integers(0, len(_GIVEN), 2)
        out.append(f"{surname}, {title}. {_GIVEN[g1]} {_GIVEN[g2]}")
    return out


def _with_empty(rng, values: list, p: float) -> list:
    empty = rng.random(len(values)) < p
    return [None if e else v for v, e in zip(values, empty)]


def wide_table(n: int = WIDE_ROWS, seed: int = WIDE_SEED):
    schema, columns, score = _wide_draws(n, seed)
    schema["label"], columns["label"] = "RealNN", (score > 0).astype(float).tolist()
    return schema, columns


def wide_hash_multiclass_table(n: int = WIDE_ROWS, seed: int = WIDE_SEED):
    """``wide_table``'s draws without ``t_sex`` (its SmartText member is
    then hash-only, so the fused scoring graph can serve the model: 1419
    vector columns) and with the label replaced by four classes: the
    quartiles of the same linear score, as a ``PickList`` of the strings
    ``WIDE_CLASSES`` (lowest quartile first), to be indexed with
    ``string_indexed``."""
    schema, columns, score = _wide_draws(n, seed)
    del schema["t_sex"], columns["t_sex"]
    edges = np.quantile(score, [0.25, 0.5, 0.75])
    cls = np.searchsorted(edges, score, side="right")
    schema["label"], columns["label"] = "PickList", [
        WIDE_CLASSES[int(c)] for c in cls.tolist()]
    return schema, columns


#: the four labels of ``wide_hash_multiclass_table``, lowest quartile first
WIDE_CLASSES = ("q1_low", "q2_mid_low", "q3_mid_high", "q4_high")


def _wide_draws(n: int, seed: int):
    """(schema, columns, linear score) of ``wide_table``'s rows, before the
    label."""
    rng = np.random.default_rng(seed)
    schema: dict[str, str] = {}
    columns: dict[str, list] = {}
    reals = []
    for j in range(N_REAL):
        kind = j % 3
        if kind == 0:
            v = rng.normal(10.0 * j, 1.0 + j, n)
        elif kind == 1:
            v = rng.lognormal(1.0, 0.5 + 0.1 * j, n)
        else:
            v = rng.uniform(-j, j + 1.0, n)
        reals.append(v)
        vals = v.tolist()
        if j < N_EMPTY_REAL:
            vals = _with_empty(rng, vals, 0.2)
        schema[f"r{j}"], columns[f"r{j}"] = "Real", vals
    i0 = rng.integers(0, 10, n)
    i1 = rng.integers(0, 100, n)
    schema["i0"], columns["i0"] = "Integral", i0.tolist()
    schema["i1"], columns["i1"] = "Integral", i1.tolist()
    schema["b0"], columns["b0"] = "Binary", _with_empty(
        rng, (rng.random(n) < 0.4).tolist(), 0.05)
    weights = (np.arange(N_LEVELS) + 1.0) ** -0.6
    weights /= weights.sum()
    p00 = None
    for k in range(N_PICK):
        lv = rng.choice(N_LEVELS, size=n, p=weights)
        if k == 0:
            p00 = lv
        vals = [f"p{k}_v{level}" for level in lv.tolist()]
        schema[f"p{k:02d}"], columns[f"p{k:02d}"] = "PickList", _with_empty(
            rng, vals, 0.03)
    female = rng.random(n) < 0.35
    schema["t_sex"], columns["t_sex"] = "Text", [
        "female" if f else "male" for f in female.tolist()]
    schema["t_name"], columns["t_name"] = "Text", names(rng, n)
    score = (0.4 * (reals[3] - reals[3].mean()) / reals[3].std()
             - 0.3 * (reals[4] - reals[4].mean()) / reals[4].std()
             + 0.1 * (i0 - 4.5) + 0.5 * (p00 < 3) + 1.0 * female - 0.6
             + rng.normal(0.0, 1.0, n))
    return schema, columns, score


def wide_hash_table(n: int = WIDE_ROWS, seed: int = WIDE_SEED):
    schema, columns = wide_table(n, seed)
    del schema["t_sex"], columns["t_sex"]
    return schema, columns
