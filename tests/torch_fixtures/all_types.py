"""The all-types table: one feature for each type group of
``transmogrify``'s default dispatch, built with a package's ``testkit`` so
that both packages, the fixture generator and ``chip_smoke.py`` draw the
same rows (``chip_smoke.py`` with the port's testkit alone, without JAX).

``all_types_table(n, seed, tk=None)`` returns a ``Dataset`` of ``tk``'s
package (the port's ``transmogrifai_tpu_torch.testkit`` by default; pass
``transmogrifai_tpu.testkit`` for the JAX package's):

* 22 predictors, one per type group: Real, Integral, Binary, Currency,
  Date, DateTime, PickList, MultiPickList, Text, Email, Phone
  (``phones_with_errors``), TextList, DateList, Geolocation, RealMap,
  IntegralMap, BinaryMap, PickListMap, TextMap, DateMap, PhoneMap and
  GeolocationMap; each is empty in about 20% of the rows
  (``with_probability_of_empty(0.2)``; a map is also empty where it draws
  no key);
* ``label``: RealNN 0/1, ``1`` where a linear score of ``real``, the
  ``picklist`` level, the ``multipicklist`` size, whether ``phone`` is
  non-empty and ``normal(0, 1)`` noise (a numpy ``default_rng(seed)``
  draw) is > 0, so the winner has signal.

``REFERENCE_DATE_MS`` is the fixed reference date both packages'
``transmogrify`` take (``TransmogrifierDefaults(ReferenceDateMs=...)``):
the default is the wall clock at the stage's construction.
"""
from __future__ import annotations

import dataclasses

import numpy as np

ROWS = 16384
SEED = 2026
EMPTY = 0.2
#: 2012-01-01T00:00:00Z, the days-since anchor of every date block
REFERENCE_DATE_MS = 1_325_376_000_000
PICK_LEVELS = ("alpha", "beta", "gamma", "delta", "epsilon")
SET_LEVELS = ("red", "green", "blue", "cyan", "magenta", "yellow")
WORDS = ("tree", "leaf", "root", "bark", "seed", "branch", "moss", "fern",
         "pine", "oak", "elm", "ash", "birch", "maple", "cedar", "yew")
MAP_KEYS = ("home", "work", "other")


def generators(tk) -> dict:
    """The predictors' generators of testkit module ``tk``, by name."""
    T = tk.T
    words = tk.RandomText.from_domain(WORDS, seed=7)
    g = {
        "real": tk.RandomReal.normal(10.0, 3.0),
        "integral": tk.RandomIntegral.integrals(0, 40),
        "binary": tk.RandomBinary.of(0.4),
        "currency": tk.RandomReal.log_normal(3.0, 1.0, ftype=T.Currency),
        "date": tk.RandomIntegral.dates(),
        "datetime": tk.RandomIntegral.datetimes(),
        "picklist": tk.RandomText.pick_lists(PICK_LEVELS, (5, 4, 3, 2, 1)),
        "multipicklist": tk.RandomSet.of(SET_LEVELS, 0, 3),
        "text": tk.RandomText.strings(3, 24),
        "email": tk.RandomText.emails("example.org"),
        "phone": tk.RandomText.phones_with_errors(0.3),
        "textlist": tk.RandomList.of_texts(words, 1, 4),
        "datelist": tk.RandomList.of_dates(1, 4),
        "geolocation": tk.RandomList.of_geolocations(),
        "realmap": tk.RandomMap.of(tk.RandomReal.normal(), T.RealMap, MAP_KEYS),
        "integralmap": tk.RandomMap.of(
            tk.RandomIntegral.integrals(0, 5), T.IntegralMap, MAP_KEYS),
        "binarymap": tk.RandomMap.of(tk.RandomBinary.of(0.5), T.BinaryMap,
                                     MAP_KEYS),
        "picklistmap": tk.RandomMap.of(
            tk.RandomText.pick_lists(PICK_LEVELS), T.PickListMap, MAP_KEYS),
        "textmap": tk.RandomMap.of(words, T.TextMap, MAP_KEYS),
        "datemap": tk.RandomMap.of(tk.RandomIntegral.dates(), T.DateMap,
                                   MAP_KEYS),
        "phonemap": tk.RandomMap.of(tk.RandomText.phones_with_errors(0.3),
                                    T.PhoneMap, MAP_KEYS),
        "geolocationmap": tk.RandomMap.of(
            tk.RandomList.of_geolocations(), T.GeolocationMap, MAP_KEYS),
    }
    return {k: v.with_probability_of_empty(EMPTY) for k, v in g.items()}


def label_values(ds, seed: int) -> list[float]:
    """The seeded rule of the label over a few of ``ds``'s predictors."""
    real = ds["real"]
    x = np.where(real.mask, real.values, 10.0) - 10.0
    level = {v: i for i, v in enumerate(PICK_LEVELS)}
    pick = np.array([level.get(v, 2) for v in ds["picklist"].values], float)
    sets = np.array([len(s) for s in ds["multipicklist"].values], float)
    phone = np.array([v is not None for v in ds["phone"].values], float)
    noise = np.random.default_rng(seed).normal(size=ds.num_rows)
    score = 0.5 * x - 0.8 * (pick - 2.0) + 0.9 * (sets - 1.5) \
        + 1.2 * (phone - 0.5) + noise
    return (score > 0).astype(np.float64).tolist()


def all_types_table(n: int = ROWS, seed: int = SEED, tk=None):
    """(``tk``'s Dataset) of ``n`` rows: the 22 predictors and ``label``."""
    if tk is None:
        from transmogrifai_tpu_torch import testkit as tk
    ds = tk.random_dataset(generators(tk), n, seed=seed)
    label = tk.column_from_values(tk.T.RealNN, label_values(ds, seed))
    return ds.with_column("label", label)


def defaults(pkg_defaults):
    """``pkg_defaults`` (a package's ``ops.defaults.DEFAULTS``) with the fixed
    reference date."""
    return dataclasses.replace(pkg_defaults, ReferenceDateMs=REFERENCE_DATE_MS)


#: the all-types flow's tree candidates in the CPU tests and in the CPU
#: comparison on the card: the default tree families at small grids whose
#: XGBoost points (20 rounds of depth 3) and RF points (8 trees of depth 3)
#: sum above the host-predict cutoff in the reduced orders of ROADMAP C4
RF_GRID = {"max_depth": [3], "min_info_gain": [0.001],
           "min_instances_per_node": [10], "num_trees": [8]}
XGB_GRID = {"num_round": [20], "eta": [0.3], "gamma": [0.0], "max_depth": [3],
            "min_child_weight": [1.0, 10.0]}
#: rows of the CPU tests' flow, and of the fresh rows they score
FLOW_ROWS, FLOW_SEED = 500, 12
FRESH_ROWS, FRESH_SEED = 300, 13


def feature_side(pkg: str, ds, device=None):
    """The all-types flow's feature side alone, as ``train()`` fits it on
    its training rows: ``from_dataset`` -> ``transmogrify`` (the fixed
    reference date) -> ``sanity_check(remove_bad_features=True)`` ->
    ``fit_and_transform_dag``, with the uid counter reset first (so its
    names are the flow's). Returns (transformed data, vector feature,
    checked feature, the SanityChecker's summary)."""
    if pkg == "jax":
        import transmogrifai_tpu.dsl  # noqa: F401  (installs sanity_check)
        from transmogrifai_tpu.features import from_dataset
        from transmogrifai_tpu.ops import transmogrify
        from transmogrifai_tpu.ops.defaults import DEFAULTS
        from transmogrifai_tpu.utils import uid
        from transmogrifai_tpu.workflow.fit import fit_and_transform_dag
        dev = {}
    else:
        import transmogrifai_tpu_torch.dsl  # noqa: F401
        from transmogrifai_tpu_torch.features import from_dataset
        from transmogrifai_tpu_torch.ops.defaults import DEFAULTS
        from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
        from transmogrifai_tpu_torch.utils import uid
        from transmogrifai_tpu_torch.workflow.fit import fit_and_transform_dag
        dev = {"device": device}
    uid.reset()
    label, preds = from_dataset(ds, response="label")
    vec = transmogrify(list(preds), defaults=defaults(DEFAULTS))
    checked = label.sanity_check(vec, remove_bad_features=True, **dev)
    data, fitted = fit_and_transform_dag(ds, [checked])
    summary = fitted[checked.origin_stage.uid].metadata["sanityCheckerSummary"]
    return data, vec, checked, summary


def train_flow(pkg: str, ds, grids: bool = True, device=None):
    """``build_flow``'s workflow trained: (model, prediction feature,
    checked vector feature, selector)."""
    wf, pred, checked, selector = build_flow(pkg, ds, grids, device)
    return wf.train(), pred, checked, selector


def build_flow(pkg: str, ds, grids: bool = True, device=None):
    """The all-types flow of ``pkg`` ("jax" or "port"): ``from_dataset`` ->
    ``transmogrify`` (the fixed reference date) ->
    ``sanity_check(remove_bad_features=True)`` ->
    ``BinaryClassificationModelSelector`` over the RF and XGBoost
    candidates (at ``RF_GRID`` / ``XGB_GRID``, or their default grids if
    not ``grids``) -> ``Workflow()`` on ``ds``, with the uid counter reset
    first; the JAX package's on one device. The port's estimators and
    statistics run on ``device``. Returns (workflow, prediction feature,
    checked vector feature, selector)."""
    if pkg == "jax":
        import transmogrifai_tpu.dsl  # noqa: F401  (installs sanity_check)
        from transmogrifai_tpu.features import from_dataset
        from transmogrifai_tpu.models import gbdt
        from transmogrifai_tpu.ops import transmogrify
        from transmogrifai_tpu.ops.defaults import DEFAULTS
        from transmogrifai_tpu.selector import BinaryClassificationModelSelector
        from transmogrifai_tpu.selector.model_selector import make_candidates
        from transmogrifai_tpu.utils import uid
        from transmogrifai_tpu.workflow.workflow import Workflow
        dev = {}
    else:
        import transmogrifai_tpu_torch.dsl  # noqa: F401
        from transmogrifai_tpu_torch.features import from_dataset
        from transmogrifai_tpu_torch.models import gbdt
        from transmogrifai_tpu_torch.ops.defaults import DEFAULTS
        from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
        from transmogrifai_tpu_torch.selector import (
            BinaryClassificationModelSelector,
        )
        from transmogrifai_tpu_torch.selector.model_selector import (
            make_candidates,
        )
        from transmogrifai_tpu_torch.utils import uid
        from transmogrifai_tpu_torch.workflow.workflow import Workflow
        dev = {"device": device}
    uid.reset()
    label, predictors = from_dataset(ds, response="label")
    vec = transmogrify(list(predictors), defaults=defaults(DEFAULTS))
    checked = label.sanity_check(vec, remove_bad_features=True, **dev)
    if grids:
        models = [(gbdt.RandomForestClassifier(**dev), RF_GRID),
                  (gbdt.XGBoostClassifier(**dev), XGB_GRID)]
    else:
        models = make_candidates(
            "BinaryClassification",
            ("OpRandomForestClassifier", "OpXGBoostClassifier"), **dev)
    selector = BinaryClassificationModelSelector(models=models)
    pred = selector.set_input(label, checked).get_output()
    wf = Workflow().set_result_features(pred).set_input_dataset(ds)
    if pkg == "jax":
        wf = wf.set_parallelism(None)
    return wf, pred, checked, selector
