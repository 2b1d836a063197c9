"""The multiclass flow (the reference's OpIris: a text label indexed with
``string_indexed``, ``MultiClassificationModelSelector``, ``train()``) at
small sizes through either package, shared by the fixture generator
(``make_multiclass_fixtures.py``), ``tests/test_torch_multiclass.py`` and
``chip_smoke.py`` (numpy only at import: the JAX package is imported only
when ``pkg == "jax"``).

``multiclass_table(n, seed)`` is a seeded table of ``n`` rows (600 by
default):

* ``label``: PickList of four classes, cut from a linear score of ``r2``,
  ``r3``, ``i0``, ``p0``'s level, ``b0`` and ``normal(0, 1)`` noise at its
  0.3, 0.55 and 0.8 quantiles, named ``CLASSES`` (lowest first): 180 /
  150 / 150 / 120 rows at 600, so the indexer breaks a frequency tie by
  the labels' order (``blue`` before ``crimson``);
* ``r0`` .. ``r5``: Real; ``r0`` and ``r1`` are about 15% empty;
* ``i0`` (0-9): Integral; ``b0``: Binary, about 5% empty;
* ``p0`` (6 levels) and ``p1`` (4 levels, about 5% empty): PickList;
* ``t0``: Text, ``"north"`` / ``"south"`` / ``"east"``.

``transmogrify`` makes 35 vector columns of it; the SanityChecker keeps 25.

Tolerances, measured on the CPU against the JAX package before they were
stated (the multinomial lanes are not bit-identical: torch's softmax and
its batched products block differently from XLA's):

* ``MULTINOMIAL_PROB_TOL`` = 1e-5: a multinomial lane's probabilities
  (measured: at most 1.98e-6 over ``test_torch_multiclass.py``'s fits and
  1.34e-6 over its sweep lanes, 2.1e-7 in ``test_torch_glm.py``, 1.0e-6
  on the ``multiclass`` flow's holdout; 4.6e-6 on another seeded table);
* ``LR_METRIC_TOL`` = 2e-4: a logistic candidate's CV weighted F1
  (measured: 0.0 for every logistic candidate of the ``multiclass`` flow,
  whose two best candidates lie 4.73e-3 apart in the JAX package's
  results; one validation row flipping moves an F1 by about 1/200 here).
"""
from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_multiclass")

TABLE_ROWS = 600
TABLE_SEED = 15
#: class names, lowest score first
CLASSES = ("dune", "blue", "crimson", "amber")

MULTINOMIAL_PROB_TOL = 1e-5
LR_METRIC_TOL = 2e-4

#: the flow's candidates' grids (small: the JAX side runs on the CPU)
GRIDS = {
    "lr": {"fit_intercept": [True], "elastic_net_param": [0.1, 0.5],
           "max_iter": [20], "reg_param": [0.01, 0.1]},
    "rf": {"max_depth": [3, 5], "min_info_gain": [0.001, 0.01],
           "min_instances_per_node": [10], "num_trees": [5]},
    "xgb": {"num_round": [6], "eta": [0.3], "max_depth": [3],
            "min_child_weight": [1.0]},
    "gbt": {"max_depth": [3], "min_info_gain": [0.001],
            "min_instances_per_node": [10], "max_iter": [4]},
    "dt": {"max_depth": [3, 5], "min_info_gain": [0.001],
           "min_instances_per_node": [10]},
}
#: the flows: name -> candidate families (the default selector's LR + RF,
#: and every ported family; ``trees`` has a tree winner)
FLOWS = {
    "multiclass": ("lr", "rf", "xgb", "gbt", "dt"),
    "multiclass_trees": ("rf", "xgb", "gbt", "dt"),
}
CLASS_NAMES = {"lr": "LogisticRegression", "rf": "RandomForestClassifier",
               "xgb": "XGBoostClassifier", "gbt": "GBTClassifier",
               "dt": "DecisionTreeClassifier"}
#: the estimators fitted directly on the flow's vector for ``fits.npz``:
#: name -> (family, params); trees EQUAL between the packages
DIRECT_FITS = {
    "xgb_multi": ("xgb", dict(num_round=8, max_depth=4)),
    "gbt_multi": ("gbt", dict(max_iter=5, max_depth=4)),
    "dt_multi": ("dt", dict(max_depth=5)),
}
#: the random forest's multiclass sweep for ``fits.npz``: 2 masks x 2
#: points x 4 classes = 16 lanes
RF_SWEEP_POINTS = [
    dict(max_depth=4, min_info_gain=0.001, min_instances_per_node=10, num_trees=3),
    dict(max_depth=4, min_info_gain=0.01, min_instances_per_node=5, num_trees=3),
]
#: rows of the fused-scoring batch (the JAX program fits at 256 and up)
FUSED_ROWS = 256


def multiclass_table(n: int = TABLE_ROWS, seed: int = TABLE_SEED):
    """(schema, columns) of the seeded table (see the module docstring)."""
    rng = np.random.default_rng(seed)
    schema: dict[str, str] = {}
    columns: dict[str, list] = {}
    reals = []
    for j in range(6):
        v = rng.normal(2.0 * j, 1.0 + 0.5 * j, n)
        reals.append(v)
        vals = v.tolist()
        if j < 2:
            empty = rng.random(n) < 0.15
            vals = [None if e else x for x, e in zip(vals, empty)]
        schema[f"r{j}"], columns[f"r{j}"] = "Real", vals
    i0 = rng.integers(0, 10, n)
    schema["i0"], columns["i0"] = "Integral", i0.tolist()
    b0 = rng.random(n) < 0.4
    empty = rng.random(n) < 0.05
    schema["b0"], columns["b0"] = "Binary", [
        None if e else bool(b) for b, e in zip(b0.tolist(), empty.tolist())]
    p0 = rng.integers(0, 6, n)
    schema["p0"], columns["p0"] = "PickList", [f"a{v}" for v in p0.tolist()]
    p1 = rng.integers(0, 4, n)
    empty = rng.random(n) < 0.05
    schema["p1"], columns["p1"] = "PickList", [
        None if e else f"b{v}" for v, e in zip(p1.tolist(), empty.tolist())]
    schema["t0"], columns["t0"] = "Text", [
        ("north", "south", "east")[v] for v in rng.integers(0, 3, n).tolist()]
    score = (0.8 * (reals[2] - reals[2].mean()) / reals[2].std()
             - 0.6 * (reals[3] - reals[3].mean()) / reals[3].std()
             + 0.3 * (i0 - 4.5) + 0.7 * (p0 < 2) + 0.5 * b0
             + rng.normal(0.0, 1.0, n))
    edges = np.quantile(score, [0.3, 0.55, 0.8])
    cls = np.searchsorted(edges, score, side="right")
    schema["label"], columns["label"] = "PickList", [
        CLASSES[int(c)] for c in cls.tolist()]
    return schema, columns


def _selector_flows():
    sys.path.insert(0, HERE)
    import selector_flows

    return selector_flows


def dataset(pkg: str, schema: dict, columns: dict):
    """The table as ``pkg``'s ("jax" or "port") Dataset."""
    if pkg == "jax":
        from transmogrifai_tpu import types as T
        from transmogrifai_tpu.dataset import Dataset
        from transmogrifai_tpu.types.columns import column_from_values
    else:
        from transmogrifai_tpu_torch import types as T
        from transmogrifai_tpu_torch.dataset import Dataset
        from transmogrifai_tpu_torch.types.columns import column_from_values
    return Dataset.of({
        k: column_from_values(T.feature_type_by_name(schema[k]), v)
        for k, v in columns.items()
    })


def modules(pkg: str) -> dict:
    """The package's modules the flow needs, by short name."""
    m = _selector_flows().modules(pkg)
    if pkg == "jax":
        from transmogrifai_tpu import types as T
        from transmogrifai_tpu.ops import text_stages
    else:
        from transmogrifai_tpu_torch import types as T
        from transmogrifai_tpu_torch.ops import text_stages
    return {**m, "types": T, "text_stages": text_stages}


def dev(pkg: str, device="cpu") -> dict:
    """Constructor kwargs that put the port's estimators on ``device``."""
    return {} if pkg == "jax" else {"device": device}


def estimator(pkg: str, family: str, device="cpu", **params):
    m = modules(pkg)
    cls = getattr(m["logistic"] if family == "lr" else m["gbdt"],
                  CLASS_NAMES[family])
    return cls(**params, **dev(pkg, device))


def candidates(pkg: str, families, device="cpu"):
    return [(estimator(pkg, f, device), GRIDS[f]) for f in families]


def feature_side(pkg: str, ds, device="cpu"):
    """(indexed label, checked vector, raw text label) of the flow:
    ``from_dataset`` with a PickList response, ``string_indexed``,
    ``transmogrify``, ``sanity_check(remove_bad_features=True)``."""
    m = modules(pkg)
    label_text, predictors = m["from_dataset"](
        ds, response="label", response_type=m["types"].PickList)
    label = label_text.string_indexed()
    vec = m["transmogrify"](list(predictors))
    checked = label.sanity_check(vec, remove_bad_features=True,
                                 **dev(pkg, device))
    return label, checked, label_text


def build(pkg: str, ds, families=None, device="cpu"):
    """(workflow, prediction feature, selector, indexed label) of the flow,
    the uid counter reset first; ``families`` None is the default
    selector's candidates (LR + RF at the default grids)."""
    m = modules(pkg)
    m["uid"].reset()
    label, checked, _ = feature_side(pkg, ds, device)
    models = None if families is None else candidates(pkg, families, device)
    kw = {} if pkg == "jax" else {"device": device}
    selector = m["model_selector"].MultiClassificationModelSelector(
        models=models, **kw)
    pred = selector.set_input(label, checked).get_output()
    wf = m["workflow"].Workflow().set_result_features(pred).set_input_dataset(ds)
    if pkg == "jax":
        wf = wf.set_parallelism(None)
    return wf, pred, selector, label


def train(pkg: str, ds, families=None, device="cpu"):
    """(model, prediction feature, selector, indexed label) of the flow."""
    wf, pred, selector, label = build(pkg, ds, families, device)
    return wf.train(), pred, selector, label


def sweep_masks(n: int) -> list[np.ndarray]:
    """The two row masks of ``RF_SWEEP_POINTS``' sweep."""
    return [(np.arange(n) % 3 != i).astype(np.float32) for i in range(2)]


def without_unported(summary: dict) -> dict:
    return _selector_flows().without_unported(summary)
