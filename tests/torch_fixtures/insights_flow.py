"""The insights plane's scenarios (``insights/{loco,correlation,
model_insights,drift}.py`` and ``explain=k`` through the scoring closure,
staged and fused, and through ``ScoringService``), run the same way
through either package: the port's tests (``tests/test_torch_insights.py``,
``tests/test_torch_explain.py``) run each through the JAX package and the
port and compare, the fixture generator (``make_insights_fixtures.py``)
stores the JAX package's attributions of the serving fixtures at the
card's shapes, and ``chip_smoke.py``'s ``insights`` phase holds the card's
to them.

``package(name, device)`` extends ``serving_plane.package`` with the
insights modules, the workflow and the model classes. This module imports
no package at import time, so ``chip_smoke.py`` loads it without JAX.

Models. The tree and logistic models are the serving fixtures ``xgb``,
``rf`` and ``lr`` (``tests/fixtures/torch_serving/``, 10 column groups,
16 lanes). ``mixed`` is the reference suite's ``trained`` flow
(``tests/test_insights_batched.py``: x1, x2 and a ``city`` pick list, 128
rows of seed 17, one ``LogisticRegression`` candidate, 2 folds), trained
by the JAX package and saved (``train_mixed``), so both packages explain
the same coefficients.

Tolerances: tree attributions EQUAL; logistic ones within ``GLM_ATOL``
(the staged cores are float64 in both packages, the fused cores float32).
"""
from __future__ import annotations

import importlib
import json
import os

import numpy as np

from serving_plane import model_path, package as _plane_package  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_insights")
RESULTS = os.path.join(FIXTURE, "jax_results.json")

GLM_ATOL = 1e-6
TREES = ("xgb", "rf")

#: the card's shapes (``chip_smoke.py insights``, stored by the generator):
#: a staged sweep of ``CHIP_ROWS`` rows (bucket 1024: the 16 lanes score
#: 16384 rows) and a fused run of ``CHIP_FUSED_ROWS`` rows (bucket 128) with
#: the host-predict cutoff at ``CHIP_FUSED_CUTOFF``. The JAX package's
#: device route on the CPU materializes its one-hot leaf select: 16 x 2048
#: rows of ``rf``'s depth-12 forest would take over 50 GB, 16 x 512 rows of
#: the fused program 13 GB, so the card's lane rows above 16384 are held to
#: the port's CPU route instead (``chip_smoke.py insights (a) depth6``)
CHIP_ROWS = 600
CHIP_FUSED_ROWS = 100
CHIP_FUSED_CUTOFF = 64
CHIP_K = 3


def package(name: str, device: str = "cpu"):
    ns = _plane_package(name, device)
    if name == "jax":
        import transmogrifai_tpu.insights as insights
        from transmogrifai_tpu.insights import drift, loco
        from transmogrifai_tpu.models import linear, logistic
        from transmogrifai_tpu.ops.transmogrify import transmogrify
        from transmogrifai_tpu.selector import model_selector
        from transmogrifai_tpu.stages import metadata
        from transmogrifai_tpu.utils import uid
        from transmogrifai_tpu.workflow import workflow
    else:
        import transmogrifai_tpu_torch.insights as insights
        from transmogrifai_tpu_torch.insights import drift, loco
        from transmogrifai_tpu_torch.models import linear, logistic
        from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
        from transmogrifai_tpu_torch.selector import model_selector
        from transmogrifai_tpu_torch.stages import metadata
        from transmogrifai_tpu_torch.utils import uid
        from transmogrifai_tpu_torch.workflow import workflow
    ns.insights, ns.drift, ns.loco = insights, drift, loco
    # the package exports the function under the module's name
    ns.model_insights = importlib.import_module(
        f"{insights.__name__}.model_insights")
    ns.linear, ns.logistic = linear, logistic
    ns.transmogrify = transmogrify
    ns.model_selector, ns.metadata, ns.uid = model_selector, metadata, uid
    ns.workflow = workflow
    return ns


# ------------------------------------------------------------------ models
def mixed_ds(P, n: int = 128, seed: int = 17):
    """The reference suite's ``trained`` table, and its scoring rows."""
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n)
    x2 = rng.normal(size=n)
    city = [["a", "b", "c", "d"][i % 4] for i in range(n)]
    label = (x1 + 0.5 * x2 + 0.2 * rng.normal(size=n) > 0).astype(float)
    cfv = P.columns.column_from_values
    ds = P.Dataset.of({
        "label": cfv(P.T.RealNN, label),
        "x1": cfv(P.T.Real, x1),
        "x2": cfv(P.T.Real, x2),
        "city": cfv(P.T.PickList, city),
    })
    rows = [{"x1": float(a), "x2": float(b), "city": c}
            for a, b, c in zip(x1, x2, city)]
    return ds, rows


def train_mixed(P, **selector_kw):
    """The reference suite's ``trained`` flow in package ``P`` (the port's
    on its device): a fitted WorkflowModel."""
    P.uid.reset()
    ds, _ = mixed_ds(P)
    resp, preds = P.from_dataset(ds, response="label")
    vec = P.transmogrify(list(preds))
    kw = {} if P.name == "jax" else {"device": P.device}
    selector = P.model_selector.BinaryClassificationModelSelector(
        seed=7, models=[(P.logistic.LogisticRegression(**kw),
                         {"reg_param": [0.01]})],
        num_folds=2, **selector_kw)
    pred = selector.set_input(resp, vec).get_output()
    return P.workflow.Workflow().set_result_features(pred) \
        .set_input_dataset(ds).train()


def train_trees(P):
    """The ``mixed`` flow with one small ``XGBoostClassifier`` candidate
    (10 rounds of depth 3), so the attribution baseline inside ``train()``
    scores its lanes through K1 and the tree sums."""
    P.uid.reset()
    ds, _ = mixed_ds(P)
    resp, preds = P.from_dataset(ds, response="label")
    vec = P.transmogrify(list(preds))
    if P.name == "jax":
        from transmogrifai_tpu.models.gbdt import XGBoostClassifier
        est = XGBoostClassifier()
    else:
        from transmogrifai_tpu_torch.models.gbdt import XGBoostClassifier
        est = XGBoostClassifier(device=P.device)
    selector = P.model_selector.BinaryClassificationModelSelector(
        seed=7, models=[(est, {"num_round": [10], "max_depth": [3]})],
        num_folds=2)
    pred = selector.set_input(resp, vec).get_output()
    return P.workflow.Workflow().set_result_features(pred) \
        .set_input_dataset(ds).train()


def depth6_models(P, trees: int, n: int = 2500):
    """Seeded depth-6 boosted and forest stacks over 7 features and their
    ``n`` rows: with 7 groups the sweep's 8 lanes score ``8 n`` rows (20000
    at the default, not a power of two, above the host-predict cutoff), 2
    tree windows at 33-64 trees and 4 at 97-128."""
    rng = np.random.default_rng(trees)
    f, depth, bins = 7, 6, 32
    x = rng.normal(size=(n, f)).astype(np.float32)
    w = 1 << depth
    sf = rng.integers(-1, f, size=(trees, depth, w)).astype(np.int32)
    sb = rng.integers(0, bins - 1, size=(trees, depth, w)).astype(np.int32)
    lv = rng.normal(scale=0.1, size=(trees, w)).astype(np.float32)
    if P.name == "jax":
        from transmogrifai_tpu.models import gbdt as G, trees as TR
    else:
        from transmogrifai_tpu_torch.models import gbdt as G, trees as TR
    thr = TR.quantile_thresholds(x, max_bins=bins)
    out = [G.BoostedBinaryModel(thr, TR.Tree(sf, sb, lv), 0.02, 0.1),
           G.ForestClassifierModel(thr, [TR.Tree(sf, sb, lv)])]
    if P.name == "port":
        for m in out:
            m.to(P.device)
    return x, out


def regression_ds(P, n: int = 96, seed: int = 9):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n)
    x2 = rng.normal(size=n)
    target = 3.0 * x1 - 0.5 * x2 + 0.1 * rng.normal(size=n)
    cfv = P.columns.column_from_values
    ds = P.Dataset.of({
        "target": cfv(P.T.RealNN, target.tolist()),
        "x1": cfv(P.T.Real, x1),
        "x2": cfv(P.T.Real, x2),
    })
    rows = [{"x1": float(a), "x2": float(b)} for a, b in zip(x1, x2)]
    return ds, rows


def train_regression(P):
    """The reference suite's regression explain flow (one
    ``LinearRegression`` candidate, seed 5)."""
    P.uid.reset()
    ds, _ = regression_ds(P)
    resp, preds = P.from_dataset(ds, response="target")
    vec = P.transmogrify(list(preds))
    kw = {} if P.name == "jax" else {"device": P.device}
    sel = P.model_selector.RegressionModelSelector(
        seed=5, models=[(P.linear.LinearRegression(**kw),
                         {"reg_param": [0.01]})])
    pred = sel.set_input(resp, vec).get_output()
    return P.workflow.Workflow().set_result_features(pred) \
        .set_input_dataset(ds).train()


# ------------------------------------------------------------- explaining
def fixture_rows(name: str, n: int) -> list[dict]:
    """``n`` scoring rows of a serving fixture, its rows repeated."""
    with open(os.path.join(model_path(name), "rows.json")) as fh:
        rows = json.load(fh)
    return [dict(rows[i % len(rows)]) for i in range(n)]


def attributions(out) -> list:
    """The ``attributions`` of a ``.batch`` result (rows) or a
    ``.columns`` result (one list)."""
    if isinstance(out, dict):
        return list(out["attributions"])
    return [r.get("attributions") for r in out]


def same_attributions(got: list, want: list, atol: float = 0.0) -> None:
    """Row by row: the same groups in the same (ranked) order, each value
    EQUAL (``atol`` 0) or within ``atol``."""
    assert len(got) == len(want), (len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None or g is None:
            assert g is None and w is None, (i, g, w)
            continue
        assert list(g) == list(w), (i, g, w)
        for k in w:
            assert abs(g[k] - w[k]) <= atol, (i, k, g[k], w[k])


def to_json(attrs: list) -> list:
    return [None if a is None else [[k, float(v)] for k, v in a.items()]
            for a in attrs]


def from_json(rows: list) -> list:
    return [None if a is None else {k: v for k, v in a} for a in rows]


def explain_fixture(P, name: str, n: int, route: str, k: int = CHIP_K,
                    cutoff: int | None = None):
    """``.batch`` attributions of ``n`` rows of fixture ``name``:
    ``route="staged"`` with the fused graph opted out, ``"fused"`` with the
    host-predict cutoff at ``cutoff`` (default ``CHIP_FUSED_CUTOFF``), on a
    fresh closure. Returns (attributions, the closure)."""
    env = {"TPTPU_FUSED": "0"} if route == "staged" else {
        "TPTPU_HOST_PREDICT_MAX": str(
            CHIP_FUSED_CUTOFF if cutoff is None else cutoff)}
    old = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    try:
        fn = P.score(P.load(model_path(name)))
        out = fn.batch(fixture_rows(name, n), explain=k)
        if route == "fused":
            assert fn.metadata()["fused"]["dispatches"] == 1
        return attributions(out), fn
    finally:
        for key, v in old.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v


def load_results() -> dict:
    with open(RESULTS) as fh:
        return json.load(fh)
