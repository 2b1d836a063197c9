"""The scoring closure's hardening scenarios, run the same way through
either package: the port's tests (``tests/test_torch_serving_sentinel.py``,
``tests/test_torch_resilience.py``) run each one through the JAX package
and the port on the same seeded data and compare the results, the fixture
generator (``make_hardening_fixtures.py``) stores the JAX package's results
under ``tests/fixtures/torch_hardening/``, and ``chip_smoke.py`` runs the
card's scenarios through the port alone and holds them to that file.

``package(name, device)`` gathers one package's entry points into a
namespace (``"jax"`` or ``"port"``; the port's on ``device``). This module
imports no package at import time, so ``chip_smoke.py`` loads it without
JAX. Every scenario returns plain JSON values: ``scores`` (each row's
results, Prediction maps as lists in key order) and the closure's counters.

The models: ``twin`` is the reference suite's logistic model (a
``BinaryClassificationModelSelector`` over ``x1``, ``x2`` of ``binary_ds(160,
3)``, ``reg_param=0.01``, 2 folds), ``graph`` the resilience suite's
(transmogrify -> SanityChecker -> the selector over ``binary_ds(120, 15)``,
selector seed 17) and ``shifted`` the all-null-response suite's (its
prediction and ``label - 1.0`` over ``binary_ds(160, 23)``), each trained
and saved by the JAX package under ``tests/fixtures/torch_hardening/``; the
tree models are the serving fixtures ``xgb`` and ``rf``
(``tests/fixtures/torch_serving/``, 5 profiled features).
"""
from __future__ import annotations

import json
import math
import os
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
HARDENING = os.path.join(ROOT, "tests", "fixtures", "torch_hardening")
SERVING = os.path.join(ROOT, "tests", "fixtures", "torch_serving")
RESULTS = os.path.join(HARDENING, "jax_results.json")

#: the card's scenarios: the staged and fused tiles of ``fused_serving``
STAGED_ROWS = 8192
FUSED_ROWS = 65536
#: (b): the rows of an 8192-row batch whose ``age`` is malformed
MALFORMED_ROWS = (3, 100, 4097, 8000)
#: (d): the drifted feature and its offset
DRIFT_FEATURE = "age"
DRIFT_OFFSET = 60.0
#: (c): the breaker's threshold and cooldown on the fake clock
BREAKER_THRESHOLD = 2
BREAKER_COOLDOWN = 10.0
#: (c) in the fixture generator: a batch above a lowered cutoff fuses in
#: both packages at this size
SMALL_FUSED_ROWS = 512
SMALL_CUTOFF = 256


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def package(name: str, device: str = "cpu"):
    """One package's entry points: ``load(path)``, ``score(model, **kw)``,
    the fault plan and sentinel classes, ``Dataset``, ``columns``, ``T``
    and ``testkit``."""
    ns = types.SimpleNamespace(name=name)
    if name == "jax":
        import transmogrifai_tpu.types as T
        from transmogrifai_tpu import testkit
        from transmogrifai_tpu.dataset import Dataset
        from transmogrifai_tpu.local import scoring
        from transmogrifai_tpu.resilience import faults, guards
        from transmogrifai_tpu.resilience import sentinel
        from transmogrifai_tpu.types import columns
        from transmogrifai_tpu.workflow.persistence import load_workflow_model

        ns.load = load_workflow_model
        ns.score = scoring.score_function
    else:
        import transmogrifai_tpu_torch.types as T
        from transmogrifai_tpu_torch import testkit
        from transmogrifai_tpu_torch.dataset import Dataset
        from transmogrifai_tpu_torch.local import scoring
        from transmogrifai_tpu_torch.resilience import faults, guards
        from transmogrifai_tpu_torch.resilience import sentinel
        from transmogrifai_tpu_torch.types import columns
        from transmogrifai_tpu_torch.workflow.persistence import (
            load_workflow_model,
        )

        ns.load = lambda path: load_workflow_model(path, device=device)
        ns.score = lambda model, **kw: scoring.score_function(
            model, device=device, **kw)
    ns.T, ns.testkit, ns.Dataset, ns.columns = T, testkit, Dataset, columns
    ns.faults, ns.sentinel = faults, sentinel
    ns.FaultPlan, ns.installed = faults.FaultPlan, faults.installed
    ns.BreakerConfig, ns.DriftConfig = sentinel.BreakerConfig, sentinel.DriftConfig
    ns.ScoreGuard = guards.ScoreGuard
    return ns


# --------------------------------------------------------------- the data
def binary_ds(P, n: int = 160, seed: int = 0):
    """The reference suites' two-feature binary table."""
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n)
    x2 = rng.normal(size=n)
    label = (x1 + 0.5 * x2 + 0.3 * rng.normal(size=n) > 0).astype(float)
    cfv = P.columns.column_from_values
    return P.Dataset.of({
        "label": cfv(P.T.RealNN, label),
        "x1": cfv(P.T.Real, x1),
        "x2": cfv(P.T.Real, x2),
    })


def model_path(name: str) -> str:
    if name in ("xgb", "rf", "lr"):
        return os.path.join(SERVING, name)
    return os.path.join(HARDENING, name)


def fixture_rows(name: str) -> list[dict]:
    with open(os.path.join(SERVING, name, "rows.json")) as fh:
        return json.load(fh)


def tiled(rows: list[dict], n: int) -> list[dict]:
    return (rows * -(-n // len(rows)))[:n]


def rows_of(P, name: str, n: int) -> list[dict]:
    """Scoring rows: the serving fixture's, or the twin tables' rows."""
    if name in ("xgb", "rf", "lr"):
        return tiled(fixture_rows(name), n)
    seed = {"twin": 3, "graph": 15, "shifted": 23}[name]
    size = 120 if name == "graph" else 160
    return binary_ds(P, size, seed).rows()[:n]


def pred_name(model) -> str:
    """The prediction result's name (the selector's output)."""
    return model.selector_info["predName"]


def features(model) -> list[str]:
    return [f.name for f in model.raw_features if not f.is_response]


# ------------------------------------------------------- normalization
def plain(v):
    """A JSON-able form of a result value (Prediction maps as lists in key
    order, NaN as the string ``"nan"``)."""
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    if isinstance(v, (np.floating, float)):
        return "nan" if math.isnan(v) else float(v)
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, np.ndarray):
        return plain(v.tolist())
    return v


def records(fn) -> list:
    return [[r.index, r.feature, r.kind, r.reason] for r in fn.quarantine.last]


def counters(fn, drift: bool = True) -> dict:
    """The closure's counters under the reference's ``metadata()`` keys."""
    md = fn.metadata()
    keys = ["scoreGuard", "sentinel", "quarantine", "breakers"]
    if drift:
        keys.append("drift")
    return plain({k: md[k] for k in keys})


def column_values(col) -> list:
    """A result column's rows (``.columns``' output) as plain values."""
    return plain(col.to_list())


def same(got, want, atol: float = 0.0, path: str = "") -> None:
    """``got`` EQUAL ``want``, floats within ``atol`` (plus ``atol`` of
    their size) where ``atol`` is given; raises AssertionError naming the
    first difference."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise AssertionError(f"{path}: keys {got!r} != {want!r}")
        for k in want:
            same(got[k], want[k], atol, f"{path}.{k}")
        return
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise AssertionError(f"{path}: {got!r} != {want!r}")
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, atol, f"{path}[{i}]")
        return
    if (atol and isinstance(want, float) and isinstance(got, float)
            and not isinstance(want, bool)):
        if abs(got - want) > atol + atol * abs(want):
            raise AssertionError(f"{path}: {got!r} != {want!r} (atol {atol})")
        return
    if got != want:
        raise AssertionError(f"{path}: {got!r} != {want!r}")


def same_result(got: dict, want: dict, atol: float) -> None:
    """Scores within ``atol`` (0 for trees), everything else EQUAL."""
    same({k: v for k, v in got.items() if k != "scores"},
         {k: v for k, v in want.items() if k != "scores"}, 0.0, "result")
    if "scores" in want:
        same(got["scores"], want["scores"], atol, "scores")


# ----------------------------------------------------- CPU scenarios
def _vec_stage(model, pred: str):
    """A fitted stage upstream of the prediction (the reference suites'
    ``vec_stage``): the first in ``model.fitted`` order."""
    return next(t for t in model.fitted.values() if t.output_name != pred)


def _malformed_value():
    """The reference's uncoercible value for a Real feature is
    ``object()``, whose repr (and so its quarantine reason) differs from
    run to run; a list takes the same path (wrong_type, uncoercible,
    escalated to the unparseable action) with a stable repr."""
    return [1, 2]


def scenario_k_malformed(P, name):
    model = P.load(model_path(name))
    pred = pred_name(model)
    f0, f1 = features(model)[:2]
    rows = rows_of(P, name, 10)
    fn = P.score(model)
    plan = (P.FaultPlan().malform_row(f0, rows=(2,), value="##bad##")
            .malform_row(f1, rows=(7,), value=_malformed_value()))
    with P.installed(plan):
        out = fn.batch(rows)
    recs = records(fn)
    clean = fn.batch(rows)
    return {"scores": plain(out), "clean": plain(clean), "records": recs,
            "counters": counters(fn), "fired": plain(plan.fired),
            "pred": pred}


def scenario_unparseable(P, name):
    model = P.load(model_path(name))
    f0 = features(model)[0]
    rows = rows_of(P, name, 4)
    bad = dict(rows[1])
    bad[f0] = "not-a-number"
    fn = P.score(model)
    out = fn.batch([rows[0], bad, rows[2], rows[3]])
    return {"scores": plain(out), "records": records(fn),
            "counters": counters(fn)}


def scenario_stage_poison(P, name, poisoned=(3,), n=6):
    model = P.load(model_path(name))
    pred = pred_name(model)
    rows = rows_of(P, name, n)
    fn = P.score(model)
    clean = fn.batch(rows)
    plan = P.FaultPlan().fail_stage_transform(pred, rows=poisoned, times=None)
    with P.installed(plan):
        out = fn.batch(rows)
    return {"scores": plain(out), "clean": plain(clean),
            "records": records(fn), "counters": counters(fn),
            "fired": plain(plan.fired)}


def scenario_multi_violation(P, name):
    model = P.load(model_path(name))
    f0, f1 = features(model)[:2]
    rows = rows_of(P, name, 4)
    bad = dict(rows[1])
    bad[f0] = "zzz"
    bad[f1] = "www"
    fn = P.score(model)
    out = fn.batch([rows[0], bad, rows[2], rows[3]])
    return {"scores": plain(out), "records": records(fn),
            "counters": counters(fn)}


def scenario_never_reach_plan(P, name):
    model = P.load(model_path(name))
    pred = pred_name(model)
    f0 = features(model)[0]
    rows = rows_of(P, name, 6)
    fn = P.score(model)
    plan = (P.FaultPlan().malform_row(f0, rows=(2,), value="##bad##")
            .fail_stage_transform(pred, rows=(2,), times=None))
    with P.installed(plan):
        out = fn.batch(rows)
    return {"scores": plain(out), "records": records(fn),
            "fired": plain(plan.fired), "counters": counters(fn)}


def scenario_budget(P, name):
    model = P.load(model_path(name))
    pred = pred_name(model)
    rows = rows_of(P, name, 64)
    fn = P.score(model)
    plan = P.FaultPlan().fail_stage_transform(pred, times=None)
    with P.installed(plan):
        out = fn.batch(rows)
    return {"scores": plain(out), "records": records(fn),
            "executions": plan._transform_faults[0]["count"],
            "counters": counters(fn)}


def scenario_open_breaker_plus_failure(P, name):
    model = P.load(model_path(name))
    pred = pred_name(model)
    rows = rows_of(P, name, 6)
    clk = FakeClock()
    fn = P.score(model, breaker=P.BreakerConfig(
        failure_threshold=1, recovery_time=1000.0, clock=clk))
    with P.installed(P.FaultPlan().fail_stage_transform(pred, times=1)):
        fn(rows[0])
    vec = _vec_stage(model, pred)
    plan = P.FaultPlan().fail_stage_transform(
        vec.output_name, rows=(2,), times=None)
    with P.installed(plan):
        out = fn.batch(rows)
    return {"scores": plain(out), "records": records(fn),
            "counters": counters(fn)}


def scenario_columns_poison(P, name):
    model = P.load(model_path(name))
    pred = pred_name(model)
    rows = rows_of(P, name, 6)
    ds = _dataset_of(P, model, rows)
    clean = P.score(model).columns(ds)[pred]
    fn2 = P.score(model)
    plan = P.FaultPlan().fail_stage_transform(pred, rows=(2,), times=None)
    with P.installed(plan):
        out = fn2.columns(ds)[pred]
    return {"scores": column_values(out), "clean": column_values(clean),
            "records": records(fn2), "counters": counters(fn2)}


def _dataset_of(P, model, rows):
    cfv = P.columns.column_from_values
    return P.Dataset.of({
        f.name: cfv(f.ftype, [r.get(f.name) for r in rows])
        for f in model.raw_features if not f.is_response
    })


def scenario_parity(P, name, kind):
    """score_one against a one-row batch, clean, malformed or under a NaN
    fault."""
    model = P.load(model_path(name))
    pred = pred_name(model)
    f0 = features(model)[0]
    row = rows_of(P, name, 6)[5 if kind == "clean" else 0]

    def plan():
        if kind == "malformed":
            return P.FaultPlan().malform_row(f0, rows=(0,), value="##bad##")
        return P.FaultPlan().nan_output(pred, rows=(0,))

    fn_one, fn_batch = P.score(model), P.score(model)
    if kind == "clean":
        one, batch = fn_one(row), fn_one.batch([row])[0]
    else:
        with P.installed(plan()):
            one = fn_one(row)
        with P.installed(plan()):
            batch = fn_batch.batch([row])[0]
    return {"scores": plain([one, batch]), "records": records(fn_one),
            "batch_records": records(fn_batch),
            "guard": plain(dict(fn_one.guard.counts)),
            "batch_guard": plain(dict(fn_batch.guard.counts))}


def scenario_breaker_recovers(P, name):
    model = P.load(model_path(name))
    pred = pred_name(model)
    rows = rows_of(P, name, 6)
    clk = FakeClock()
    fn = P.score(model, breaker=P.BreakerConfig(
        failure_threshold=3, recovery_time=10.0, clock=clk))
    outs, stats = [], []
    plan = P.FaultPlan().fail_stage_transform(pred, times=3)
    with P.installed(plan):
        for i in range(3):
            outs.append(fn(rows[i]))
        stats.append(fn.breakers[pred].stats())
        outs.append(fn(rows[3]))
        stats.append(fn.breakers[pred].stats())
        clk.now = 5.0
        outs.append(fn(rows[4]))
        stats.append(fn.breakers[pred].stats())
        clk.now = 11.0
        outs.append(fn(rows[5]))
        stats.append(fn.breakers[pred].stats())
    return {"scores": plain(outs), "stats": plain(stats),
            "fired": plain(plan.fired), "counters": counters(fn)}


def scenario_failed_probe(P, name):
    model = P.load(model_path(name))
    pred = pred_name(model)
    rows = rows_of(P, name, 4)
    clk = FakeClock()
    fn = P.score(model, breaker=P.BreakerConfig(
        failure_threshold=2, recovery_time=10.0, clock=clk))
    outs, stats = [], []
    with P.installed(P.FaultPlan().fail_stage_transform(pred, times=3)):
        outs.append(fn(rows[0]))
        outs.append(fn(rows[1]))
        stats.append(fn.breakers[pred].stats())
        clk.now = 11.0
        outs.append(fn(rows[2]))
        stats.append(fn.breakers[pred].stats())
        clk.now = 22.0
        outs.append(fn(rows[3]))
        stats.append(fn.breakers[pred].stats())
    return {"scores": plain(outs), "stats": plain(stats),
            "counters": counters(fn)}


def scenario_short_circuit(P, name):
    model = P.load(model_path(name))
    pred = pred_name(model)
    rows = rows_of(P, name, 4)
    clk = FakeClock()
    fn = P.score(model, breaker=P.BreakerConfig(
        failure_threshold=1, recovery_time=100.0, clock=clk))
    with P.installed(P.FaultPlan().fail_stage_transform(pred, times=1)):
        fn(rows[0])
    out = fn.batch(rows)
    return {"scores": plain(out), "counters": counters(fn)}


def scenario_deadline_overruns(P, name):
    model = P.load(model_path(name))
    rows = rows_of(P, name, 1)

    class TickClock:
        """Each clock() call advances 1 s: every stage 'takes' 1 s."""

        def __init__(self):
            self.now = 0.0

        def __call__(self):
            self.now += 1.0
            return self.now

    fn = P.score(model, breaker=P.BreakerConfig(
        failure_threshold=100, recovery_time=1.0, deadline=0.5,
        clock=TickClock()))
    out = fn(rows[0])
    return {"scores": plain(out), "counters": counters(fn)}


def scenario_breaker_disabled(P, name):
    model = P.load(model_path(name))
    fn = P.score(model, breaker=False)
    out = fn(rows_of(P, name, 1)[0])
    return {"scores": plain(out), "breakers": len(fn.breakers),
            "counters": counters(fn)}


def scenario_drift(P, name, kind):
    """The drift sentinel over single-row calls (the reference suite's
    streams): ``quiet``, ``shifted``, ``fill`` (a feature vanished),
    ``window`` (a shift that ages out), ``torn`` (a torn profile)."""
    model = P.load(model_path(name))
    f0, f1 = features(model)[:2]
    rows = rows_of(P, name, 160)
    cfg = {
        "quiet": dict(min_rows=30, js_threshold=0.35),
        "shifted": dict(min_rows=30, js_threshold=0.35),
        "fill": dict(min_rows=30, fill_ratio_threshold=5.0),
        "window": dict(window=40, chunks=4, min_rows=20, js_threshold=0.35),
    }.get(kind)
    reports = []
    if kind == "torn":
        plan = P.FaultPlan().tear_profile(f0)
        with P.installed(plan):
            fn = P.score(model)
            out = [fn(rows[0])]
        return {"scores": plain(out), "report": plain(fn.metadata()["drift"]),
                "fired": plain(plan.fired)}
    fn = P.score(model, drift=P.DriftConfig(**cfg))
    out = []
    plan = None
    if kind == "quiet":
        out = [fn(r) for r in rows[:80]]
    elif kind == "shifted":
        plan = P.FaultPlan().shift_feature(f0, offset=25.0)
        with P.installed(plan):
            out = [fn(r) for r in rows[:80]]
    elif kind == "fill":
        for r in rows[:60]:
            r = dict(r)
            r.pop(f1, None)
            out.append(fn(r))
    elif kind == "window":
        plan = P.FaultPlan().shift_feature(f0, offset=25.0, times=40)
        with P.installed(plan):
            out = [fn(r) for r in rows[:40]]
        reports.append(plain(fn.metadata()["drift"]))
        out += [fn(r) for r in rows[40:120]]
    reports.append(plain(fn.metadata()["drift"]))
    reports.append(plain(fn.metadata()["drift"]))  # alerts count transitions
    return {"scores": plain(out), "reports": reports,
            "fired": None if plan is None else plain(plan.fired)}


def scenario_drift_columns(P, name, kind):
    """The drift sentinel through ``.columns``: the training table
    (``train``) or a testkit-drifted stream (``drifted``)."""
    model = P.load(model_path(name))
    pred = pred_name(model)
    fn = P.score(model, drift=P.DriftConfig(min_rows=30, js_threshold=0.35))
    if kind == "train":
        seed = {"twin": 3}[name]
        ds = binary_ds(P, 160, seed).drop(["label"])
    else:
        tk = P.testkit
        base = tk.RandomReal.normal(0.0, 1.0, seed=9)
        shifted = tk.drifted(base, offset=30.0)
        ds = P.Dataset.of({
            "x1": shifted.to_column(80),
            "x2": tk.RandomReal.normal(0.0, 1.0, seed=10).to_column(80),
        })
    out = fn.columns(ds)[pred]
    return {"scores": column_values(out),
            "report": plain(fn.metadata()["drift"])}


def scenario_isolation_guard(P, name):
    model = P.load(model_path(name))
    pred = pred_name(model)
    rows = rows_of(P, name, 8)
    fn = P.score(model)
    vec = _vec_stage(model, pred)
    plan = (P.FaultPlan().nan_output(pred, rows=(1,), times=10)
            .fail_stage_transform(vec.output_name, rows=(5,), times=None))
    with P.installed(plan):
        out = fn.batch(rows)
    return {"scores": plain(out), "records": records(fn),
            "counters": counters(fn)}


def scenario_counters(P, name):
    model = P.load(model_path(name))
    pred = pred_name(model)
    f0 = features(model)[0]
    rows = rows_of(P, name, 12)
    fn = P.score(model)
    plan = (P.FaultPlan().malform_row(f0, rows=(1, 4, 9), value="##bad##")
            .nan_output(pred, rows=(0,)))
    with P.installed(plan):
        out = fn.batch(rows)
    return {"scores": plain(out), "counters": counters(fn),
            "fired": plain(plan.fired)}


def scenario_summary(P, name):
    model = P.load(model_path(name))
    f0 = features(model)[0]
    rows = rows_of(P, name, 2)
    fn = P.score(model)
    bad = dict(rows[0])
    bad[f0] = "not-a-number"
    fn.batch([bad, rows[1]])
    line = next(ln for ln in model.summary_pretty().splitlines()
                if ln.startswith("Serving resilience:"))
    return {"line": line}


def scenario_true_flags(P, name):
    model = P.load(model_path(name))
    fn = P.score(model, sentinel=True, breaker=True, drift=True)
    out = fn(rows_of(P, name, 1)[0])
    return {"scores": plain(out), "counters": counters(fn)}


def scenario_nan_guard(P, name, mode, n=4, nan_rows=(0,)):
    """A NaN prediction under ``ScoreGuard(fallback=mode)`` (``None``: the
    default guard)."""
    model = P.load(model_path(name))
    pred = pred_name(model)
    rows = rows_of(P, name, n)
    kw = {} if mode is None else {"guard": P.ScoreGuard(fallback=mode)}
    fn = P.score(model, **kw)
    plan = P.FaultPlan().nan_output(pred, rows=nan_rows)
    with P.installed(plan):
        try:
            out = fn.batch(rows)
        except Exception as e:
            return {"raised": type(e).__name__, "message": str(e),
                    "fired": plain(plan.fired)}
    return {"scores": plain(out), "fired": plain(plan.fired),
            "counters": counters(fn)}


def scenario_null_label(P, name):
    """A present but all-null response column: ``.batch`` and ``.columns``
    see the same score-time null-label fill."""
    model = P.load(model_path(name))
    label = next(f for f in model.raw_features if f.is_response)
    rows = [dict(r, **{label.name: None}) for r in rows_of(P, name, 64)]
    cfv = P.columns.column_from_values
    ds = P.Dataset.of({
        f.name: cfv(f.ftype, [r.get(f.name) for r in rows])
        for f in model.raw_features
    })
    fn = P.score(model)
    out_rows = fn.batch(rows)
    out_cols = {nm: column_values(col) for nm, col in fn.columns(ds).items()}
    return {"scores": plain(out_rows), "columns": out_cols}


#: the CPU scenarios: name -> (function, model, extra arguments)
CPU_SCENARIOS = {
    "k_malformed": (scenario_k_malformed, "twin", ()),
    "k_malformed_xgb": (scenario_k_malformed, "xgb", ()),
    "unparseable": (scenario_unparseable, "twin", ()),
    "stage_poison": (scenario_stage_poison, "twin", ()),
    "stage_poison_rf": (scenario_stage_poison, "rf", ()),
    "multi_violation": (scenario_multi_violation, "twin", ()),
    "never_reach_plan": (scenario_never_reach_plan, "twin", ()),
    "budget": (scenario_budget, "twin", ()),
    "bisection": (scenario_stage_poison, "twin", ((0, 5, 8), 9)),
    "bisection_xgb": (scenario_stage_poison, "xgb", ((0, 5, 8), 9)),
    "open_breaker_plus_failure": (scenario_open_breaker_plus_failure,
                                  "twin", ()),
    "columns_poison": (scenario_columns_poison, "twin", ()),
    "columns_poison_xgb": (scenario_columns_poison, "xgb", ()),
    "parity_malformed": (scenario_parity, "twin", ("malformed",)),
    "parity_nan": (scenario_parity, "twin", ("nan",)),
    "parity_clean": (scenario_parity, "twin", ("clean",)),
    "breaker_recovers": (scenario_breaker_recovers, "twin", ()),
    "breaker_recovers_xgb": (scenario_breaker_recovers, "xgb", ()),
    "failed_probe": (scenario_failed_probe, "twin", ()),
    "short_circuit": (scenario_short_circuit, "twin", ()),
    "deadline_overruns": (scenario_deadline_overruns, "twin", ()),
    "breaker_disabled": (scenario_breaker_disabled, "twin", ()),
    "drift_quiet": (scenario_drift, "twin", ("quiet",)),
    "drift_shifted": (scenario_drift, "twin", ("shifted",)),
    "drift_fill": (scenario_drift, "twin", ("fill",)),
    "drift_window": (scenario_drift, "twin", ("window",)),
    "drift_torn": (scenario_drift, "twin", ("torn",)),
    "drift_shifted_xgb": (scenario_drift, "xgb", ("shifted",)),
    "drift_columns_train": (scenario_drift_columns, "twin", ("train",)),
    "drift_columns_drifted": (scenario_drift_columns, "twin", ("drifted",)),
    "isolation_guard": (scenario_isolation_guard, "twin", ()),
    "counters": (scenario_counters, "twin", ()),
    "counters_rf": (scenario_counters, "rf", ()),
    "summary": (scenario_summary, "twin", ()),
    "true_flags": (scenario_true_flags, "twin", ()),
    "guard_default": (scenario_nan_guard, "graph", (None,)),
    "guard_raise": (scenario_nan_guard, "graph", ("raise", 2)),
    "guard_padding": (scenario_nan_guard, "graph", (None, 3, (0, 3))),
    "guard_off": (scenario_nan_guard, "graph", ("off", 2)),
    "guard_default_xgb": (scenario_nan_guard, "xgb", (None,)),
    "null_label": (scenario_null_label, "twin", ()),
    "null_label_shifted": (scenario_null_label, "shifted", ()),
}


def run_cpu(P, key: str) -> dict:
    fn, name, args = CPU_SCENARIOS[key]
    return fn(P, name, *args)


def tolerance(key: str) -> float:
    """Scores' tolerance of a scenario: trees EQUAL, logistic 1e-6."""
    name = CPU_SCENARIOS[key][1] if key in CPU_SCENARIOS else key
    return 0.0 if name in ("xgb", "rf") else 1e-6


# ------------------------------------------------------ card scenarios
def card_model_stage(model) -> str:
    """(c)'s covered stage: the numeric vectorizer fed by ``age``."""
    return next(t.output_name for t in model.fitted.values()
                if "age" in t.input_names)


def scenario_card_clean(P, name, n=STAGED_ROWS):
    """(a): the default closure's counters after one ``.batch`` and, on a
    second closure, one ``.columns`` of the same rows."""
    model = P.load(model_path(name))
    rows = tiled(fixture_rows(name), n)
    fn = P.score(model)
    fn.batch(rows)
    fn2 = P.score(model)
    fn2.columns(_dataset_of(P, model, rows))
    return {"batch": counters(fn), "columns": counters(fn2)}


def scenario_card_quarantine(P, name, n=STAGED_ROWS):
    """(b): ``age`` malformed on ``MALFORMED_ROWS``."""
    model = P.load(model_path(name))
    rows = tiled(fixture_rows(name), n)
    fn = P.score(model)
    plan = P.FaultPlan().malform_row(
        DRIFT_FEATURE, rows=MALFORMED_ROWS, value="##bad##")
    with P.installed(plan):
        out = fn.batch(rows)
    return {"records": records(fn), "counters": counters(fn),
            "defaults": plain([out[i] for i in MALFORMED_ROWS]),
            "_out": out}


def scenario_card_breaker(P, name, n: int):
    """(c): ``fail_stage_transform`` on the covered stage of ``age`` opens
    its breaker over two single rows; with the plan uninstalled a batch
    of ``n`` rows goes staged and defaulted, the probe after the cooldown
    runs staged and closes the breaker, and the next batch fuses. Returns
    the counters (the sentinel's without ``rowsSeen``, which counts the
    batches' rows) and, per batch, the scores and whether it fused."""
    model = P.load(model_path(name))
    rows = tiled(fixture_rows(name), n)
    clk = FakeClock()
    fn = P.score(model, breaker=P.BreakerConfig(
        failure_threshold=BREAKER_THRESHOLD, recovery_time=BREAKER_COOLDOWN,
        clock=clk))
    if not fn.prime_fused():
        raise AssertionError(f"{name}: no fused program")
    stage = card_model_stage(model)
    plan = P.FaultPlan().fail_stage_transform(stage, times=BREAKER_THRESHOLD)
    opening = []
    with P.installed(plan):
        for i in range(BREAKER_THRESHOLD):
            opening.append(plain(fn(rows[i])))
    states = [fn.breakers[stage].stats()]
    batches = []
    for when in (1.0, BREAKER_COOLDOWN + 1.0, BREAKER_COOLDOWN + 2.0):
        clk.now = when
        before = fn.metadata()["fused"]["dispatches"]
        out = fn.batch(rows)
        batches.append({
            "fused": fn.metadata()["fused"]["dispatches"] - before,
            "scores": out,
        })
        states.append(fn.breakers[stage].stats())
    kept = counters(fn, drift=False)
    kept["sentinel"].pop("rowsSeen")
    return {"stage": stage, "opening": opening, "states": plain(states),
            "fused": [b["fused"] for b in batches],
            "default": plain(batches[0]["scores"][0]),
            "counters": kept, "fired": plain(plan.fired),
            "_batches": batches}


def scenario_card_drift(P, name, n=STAGED_ROWS):
    """(d): ``shift_feature`` on ``age`` through ``.batch`` and, on a
    second closure, through ``.columns``."""
    model = P.load(model_path(name))
    rows = tiled(fixture_rows(name), n)
    fn = P.score(model)
    with P.installed(P.FaultPlan().shift_feature(DRIFT_FEATURE,
                                                 DRIFT_OFFSET)):
        fn.batch(rows)
    fn2 = P.score(model)
    with P.installed(P.FaultPlan().shift_feature(DRIFT_FEATURE,
                                                 DRIFT_OFFSET)):
        fn2.columns(_dataset_of(P, model, rows))
    return {"batch": plain(fn.metadata()["drift"]),
            "columns": plain(fn2.metadata()["drift"])}


def public(result: dict) -> dict:
    """A card scenario's result without its raw outputs (``_`` keys)."""
    return {k: v for k, v in result.items() if not k.startswith("_")}


def load_results() -> dict:
    with open(RESULTS) as fh:
        return json.load(fh)
