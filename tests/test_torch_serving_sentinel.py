"""The hardened scoring closure (``local/scoring.py`` with
``resilience/sentinel.py``): schema sentinel, per-row quarantine, circuit
breakers, the drift sentinel and the score guard, driven through fault
plans and injectable clocks in both packages on the same seeded data.

Every scenario of ``tests/test_serving_sentinel.py`` and of the score-guard
class of ``tests/test_resilience.py`` is a function of
``tests/torch_fixtures/hardening.py`` run through the JAX package and the
port; the results (each row's scores, the quarantine records, the guard,
sentinel, quarantine, breaker and drift counters, the plan's firings) must
agree, and the reference suite's own assertions hold on the port's.
Tolerances: tree scores EQUAL; logistic scores within ``1e-6`` (plus
``1e-6`` of their size: the port's float64 core sums in another order);
every counter, record and drift report EQUAL (the drift statistics are
host float64 in both packages). The port's results also equal the JAX
package's stored ones (``tests/fixtures/torch_hardening/jax_results.json``,
which ``chip_smoke.py`` reads on the card).

An uncoercible value the reference writes as ``object()`` is a list here:
its repr, and so the quarantine reason, is the same in both packages.
"""
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from transmogrifai_tpu.resilience import sentinel as jax_sentinel
from transmogrifai_tpu.utils import streaming_histogram as jax_sh
from transmogrifai_tpu_torch.local import scoring
from transmogrifai_tpu_torch.models import serve_trees as ST
from transmogrifai_tpu_torch.resilience import faults
from transmogrifai_tpu_torch.resilience import sentinel as port_sentinel
from transmogrifai_tpu_torch.serving import shedding
from transmogrifai_tpu_torch.telemetry import events, metrics, spans
from transmogrifai_tpu_torch.utils import streaming_histogram as port_sh
from transmogrifai_tpu_torch.utils.cuda_build import KernelLaunchError

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_fixtures"))
import hardening as H  # noqa: E402

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]


@pytest.fixture(autouse=True)
def _fresh_process_state():
    """The fault plan, the metrics registry, the event ring, the span clock
    and the shed flags are process-global: every test starts clean."""
    faults.uninstall()
    metrics.REGISTRY.reset_metrics_for_tests()
    events.reset_for_tests()
    spans.reset_for_tests()
    shedding.reset_process_flags_for_tests()
    yield
    faults.uninstall()
    spans.set_clock(None)
    shedding.reset_process_flags_for_tests()


@pytest.fixture(scope="module")
def jax_results():
    return H.load_results()


def _json(x):
    return json.loads(json.dumps(x))


def _preds(result, pred=None) -> list:
    """Each row's prediction map (the scenario's one prediction result)."""
    out = []
    for row in result["scores"]:
        maps = [v for k, v in row.items() if pred is None or k == pred]
        out.append(maps[0])
    return out


# the reference suite's assertions, on the port's result of each scenario
CHECKS = {
    "k_malformed": lambda r: (
        sorted(x[0] for x in r["records"]) == [2, 7]
        and r["counters"]["quarantine"]["quarantinedRows"] == 2
        and r["counters"]["sentinel"]["violations"]["unparseable"] == 1
        and r["counters"]["sentinel"]["violations"]["wrong_type"] >= 1
        and all(r["scores"][i] == r["clean"][i]
                for i in (0, 1, 3, 4, 5, 6, 8, 9))),
    "unparseable": lambda r: [x[0] for x in r["records"]] == [1],
    "stage_poison": lambda r: (
        [x[0] for x in r["records"]] == [3] and r["records"][0][2] == "stage"
        and all(r["scores"][i] == r["clean"][i] for i in (0, 1, 2, 4, 5))),
    "multi_violation": lambda r: (
        r["counters"]["quarantine"]["quarantinedRows"] == 1
        and r["counters"]["quarantine"]["records"] == 2),
    "never_reach_plan": lambda r: (
        [x[0] for x in r["records"]] == [2]
        and r["records"][0][2] == "unparseable"
        and not any(f[0] == "transform" for f in r["fired"])),
    "budget": lambda r: (
        sorted(x[0] for x in r["records"]) == list(range(64))
        and r["executions"] <= 70),
    "bisection": lambda r: (
        sorted(x[0] for x in r["records"]) == [0, 5, 8]
        and all(r["scores"][i] == r["clean"][i] for i in (1, 2, 3, 4, 6, 7))),
    "open_breaker_plus_failure": lambda r: (
        [x[0] for x in r["records"]] == [2]
        and any(b["state"] == "open"
                and b["transitions"] == {"closed->open": 1}
                for b in r["counters"]["breakers"].values())),
    "columns_poison": lambda r: (
        [x[0] for x in r["records"]] == [2]
        and all(r["scores"][i] == r["clean"][i] for i in (0, 1, 3, 4, 5))),
    "parity_malformed": lambda r: (
        r["scores"][0] == r["scores"][1]
        and [x[1:3] for x in r["records"]]
        == [x[1:3] for x in r["batch_records"]]),
    "parity_nan": lambda r: (
        r["scores"][0] == r["scores"][1] and r["guard"] == r["batch_guard"]),
    "parity_clean": lambda r: r["scores"][0] == r["scores"][1],
    "breaker_recovers": lambda r: (
        r["stats"][0]["state"] == "open"
        and r["stats"][0]["transitions"] == {"closed->open": 1}
        and r["stats"][1]["shortCircuits"] == 1
        and r["stats"][2]["state"] == "open"
        and r["stats"][3]["state"] == "closed"
        and r["stats"][3]["transitions"]["open->half_open"] == 1
        and r["stats"][3]["transitions"]["half_open->closed"] == 1
        and len(r["fired"]) == 1),
    "failed_probe": lambda r: (
        r["stats"][0]["state"] == "open" and r["stats"][1]["state"] == "open"
        and r["stats"][1]["transitions"]["half_open->open"] == 1
        and r["stats"][2]["state"] == "closed"),
    "short_circuit": lambda r: (
        len(r["scores"]) == 4
        and all(b["shortCircuits"] == 1 for b in r["counters"]["breakers"]
                .values() if b["state"] == "open")),
    "deadline_overruns": lambda r: all(
        b["deadlineOverruns"] >= 1 and b["consecutiveFailures"] >= 1
        for b in r["counters"]["breakers"].values()),
    "breaker_disabled": lambda r: (
        r["breakers"] == 0 and r["counters"]["breakers"] == {}),
    "drift_quiet": lambda r: (
        r["reports"][0]["enabled"] and r["reports"][0]["alerts"] == []
        and r["reports"][0]["features"]["x1"]["status"] == "ok"
        and r["reports"][0]["features"]["x1"]["jsDivergence"] < 0.35),
    "drift_shifted": lambda r: (
        r["reports"][0]["alerts"] == ["x1"]
        and r["reports"][1]["driftAlertsTotal"] == 1
        and r["reports"][0]["features"]["x1"]["jsDivergence"] > 0.35
        and r["reports"][0]["features"]["x2"]["status"] == "ok"
        and r["fired"] == [["drift", "x1"]]),
    "drift_fill": lambda r: (
        "x2" in r["reports"][0]["alerts"]
        and r["reports"][0]["features"]["x2"]["fillRatio"] is None),
    "drift_window": lambda r: (
        r["reports"][0]["alerts"] == ["x1"] and r["reports"][1]["alerts"] == []
        and r["reports"][1]["driftAlertsTotal"] == 1),
    "drift_torn": lambda r: (
        r["report"]["tornProfiles"] == ["x1"]
        and "x1" not in r["report"]["features"]
        and r["fired"] == [["profile", "x1"]]),
    "drift_columns_train": lambda r: (
        r["report"]["rowsObserved"] == 160
        and r["report"]["features"]["x1"]["status"] == "ok"),
    "drift_columns_drifted": lambda r: r["report"]["alerts"] == ["x1"],
    "isolation_guard": lambda r: (
        [x[0] for x in r["records"]] == [5]
        and r["counters"]["scoreGuard"]["guardedRows"] == 0),
    "counters": lambda r: (
        r["counters"]["quarantine"]["quarantinedRows"] == 3
        and r["counters"]["quarantine"]["byKind"] == {"unparseable": 3}
        and r["counters"]["sentinel"]["violations"]["unparseable"] == 3
        and r["counters"]["scoreGuard"]["guardedRows"] == 1
        and r["counters"]["drift"]["rowsObserved"] == 9
        and len([f for f in r["fired"] if f[0] == "malform"]) == 3),
    "summary": lambda r: "quarantined row(s)" in r["line"],
    "true_flags": lambda r: (
        r["counters"]["sentinel"] is not None
        and r["counters"]["drift"]["enabled"]),
    "guard_default": lambda r: (
        _preds(r)[0]["prediction"] == 0.0
        and _preds(r)[0]["probability_0"] == pytest.approx(0.5)
        and np.isfinite(_preds(r)[1]["prediction"])
        and r["counters"]["scoreGuard"]["guardedRows"] == 1
        and len(r["fired"]) == 1 and r["fired"][0][0] == "nan"),
    "guard_raise": lambda r: (
        r["raised"] == "ScoreGuardError" and "non-finite" in r["message"]),
    "guard_padding": lambda r: (
        r["counters"]["scoreGuard"]["guardedRows"] == 1
        and _preds(r)[0]["prediction"] == 0.0),
    "guard_off": lambda r: _preds(r)[0]["prediction"] == "nan",
    "null_label": lambda r: all(
        v == r["columns"][k][i]
        for i, row in enumerate(r["scores"]) for k, v in row.items()),
    "null_label_shifted": lambda r: all(
        row[k] == -1.0 and r["columns"][k][i] == -1.0
        for i, row in enumerate(r["scores"]) for k in row
        if not isinstance(row[k], dict)),
}
CHECKS["k_malformed_xgb"] = lambda r: (
    sorted(x[0] for x in r["records"]) == [2, 7]
    and all(r["scores"][i] == r["clean"][i] for i in (0, 1, 3, 4, 5, 6, 8, 9)))
CHECKS["stage_poison_rf"] = CHECKS["stage_poison"]
CHECKS["bisection_xgb"] = CHECKS["bisection"]
CHECKS["columns_poison_xgb"] = CHECKS["columns_poison"]
CHECKS["breaker_recovers_xgb"] = CHECKS["breaker_recovers"]
CHECKS["counters_rf"] = CHECKS["counters"]
CHECKS["guard_default_xgb"] = lambda r: (
    _preds(r)[0]["prediction"] == 0.0
    and r["counters"]["scoreGuard"]["guardedRows"] == 1)
CHECKS["drift_shifted_xgb"] = lambda r: (
    r["reports"][0]["alerts"] == [r["fired"][0][1]])


@pytest.mark.parametrize("key", sorted(H.CPU_SCENARIOS))
def test_scenario_equals_the_reference(key, jax_results):
    """One scenario through both packages: results and counters agree, the
    reference's assertions hold on the port, and the port equals the JAX
    package's stored result."""
    port = _json(H.run_cpu(H.package("port"), key))
    faults.uninstall()
    reference = _json(H.run_cpu(H.package("jax"), key))
    atol = H.tolerance(key)
    H.same_result(port, reference, atol)
    H.same_result(port, jax_results["cpu"][key], atol)
    assert CHECKS[key](port), port


def test_every_scenario_has_a_check():
    assert set(CHECKS) == set(H.CPU_SCENARIOS)


def test_empty_batch_and_explain_zero():
    P = H.package("port")
    fn = P.score(P.load(H.model_path("twin")))
    assert fn.batch([]) == []
    assert fn.batch([], explain=0) == []
    assert fn.batch([], explain=2) == []
    out = fn.batch([{"x1": 1.0, "x2": 2.0}], explain=2)
    assert len(out[0]["attributions"]) == 2


def test_isolation_raise_restores_fail_fast():
    from transmogrifai_tpu_torch.resilience import TransientError

    P = H.package("port")
    model = P.load(H.model_path("twin"))
    pred = H.pred_name(model)
    fn = P.score(model, isolation="raise")
    with P.installed(P.FaultPlan().fail_stage_transform(pred, times=1)):
        with pytest.raises(TransientError, match="injected"):
            fn.batch(H.rows_of(P, "twin", 4))
    # the breaker recorded the failure before propagating
    assert fn.breakers[pred].stats()["consecutiveFailures"] == 1
    with pytest.raises(ValueError, match="isolation"):
        P.score(model, isolation="nope")


def test_default_values_do_not_alias_between_rows():
    P = H.package("port")
    model = P.load(H.model_path("twin"))
    pred = H.pred_name(model)
    rows = H.rows_of(P, "twin", 2)
    bad1, bad2 = dict(rows[0], x1="zzz"), dict(rows[1], x1="www")
    out = P.score(model).batch([bad1, bad2])
    out[0][pred]["prediction"] = 99.0
    assert out[1][pred]["prediction"] != 99.0


def test_guard_raise_is_not_swallowed_by_isolation():
    from transmogrifai_tpu_torch.resilience import ScoreGuard, ScoreGuardError

    P = H.package("port")
    model = P.load(H.model_path("twin"))
    fn = P.score(model, guard=ScoreGuard(fallback="raise"))
    with P.installed(P.FaultPlan().nan_output(H.pred_name(model), rows=(0,))):
        with pytest.raises(ScoreGuardError, match="non-finite"):
            fn.batch(H.rows_of(P, "twin", 2))


def test_metadata_has_the_reference_keys():
    """``metadata()`` carries the reference's keys; the planes not ported
    yet hold ``None``, and ``attributions`` (the insights plane) has the
    reference's sub-keys."""
    from transmogrifai_tpu.local.scoring import score_function as jax_sf
    from transmogrifai_tpu.workflow.persistence import load_workflow_model

    P = H.package("port")
    fn = P.score(P.load(H.model_path("twin")))
    fn.batch(H.rows_of(P, "twin", 4))
    md = fn.metadata()
    jmd = jax_sf(load_workflow_model(H.model_path("twin"))).metadata()
    assert set(md) == set(jmd)
    for key in ("analysis", "compileStats", "distributed",
                "retrainLedger", "telemetry"):
        assert md[key] is None
    assert set(md["attributions"]) == set(jmd["attributions"])
    assert set(jmd["fused"]) <= set(md["fused"])


# --------------------------------------------------------- schema sentinel
SENTINEL_CASES = [
    # (policy kwargs, per-feature policies, row)
    ({}, {}, {"x1": "3.5", "x2": 1.0}),
    ({}, {}, {"x1": "zzz", "x2": 1.0}),
    ({}, {}, {"x1": float("nan"), "x2": float("inf")}),
    ({}, {}, {"x1": 1.0}),
    ({}, {}, {"x1": 1.0, "x2": 2.0, "label": "garbage"}),
    ({"unparseable": "raise"}, {}, {"x1": "zzz", "x2": 1.0}),
    ({}, {"x1": {"missing": "quarantine"}}, {"x2": 1.0}),
    ({}, {"x1": {"missing": "quarantine"}}, {"x1": 1.0}),
    ("off", {}, {"x1": "zzz"}),
    ({}, {}, {"x1": np.float64(1.5), "x2": np.int64(3)}),
    ({}, {}, {"x1": np.bool_(True), "x2": np.float32(2.0)}),
    ({}, {}, {"x1": 2.0, "x2": [1, 2]}),
]


def _check_rows(mod, P, case):
    policy_kw, per_feature, row = case
    ds = H.binary_ds(P, 8)
    from_dataset = (
        __import__("transmogrifai_tpu.features", fromlist=["x"]).from_dataset
        if P.name == "jax"
        else __import__("transmogrifai_tpu_torch.features",
                        fromlist=["x"]).from_dataset)
    resp, preds = from_dataset(ds, response="label")
    policy = (mod.SentinelPolicy.off() if policy_kw == "off"
              else mod.SentinelPolicy(**policy_kw))
    s = mod.SchemaSentinel(
        [resp, *preds], policy=policy,
        per_feature={k: mod.SentinelPolicy(**v)
                     for k, v in per_feature.items()})
    try:
        clean, q = s.check_row(row)
    except mod.SchemaViolationError as e:
        return {"raised": str(e)}
    bulk = s.check_rows([row, row])
    return {
        "clean": H.plain({k: v for k, v in clean.items()}),
        "same_object": clean is row,
        "quarantine": q,
        "bulk": [[H.plain(c), r] for c, r in bulk],
        "stats": H.plain(s.stats()),
    }


@pytest.mark.parametrize("case", range(len(SENTINEL_CASES)))
def test_schema_sentinel_equals_the_reference(case):
    got = _check_rows(port_sentinel, H.package("port"), SENTINEL_CASES[case])
    want = _check_rows(jax_sentinel, H.package("jax"), SENTINEL_CASES[case])
    assert got == want


INSPECT_CASES = [
    ("Binary", "yes"), ("Binary", "false"), ("Binary", "N/A"),
    ("Binary", True), ("Binary", 1.5), ("Integral", 3.7), ("Integral", "4"),
    ("Integral", "4.5"), ("Real", "inf"), ("Real", " "), ("Text", 3),
    ("TextList", "a"), ("MultiPickList", {"a"}), ("PickList", 1.0),
    ("Date", 17.0), ("Real", None),
]


@pytest.mark.parametrize("type_name,value", INSPECT_CASES)
def test_inspect_value_equals_the_reference(type_name, value):
    import transmogrifai_tpu.types as JT
    import transmogrifai_tpu_torch.types as PT

    def run(mod, T):
        kind, coerced = mod._inspect_value(getattr(T, type_name), value)
        return kind, ("UNCOERCIBLE" if coerced is mod._UNCOERCIBLE
                      else coerced)

    assert run(port_sentinel, PT) == run(jax_sentinel, JT)


def test_binary_garbage_strings_do_not_coerce_to_false():
    import transmogrifai_tpu_torch.types as T

    assert port_sentinel._inspect_value(T.Binary, "yes") == ("wrong_type", True)
    assert port_sentinel._inspect_value(T.Binary, "false") == \
        ("wrong_type", False)
    assert port_sentinel._inspect_value(T.Binary, np.bool_(True)) == \
        (None, True)
    assert port_sentinel._inspect_value(T.Binary, "N/A")[0] == "unparseable"


# ---------------------------------------------- streaming histograms, drift
@pytest.mark.parametrize("seed", range(8))
def test_histogram_merge_quantiles_shrink_equal_the_reference(seed):
    """The reference's three invariants (merged mass, monotone quantiles,
    no mass lost when shrinking), with every bin EQUAL in both packages."""
    def run(mod):
        rng = np.random.default_rng(seed)
        a, b = mod.StreamingHistogram(16), mod.StreamingHistogram(16)
        for v in rng.normal(size=50):
            a.update(float(v))
        for v in rng.exponential(size=37):
            b.update(float(v))
        merged = a.merge(b)
        h = mod.StreamingHistogram(12)
        for v in np.random.default_rng(seed + 100).normal(size=80):
            h.update(float(v))
        qs = [h.quantile(q) for q in np.linspace(0.0, 1.0, 21)]
        tiny = mod.StreamingHistogram(4)
        totals = []
        for v in np.random.default_rng(seed + 200).uniform(-5, 5, size=60):
            tiny.update(float(v))
            totals.append(tiny.total_count)
        return merged.bins, a.total_count + b.total_count, \
            merged.total_count, qs, totals, tiny.bins

    got, want = run(port_sh), run(jax_sh)
    assert got == want
    bins, mass, merged_mass, qs, totals, tiny = got
    assert merged_mass == pytest.approx(mass)
    assert all(q2 >= q1 - 1e-9 for q1, q2 in zip(qs, qs[1:]))
    assert totals == pytest.approx(list(range(1, 61)))
    assert len(tiny) <= 4


def test_bulk_histograms_and_js_divergence_equal_the_reference():
    def run(mod, smod):
        vals = [1.0, 2.0, 2.0, 5.0, 9.0]
        bulk = mod.histogram_from_values(vals, max_bins=16)
        inc = mod.StreamingHistogram(16)
        for v in vals:
            inc.update(v)
        rng = np.random.default_rng(7)
        big = mod.histogram_from_values(rng.normal(size=5000), max_bins=32)
        rng = np.random.default_rng(1)
        a = mod.histogram_from_values(rng.normal(size=500), max_bins=32)
        b = mod.histogram_from_values(rng.normal(size=500) + 0.01, max_bins=32)
        far = mod.histogram_from_values(rng.normal(size=500) + 100.0,
                                        max_bins=32)
        js = smod.histogram_js_divergence
        return (bulk.bins == inc.bins, big.total_count, len(big.bins),
                big.bins, js(a, b), js(a, far), js(a, a),
                a.to_json())

    got = run(port_sh, port_sentinel)
    assert got == run(jax_sh, jax_sentinel)
    same_bins, total, nbins, _, near, far, self_js, _ = got
    assert same_bins and total == pytest.approx(5000) and nbins <= 32
    assert 0.0 <= near < 0.2 and far > 0.9
    assert self_js == pytest.approx(0.0, abs=1e-9)


def test_corrupt_profile_json_is_torn_not_fatal():
    sent = port_sentinel.DriftSentinel({"x1": {"count": "??", "nulls": None}})
    assert sent.torn == ["x1"] and sent.profiles == {}


def test_model_without_profiles_is_inert():
    from transmogrifai_tpu_torch.workflow.workflow import WorkflowModel

    P = H.package("port")
    model = P.load(H.model_path("twin"))
    stripped = WorkflowModel(
        result_features=model.result_features,
        raw_features=model.raw_features, fitted=model.fitted,
        selector_info=model.selector_info, device=model.device,
    )
    fn = P.score(stripped)
    fn(H.rows_of(P, "twin", 1)[0])
    rep = fn.metadata()["drift"]
    assert rep["enabled"] is False and rep["features"] == {}


def test_drift_yields_to_the_shed_flag():
    """While a load shedder holds the drift flag (tier 3), batches are
    scored and the drift window is not fed."""
    P = H.package("port")
    fn = P.score(P.load(H.model_path("twin")))
    shedder = shedding.LoadShedder(capacity=100)
    assert shedder.update(80, 0, 0.0) == 3 and shedding.drift_shed()
    fn.batch(H.rows_of(P, "twin", 8))
    assert fn.metadata()["drift"]["rowsObserved"] == 0
    shedder.reset()
    fn.batch(H.rows_of(P, "twin", 8))
    assert fn.metadata()["drift"]["rowsObserved"] == 8


# ------------------------------------------------- serving profiles, train
def _train_twin(pkg: str):
    if pkg == "jax":
        from transmogrifai_tpu.features import from_dataset
        from transmogrifai_tpu.models.logistic import LogisticRegression
        from transmogrifai_tpu.ops import transmogrify
        from transmogrifai_tpu.selector import (
            BinaryClassificationModelSelector,
        )
        from transmogrifai_tpu.utils import uid as uid_util
        from transmogrifai_tpu.workflow.workflow import Workflow
        lr = LogisticRegression()
    else:
        from transmogrifai_tpu_torch.features import from_dataset
        from transmogrifai_tpu_torch.models.logistic import LogisticRegression
        from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
        from transmogrifai_tpu_torch.selector import (
            BinaryClassificationModelSelector,
        )
        from transmogrifai_tpu_torch.utils import uid as uid_util
        from transmogrifai_tpu_torch.workflow.workflow import Workflow
        lr = LogisticRegression(device="cpu")
    uid_util.reset()
    ds = H.binary_ds(H.package(pkg), 160, 3)
    resp, preds = from_dataset(ds, response="label")
    selector = BinaryClassificationModelSelector(
        seed=7, models=[(lr, {"reg_param": [0.01]})], num_folds=2)
    pred = selector.set_input(resp, transmogrify(list(preds))).get_output()
    return Workflow().set_result_features(pred).set_input_dataset(ds).train()


def test_train_stores_profiles_equal_to_the_reference(tmp_path):
    """``Workflow.train()`` profiles every raw predictor (never the
    response) over the training rows, EQUAL the JAX package's; save and
    load carry them in both directions between the packages."""
    from transmogrifai_tpu.workflow.workflow import WorkflowModel as JWM

    from transmogrifai_tpu_torch.workflow.persistence import (
        load_workflow_model,
    )

    model = _train_twin("port")
    profs = model.serving_profiles
    assert set(profs) == {"x1", "x2"}
    assert profs["x1"]["count"] > 0 and profs["x1"]["histogram"] is not None
    assert _json(profs) == _json(_train_twin("jax").serving_profiles)
    model.save(str(tmp_path / "port"))
    assert JWM.load(str(tmp_path / "port")).serving_profiles == profs
    assert load_workflow_model(str(tmp_path / "port"),
                               device="cpu").serving_profiles == profs


@pytest.mark.parametrize("name", ["xgb", "rf", "lr"])
def test_jax_saved_profiles_round_trip_through_the_port(name, tmp_path):
    """The JAX-saved serving fixtures' ``servingProfiles`` load into the
    port and save back unchanged, and the JAX package reads them back."""
    from transmogrifai_tpu.workflow.workflow import WorkflowModel as JWM

    from transmogrifai_tpu_torch.workflow.persistence import (
        load_workflow_model,
    )

    with open(os.path.join(H.model_path(name), "manifest.json")) as fh:
        want = json.load(fh)["servingProfiles"]
    assert len(want) == 5
    model = load_workflow_model(H.model_path(name), device="cpu")
    assert model.serving_profiles == want
    model.save(str(tmp_path / "m"))
    with open(tmp_path / "m" / "manifest.json") as fh:
        assert json.load(fh)["servingProfiles"] == want
    assert JWM.load(str(tmp_path / "m")).serving_profiles == want
    P = H.package("port")
    fn = P.score(model)
    fn.batch(H.tiled(H.fixture_rows(name), 64))
    assert fn.metadata()["drift"]["enabled"]


# ------------------------------------------------------- port-only cases
def test_a_staged_kernel_fault_propagates_unabsorbed(monkeypatch):
    """A kernel fault in the staged tree predictor comes out of ``.batch``
    and ``.columns``: no row quarantined, no breaker failure recorded, no
    guard count, no fused fallback."""
    P = H.package("port")
    model = P.load(H.model_path("xgb"))
    rows = H.tiled(H.fixture_rows("xgb"), 64)
    fn = P.score(model)
    fn.batch(rows[:4])  # breakers exist and the neutral row is scored

    def fault(*a, **kw):
        raise KernelLaunchError("serve_trees kernel launch failed: test")

    monkeypatch.setattr(ST, "serve_trees_packed", fault)
    with pytest.raises(KernelLaunchError):
        fn.batch(rows)
    with pytest.raises(KernelLaunchError):
        fn.columns(H._dataset_of(P, model, rows))
    with pytest.raises(KernelLaunchError):
        fn(rows[0])
    md = fn.metadata()
    assert md["quarantine"]["quarantinedRows"] == 0
    assert md["scoreGuard"]["guardedRows"] == 0
    assert md["breakers"] and all(
        b["consecutiveFailures"] == 0 and b["transitions"] == {}
        and b["state"] == "closed" for b in md["breakers"].values())
    assert (md["fused"]["dispatches"], md["fused"]["fallbacks"]) == (0, 0)


def test_a_fused_kernel_fault_propagates_unabsorbed(monkeypatch):
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    P = H.package("port")
    model = P.load(H.model_path("xgb"))
    rows = H.tiled(H.fixture_rows("xgb"), 16)
    fn = P.score(model)

    def fault(*a, **kw):
        raise KernelLaunchError("serve_trees kernel launch failed: test")

    monkeypatch.setattr(ST, "predict_device_route", fault)
    with pytest.raises(KernelLaunchError):
        fn.batch(rows)
    with pytest.raises(KernelLaunchError):
        fn.columns(H._dataset_of(P, model, rows))
    md = fn.metadata()
    assert md["quarantine"]["quarantinedRows"] == 0
    assert all(b["consecutiveFailures"] == 0
               for b in md["breakers"].values())
    assert (md["fused"]["dispatches"], md["fused"]["fallbacks"],
            md["fused"]["fallbackReasons"]) == (0, 0, {})


def test_a_kernel_fault_in_a_half_open_probe_releases_it(monkeypatch):
    """A kernel fault during a half-open probe records no outcome: the
    breaker stays half-open and the next batch probes again."""
    P = H.package("port")
    model = P.load(H.model_path("xgb"))
    pred = H.pred_name(model)
    rows = H.tiled(H.fixture_rows("xgb"), 8)
    clk = H.FakeClock()
    fn = P.score(model, breaker=P.BreakerConfig(
        failure_threshold=1, recovery_time=5.0, clock=clk))
    with P.installed(P.FaultPlan().fail_stage_transform(pred, times=1)):
        fn(rows[0])
    br = fn.breakers[pred]
    assert br.state == "open"
    clk.now = 6.0
    real = ST.serve_trees_packed

    def fault(*a, **kw):
        raise KernelLaunchError("serve_trees kernel launch failed: test")

    monkeypatch.setattr(ST, "serve_trees_packed", fault)
    with pytest.raises(KernelLaunchError):
        fn.batch(rows)
    assert br.state == "half_open" and not br.probe_in_flight
    assert br.stats()["consecutiveFailures"] == 1
    monkeypatch.setattr(ST, "serve_trees_packed", real)
    fn.batch(rows)
    assert br.state == "closed"


def test_a_half_open_covered_breaker_routes_a_fused_batch_staged(monkeypatch):
    """A 20000-row batch above ``TPTPU_HOST_PREDICT_MAX`` fuses only while
    every covered breaker is closed: open, the batch goes staged with the
    prediction defaulted; past the cooldown the probe runs staged and
    closes the breaker; the next batch fuses (``dispatches`` + 1)."""
    monkeypatch.delenv("TPTPU_HOST_PREDICT_MAX", raising=False)
    P = H.package("port")
    model = P.load(H.model_path("xgb"))
    rows = H.tiled(H.fixture_rows("xgb"), 20000)
    clk = H.FakeClock()
    fn = P.score(model, breaker=P.BreakerConfig(
        failure_threshold=1, recovery_time=10.0, clock=clk))
    assert fn.prime_fused()
    stage = H.card_model_stage(model)
    assert stage in fn.fused_state["program"].covered
    with P.installed(P.FaultPlan().fail_stage_transform(stage, times=1)):
        fn(rows[0])
    br = fn.breakers[stage]
    assert br.state == "open"
    dispatches = lambda: fn.metadata()["fused"]["dispatches"]  # noqa: E731
    clk.now = 1.0
    out = fn.batch(rows)
    assert dispatches() == 0 and br.state == "open"
    default = scoring_default(fn, model)
    assert out[0] == out[-1] == default
    clk.now = 11.0
    probed = fn.batch(rows)
    assert dispatches() == 0 and br.state == "closed"
    assert br.stats()["transitions"] == {
        "closed->open": 1, "open->half_open": 1, "half_open->closed": 1}
    fused = fn.batch(rows)
    assert dispatches() == 1
    assert probed == fused  # tree scores EQUAL on both routes


def scoring_default(fn, model):
    """The closure's default result row (the all-missing row's scores)."""
    P = H.package("port")
    with P.installed(P.FaultPlan().malform_row(
            "age", rows=(0,), value="##bad##")):
        return fn.batch([H.fixture_rows("xgb")[0]])[0]


def test_fault_plan_batches_never_fuse(monkeypatch):
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    P = H.package("port")
    model = P.load(H.model_path("xgb"))
    rows = H.tiled(H.fixture_rows("xgb"), 16)
    fn = P.score(model)
    with P.installed(P.FaultPlan()):
        staged = fn.batch(rows)
    assert fn.metadata()["fused"]["dispatches"] == 0
    assert fn.batch(rows) == staged
    assert fn.metadata()["fused"]["dispatches"] == 1


def test_a_degraded_prefix_goes_staged_and_counts(monkeypatch):
    """A host-prefix stage whose breaker is open short-circuits: the fused
    batch goes down the staged loop, counted as ``prefix_degraded``, and
    the prediction degrades to the default."""
    import dsl_flow as D
    import fit_side_tables as FT

    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", "0")
    P = H.package("port")
    model = P.load(os.path.join(os.path.dirname(__file__), "fixtures",
                                "torch_dsl", "f2_model"))
    clk = H.FakeClock()
    cfg = P.BreakerConfig(failure_threshold=1, recovery_time=100.0,
                          clock=clk)
    fn = P.score(model, breaker=cfg)
    assert fn.prime_fused()
    prog = fn.fused_state["program"]
    stage = prog.prefix[0].output_name
    assert stage not in prog.covered
    fn.breakers[stage] = port_sentinel.CircuitBreaker(stage, cfg)
    fn.breakers[stage].record_failure()
    rows = D.fresh_rows(FT.wide_hash_table, 16)
    fn.batch(rows)
    md = fn.metadata()["fused"]
    assert (md["dispatches"], md["fallbacks"], md["fallbackReasons"]) == (
        0, 1, {"prefix_degraded": 1})
    assert md["lastFallback"] == "prefix_degraded"


def test_quarantine_log_and_breakers_stay_exact_under_threads():
    """One closure shared by threads: each thread's ``quarantine.last`` is
    its own batch's, and the cumulative counters and breaker counters are
    exact."""
    P = H.package("port")
    model = P.load(H.model_path("twin"))
    fn = P.score(model)
    rows = H.rows_of(P, "twin", 16)
    errors, seen = [], {}
    barrier = threading.Barrier(4)

    def work(t):
        try:
            barrier.wait()
            for rep in range(5):
                bad = [dict(r) for r in rows]
                bad[t]["x1"] = "##bad##"
                fn.batch(bad)
                seen[(t, rep)] = [r.index for r in fn.quarantine.last]
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors
    assert all(v == [t] for (t, _), v in seen.items())
    md = fn.metadata()
    assert md["quarantine"]["quarantinedRows"] == 20
    assert md["sentinel"]["rowsSeen"] == 20 * 16
    assert all(b["consecutiveFailures"] == 0
               for b in md["breakers"].values())


def test_the_serving_source_counts_live_closures():
    P = H.package("port")
    fn = P.score(P.load(H.model_path("twin")))
    rows = H.rows_of(P, "twin", 4)
    rows[1] = dict(rows[1], x1="##bad##")
    fn.batch(rows)
    src = metrics.REGISTRY.source_snapshots()["serving"]
    assert src["scoreFunctions"] >= 1 and src["quarantinedRows"] >= 1
    assert scoring._serving_source()["quarantinedRows"] >= 1


@pytest.mark.parametrize("family", ["sentinel", "dispatch"])
def test_deadline_checkpoints_reject_before_the_family(family):
    """A request whose budget cannot cover a stage family's p95 is rejected
    at that family's checkpoint with a typed ``DeadlineExceeded``, as the
    JAX closure rejects it: a spent budget before ``sentinel``; a budget
    short of the recorded dispatch p95 before the predictor. No breaker
    records it and nothing is quarantined."""
    from transmogrifai_tpu.serving import deadline as jdl
    from transmogrifai_tpu.telemetry import metrics as jme
    from transmogrifai_tpu_torch.serving import deadline as pdl

    def run(P, dl, registry):
        model = P.load(H.model_path("twin"))
        fn = P.score(model)
        rows = H.rows_of(P, "twin", 4)
        fn.batch(rows)  # breakers exist
        clock = H.FakeClock()
        if family == "dispatch":
            registry.histogram("tptpu_serve_seconds",
                               labels={"stage": "dispatch"}).observe(5.0)
            budget = dl.DeadlineBudget(1.0, clock=clock)
        else:
            budget = dl.DeadlineBudget(0.0, clock=clock)
        with dl.active(budget):
            with pytest.raises(dl.DeadlineExceeded) as ei:
                fn.batch(rows)
        md = fn.metadata()
        return (ei.value.family, md["quarantine"]["quarantinedRows"],
                sorted((nm, b["consecutiveFailures"], b["state"])
                       for nm, b in md["breakers"].items()))

    jme.REGISTRY.reset_metrics_for_tests()
    try:
        want = run(H.package("jax"), jdl, jme.REGISTRY)
    finally:
        jme.REGISTRY.reset_metrics_for_tests()
    got = run(H.package("port"), pdl, metrics.REGISTRY)
    assert got[0] == want[0] == family
    assert got[1] == want[1] == 0
    assert [b[1:] for b in got[2]] == [b[1:] for b in want[2]]
