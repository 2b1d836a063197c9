"""The port's retry policy, fault plan and training-side consumers of both
(``resilience/{retry,faults}.py``, ``workflow/fit.py``,
``selector/validators.py``, ``readers/core.py``), held against the JAX
package on the same seeded data.

The reference's ``tests/test_resilience.py`` classes ported here, each run
through both packages: ``TestRetryPolicy`` (backoff schedules, attempts and
errors EQUAL), ``TestFaultPlan`` (the injected fit failure, the installed
plan's firings EQUAL), ``TestCVFaults`` without its two checkpoint cases
(the attempt records EQUAL but for the candidates' uids; the port has no
NaiveBayes yet, ``ROADMAP.md`` A9, so ``RandomForestClassifier`` with one
grid point takes its place in both packages), ``TestAtomicPersistence``
(the load errors' messages EQUAL, the paths aside; a round trip scores
EQUAL within each package) and ``TestReaderRetry``. ``TestScoreGuards``
runs with the serving scenarios (``tests/test_torch_serving_sentinel.py``,
``guard_*``). The port's own rule: a kernel fault is never transient and
never retried.
"""
import os

import numpy as np
import pytest
import torch

import transmogrifai_tpu.resilience as JR
import transmogrifai_tpu_torch.resilience as PR
from transmogrifai_tpu_torch import testkit
from transmogrifai_tpu_torch.resilience import faults
from transmogrifai_tpu_torch.utils.cuda_build import (
    KernelBuildError,
    KernelLaunchError,
)

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

GRID = {"reg_param": [0.01, 0.1], "elastic_net_param": [0.1]}
PACKAGES = ("jax", "port")


@pytest.fixture(autouse=True)
def _no_installed_plan():
    faults.uninstall()
    JR.faults.uninstall()
    yield
    faults.uninstall()
    JR.faults.uninstall()


class FakeClock:
    """Injectable clock/sleep pair: backoff schedules run in zero wall time."""

    def __init__(self):
        self.now = 0.0
        self.sleeps = []

    def time(self):
        return self.now

    def sleep(self, d):
        self.sleeps.append(d)
        self.now += d


def fast_policy(R, **kw):
    clk = FakeClock()
    kw.setdefault("max_attempts", 3)
    kw.setdefault("base_delay", 1.0)
    kw.setdefault("jitter", 0.0)
    return R.RetryPolicy(sleep=clk.sleep, clock=clk.time, **kw), clk


def api(pkg: str):
    """One package's training entry points (the port's on the CPU)."""
    import types

    ns = types.SimpleNamespace(pkg=pkg)
    if pkg == "jax":
        import transmogrifai_tpu.types as T
        from transmogrifai_tpu.dataset import Dataset
        from transmogrifai_tpu.evaluators import BinaryClassificationEvaluator
        from transmogrifai_tpu.features import from_dataset
        from transmogrifai_tpu.models.gbdt import RandomForestClassifier
        from transmogrifai_tpu.models.logistic import LogisticRegression
        from transmogrifai_tpu.ops import transmogrify
        from transmogrifai_tpu.prep import SanityChecker
        from transmogrifai_tpu.readers.core import SimpleReader
        from transmogrifai_tpu.selector import BinaryClassificationModelSelector
        from transmogrifai_tpu.selector.validators import CrossValidator
        from transmogrifai_tpu.types.columns import column_from_values
        from transmogrifai_tpu.utils import uid as uid_util
        from transmogrifai_tpu.workflow.persistence import ModelLoadError
        from transmogrifai_tpu.workflow.workflow import Workflow, WorkflowModel

        ns.R = JR
        ns.dev = {}
        ns.checker = SanityChecker
    else:
        import transmogrifai_tpu_torch.types as T
        from transmogrifai_tpu_torch.dataset import Dataset
        from transmogrifai_tpu_torch.evaluators import (
            BinaryClassificationEvaluator,
        )
        from transmogrifai_tpu_torch.features import from_dataset
        from transmogrifai_tpu_torch.models.gbdt import RandomForestClassifier
        from transmogrifai_tpu_torch.models.logistic import LogisticRegression
        from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
        from transmogrifai_tpu_torch.prep import SanityChecker
        from transmogrifai_tpu_torch.readers.core import SimpleReader
        from transmogrifai_tpu_torch.selector import (
            BinaryClassificationModelSelector,
        )
        from transmogrifai_tpu_torch.selector.validators import CrossValidator
        from transmogrifai_tpu_torch.types.columns import column_from_values
        from transmogrifai_tpu_torch.utils import uid as uid_util
        from transmogrifai_tpu_torch.workflow.persistence import ModelLoadError
        from transmogrifai_tpu_torch.workflow.workflow import (
            Workflow,
            WorkflowModel,
        )

        ns.R = PR
        ns.dev = {"device": "cpu"}
        ns.checker = lambda **kw: SanityChecker(device="cpu", **kw)
    ns.T, ns.Dataset, ns.cfv = T, Dataset, column_from_values
    ns.from_dataset, ns.transmogrify = from_dataset, transmogrify
    ns.LR = lambda: LogisticRegression(**ns.dev)
    ns.RF = lambda: RandomForestClassifier(**ns.dev)
    ns.Selector, ns.CrossValidator = (BinaryClassificationModelSelector,
                                      CrossValidator)
    ns.Evaluator, ns.SimpleReader = BinaryClassificationEvaluator, SimpleReader
    ns.uid, ns.ModelLoadError = uid_util, ModelLoadError
    ns.Workflow, ns.WorkflowModel = Workflow, WorkflowModel
    return ns


def binary_ds(A, n=160, seed=0):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n)
    x2 = rng.normal(size=n)
    label = (x1 + 0.5 * x2 + 0.3 * rng.normal(size=n) > 0).astype(float)
    return A.Dataset.of({
        "label": A.cfv(A.T.RealNN, label),
        "x1": A.cfv(A.T.Real, x1),
        "x2": A.cfv(A.T.Real, x2),
    })


def graph(A, ds, seed=5):
    """transmogrify -> SanityChecker -> selector: a multi-layer DAG."""
    resp, preds = A.from_dataset(ds, response="label")
    checked = resp.transform_with(
        A.checker(remove_bad_features=True), A.transmogrify(list(preds)))
    selector = A.Selector(seed=seed, models=[(A.LR(), GRID)], num_folds=2)
    return selector.set_input(resp, checked).get_output(), selector


def xy(n=160, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float64)
    return x, y


def both(fn):
    """``fn(api(pkg))`` for each package: {"jax": ..., "port": ...}."""
    return {pkg: fn(api(pkg)) for pkg in PACKAGES}


# ------------------------------------------------------------------ retry
def _retry_case(R, case):
    def run():
        if case == "transient":
            policy, clk = fast_policy(R, max_attempts=4, multiplier=2.0)
            calls = []

            def fn():
                calls.append(1)
                if len(calls) < 3:
                    raise R.TransientError("flaky")
                return "ok"

            out, attempts = policy.call(fn)
            return {"out": out, "attempts": attempts, "sleeps": clk.sleeps}
        if case == "fatal":
            policy, clk = fast_policy(R)
            try:
                policy.call(lambda: (_ for _ in ()).throw(ValueError("bad")))
            except ValueError as e:
                return {"sleeps": clk.sleeps, "attempts": e._retry_attempts}
        if case == "deadline":
            policy, clk = fast_policy(R, max_attempts=10, deadline=2.5)

            def always():
                raise R.TransientError("down")

            try:
                policy.call(always)
            except R.TransientError as e:
                return {"sleeps": clk.sleeps, "attempts": e._retry_attempts}
        if case == "jitter":
            import random

            return [R.RetryPolicy(seed=7).delay_for(a, random.Random(7))
                    for a in (1, 2, 3)]
        if case == "classification":
            return [R.is_transient(e) for e in (
                R.TransientError("x"), ConnectionResetError(), TimeoutError(),
                R.FatalError("x"), ValueError("x"),
                FileNotFoundError(2, "gone"), InterruptedError(),
                OSError(5, "eio"))]
        if case == "default_io":
            p = R.default_io_policy()
            return [p.max_attempts, p.base_delay, p.max_delay]
        raise AssertionError(case)

    return run()


RETRY_EXPECTED = {
    "transient": {"out": "ok", "attempts": 3, "sleeps": [1.0, 2.0]},
    "fatal": {"sleeps": [], "attempts": 1},
    "deadline": {"sleeps": [1.0], "attempts": 2},
    "classification": [True, True, True, False, False, False, True, True],
    "default_io": [3, 0.1, 1.0],
}


@pytest.mark.parametrize("case", ["transient", "fatal", "deadline", "jitter",
                                  "classification", "default_io"])
def test_retry_policy_equals_the_reference(case):
    got, want = _retry_case(PR, case), _retry_case(JR, case)
    assert got == want
    if case in RETRY_EXPECTED:
        assert got == RETRY_EXPECTED[case]


@pytest.mark.parametrize("exc", [
    KernelLaunchError("serve_trees kernel launch failed"),
    KernelBuildError("nvcc failed"),
    torch.OutOfMemoryError("CUDA out of memory"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
])
def test_a_kernel_fault_is_never_transient_nor_retried(exc):
    assert PR.is_transient(exc) is False
    policy, clk = fast_policy(PR, max_attempts=5, classify=lambda e: True)
    calls = []

    def fn():
        calls.append(1)
        raise exc

    with pytest.raises(type(exc)) as ei:
        policy.call(fn)
    assert calls == [1] and clk.sleeps == []
    assert ei.value._retry_attempts == 1


# -------------------------------------------------------------- fault plan
def test_fail_nth_stage_fit_raises_in_train():
    def run(A):
        ds = binary_ds(A, n=60, seed=30)
        A.uid.reset()
        pred, _ = graph(A, ds)
        wf = A.Workflow().set_result_features(pred).set_input_dataset(ds)
        plan = A.R.FaultPlan().fail_stage_fit(nth=1, transient=False)
        with A.R.installed(plan):
            with pytest.raises(A.R.FatalError, match="injected fit failure") \
                    as ei:
                wf.train()
        return str(ei.value), plan.fired

    got = both(run)
    assert got["port"] == got["jax"]


def test_the_testkit_plan_installs_and_uninstalls():
    """``testkit.fault_plan`` / ``install_faults`` (the port's twin of the
    reference's ``fault_plan`` fixture): the plan is active inside the
    block, fires once on the SanityChecker fit, and is gone after."""
    def run(A, kit):
        plan = kit.fault_plan()
        with kit.install_faults(plan):
            assert A.R.faults.active() is plan
            plan.fail_stage_fit(target="SanityChecker", times=1)
            ds = binary_ds(A, n=60, seed=31)
            A.uid.reset()
            pred, _ = graph(A, ds)
            wf = A.Workflow().set_result_features(pred).set_input_dataset(ds)
            with pytest.raises(A.R.TransientError):
                wf.train()
        assert A.R.faults.active() is None
        return plan.fired

    from transmogrifai_tpu import testkit as jax_testkit

    got = run(api("port"), testkit)
    assert got == run(api("jax"), jax_testkit)
    assert len(got) == 1 and got[0][0] == "fit"


def test_nan_output_in_training_corrupts_the_stage_column():
    """The fit loop consults the plan on every transform's output, as the
    reference's does: a NaN fault on the vectorizer reaches the fitted
    dataset in both packages."""
    def run(A):
        A.uid.reset()
        ds = binary_ds(A, n=60, seed=32)
        resp, preds = A.from_dataset(ds, response="label")
        vec = A.transmogrify(list(preds))
        plan = A.R.FaultPlan().nan_output(vec.name, rows=(0, 3))
        if A.pkg == "jax":
            from transmogrifai_tpu.workflow.fit import fit_and_transform_dag
        else:
            from transmogrifai_tpu_torch.workflow.fit import (
                fit_and_transform_dag,
            )
        with A.R.installed(plan):
            out, _ = fit_and_transform_dag(ds, [vec])
        vals = np.asarray(out[vec.name].values)
        return np.isnan(vals).any(axis=1).tolist(), plan.fired

    got = both(run)
    assert got["port"] == got["jax"]
    assert got["port"][0][:4] == [True, False, False, True]


def test_every_fault_of_the_reference_can_be_scripted():
    """The whole FaultPlan API for scripting faults: the port's plan has
    every public method of the reference's that adds a fault; those of
    the distributed plane raise naming A13, the others return the plan."""
    ref = {m for m in dir(JR.FaultPlan) if not m.startswith("_")}
    port = {m for m in dir(PR.FaultPlan) if not m.startswith("_")}
    #: the queries of the retrain plane (A12); the fleet's and the load
    #: test's (``arrival_multiplier``, ``burst_replica``,
    #: ``replicas_to_kill``, ``replica_partitioned``) are ported with them
    queries = {"corrupts_new_chunk", "begin_retrain", "end_retrain"}
    scripting = {m for m in ref if not m.startswith(("on_", "wants_"))}
    assert scripting - queries <= port
    plan = PR.FaultPlan()
    for call in (lambda: plan.fail_host(1, after_layer=0),
                 lambda: plan.straggle_collective("pxtx")):
        with pytest.raises(NotImplementedError, match="A13"):
            call()
    for call in (plan.crash_after_layer(1), plan.tear_stream_chunk(),
                 plan.corrupt_chunk(), plan.oom_chunk(),
                 plan.crash_after_chunk(0), plan.fail_retrain(),
                 plan.crash_retrain(), plan.corrupt_new_chunk(),
                 plan.drop_heartbeat(1), plan.corrupt_shard(),
                 plan.kill_replica(0), plan.partition_replica(0),
                 plan.burst_arrivals(0.0, 1.0), plan.slow_replica(0),
                 plan.fail_chunk_read()):
        assert call is plan


def test_truncate_file(tmp_path):
    path = tmp_path / "blob"
    path.write_bytes(b"x" * 100)
    PR.FaultPlan.truncate_file(str(path), keep=8)
    assert path.read_bytes() == b"x" * 8


# ----------------------------------------------------------- CV resilience
def _attempts(v) -> list:
    return [{k: a[k] for k in ("modelName", "attempts", "error", "excluded",
                               "fromCheckpoint")}
            for a in v.last_attempt_info]


def test_transient_candidate_retries_then_included():
    """A candidate that fails transiently twice completes with its attempt
    count recorded; a fatally failing one is excluded after zero retries."""
    def run(A):
        x, y = xy()
        v = A.CrossValidator(num_folds=2, seed=9)
        v.retry_policy, clk = fast_policy(A.R, max_attempts=3)
        plan = (A.R.FaultPlan()
                .fail_candidate("LogisticRegression", times=2, transient=True)
                .fail_candidate("RandomForestClassifier", times=1,
                                transient=False))
        candidates = [(A.LR(), GRID), (A.RF(), {"num_trees": [5]})]
        with A.R.installed(plan):
            results = v.validate(candidates, x, y, A.Evaluator())
        return {"attempts": _attempts(v), "sleeps": len(clk.sleeps),
                "names": sorted({r.model_name for r in results}),
                "fired": plan.fired}

    got = both(run)
    assert got["port"] == got["jax"]
    by_name = {a["modelName"]: a for a in got["port"]["attempts"]}
    lr, rf = by_name["LogisticRegression"], by_name["RandomForestClassifier"]
    assert lr["attempts"] == 3 and not lr["excluded"]
    assert rf["excluded"] and "injected" in rf["error"]
    assert rf["attempts"] == 1
    assert got["port"]["names"] == ["LogisticRegression"]
    assert got["port"]["sleeps"] == 2


def test_selector_summary_records_attempts():
    def run(A):
        x, y = xy(seed=4)
        selector = A.Selector(seed=11, models=[(A.LR(), GRID)], num_folds=2)
        selector.validator.retry_policy, _ = fast_policy(A.R, max_attempts=3)
        plan = A.R.FaultPlan().fail_candidate(
            "LogisticRegression", times=1, transient=True)
        with A.R.installed(plan):
            model = selector.fit_arrays(
                x, y, np.ones(len(y), dtype=np.float32))
        return [{k: a[k] for k in ("modelName", "attempts", "excluded")}
                for a in model.summary["candidateAttempts"]]

    got = both(run)
    assert got["port"] == got["jax"]
    assert got["port"][0] == {"modelName": "LogisticRegression",
                              "attempts": 2, "excluded": False}


def test_summary_pretty_shows_retries_and_exclusions():
    def run(A):
        x, y = xy(seed=6)
        selector = A.Selector(
            seed=12, num_folds=2,
            models=[(A.LR(), GRID), (A.RF(), {"num_trees": [5]})])
        selector.validator.retry_policy, _ = fast_policy(A.R, max_attempts=2)
        plan = (A.R.FaultPlan()
                .fail_candidate("LogisticRegression", times=1, transient=True)
                .fail_candidate("RandomForestClassifier", times=1,
                                transient=False))
        with A.R.installed(plan):
            sel_model = selector.fit_arrays(
                x, y, np.ones(len(y), dtype=np.float32))
        wm = A.WorkflowModel(
            result_features=(), raw_features=(),
            fitted={selector.uid: sel_model},
            selector_info={"estimatorUid": selector.uid},
        )
        return [ln for ln in wm.summary_pretty().splitlines()
                if ln.startswith(("Retried", "Excluded"))]

    got = both(run)
    assert got["port"] == got["jax"]
    assert "Retried LogisticRegression: succeeded on attempt 2" in got["port"]
    assert any(ln.startswith("Excluded RandomForestClassifier")
               and "injected" in ln for ln in got["port"])


def test_a_kernel_fault_in_a_candidate_propagates_unretried():
    from transmogrifai_tpu_torch.selector.validators import CrossValidator

    A = api("port")
    x, y = xy(seed=8)
    v = CrossValidator(num_folds=2, seed=9)
    v.retry_policy, clk = fast_policy(PR, max_attempts=3,
                                      classify=lambda e: True)
    calls = []

    def fault(*a, **kw):
        calls.append(1)
        raise KernelLaunchError("hist kernel launch failed: test")

    v._sweep_family = fault
    with pytest.raises(KernelLaunchError):
        v.validate([(A.LR(), GRID)], x, y, A.Evaluator())
    assert calls == [1] and clk.sleeps == []


# ------------------------------------------------------- persistence atomics
@pytest.fixture(scope="module")
def trained():
    out = {}
    for pkg in PACKAGES:
        A = api(pkg)
        A.uid.reset()
        ds = binary_ds(A, n=120, seed=8)
        pred, _ = graph(A, ds, seed=13)
        model = (A.Workflow().set_result_features(pred)
                 .set_input_dataset(ds).train())
        out[pkg] = (A, ds, pred, model)
    return out


def _load_error(A, path, root) -> str:
    with pytest.raises(A.ModelLoadError) as ei:
        A.WorkflowModel.load(path, **A.dev)
    return str(ei.value).replace(str(root), "<dir>")


def test_save_leaves_no_temp_dirs(trained, tmp_path):
    for pkg, (A, _, _, model) in trained.items():
        root = tmp_path / pkg
        root.mkdir()
        model.save(str(root / "model"))
        model.save(str(root / "model"))  # overwrite: the same atomic swap
        assert os.listdir(root) == ["model"]
        assert sorted(os.listdir(root / "model")) == [
            "arrays.npz", "manifest.json"]


@pytest.mark.parametrize("damage", ["missing_manifest", "corrupt_arrays",
                                    "missing_member"])
def test_load_names_the_damage_as_the_reference_does(trained, tmp_path,
                                                     damage):
    messages = {}
    for pkg, (A, _, _, model) in trained.items():
        root = tmp_path / pkg
        path = str(root / "model")
        if damage != "missing_manifest":
            model.save(path)
        if damage == "corrupt_arrays":
            A.R.FaultPlan.truncate_file(os.path.join(path, "arrays.npz"),
                                        keep=8)
        elif damage == "missing_member":
            np.savez(os.path.join(path, "arrays.npz"), dummy=np.zeros(1))
        messages[pkg] = _load_error(A, path, root)
    assert messages["port"] == messages["jax"]
    assert {"missing_manifest": "manifest.json",
            "corrupt_arrays": "arrays.npz",
            "missing_member": "missing member"}[damage] in messages["port"]


def test_roundtrip_still_scores_identically(trained, tmp_path):
    for pkg, (A, ds, pred, model) in trained.items():
        path = str(tmp_path / pkg)
        model.save(path)
        loaded = A.WorkflowModel.load(path, **A.dev)
        s1 = model.score(dataset=ds)[pred.name]
        s2 = loaded.score(dataset=ds)[pred.name]
        np.testing.assert_array_equal(
            np.asarray(s1.prediction), np.asarray(s2.prediction))


def test_trained_graphs_carry_equal_profiles(trained):
    profiles = {pkg: t[3].serving_profiles for pkg, t in trained.items()}
    assert profiles["port"] == profiles["jax"]
    assert set(profiles["port"]) == {"x1", "x2"}


# ------------------------------------------------------------- reader retry
def test_transient_reads_retry():
    def run(A):
        ds = binary_ds(A, n=24, seed=19)
        resp, preds = A.from_dataset(ds, response="label")

        class Flaky(A.SimpleReader):
            calls = 0

            def read_records(self):
                Flaky.calls += 1
                if Flaky.calls <= 2:
                    raise A.R.TransientError("blip")
                return self._records

        reader = Flaky(ds.rows())
        reader.retry_policy, clk = fast_policy(A.R, max_attempts=3)
        out = reader.generate_dataset([resp, *preds])
        return out.num_rows, Flaky.calls, clk.sleeps

    got = both(run)
    assert got["port"] == got["jax"] == (24, 3, [1.0, 2.0])


def test_fatal_read_fails_immediately():
    def run(A):
        ds = binary_ds(A, n=8, seed=20)
        resp, preds = A.from_dataset(ds, response="label")

        class Broken(A.SimpleReader):
            def read_records(self):
                raise ValueError("schema mismatch")

        reader = Broken(ds.rows())
        reader.retry_policy, clk = fast_policy(A.R, max_attempts=5)
        with pytest.raises(ValueError, match="schema mismatch"):
            reader.generate_dataset([resp, *preds])
        return clk.sleeps

    got = both(run)
    assert got["port"] == got["jax"] == []


def test_a_kernel_fault_in_a_read_is_not_retried():
    A = api("port")
    ds = binary_ds(A, n=8, seed=21)
    resp, preds = A.from_dataset(ds, response="label")

    class Faulty(A.SimpleReader):
        calls = 0

        def read_records(self):
            Faulty.calls += 1
            raise KernelLaunchError("a launch failed while reading: test")

    reader = Faulty(ds.rows())
    reader.retry_policy, clk = fast_policy(PR, max_attempts=5,
                                           classify=lambda e: True)
    with pytest.raises(KernelLaunchError):
        reader.generate_dataset([resp, *preds])
    assert Faulty.calls == 1 and clk.sleeps == []
