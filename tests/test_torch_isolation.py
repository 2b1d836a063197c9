"""The PyTorch port stands alone: it imports neither JAX nor any module of
the JAX package ``transmogrifai_tpu`` (whose name is a prefix of the port's,
so every check matches the module name exactly or with a trailing dot), and
its entry points refuse to run on the CPU unless asked to."""
import ast
import os
import subprocess
import sys

import pytest
import torch

from transmogrifai_tpu_torch.features import FeatureBuilder
from transmogrifai_tpu_torch.local.scoring import score_function
from transmogrifai_tpu_torch.ops.numeric import RealVectorizer
from transmogrifai_tpu_torch.prep import SanityChecker
from transmogrifai_tpu_torch.readers import infer_csv_dataset
from transmogrifai_tpu_torch.workflow.fit import fit_and_transform_dag
from transmogrifai_tpu_torch.workflow.persistence import load_workflow_model

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "transmogrifai_tpu_torch")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_serving", "xgb")
CSV_TWIN = os.path.join(ROOT, "tests", "fixtures", "torch_fit_side",
                        "titanic_twin.csv")
FORBIDDEN = ("jax", "jaxlib", "transmogrifai_tpu")


def _forbidden(module: str) -> bool:
    return any(module == m or module.startswith(m + ".") for m in FORBIDDEN)


def test_forbidden_matcher_is_exact():
    assert _forbidden("transmogrifai_tpu")
    assert _forbidden("transmogrifai_tpu.models.trees")
    assert _forbidden("jax.numpy")
    assert not _forbidden("transmogrifai_tpu_torch")
    assert not _forbidden("transmogrifai_tpu_torch.models")
    assert not _forbidden("jaxtyping_like")


def _imports(path: str) -> list[str]:
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
    return out


#: modules the walk must reach (the training slice's among them)
REQUIRED = (
    "models/hist.py", "models/trees.py", "models/gbdt.py", "models/base.py",
    "models/serve_trees.py", "models/tree_sum.py", "models/solvers.py",
    "models/logistic.py", "models/linear.py", "compiler/bucketing.py",
    "stages/base.py", "utils/prng.py", "utils/cuda_build.py",
    "dsl.py", "features/builder.py", "readers/core.py", "readers/csv.py",
    "ops/defaults.py", "ops/text.py", "ops/transmogrify.py",
    "utils/text.py", "utils/stats.py", "prep/sanity_checker.py",
    "workflow/fit.py",
    "evaluators/base.py", "evaluators/binary.py", "evaluators/regression.py",
    "evaluators/multiclass.py", "evaluators/binscore.py",
    "evaluators/forecast.py", "prep/splitters.py", "utils/table.py",
    "selector/validators.py", "selector/model_selector.py",
    "workflow/workflow.py", "workflow/cv.py", "workflow/persistence.py",
    "workflow/dag.py", "compiler/fused.py", "compiler/dispatch.py",
    "featurize/quantize.py", "local/scoring.py",
    "testkit.py", "ops/categorical.py", "ops/dates.py", "ops/time_period.py",
    "ops/phone.py", "ops/lists.py", "ops/domains.py", "ops/maps.py",
    "utils/serial.py", "ops/math.py", "ops/scalers.py", "ops/bucketizers.py",
    "ops/simple.py", "ops/prediction.py", "prep/raw_feature_filter.py",
    "native.py", "featurize/stats.py", "featurize/interning.py",
    "featurize/kernels.py", "featurize/parallel.py", "featurize/engine.py",
    "ops/text_stages.py",
    "utils/streaming_histogram.py", "analysis/schedule.py",
    "telemetry/metrics.py", "telemetry/spans.py", "telemetry/events.py",
    "telemetry/runlog.py", "resilience/retry.py", "resilience/faults.py",
    "resilience/guards.py", "resilience/sentinel.py", "serving/deadline.py",
    "serving/shedding.py", "analysis/findings.py", "insights/ledger.py",
    "telemetry/export.py", "resilience/distributed.py", "serving/queue.py",
    "serving/batcher.py", "serving/service.py", "serving/router.py",
    "serving/fleet.py", "serving/registry.py", "serving/loadtest.py",
    "models/naive_bayes.py", "models/svc.py", "models/glm.py",
    "models/isotonic.py", "models/mlp.py", "selector/combiner.py",
    "insights/loco.py", "insights/correlation.py",
    "insights/model_insights.py", "insights/drift.py",
)


def test_no_source_file_imports_jax_or_the_jax_package():
    files = [os.path.join(ROOT, name) for name in ("chip_smoke.py", "chip_ab.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    walked = {os.path.relpath(f, PORT) for f in files}
    assert set(REQUIRED) <= walked
    bad = {
        os.path.relpath(f, ROOT): [m for m in _imports(f) if _forbidden(m)]
        for f in files
    }
    assert {f: m for f, m in bad.items() if m} == {}


_BLOCKED_RUN = f"""
import sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None  # any import of it now raises ImportError
import transmogrifai_tpu_torch
from transmogrifai_tpu_torch import load_workflow_model, score_function
import json
with open({os.path.join(FIXTURE, "rows.json")!r}) as fh:
    rows = json.load(fh)
fn = score_function(load_workflow_model({FIXTURE!r}, device="cpu"), device="cpu")
out = fn.batch(rows[:8])
from transmogrifai_tpu_torch import testkit
from transmogrifai_tpu_torch.serving import deadline, shedding
plan = testkit.fault_plan().malform_row("age", rows=(1,)).shift_feature(
    "fare", 50.0)
with testkit.install_faults(plan), deadline.active(
        deadline.DeadlineBudget(60.0)):
    fn.batch(rows[:8])
md = fn.metadata()
assert [r.index for r in fn.quarantine.last] == [1]
assert md["drift"]["enabled"] and md["quarantine"]["quarantinedRows"] == 1
assert not shedding.drift_shed()
from transmogrifai_tpu_torch.serving import (
    FleetConfig, FleetService, ModelRegistry, ScoringService, ServiceConfig,
    run_fleet_loadtest, run_loadtest,
)
from transmogrifai_tpu_torch.telemetry import render_prometheus
svc = ScoringService(fn, ServiceConfig(workers=0)).start(wait_warmup=True)
handles = [svc.submit(r) for r in rows[:8]]
while svc.pump():
    pass
svc.stop()
assert [h.result(1)[0] for h in handles] == fn.batch(rows[:8])
fleet = FleetService(fn, FleetConfig(replicas=2, service=ServiceConfig(
    workers=0))).start()
ModelRegistry(fleet)
fleet.submit(rows[0])
fleet.pump_until_quiet()
fleet.stop()
assert fleet.reconcile()["reconciled"]
assert run_loadtest(fn, rows, rate=100.0, duration=0.1,
                    service_time=lambda n: 0.001)["reconciled"]
assert run_fleet_loadtest(fn, rows, rate=100.0, duration=0.1,
                          service_time=lambda n: 0.001)["reconciled"]
assert "tptpu_service_admitted" in render_prometheus()
import os
os.environ["TPTPU_HOST_PREDICT_MAX"] = "0"
quantized = score_function(load_workflow_model({FIXTURE!r}, device="cpu"),
                           device="cpu", quantized=True)
assert len(quantized.batch(rows[:8])) == 8
assert quantized.metadata()["fused"]["dispatches"] == 1
del os.environ["TPTPU_HOST_PREDICT_MAX"]
import numpy as np
from transmogrifai_tpu_torch.models.gbdt import (
    RandomForestClassifier, XGBoostClassifier,
)
rng = np.random.default_rng(0)
x = rng.normal(size=(120, 4)).astype(np.float32)
y = (x[:, 0] > 0).astype(np.float32)
mask = np.ones(120, np.float32)
XGBoostClassifier(num_round=2, max_depth=2, device="cpu").fit_arrays(x, y, mask)
RandomForestClassifier(num_trees=2, max_depth=2, device="cpu").fit_arrays(x, y, mask)
from transmogrifai_tpu_torch.models.linear import LinearRegression
from transmogrifai_tpu_torch.models.logistic import LogisticRegression
LogisticRegression(max_iter=5, device="cpu").fit_arrays(x, y, mask)
LinearRegression(max_iter=5, device="cpu").fit_arrays(x, x[:, 1], mask)
from transmogrifai_tpu_torch.models.glm import GeneralizedLinearRegression
from transmogrifai_tpu_torch.models.mlp import MLPClassifier
from transmogrifai_tpu_torch.models.naive_bayes import NaiveBayes
from transmogrifai_tpu_torch.models.svc import LinearSVC
NaiveBayes(device="cpu").fit_arrays(np.abs(x), y, mask)
LinearSVC(max_iter=2, device="cpu").fit_arrays(x, y, mask)
GeneralizedLinearRegression("poisson", max_iter=2, device="cpu").fit_arrays(
    x, np.abs(x[:, 1]), mask)
MLPClassifier(hidden_layers=(3,), max_iter=2, device="cpu").fit_arrays(x, y, mask)
assert all(len(r["attributions"]) == 2 for r in fn.batch(rows[:4], explain=2))
from transmogrifai_tpu_torch.models.gbdt import (
    DecisionTreeClassifier, DecisionTreeRegressor, GBTClassifier,
)
y3 = np.digitize(x[:, 0], [-0.5, 0.5]).astype(np.float32)
for est in (XGBoostClassifier(num_round=2, max_depth=2, device="cpu"),
            RandomForestClassifier(num_trees=2, max_depth=2, device="cpu"),
            GBTClassifier(max_iter=2, max_depth=2, device="cpu"),
            DecisionTreeClassifier(max_depth=2, device="cpu"),
            LogisticRegression(max_iter=5, device="cpu")):
    assert est.fit_arrays(x, y3, mask).predict_arrays(x)[1].shape == (120, 3)
DecisionTreeRegressor(max_depth=2, device="cpu").fit_arrays(x, x[:, 1], mask)
from transmogrifai_tpu_torch.ops.text_stages import OpIndexToString, OpStringIndexer
from transmogrifai_tpu_torch.features import from_dataset
from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
from transmogrifai_tpu_torch.readers import infer_csv_dataset
from transmogrifai_tpu_torch.workflow.fit import fit_and_transform_dag
ds = infer_csv_dataset({CSV_TWIN!r})
resp, preds = from_dataset(ds, response="survived")
checked = resp.sanity_check(transmogrify(preds), remove_bad_features=True,
                            device="cpu")
fit_and_transform_dag(ds, [checked])
import tempfile
from transmogrifai_tpu_torch.selector import BinaryClassificationModelSelector
from transmogrifai_tpu_torch.workflow.workflow import Workflow
selector = BinaryClassificationModelSelector(models=[
    (LogisticRegression(device="cpu"), {{"reg_param": [0.1], "max_iter": [5]}}),
    (XGBoostClassifier(device="cpu"), {{"num_round": [2], "max_depth": [2]}}),
])
pred = selector.set_input(resp, checked).get_output()
model = Workflow().set_result_features(pred).set_input_dataset(ds).train()
with tempfile.TemporaryDirectory() as tmp:
    model.save(tmp + "/m")
    load_workflow_model(tmp + "/m", device="cpu").score(ds)
model.summary_pretty()
loaded = sorted(
    m for m in sys.modules
    if any(m == b or m.startswith(b + ".") for b in {FORBIDDEN!r})
    and sys.modules[m] is not None
)
print(len(out), loaded)
"""


def test_port_imports_and_scores_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "8 []"


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_workflow_model(FIXTURE)
    model = load_workflow_model(FIXTURE, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        score_function(model)


def test_sanity_checker_needs_a_card_unless_asked_for_the_cpu():
    """``SanityChecker(device=None)`` fits on the card; with no card it
    raises and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    ds = infer_csv_dataset(CSV_TWIN)
    label = FeatureBuilder.RealNN("survived").as_response()
    vec = FeatureBuilder.Real("age").as_predictor().transform_with(
        RealVectorizer())
    checked = label.sanity_check(vec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_and_transform_dag(ds, [checked])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SanityChecker().set_input(label, vec).fit(
            fit_and_transform_dag(ds, [vec])[0])


def _code_strings(path: str) -> list[str]:
    """The string constants of a module, its docstrings left out."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    getattr(body[0], "value", None), ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_native_loader_never_runs_make_or_writes_under_native():
    """The port's loader for ``native/tptpu_native.cpp`` compiles into the
    package's ``_build/`` with the compiler itself: no ``make``, no
    ``Makefile``, and nothing under ``native/`` but the source it reads
    (the JAX package's ``native/libtptpu.so`` is never loaded or
    rebuilt)."""
    from transmogrifai_tpu_torch import native

    strings = _code_strings(os.path.join(PORT, "native.py"))
    assert strings, "the loader's source has no string constants"
    for s in strings:
        assert s != "make" and "Makefile" not in s and "libtptpu.so" not in s, s
    native_dir = os.path.join(ROOT, "native")
    assert os.path.dirname(native.SOURCE) == native_dir
    assert native.BUILD_DIR == os.path.join(PORT, "_build")
    assert os.path.dirname(native.library_path()) == native.BUILD_DIR
    assert native.COMPILER == "g++"
    assert native.CXX_FLAGS == ("-O3", "-fPIC", "-shared", "-std=c++17")
