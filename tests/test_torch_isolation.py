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

from transmogrifai_tpu_torch.local.scoring import score_function
from transmogrifai_tpu_torch.workflow.persistence import load_workflow_model

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "transmogrifai_tpu_torch")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_serving", "xgb")
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
    "models/serve_trees.py", "stages/base.py", "utils/prng.py",
    "utils/cuda_build.py",
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
