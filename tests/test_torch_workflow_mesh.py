"""``Workflow.set_parallelism(mesh)``: the five contracts of
``tests/test_workflow_mesh.py``, on a ``testkit.random_dataset`` table
(``torch_fixtures/parallel_cases.workflow_table``; the reference's
Titanic and iris files are absent), trained over a world of 2 ``gloo``
ranks on the CPU and held against one device at the reference's
tolerances:

* the selector: the same winner; XGBoost fold metrics within rtol 1e-4 /
  atol 1e-6, the logistic ones within 1e-3; holdout AuPR within 1e-4;
  probabilities within rtol 1e-3 / atol 1e-5;
* the raw feature filter's blocklist and the sanity checker's kept
  columns equal, the holdout AuPR within 1e-3;
* multiclass (logistic and a forest, one class at a time under the mesh):
  the same winner, fold metrics and holdout F1 within 1e-3;
* the MLP's data-parallel fit: probabilities within rtol 1e-3 / atol
  1e-4, predictions agreeing on more than 99.5% of the rows;
* scoring a single-device model under the mesh changes nothing (rtol
  1e-5 / atol 1e-7).

The port's two-rank drift from one device is also held against the JAX
package's own: its selector contract trained under ``make_mesh(n_data=2)``
against one device on the same table. A mesh of one rank trains the same
bits as no mesh, both ranks return the same model, and their tapes are
identical."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_fixtures"))
import parallel_cases as C  # noqa: E402
import world  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return world.run_world(2, "parallel_cases:workflow_contracts", (),
                           tmp_path_factory.mktemp("wf"))


@pytest.fixture(scope="module")
def one():
    return C.workflow_contracts(world=False)


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def test_selector_output_matches_one_device(one, two):
    s1, s2 = one["selector"], two[0][0]["selector"]
    assert s1["bestModelName"] == s2["bestModelName"]
    for r1, r2 in zip(s1["validationResults"], s2["validationResults"]):
        assert r1["modelName"] == r2["modelName"] and r1["grid"] == r2["grid"]
        if r1["modelName"] == "XGBoostClassifier":
            _close(r1["metricValues"], r2["metricValues"], 1e-4, 1e-6)
        else:
            _close(r1["metricValues"], r2["metricValues"], 1e-3, 1e-3)
    _close(s1["holdoutEvaluation"]["AuPR"], s2["holdoutEvaluation"]["AuPR"],
           1e-4, 0)
    _close(one["selector_probs"], two[0][0]["selector_probs"], 1e-3, 1e-5)


@pytest.fixture(scope="module")
def jax_selector():
    """The JAX package's selector contract on the same table, on one
    device and under ``make_mesh(n_data=2)``."""
    return {n: C.jax_selector_contract(n) for n in (None, 2)}


def test_selector_drift_is_the_jax_packages_own(one, two, jax_selector):
    """The port's two-rank selector lies no further from its one-device
    run than the JAX package's two-shard run lies from its own: fold
    metrics family by family and the probabilities, within twice the JAX
    package's distance plus 1e-6; the winners agree in both."""
    j1, j2 = jax_selector[None], jax_selector[2]
    p1, p2 = one, two[0][0]
    assert j1["selector"]["bestModelName"] == j2["selector"]["bestModelName"]
    assert p1["selector"]["bestModelName"] == p2["selector"]["bestModelName"]

    def fold_drift(a, b):
        out = {}
        for r1, r2 in zip(a["validationResults"], b["validationResults"]):
            err = np.abs(np.subtract(r1["metricValues"],
                                     r2["metricValues"])).max()
            out[r1["modelName"]] = max(out.get(r1["modelName"], 0.0), err)
        return out

    port = fold_drift(p1["selector"], p2["selector"])
    jax = fold_drift(j1["selector"], j2["selector"])
    for family, err in port.items():
        assert err <= 2 * jax[family] + 1e-6, (family, err, jax[family])
    port_p = np.abs(p1["selector_probs"] - p2["selector_probs"]).max()
    jax_p = np.abs(j1["selector_probs"] - j2["selector_probs"]).max()
    assert port_p <= 2 * jax_p + 1e-6, (port_p, jax_p)


def test_rff_and_sanity_drop_decisions_match(one, two):
    r1, r2 = one["rff"], two[0][0]["rff"]
    assert r1["blocklist"] == r2["blocklist"] == ["sparse"]
    assert r1["kept"] == r2["kept"]
    _close(r1["summary"]["holdoutEvaluation"]["AuPR"],
           r2["summary"]["holdoutEvaluation"]["AuPR"], 1e-3, 0)


def test_multiclass_selector_matches_one_device(one, two):
    s1, s2 = one["multiclass"], two[0][0]["multiclass"]
    assert s1["bestModelName"] == s2["bestModelName"]
    names = [r["modelName"] for r in s1["validationResults"]]
    assert "RandomForestClassifier" in names  # the family is not dropped
    for r1, r2 in zip(s1["validationResults"], s2["validationResults"]):
        assert r1["modelName"] == r2["modelName"] and r1["grid"] == r2["grid"]
        _close(r1["metricValues"], r2["metricValues"], 1e-3, 1e-3)
    _close(s1["holdoutEvaluation"]["F1"], s2["holdoutEvaluation"]["F1"],
           1e-3, 0)


def test_mlp_fit_matches_one_device(one, two):
    p1, prob1 = one["mlp"]
    p2, prob2 = two[0][0]["mlp"]
    _close(prob1, prob2, 1e-3, 1e-4)
    assert (p1 == p2).mean() > 0.995


def test_scoring_path_unchanged_under_the_mesh(two):
    single, meshed = two[0][0]["scoring"]
    _close(single, meshed, 1e-5, 1e-7)


def test_ranks_return_the_same_model_with_identical_tapes(two):
    (r0, t0), (r1, t1) = two
    np.testing.assert_array_equal(r0["selector_probs"], r1["selector_probs"])
    np.testing.assert_array_equal(r0["mlp"][1], r1["mlp"][1])
    assert r0["selector"]["validationResults"] == \
        r1["selector"]["validationResults"]
    assert t0["hosts"]["0"] == t1["hosts"]["1"]
    names = {name for _, name in t0["hosts"]["0"]}
    # the GLM sweep's (whose extra lane is the winner's refit), the
    # trees' and the MLP's collectives are all taped
    glm = ("glm_count", "glm_shift", "glm_moments", "glm_range", "glm_loss",
           "glm_grad", "glm_grad_sum")
    assert {f"sweep_logistic_binary_sharded/{g}" for g in glm} <= names
    assert {"sweep_logistic_multinomial_sharded/glm_grad", "tree_histogram",
            "tree_occupancy", "tree_leaf_sums", "tree_rows", "mlp_count",
            "mlp_loss", "mlp_grad"} <= names


def test_mesh_of_one_trains_the_same_bits(one):
    got = C.workflow_contracts(world=True)  # no process group: one rank
    np.testing.assert_array_equal(got["selector_probs"],
                                  one["selector_probs"])
    assert got["selector"]["validationResults"] == \
        one["selector"]["validationResults"]
    assert got["multiclass"]["validationResults"] == \
        one["multiclass"]["validationResults"]
    assert got["rff"]["kept"] == one["rff"]["kept"]
    np.testing.assert_array_equal(got["mlp"][1], one["mlp"][1])


def test_set_parallelism_takes_a_mesh():
    from transmogrifai_tpu_torch.parallel import make_mesh
    from transmogrifai_tpu_torch.workflow.workflow import Workflow

    wf = Workflow()
    mesh = make_mesh(n_data=1, device="cpu")
    assert wf.set_parallelism(mesh) is wf and wf._resolve_mesh() is mesh
    assert wf.set_parallelism(None)._resolve_mesh() is None
    # "auto" in a world of one is one device
    assert wf.set_parallelism("auto")._resolve_mesh() is None
    with pytest.raises(TypeError, match="Mesh"):
        wf.set_parallelism(object())


def test_make_mesh_never_falls_back_to_the_cpu(monkeypatch):
    """With no card, ``make_mesh()`` raises (``resolve_device``'s
    contract) instead of computing on the CPU unasked; the CPU is used
    only when named."""
    from transmogrifai_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(n_data=1)
    assert make_mesh(n_data=1, device="cpu").device == torch.device("cpu")
