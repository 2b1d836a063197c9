"""The data- and model-parallel GLM fits (``parallel/fit.py``) over worlds
of 2 and 4 ``gloo`` ranks on the CPU, held to
``tests/test_parallel.py:118-158``: ``data_parallel_fit`` converges to
the single-device optimum (rtol 1e-3 / atol 1e-3), ``grid_parallel_fit``
splits the grid over the model axis (6 points padded onto 2 model ranks,
stronger regularization shrinking the weights).

``sweep_parallel_fit`` is held against the single-device reference: the
batched solver on the same bucketed lanes (the route the estimators take
without a mesh). A mesh of one rank EQUALS it, which is stronger than the
reference's own 1x1 parity (atol 1e-6, ``tests/test_sweep_sharded.py:
117-148``). Across ranks the row sums reassociate: the linear lanes stay
within atol 1e-6, and the logistic lanes, whose 60 L-BFGS steps
(OWL-QN with l1) carry the reassociation along, within the data-parallel
tolerance, atol 1e-3 (measured: at most 4.2e-4). That drift is the JAX
package's own: its sharded sweep at the same layouts drifts as far from
its single-device sweep, and the port's worst drift is held to no more
than twice the JAX package's, fit by fit. Every rank returns the same bits and
the tapes are identical."""
import itertools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_fixtures"))
import parallel_cases as C  # noqa: E402
import world  # noqa: E402

from transmogrifai_tpu_torch.compiler import bucketing  # noqa: E402
from transmogrifai_tpu_torch.models import solvers as S  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: world.run_world(n, "parallel_cases:glm_fits", (),
                               tmp_path_factory.mktemp(f"fit{n}"))
            for n in (2, 4)}


def _single():
    x, y, y_lin, mask = C.glm_data()
    out = {}
    p = S.fit_logistic_binary(x, y, mask, 0.05, 0.0, num_iters=100,
                              device="cpu")
    out["dp_logistic"] = (p.weights.numpy(), p.intercept.numpy())
    p = S.fit_linear(x, y_lin, mask, 0.01, 0.0, num_iters=200, device="cpu")
    out["dp_linear"] = (p.weights.numpy(), p.intercept.numpy())
    masks, regs, ens = C.sweep_lanes(3, len(y))
    k, (rm, regs, ens) = bucketing.bucket_sweep_lanes(masks, regs, ens)
    lin = S.fit_linear_batched(x, y_lin, rm, regs, ens, num_iters=60,
                               fit_intercept=True, device="cpu")
    log = S.fit_logistic_binary_batched(x, y, rm, regs, ens, num_iters=60,
                                        fit_intercept=True,
                                        standardization=True, device="cpu")
    out["sweep"] = tuple(t[:k].numpy() for t in (lin.weights, lin.intercept,
                                                 log.weights, log.intercept))
    return out


@pytest.fixture(scope="module")
def single():
    return _single()


@pytest.mark.parametrize("n", (2, 4))
def test_data_parallel_fit_converges_to_the_single_device_optimum(
        worlds, single, n):
    got = worlds[n][0][0]
    for key in ("dp_logistic", "dp_linear"):
        w, b = got[key]
        assert np.isfinite(w).all()
        np.testing.assert_allclose(w, single[key][0], rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(b, single[key][1], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n", (2, 4))
def test_grid_parallel_fit_splits_the_grid_axis(worlds, n):
    x, y, _, mask = C.glm_data()
    w, b = worlds[n][0][0]["grid"]
    assert w.shape == (6, x.shape[1]) and b.shape == (6,)
    assert np.isfinite(w).all()
    # stronger regularization shrinks weights
    assert np.linalg.norm(w[-1]) < np.linalg.norm(w[0])
    # each point is the fit of that point alone
    regs = np.linspace(0.0, 0.3, 6).astype(np.float32)
    for i in (0, 5):
        ref = S.fit_logistic_binary(x[:64], y[:64], mask[:64], float(regs[i]),
                                    0.0, num_iters=20, device="cpu")
        np.testing.assert_allclose(w[i], ref.weights.numpy(), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("layout", ("data", "grid"))
def test_sweep_parallel_fit_matches_single_device(worlds, single, n, layout):
    lin_w, lin_b, log_w, log_b = worlds[n][0][0][f"sweep_{layout}"]
    want = single["sweep"]
    np.testing.assert_allclose(lin_w, want[0], atol=1e-6)
    np.testing.assert_allclose(lin_b, want[1], atol=1e-6)
    np.testing.assert_allclose(log_w, want[2], atol=1e-3)
    np.testing.assert_allclose(log_b, want[3], atol=1e-3)


def _jax_glm_fits(mesh_data, mesh_grid) -> dict:
    """The JAX package's fits of ``parallel_cases.glm_fits`` on the same
    inputs: sharded over its simulated CPU devices at the given meshes,
    or on one device (``None``)."""
    from transmogrifai_tpu.compiler import bucketing as JB
    from transmogrifai_tpu.models import solvers as JS
    from transmogrifai_tpu.parallel.fit import (
        data_parallel_fit, sweep_parallel_fit,
    )

    x, y, y_lin, mask = C.glm_data()
    masks, regs, ens = C.sweep_lanes(3, len(y))
    out = {}
    for key, fn, yy, args in (
            ("dp_logistic", JS.fit_logistic_binary, y, (0.05, 0.0, 100)),
            ("dp_linear", JS.fit_linear, y_lin, (0.01, 0.0, 200))):
        kw = {"num_iters": args[2]}
        p = (fn(x, yy, mask, *args[:2], **kw) if mesh_data is None else
             data_parallel_fit(fn, mesh_data, x, yy, mask, *args[:2], **kw))
        out[key] = (np.asarray(p.weights), np.asarray(p.intercept))
    if mesh_data is None:
        k, (rm, r2, e2) = JB.bucket_sweep_lanes(masks, regs, ens)
        lin = JS.fit_linear_batched(x, y_lin, rm, r2, e2, num_iters=60,
                                    fit_intercept=True)
        log = JS.fit_logistic_binary_batched(
            x, y, rm, r2, e2, num_iters=60, fit_intercept=True,
            standardization=True)
        out["sweep"] = tuple(np.asarray(t)[:k] for t in (
            lin.weights, lin.intercept, log.weights, log.intercept))
        return out
    for layout, mesh in (("data", mesh_data), ("grid", mesh_grid)):
        lin = sweep_parallel_fit(JS.fit_linear_batched, "t_jax_lin", mesh,
                                 x, y_lin, masks, regs, ens, num_iters=60,
                                 fit_intercept=True)
        log = sweep_parallel_fit(JS.fit_logistic_binary_batched, "t_jax_log",
                                 mesh, x, y, masks, regs, ens, num_iters=60,
                                 fit_intercept=True, standardization=True)
        out[f"sweep_{layout}"] = tuple(np.asarray(t) for t in (
            lin.weights, lin.intercept, log.weights, log.intercept))
    return out


@pytest.fixture(scope="module")
def jax_fits():
    """{None: one device, n: the JAX package's fits at the n-rank world's
    layouts: (n, 1) for the data-parallel fits and the data sweep, (n/2, 2)
    for the grid sweep}."""
    from transmogrifai_tpu.parallel import make_mesh

    out = {None: _jax_glm_fits(None, None)}
    for n in (2, 4):
        out[n] = _jax_glm_fits(make_mesh(n_data=n, n_model=1),
                               make_mesh(n_data=n // 2, n_model=2))
    return out


#: fit -> (worlds' key, single-device key, indices of its arrays)
DRIFT_FITS = {
    "dp_logistic": (("dp_logistic",), "dp_logistic", (0, 1)),
    "dp_linear": (("dp_linear",), "dp_linear", (0, 1)),
    "sweep_linear": (("sweep_data", "sweep_grid"), "sweep", (0, 1)),
    "sweep_logistic": (("sweep_data", "sweep_grid"), "sweep", (2, 3)),
}


@pytest.mark.parametrize("fit", sorted(DRIFT_FITS))
def test_sharding_drift_is_the_jax_packages_own(worlds, single, jax_fits,
                                                fit):
    """Sharding reassociates the sums over rows (and splitting lanes
    changes the products' shapes); the iterative fits carry that along.
    Over the layouts of worlds 2 and 4, the port's worst distance from its
    single-device fit is no more than twice the JAX package's worst
    distance from its own at the same layouts, plus 1e-6 for a float32
    rounding of the result. The data-parallel fits drift by about 1e-7
    in both packages; the unconverged logistic sweep lanes (60 OWL-QN
    steps on separable data) by about 4e-4 in both."""
    keys, base, idx = DRIFT_FITS[fit]
    port, jax = [], []
    for n in (2, 4):
        got = worlds[n][0][0]
        for key in keys:
            for i in idx:
                port.append(np.abs(got[key][i] - single[base][i]).max())
                jax.append(np.abs(jax_fits[n][key][i]
                                  - jax_fits[None][base][i]).max())
    assert max(port) <= 2 * max(jax) + 1e-6, (max(port), max(jax))


def test_mesh_of_one_equals_single_device(single):
    got = C.glm_fits()  # no process group: a world of one
    for key in ("dp_logistic", "dp_linear"):
        for a, b in zip(got[key], single[key]):
            np.testing.assert_array_equal(a, b)
    for layout in ("data", "grid"):
        for a, b in zip(got[f"sweep_{layout}"], single["sweep"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", (2, 4))
def test_ranks_agree_bit_for_bit_with_identical_tapes(worlds, n):
    (first, tapes0), *rest = worlds[n]
    for rank, (got, tapes) in enumerate(worlds[n]):
        for key in first:
            for a, b in zip(got[key], first[key]):
                np.testing.assert_array_equal(a, b)
        assert tapes["hosts"][str(rank)] == tapes0["hosts"]["0"]
    names = [name for _, name in tapes0["hosts"]["0"]]
    # each fit's collectives are taped in its scope: the data-parallel
    # logistic and linear fits, the grid, then the two sweeps per layout
    scopes = [k for k, _ in itertools.groupby(m.split("/")[0] for m in names)]
    assert scopes == ["fit_logistic_binary", "fit_linear",
                      "fit_logistic_binary", "t_sweep_lin", "t_sweep_log",
                      "t_sweep_lin", "t_sweep_log"]
    # every sum of the solvers is taped, and the model axis's lane gathers
    assert {"fit_logistic_binary/glm_count", "fit_logistic_binary/glm_shift",
            "fit_logistic_binary/glm_moments",
            "fit_logistic_binary/glm_range", "fit_logistic_binary/glm_loss",
            "fit_logistic_binary/glm_grad", "fit_logistic_binary/fit_lanes",
            "fit_linear/glm_grad", "fit_linear/glm_lipschitz",
            "t_sweep_lin/glm_grad", "t_sweep_log/glm_loss",
            "t_sweep_log/fit_lanes"} <= set(names)
