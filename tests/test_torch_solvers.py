"""The PyTorch port's GLM solvers (``transmogrifai_tpu_torch.models.
solvers``) against the JAX package's ``models/solvers.py``: the same numpy
inputs through both, on the CPU.

What is exact: the masked min/max and the constant-column gate built on
it (min and max are exact under any order), ``_soft_threshold`` with
``sign(0) == 0``, and the lane-buckets' padding.

What is held to a tolerance: the fits. Their products are float32 GEMMs,
reduced by XLA's CPU dot on one side and by torch's CPU BLAS on the other,
whose blockings cannot be mirrored, so the objectives differ in the last
ulps. Linear lanes (FISTA, a fixed step, no decisions) reach the
reference's sharded-versus-single bound ``LINEAR_TOL`` (atol 2e-6, rtol
1e-5, ``tests/test_sweep_sharded.py``). Logistic lanes run OWL-QN, whose
line search is discontinuous: one flipped Armijo test changes a lane's
path, and a lane that is not fully converged after its iterations stops
elsewhere on a flat objective. Measured over this module's cases (jax
0.9.0, torch 2.13 CPU): weights up to 3.0e-3 apart, intercepts 2.4e-3
(large-mean columns aside, where the intercept carries 2000 x the weight
difference: 8.6e-4 relative), final objectives within 1.1e-6 relative of
each other and held-out probabilities within 1.4e-3. ``LOGISTIC_TOL`` is the reference's
own batched-versus-sequential bound (rtol = atol = 0.02,
``tests/test_logistic_batched.py``), under 10x the measured weights'
difference; the objectives are held to ``OBJECTIVE_RTOL`` and the
held-out probabilities to ``HELDOUT_PROB_ATOL``, 10x their measured
maxima.

Two ill-conditioned combinations are left out of the lane comparisons: a
mean-2000 column fitted without standardization, or without an
intercept. After 100 iterations those fits are far from converged, and the
reference's own batched and sequential solvers disagree there by 1.62 and
0.73 in the weights (measured), so no bound of 0.02 holds for any pair.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transmogrifai_tpu.compiler import bucketing as JB
from transmogrifai_tpu.models import solvers as JS
from transmogrifai_tpu_torch.compiler import bucketing as PB
from transmogrifai_tpu_torch.models import solvers as PS

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

LINEAR_TOL = dict(rtol=1e-5, atol=2e-6)
LOGISTIC_TOL = dict(rtol=0.02, atol=0.02)
OBJECTIVE_RTOL = 1.1e-5
HELDOUT_PROB_ATOL = 0.014

REGS = np.array([0.001, 0.01, 0.1, 0.2], np.float32)
ENS = np.array([0.1, 0.5, 0.0, 0.3], np.float32)


def _data(case="plain", seed=0, n=400, d=12):
    """A seeded table: 8 continuous columns and 4 indicators, a noisy
    logistic label and its continuous score. ``large_mean`` shifts column 3
    by 2000 (one-pass variance cancellation); ``fold_const`` makes column 5
    globally constant (4.7) and column 6 zero outside the rows that the
    first mask holds out (constant within that mask only)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, d - 4:] = rng.uniform(size=(n, 4)) < 0.2
    w = rng.normal(size=d).astype(np.float32)
    z = (x @ w + rng.normal(size=n).astype(np.float32)).astype(np.float32)
    if case == "large_mean":
        x[:, 3] += 2000.0
    elif case == "fold_const":
        x[:, 5] = 4.7
        x[np.arange(n) % 3 != 0, 6] = 0.0
    return x, (z > 0).astype(np.float32), z


def _masks(n, k=3):
    return np.stack([(np.arange(n) % 3 != i).astype(np.float32) for i in range(k)])


def _lanes(n):
    """12 lanes: the 3 fold masks x 4 (reg, elastic-net) points."""
    return np.repeat(_masks(n), 4, axis=0), np.tile(REGS, 3), np.tile(ENS, 3)


def _np(params):
    return params.weights.numpy(), params.intercept.numpy()


def _objective(x, y, mask, w, b, reg, en, standardization):
    """The lane's objective in float64 at (w, b), with the l1/l2 terms on
    the standardized weights as the solver defines them."""
    xd = x.astype(np.float64)
    n = mask.sum()
    if standardization:
        mean = (xd * mask[:, None]).sum(0) / n
        std = np.sqrt(((xd - mean) ** 2 * mask[:, None]).sum(0) / n)
        std[std < 1e-9] = 1.0
    else:
        std = np.ones(x.shape[1])
    z = xd @ w.astype(np.float64) + float(b)
    ll = np.logaddexp(z, 0.0) - y * z
    ws = w * std
    return ((ll * mask).sum() / n + 0.5 * reg * (1 - en) * (ws * ws).sum()
            + reg * en * np.abs(ws).sum())


def _assert_logistic_lanes(x, y, rm, regs, ens, jw, jb, pw, pb, standardization):
    np.testing.assert_allclose(pw, jw, **LOGISTIC_TOL)
    np.testing.assert_allclose(pb, jb, **LOGISTIC_TOL)
    for k in range(rm.shape[0]):
        oj = _objective(x, y, rm[k], jw[k], jb[k], regs[k], ens[k], standardization)
        op = _objective(x, y, rm[k], pw[k], pb[k], regs[k], ens[k], standardization)
        assert abs(op - oj) <= OBJECTIVE_RTOL * abs(oj), (k, oj, op)
        held = rm[k] == 0
        xd = x[held].astype(np.float64)
        pj = 1 / (1 + np.exp(-(xd @ jw[k] + jb[k])))
        pp = 1 / (1 + np.exp(-(xd @ pw[k] + pb[k])))
        np.testing.assert_allclose(pp, pj, rtol=0, atol=HELDOUT_PROB_ATOL)


# ---------------------------------------------------------------- exact parts
@pytest.mark.parametrize("case", ["plain", "fold_const", "large_mean"])
def test_masked_minmax_and_constant_gate_equal(case):
    x, _, _ = _data(case)
    x[7, 2] = -np.inf  # extremes pass through unchanged
    rm = _masks(len(x))
    rm[1, :] = 0.0     # an empty mask: every column +-big, hence constant
    jmin, jmax = JS._masked_minmax(jnp.asarray(x), jnp.asarray(rm))
    pmin, pmax = PS._masked_minmax(torch.from_numpy(x), torch.from_numpy(rm))
    assert np.array_equal(pmin.numpy(), np.asarray(jmin))
    assert np.array_equal(pmax.numpy(), np.asarray(jmax))
    assert np.array_equal((pmax <= pmin).numpy(), np.asarray(jmax <= jmin))
    if case == "fold_const":
        const = (pmax <= pmin).numpy()
        assert const[:, 5].all() and const[0, 6] and not const[2, 6]


def test_soft_threshold_and_sign_of_zero_equal():
    w = np.array([-2.0, -0.5, -0.0, 0.0, 0.25, 0.5, 3.0], np.float32)
    t = np.float32(0.5)
    want = np.asarray(JS._soft_threshold(jnp.asarray(w), t))
    got = PS._soft_threshold(torch.from_numpy(w), float(t)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(torch.sign(torch.from_numpy(w)).numpy(),
                          np.asarray(jnp.sign(jnp.asarray(w))))


def test_argmax_over_accepts_takes_the_first_true():
    """The line search takes the largest accepted step: jnp.argmax over a
    boolean axis returns its first True; the port casts to int32, where
    torch.argmax also returns the first maximal index."""
    accept = np.random.default_rng(2).random((7, 40)) < 0.4
    accept[:, 0] = False  # no step accepted: index 0 on both sides
    accept[:, 1] = True
    want = np.asarray(jnp.argmax(jnp.asarray(accept), axis=0))
    got = torch.from_numpy(accept).to(torch.int32).argmax(dim=0).numpy()
    assert np.array_equal(got, want)


def test_owlqn_keeps_the_references_orthant_decisions():
    """The optimizer's branchless control on a separable quadratic with
    per-lane l1 (zero components inside the pseudo-gradient's band, the
    orthant projection, the line search): the same components end at
    exactly 0 on both sides, and the values agree."""
    rng = np.random.default_rng(4)
    k, p = 5, 9
    a = rng.uniform(0.5, 4.0, size=(k, p)).astype(np.float32)
    c = rng.normal(size=(k, p)).astype(np.float32)
    l1 = np.zeros((k, p), np.float32)
    l1[1:, :-1] = np.array([0.1, 0.5, 1.0, 2.0], np.float32)[:, None]
    gamma0 = np.full(k, 0.25, np.float32)

    def run(xp, lib):
        A, C, L = (xp(v) for v in (a, c, l1))

        def value(w):
            return (0.5 * (A * (w - C) ** 2).sum(-1) + (L * lib.abs(w)).sum(-1))

        def value_grad(w):
            return value(w), A * (w - C)

        return value_grad, value

    jvg, jv = run(jnp.asarray, jnp)
    pvg, pv = run(torch.from_numpy, torch)
    for iters in (1, 3, 30):
        jw = np.asarray(JS._lbfgs_owlqn(jvg, jv, jnp.zeros((k, p)), jnp.asarray(l1),
                                        jnp.asarray(gamma0), iters))
        pw = PS._lbfgs_owlqn(pvg, pv, torch.zeros((k, p)), torch.from_numpy(l1),
                             torch.from_numpy(gamma0), iters).numpy()
        assert np.array_equal(pw == 0, jw == 0), iters
        # the trajectories agree to 1.2e-7 for 5 iterations; from the 10th
        # one lane stops 3.3e-5 from the reference's, where the float32
        # objective is flat (XLA contracts w + t*d and the two-loop's
        # updates into fused multiply-adds, torch rounds twice): 10x that
        np.testing.assert_allclose(pw, jw, rtol=0, atol=3.3e-4)
    # the closed form: w* = soft_threshold(c, l1 / a); both sides stop
    # 2.3e-4 from it (measured), where the objective is flat in float32
    want = np.sign(c) * np.maximum(np.abs(c) - l1 / a, 0)
    np.testing.assert_allclose(pw, want, rtol=0, atol=2.3e-3)


@pytest.mark.parametrize("k", [1, 3, 24, 65, 100])
def test_lane_buckets_equal(k, monkeypatch):
    rng = np.random.default_rng(k)
    arrays = (rng.random((k, 5)), rng.random(k), rng.random(k))
    want = JB.pad_lane_arrays(JB.lane_bucket(k), *arrays)
    assert PB.lane_bucket(k) == JB.lane_bucket(k)
    got_k, got = PB.bucket_sweep_lanes(*arrays)
    assert got_k == k and len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    monkeypatch.setenv("TPTPU_LANE_BUCKETS", "0")
    assert PB.lane_bucket(k) == k == JB.lane_bucket(k)


# ------------------------------------------------------------------- linear
@pytest.mark.parametrize("case", ["plain", "fold_const", "large_mean"])
@pytest.mark.parametrize("fit_intercept", [True, False])
def test_fit_linear_batched_matches_reference(case, fit_intercept):
    x, _, z = _data(case)
    rm, regs, ens = _lanes(len(z))
    want = JS.fit_linear_batched(x, z, rm, regs, ens, num_iters=200,
                                 fit_intercept=fit_intercept)
    got = PS.fit_linear_batched(x, z, rm, regs, ens, num_iters=200,
                                fit_intercept=fit_intercept, device="cpu")
    pw, pb = _np(got)
    np.testing.assert_allclose(pw, np.asarray(want.weights), **LINEAR_TOL)
    np.testing.assert_allclose(pb, np.asarray(want.intercept), **LINEAR_TOL)
    if not fit_intercept:
        assert (pb == 0).all()
    if case == "fold_const":
        # lanes 0-3 train on the first mask, where column 6 is constant
        assert (pw[:, 5] == 0).all() and (pw[:4, 6] == 0).all()


@pytest.mark.parametrize("case", ["plain", "fold_const", "large_mean"])
@pytest.mark.parametrize("fit_intercept", [True, False])
def test_fit_linear_matches_reference(case, fit_intercept):
    x, _, z = _data(case)
    mask = _masks(len(z))[1]
    want = JS.fit_linear(x, z, mask, 0.01, 0.3, num_iters=200,
                         fit_intercept=fit_intercept)
    got = PS.fit_linear(x, z, mask, 0.01, 0.3, num_iters=200,
                        fit_intercept=fit_intercept, device="cpu")
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               **LINEAR_TOL)
    np.testing.assert_allclose(float(got.intercept), float(want.intercept),
                               **LINEAR_TOL)


# ----------------------------------------------------------------- logistic
LOGISTIC_CASES = [
    ("plain", {}), ("plain", {"fit_intercept": False}),
    ("plain", {"standardization": False}),
    ("fold_const", {}), ("fold_const", {"fit_intercept": False}),
    ("fold_const", {"standardization": False}),
    ("large_mean", {}),
]


@pytest.mark.parametrize("case,kw", LOGISTIC_CASES)
def test_fit_logistic_binary_batched_matches_reference(case, kw):
    x, y, _ = _data(case)
    rm, regs, ens = _lanes(len(y))
    want = JS.fit_logistic_binary_batched(x, y, rm, regs, ens, num_iters=100, **kw)
    got = PS.fit_logistic_binary_batched(x, y, rm, regs, ens, num_iters=100,
                                         device="cpu", **kw)
    pw, pb = _np(got)
    _assert_logistic_lanes(x, y, rm, regs, ens, np.asarray(want.weights),
                           np.asarray(want.intercept), pw, pb,
                           kw.get("standardization", True))
    if kw.get("fit_intercept") is False:
        assert (pb == 0).all()
    if case == "fold_const" and kw.get("standardization", True):
        assert (np.abs(pw[:, 5]) < 1e-3).all()


@pytest.mark.parametrize("case,kw", LOGISTIC_CASES)
def test_fit_logistic_binary_matches_reference(case, kw):
    x, y, _ = _data(case)
    mask = _masks(len(y))[0]
    want = JS.fit_logistic_binary(x, y, mask, 0.01, 0.3, num_iters=100, **kw)
    got = PS.fit_logistic_binary(x, y, mask, 0.01, 0.3, num_iters=100,
                                 device="cpu", **kw)
    _assert_logistic_lanes(
        x, y, mask[None], np.array([0.01]), np.array([0.3]),
        np.asarray(want.weights)[None], np.asarray(want.intercept)[None],
        got.weights.numpy()[None], got.intercept.numpy()[None],
        kw.get("standardization", True))


def test_single_fit_is_the_batched_fits_lane():
    """fit_logistic_binary runs the K=1 lane of the batched solver, so the
    sweep and a refit of one point run the same math."""
    x, y, _ = _data()
    mask = _masks(len(y))[2]
    one = PS.fit_logistic_binary(x, y, mask, 0.1, 0.5, num_iters=40, device="cpu")
    lane = PS.fit_logistic_binary_batched(
        x, y, mask[None], np.array([0.1], np.float32), np.array([0.5], np.float32),
        num_iters=40, device="cpu")
    assert torch.equal(one.weights, lane.weights[0])
    assert torch.equal(one.intercept, lane.intercept[0])


def test_fits_are_deterministic():
    x, y, z = _data()
    rm, regs, ens = _lanes(len(y))
    a = PS.fit_logistic_binary_batched(x, y, rm, regs, ens, num_iters=30, device="cpu")
    b = PS.fit_logistic_binary_batched(x, y, rm, regs, ens, num_iters=30, device="cpu")
    assert torch.equal(a.weights, b.weights) and torch.equal(a.intercept, b.intercept)
    a = PS.fit_linear_batched(x, z, rm, regs, ens, num_iters=50, device="cpu")
    b = PS.fit_linear_batched(x, z, rm, regs, ens, num_iters=50, device="cpu")
    assert torch.equal(a.weights, b.weights) and torch.equal(a.intercept, b.intercept)


def test_softplus_is_logaddexp_above_the_torch_threshold():
    """jax.nn.softplus is logaddexp(x, 0) (torch's softplus switches to x
    itself above a threshold of 20); the port's loss takes logaddexp, which
    agrees with jax's softplus across the range."""
    import jax

    v = np.array([-30.0, -1.0, 0.0, 15.0, 20.0, 20.5, 25.0], np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(v)))
    got = torch.logaddexp(torch.from_numpy(v), torch.zeros(())).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


def test_precision_guard_refuses_tf32_for_the_card(monkeypatch):
    """A fit on the card refuses TF32 matmuls; the CPU is not affected."""
    PS._check_precision(torch.device("cpu"))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        PS._check_precision(torch.device("cuda"))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="'high'"):
            PS._check_precision(torch.device("cuda"))
    finally:
        torch.set_float32_matmul_precision(prev)
    PS._check_precision(torch.device("cuda"))
