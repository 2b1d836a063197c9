"""The port's other model families (``transmogrifai_tpu_torch.models.{
naive_bayes,svc,glm,isotonic,mlp}`` and ``utils.prng.normal``) against the
JAX package's: the same numpy-seeded inputs through both, on the CPU.

Tolerances, each measured first on these cases (jax 0.9.0, torch 2.13
CPU) and stated:

* ``NB_RTOL`` = 1e-6 on ``pi`` and ``theta`` (measured 2.3e-7: float32
  logs), predictions EQUAL where the probabilities are not tied;
* ``LINEAR_RTOL`` = 1e-4 on the SVC's and the GLR's weights and intercept,
  relative to the largest |w| (measured: 7.6e-6 SVC, 1.2e-5 GLR; the
  products block differently and the IRLS solves are LAPACK's against
  XLA's);
* isotonic boundaries and predictions EQUAL (host numpy in both);
* ``prng.normal`` EQUAL to ``jax.random.normal``, and the MLP's initial
  parameters EQUAL to the reference's jitted ``_init_params``;
* ``MLP_PROB_ATOL`` = 1e-4 on the MLP's probabilities after ``max_iter``
  Adam steps (measured 1.1e-7) and ``MLP_LOSS_RTOL`` = 1e-5 on its
  ``finalLoss`` (measured 1.1e-7); in float32 the losses' relative gap
  stays at or below 2.3e-7 at every one of the 100 steps. With
  ``compute_dtype="bfloat16"``, ``MLP_BF16_ATOL`` = 5e-3 on the
  probabilities and ``MLP_BF16_LOSS_RTOL`` = 1e-3 on the loss: a bfloat16
  ulp is 2^-8 relative, so operands one float32 ulp apart in the two
  packages can round to neighbouring bfloat16 values, and Adam carries the
  step on. Measured with two hidden layers: the losses' relative gap is 0
  to step 10, 4.7e-5 at step 50, at most 5.3e-4 over the 100 steps and
  8.0e-5 at the last, the probabilities 5.0e-4 apart (one hidden layer:
  7.4e-6 and 8.7e-6).
"""
import numpy as np
import pytest
import torch

import jax

from transmogrifai_tpu.models import glm as JG
from transmogrifai_tpu.models import isotonic as JI
from transmogrifai_tpu.models import mlp as JM
from transmogrifai_tpu.models import naive_bayes as JN
from transmogrifai_tpu.models import svc as JS
from transmogrifai_tpu_torch.models import glm as PG
from transmogrifai_tpu_torch.models import isotonic as PI
from transmogrifai_tpu_torch.models import mlp as PM
from transmogrifai_tpu_torch.models import naive_bayes as PN
from transmogrifai_tpu_torch.models import solvers as PSOL
from transmogrifai_tpu_torch.models import svc as PS
from transmogrifai_tpu_torch.utils import prng

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

NB_RTOL = 1e-6
LINEAR_RTOL = 1e-4
MLP_PROB_ATOL = 1e-4
MLP_LOSS_RTOL = 1e-5
MLP_BF16_ATOL = 5e-3
MLP_BF16_LOSS_RTOL = 1e-3


def _glm_data(seed=3, n=3000, d=3):
    """``tests/test_models_extra.py``'s GLR table, with every seventh row
    masked out."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * 0.3).astype(np.float32)
    eta = x @ np.array([0.5, -0.4, 0.3]) + 0.2
    ys = {
        "gaussian": eta + rng.normal(scale=0.05, size=n),
        "poisson": rng.poisson(np.exp(eta)).astype(np.float64),
        "gamma": rng.gamma(shape=20.0, scale=np.exp(eta) / 20.0),
        "binomial": (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(np.float64),
    }
    mask = np.ones(n, np.float32)
    mask[::7] = 0
    return x, {k: v.astype(np.float32) for k, v in ys.items()}, mask, eta


def _close_linear(jm, pm):
    scale = np.abs(jm.weights).max()
    np.testing.assert_allclose(pm.weights, jm.weights, rtol=0,
                               atol=LINEAR_RTOL * scale)
    assert abs(pm.intercept - jm.intercept) <= LINEAR_RTOL * scale


# ------------------------------------------------------------ naive Bayes
@pytest.mark.parametrize("kind", ["multinomial", "bernoulli"])
@pytest.mark.parametrize("smoothing", [1.0, 0.5])
def test_naive_bayes_matches_the_reference(kind, smoothing):
    rng = np.random.default_rng(4)
    x = rng.poisson(2.0, size=(500, 8)).astype(np.float32)
    y = rng.integers(0, 3, 500).astype(np.float32)
    mask = (rng.random(500) > 0.2).astype(np.float32)
    jm = JN.NaiveBayes(smoothing, kind).fit_arrays(x, y, mask)
    pm = PN.NaiveBayes(smoothing, kind, device="cpu").fit_arrays(x, y, mask)
    np.testing.assert_allclose(pm.pi, jm.pi, rtol=NB_RTOL)
    np.testing.assert_allclose(pm.theta, jm.theta, rtol=NB_RTOL)
    jp, jprob, _ = jm.predict_arrays(x)
    pp, pprob, _ = pm.predict_arrays(x)
    top2 = np.sort(jprob, axis=1)[:, -2:]
    untied = top2[:, 1] - top2[:, 0] > 1e-9
    np.testing.assert_array_equal(pp[untied], jp[untied])
    np.testing.assert_allclose(pprob, jprob, atol=1e-6)


def test_naive_bayes_refuses_negative_features_like_the_reference():
    x = np.array([[1.0, -0.5], [2.0, 1.0]], np.float32)
    y = np.array([0.0, 1.0], np.float32)
    for est in (JN.NaiveBayes(), PN.NaiveBayes(device="cpu")):
        with pytest.raises(ValueError, match="non-negative"):
            est.fit_arrays(x, y, np.ones(2, np.float32))
    # a negative value in a masked-out row is not seen by either
    mask = np.array([0.0, 1.0], np.float32)
    JN.NaiveBayes().fit_arrays(x, y, mask)
    PN.NaiveBayes(device="cpu").fit_arrays(x, y, mask)


# ------------------------------------------------------------------- SVC
@pytest.mark.parametrize("standardization", [True, False])
@pytest.mark.parametrize("fit_intercept", [True, False])
def test_linear_svc_matches_the_reference(standardization, fit_intercept):
    x, _, mask, eta = _glm_data()
    x = x.copy()
    x[:, 1] += 5.0
    y = (eta > 0.2).astype(np.float32)
    kw = dict(reg_param=0.01, standardization=standardization,
              fit_intercept=fit_intercept)
    jm = JS.LinearSVC(**kw).fit_arrays(x, y, mask)
    pm = PS.LinearSVC(device="cpu", **kw).fit_arrays(x, y, mask)
    _close_linear(jm, pm)
    jp, jprob, jraw = jm.predict_arrays(x)
    pp, pprob, praw = pm.predict_arrays(x)
    assert jprob is None and pprob is None
    margin = np.abs(jraw[:, 1])
    np.testing.assert_array_equal(pp[margin > 1e-3], jp[margin > 1e-3])


def test_linear_svc_keeps_four_steps_per_iteration(monkeypatch):
    seen = []
    real = PSOL._fista

    def spy(grad, prox, w0, step, num_iters):
        seen.append(num_iters)
        return real(grad, prox, w0, step, num_iters)

    monkeypatch.setattr(PSOL, "_fista", spy)
    x, _, mask, eta = _glm_data(n=200)
    PS.LinearSVC(max_iter=7, device="cpu").fit_arrays(
        x, (eta > 0.2).astype(np.float32), mask)
    assert seen == [28]


# ------------------------------------------------------------------- GLR
@pytest.mark.parametrize("family,link", [
    ("gaussian", "identity"), ("poisson", "log"), ("gamma", "log"),
    ("binomial", "logit"), ("gamma", "inverse"), ("gaussian", "log"),
    ("poisson", "sqrt"), ("poisson", "identity"),
])
@pytest.mark.parametrize("reg", [0.0, 0.1])
def test_glm_matches_the_reference(family, link, reg):
    x, ys, mask, _ = _glm_data()
    y = ys[family]
    jm = JG.GeneralizedLinearRegression(family, link, reg).fit_arrays(x, y, mask)
    pm = PG.GeneralizedLinearRegression(family, link, reg, device="cpu"
                                        ).fit_arrays(x, y, mask)
    _close_linear(jm, pm)
    np.testing.assert_allclose(pm.predict_arrays(x)[0], jm.predict_arrays(x)[0],
                               rtol=1e-4, atol=1e-6)


def test_glm_without_intercept_matches_the_reference():
    x, ys, mask, _ = _glm_data()
    kw = dict(family="poisson", fit_intercept=False)
    jm = JG.GeneralizedLinearRegression(**kw).fit_arrays(x, ys["poisson"], mask)
    pm = PG.GeneralizedLinearRegression(device="cpu", **kw).fit_arrays(
        x, ys["poisson"], mask)
    _close_linear(jm, pm)
    assert pm.intercept == 0.0


def test_glm_params_and_canonical_links_match():
    for family in ("gaussian", "binomial", "poisson", "gamma"):
        assert PG.GeneralizedLinearRegression(family).link == \
            JG.GeneralizedLinearRegression(family).link
    est = PG.GeneralizedLinearRegression("gamma", "log")
    assert est.with_params(family="poisson").link == "log"
    assert est.with_params(family="poisson", link="sqrt").link == "sqrt"
    assert est.with_params(reg_param=0.1).link == "log"
    assert PSOL.GLM_FAMILIES == JG.GLM_FAMILIES
    assert PSOL.GLM_LINKS == JG.GLM_LINKS
    assert PSOL.GLM_DEFAULT_LINK == JG.GLM_DEFAULT_LINK
    with pytest.raises(ValueError):
        PG.GeneralizedLinearRegression("tweedie")


def test_glm_fused_spec_is_the_float32_core():
    x, ys, mask, _ = _glm_data(n=300)
    pm = PG.GeneralizedLinearRegression("poisson", device="cpu").fit_arrays(
        x, ys["poisson"], mask)
    spec = pm.fused_predict_spec()
    assert spec.descriptor == "glm:poisson:log"
    core = spec.core(torch.from_numpy(x), {
        k: torch.from_numpy(np.asarray(v)) for k, v in spec.params.items()})
    mu, _, _ = spec.epilogue(core.numpy())
    np.testing.assert_allclose(mu, pm.predict_arrays(x)[0], rtol=1e-6)


# ------------------------------------------------------------- isotonic
@pytest.mark.parametrize("isotonic", [True, False])
def test_isotonic_calibrator_equals_the_reference(isotonic):
    rng = np.random.default_rng(8)
    score = np.round(rng.random(400), 2)
    label = (rng.random(400) < (score if isotonic else 1 - score)).astype(float)
    out = {}
    for pkg, mod, base in (("jax", JI, "transmogrifai_tpu"),
                           ("port", PI, "transmogrifai_tpu_torch")):
        T = __import__(f"{base}.types", fromlist=["x"])
        cols = __import__(f"{base}.types.columns", fromlist=["x"])
        ds_mod = __import__(f"{base}.dataset", fromlist=["x"])
        fb = __import__(f"{base}.features", fromlist=["x"]).FeatureBuilder
        lbl = fb.RealNN("label").as_response()
        sc = fb.RealNN("score").as_predictor()
        est = mod.IsotonicRegressionCalibrator(isotonic=isotonic).set_input(lbl, sc)
        ds = ds_mod.Dataset.of({
            "label": cols.column_from_values(T.RealNN, label.tolist()),
            "score": cols.column_from_values(T.RealNN, score.tolist()),
        })
        m = est.fit(ds)
        col = m.transform(ds)[est.get_output().name]
        out[pkg] = (m.boundaries, m.predictions, np.asarray(col.values),
                    est.metadata["numBoundaries"])
    for a, b in zip(out["jax"], out["port"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------------ prng
@pytest.mark.parametrize("seed", [0, 42, 7, 2**31 + 5])
@pytest.mark.parametrize("shape", [(1,), (5,), (10, 3), (37, 10), (1423, 10),
                                   (6, 8)])
def test_normal_equals_jax(seed, shape):
    jkey = jax.random.split(jax.random.PRNGKey(np.uint32(seed)))[1]
    key = prng.split(prng.prng_key(seed))[1]
    np.testing.assert_array_equal(
        prng.normal(key, shape), np.asarray(jax.random.normal(jkey, shape)))


def test_normal_covers_both_erfinv_branches():
    key = prng.prng_key(9)
    z = prng.normal(key, (200000,))
    np.testing.assert_array_equal(
        z, np.asarray(jax.random.normal(jax.random.PRNGKey(9), (200000,))))
    assert np.abs(z).max() > 3.0  # w >= 5: the tail polynomial


# ------------------------------------------------------------------- MLP
@pytest.mark.parametrize("sizes", [(6, 10, 2), (6, 5, 4, 3), (37, 10, 2)])
def test_mlp_initial_parameters_equal(sizes):
    jp = jax.jit(JM._init_params, static_argnums=1)(jax.random.PRNGKey(42), sizes)
    pp = PM._init_params(42, sizes)
    for a, b in zip(jp, pp):
        np.testing.assert_array_equal(np.asarray(a["w"]), b["w"])
        np.testing.assert_array_equal(np.asarray(a["b"]), b["b"])


def _mlp_data(classes=2):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 6)).astype(np.float32)
    s = x[:, 0] + 0.5 * x[:, 1]
    y = (np.digitize(s, np.quantile(s, np.linspace(0, 1, classes + 1)[1:-1]))
         ).astype(np.float32)
    mask = np.ones(300, np.float32)
    mask[::5] = 0
    return x, y, mask


@pytest.mark.parametrize("compute_dtype,prob_atol,loss_rtol", [
    (None, MLP_PROB_ATOL, MLP_LOSS_RTOL),
    ("bfloat16", MLP_BF16_ATOL, MLP_BF16_LOSS_RTOL),
])
@pytest.mark.parametrize("classes,hidden", [(2, (8,)), (3, (6, 5))])
def test_mlp_matches_the_reference(compute_dtype, prob_atol, loss_rtol,
                                   classes, hidden):
    x, y, mask = _mlp_data(classes)
    kw = dict(hidden_layers=hidden, max_iter=100, compute_dtype=compute_dtype)
    je = JM.MLPClassifier(**kw)
    pe = PM.MLPClassifier(device="cpu", **kw)
    jm, pm = je.fit_arrays(x, y, mask), pe.fit_arrays(x, y, mask)
    _, jprob, _ = jm.predict_arrays(x)
    _, pprob, _ = pm.predict_arrays(x)
    np.testing.assert_allclose(pprob, jprob, rtol=0, atol=prob_atol)
    assert abs(pe.metadata["finalLoss"] - je.metadata["finalLoss"]) <= \
        loss_rtol * je.metadata["finalLoss"]
    assert pm.get_params() == jm.get_params()


def test_mlp_predict_is_full_float32_and_loads():
    x, y, mask = _mlp_data()
    m = PM.MLPClassifier(hidden_layers=(4,), max_iter=5, device="cpu").fit_arrays(
        x, y, mask)
    again = PM.MLPClassifierModel.from_params(m.get_params(), m.get_arrays())
    again.to("cpu")
    for a, b in zip(m.predict_arrays(x), again.predict_arrays(x)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ precision rule
@pytest.mark.parametrize("fit", [
    lambda x, y, m: PSOL.fit_glm_irls(x, y, m, 0.0, device="cuda"),
    lambda x, y, m: PM.train_mlp(x, np.eye(2, dtype=np.float32)[y.astype(int)],
                                 m, (3, 2, 2), 2, 0.01, 0, device="cuda"),
], ids=["irls", "mlp"])
def test_tf32_is_refused_on_the_card(fit, monkeypatch):
    """The IRLS and the MLP run under the GLM fits' TF32 rule: a fit on the
    card refuses to start while TF32 matmuls are on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    x = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="full-float32"):
        fit(x, np.zeros(4, np.float32), np.ones(4, np.float32))
