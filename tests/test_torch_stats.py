"""The port's statistics plane (``transmogrifai_tpu_torch/utils/stats.py``)
against the JAX package's ``utils/stats.py`` on the same seeded inputs,
on the CPU (``device="cpu"``).

Tolerances:
* below 2^22 elements both take a float64 route (the reference's numpy,
  the port's torch): ``F64_ATOL`` = 1e-12 (different reduction orders);
* at or above 2^22 elements the port takes the reference's single-device
  float32 route (``_corr_kernel``); under tier-1 the reference has 8 CPU
  devices and takes its mesh route instead (a float32 centred gram
  finished in float64). Either way the port is held within ``F32_ATOL`` =
  2e-5 for correlations and means, and ``F32_RTOL`` = 2e-5 for variances;
* contingency tables count 0/1 indicators: equal on both routes, as are
  the chi-squared, Cramér's V, PMI and rule-confidence values computed from
  them (the same float64 numpy code).
"""
import numpy as np
import pytest
import torch
from scipy.stats import rankdata

from transmogrifai_tpu.utils import stats as R

from transmogrifai_tpu_torch.utils import stats as S

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

F64_ATOL = 1e-12
F32_ATOL = 2e-5
F32_RTOL = 2e-5
CPU = "cpu"


def _table(n: int, d: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Seeded float32 columns of the kinds a transmogrified vector holds:
    continuous, 0/1 indicators, a constant and an all-zero column."""
    rng = np.random.default_rng(seed)
    x = np.empty((n, d), np.float32)
    kinds = np.arange(d) % 4
    x[:, kinds == 0] = rng.normal(3.0, 2.0, (n, int((kinds == 0).sum())))
    x[:, kinds == 1] = rng.random((n, int((kinds == 1).sum()))) < 0.2
    x[:, kinds == 2] = rng.lognormal(0.0, 1.0, (n, int((kinds == 2).sum())))
    x[:, kinds == 3] = rng.integers(0, 5, (n, int((kinds == 3).sum())))
    x[:, 1] = 7.0
    x[:, 3] = 0.0
    y = (x[:, 0] + rng.normal(0, 2.0, n) > 3.0).astype(np.float64)
    return x, y


def test_routes_split_at_the_reference_threshold():
    assert S._DEVICE_THRESHOLD == R._DEVICE_THRESHOLD == 1 << 22
    assert S.route_dtype((1 << 22) - 1) is torch.float64
    assert S.route_dtype(1 << 22) is torch.float32


@pytest.mark.parametrize("n,d", [(891, 13), (300, 40), (2, 5)])
def test_column_stats_float64_route(n, d):
    x, _ = _table(n, d, seed=n)
    want, got = R.column_stats(x), S.column_stats(x, device=CPU)
    assert got.count == want.count == n
    for key in ("mean", "variance", "min", "max"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                   rtol=0, atol=F64_ATOL)


@pytest.mark.parametrize("n,d", [(891, 13), (300, 40)])
def test_correlation_float64_route(n, d):
    x, y = _table(n, d, seed=d)
    np.testing.assert_allclose(S.correlation_matrix(x, y, device=CPU),
                               R.correlation_matrix(x, y), rtol=0, atol=F64_ATOL)
    np.testing.assert_allclose(S.correlation_matrix(x, device=CPU),
                               R.correlation_matrix(x), rtol=0, atol=F64_ATOL)


@pytest.fixture(scope="module")
def above_threshold():
    """4096 x 1100 (+ the label: 4,509,696 elements), just above 2^22."""
    x, y = _table(4096, 1100, seed=22)
    assert x.size + len(y) >= 1 << 22
    return x, y


def test_column_stats_float32_route(above_threshold):
    x, _ = above_threshold
    want, got = R.column_stats(x), S.column_stats(x, device=CPU)
    np.testing.assert_allclose(got.mean, want.mean, rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(got.variance, want.variance, rtol=F32_RTOL,
                               atol=1e-12)
    np.testing.assert_array_equal(got.min, want.min)
    np.testing.assert_array_equal(got.max, want.max)


def test_correlation_float32_route(above_threshold):
    x, y = above_threshold
    got = S.correlation_matrix(x, y, device=CPU)
    want = R.correlation_matrix(x, y)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    # zero-variance columns correlate 0 on both routes, the diagonal is 1
    assert (got[1, :][np.arange(got.shape[0]) != 1] == 0).all()
    np.testing.assert_array_equal(np.diag(got), 1.0)


def test_float32_route_runs_at_full_float32_precision():
    """The gram product is taken with TF32 off whatever the process-wide
    setting, and the caller's setting is restored after."""
    prior = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        with S.full_f32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prior)


def test_spearman_matches_the_reference():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 6, (400, 5)).astype(np.float64)  # many ties
    x[:, 2] = rng.normal(size=400)
    y = rng.integers(0, 2, 400).astype(np.float64)
    np.testing.assert_allclose(S.spearman_correlation_matrix(x, y, device=CPU),
                               R.spearman_correlation_matrix(x, y),
                               rtol=0, atol=F64_ATOL)
    ranks = S.rank_columns(torch.from_numpy(x)).numpy()
    for j in range(x.shape[1]):
        np.testing.assert_array_equal(ranks[:, j], rankdata(x[:, j]) - 1.0)


@pytest.mark.parametrize("n,k", [(891, 3), (4096, 1100)])
def test_contingency_both_routes(n, k):
    rng = np.random.default_rng(k)
    g = (rng.random((n, k)) < 0.3).astype(np.float64)
    y = rng.integers(0, 3, n)
    onehot = (y[:, None] == np.arange(3)[None, :]).astype(np.float64)
    got = S.contingency_table(g, onehot, device=CPU)
    want = R.contingency_table(g, onehot)
    np.testing.assert_array_equal(got, want)


def test_table_statistics_match_the_reference():
    rng = np.random.default_rng(0)
    tables = [np.array([[50.0, 0.0], [0.0, 50.0]]),
              np.array([[25.0, 25.0], [25.0, 25.0]]),
              np.array([[30.0, 0.0], [10.0, 10.0]]),
              np.zeros((2, 2)), np.array([[4.0, 0.0], [0.0, 0.0]]),
              rng.integers(0, 40, (6, 3)).astype(np.float64)]
    for t in tables:
        assert S.chi_squared(t) == R.chi_squared(t)
        assert S.cramers_v(t) == R.cramers_v(t)
        np.testing.assert_array_equal(S.pointwise_mutual_information(t),
                                      R.pointwise_mutual_information(t))
        for a, b in zip(S.association_rule_confidence(t),
                        R.association_rule_confidence(t)):
            np.testing.assert_array_equal(a, b)


# the reference's own stats-plane cases (tests/test_sanity_checker.py)
def test_correlation_matrix_basic():
    rng = np.random.default_rng(0)
    a = rng.normal(size=500)
    b = 2 * a + 0.001 * rng.normal(size=500)
    c = rng.normal(size=500)
    corr = S.correlation_matrix(np.stack([a, b, c], axis=1), device=CPU)
    assert corr[0, 1] > 0.999
    assert abs(corr[0, 2]) < 0.2
    np.testing.assert_allclose(np.diag(corr), 1.0)


def test_correlation_zero_variance_is_zero():
    x = np.stack([np.ones(10), np.arange(10.0)], axis=1)
    assert S.correlation_matrix(x, device=CPU)[0, 1] == 0.0


def test_cramers_v_perfect_and_independent():
    assert S.cramers_v(np.array([[50.0, 0.0], [0.0, 50.0]])) == pytest.approx(1.0)
    assert S.cramers_v(np.array([[25.0, 25.0], [25.0, 25.0]])) == pytest.approx(0.0)


def test_spearman_monotonic():
    x = np.arange(100.0)
    corr = S.spearman_correlation_matrix(x[:, None], np.exp(x / 10.0), device=CPU)
    assert corr[0, 1] == pytest.approx(1.0)


def test_stats_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    x, y = _table(20, 5, seed=1)
    for call in (lambda: S.column_stats(x), lambda: S.correlation_matrix(x, y),
                 lambda: S.contingency_table(x, x)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_stats_on_the_card():
    """Both routes on the card against the CPU's: the float64 route within
    F64_ATOL, the float32 route within F32_ATOL, contingencies equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for n, d in ((891, 13), (4096, 1100)):
        x, y = _table(n, d, seed=d)
        tol = F64_ATOL if x.size + n < 1 << 22 else F32_ATOL
        np.testing.assert_allclose(S.correlation_matrix(x, y),
                                   S.correlation_matrix(x, y, device=CPU),
                                   rtol=0, atol=tol)
        a, b = S.column_stats(x), S.column_stats(x, device=CPU)
        np.testing.assert_allclose(a.mean, b.mean, rtol=0, atol=tol)
        onehot = np.stack([y == 0, y == 1], 1).astype(np.float64)
        np.testing.assert_array_equal(S.contingency_table(x[:, 1::4], onehot),
                                      S.contingency_table(x[:, 1::4], onehot,
                                                          device=CPU))
