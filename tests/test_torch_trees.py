"""The PyTorch port's tree predict machinery (``transmogrifai_tpu_torch.
models.trees``) against the JAX package's ``models/trees.py`` on the same
seeded numpy inputs: ``bin_data`` BIT-IDENTICAL, including NaN, ±inf,
-0.0, values equal to a threshold and NaN thresholds; ``predict_tree``
bit-identical; the fused bin + reduce entry points equal to the
reference's host twins (``predict_boosted_host`` / ``predict_forest_host``,
the trees summed in tree order) and within ``SUM_ATOL`` of its jitted
device route, which sums in another order.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transmogrifai_tpu import native
from transmogrifai_tpu.models import trees as JTR
from transmogrifai_tpu_torch.models import trees as PTR

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

#: the reference's device route (``predict_*_raw``) sums the trees in
#: another order than the tree order both host routes take: its results
#: differ in the last ulp; held to the reference's own host-versus-device
#: bound, rtol = atol = 1e-6 (tests/test_predict_host.py)
SUM_ATOL = 1e-6


def _edge_matrix(rng, n, f, bins):
    x = rng.normal(size=(n, f)).astype(np.float32)
    thr = JTR.quantile_thresholds(x, max_bins=bins)
    # plant the edge cases: exact threshold values, NaN, ±inf, signed zero
    x[0, :] = thr[:, 0]
    x[1, :] = thr[:, -1]
    x[2, :] = np.nan
    x[3, :] = np.inf
    x[4, :] = -np.inf
    x[5, :] = -0.0
    x[6, :] = thr[:, (bins - 1) // 2]
    return x, thr


@pytest.mark.parametrize("bins", [2, 4, 32])
def test_bin_data_bit_identical(bins):
    rng = np.random.default_rng(bins)
    x, thr = _edge_matrix(rng, 64, 9, bins)
    want = np.asarray(JTR.bin_data(jnp.asarray(x), jnp.asarray(thr)))
    got = PTR.bin_data(torch.from_numpy(x), torch.from_numpy(thr)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


def test_bin_data_nan_threshold_column():
    rng = np.random.default_rng(3)
    x, thr = _edge_matrix(rng, 16, 4, 8)
    thr[1, :] = np.nan  # an all-NaN training column: x > NaN is false
    thr[2, 3] = np.nan
    want = np.asarray(JTR.bin_data(jnp.asarray(x), jnp.asarray(thr)))
    got = PTR.bin_data(torch.from_numpy(x), torch.from_numpy(thr)).numpy()
    assert np.array_equal(got, want)
    assert (got[:, 1] == 0).all()


def _stack(rng, t, depth, f, bins):
    w = 1 << depth
    return (
        rng.integers(-1, f, size=(t, depth, w)).astype(np.int32),
        rng.integers(0, bins - 1, size=(t, depth, w)).astype(np.int32),
        rng.normal(scale=0.1, size=(t, w)).astype(np.float32),
    )


@pytest.mark.parametrize("depth", [1, 3, 10])
def test_predict_tree_bit_identical(depth):
    rng = np.random.default_rng(20 + depth)
    sf, sb, lv = _stack(rng, 1, depth, 6, 16)
    binned = rng.integers(0, 16, size=(50, 6)).astype(np.int32)
    want = np.asarray(JTR.predict_tree(
        jnp.asarray(binned), JTR.Tree(*(jnp.asarray(a[0]) for a in (sf, sb, lv)))
    ))
    got = PTR.predict_tree(
        torch.from_numpy(binned),
        PTR.Tree(*(torch.from_numpy(a[0]) for a in (sf, sb, lv))),
    ).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("t,depth", [(200, 6), (50, 8)])
def test_raw_predicts_match_reference(t, depth):
    rng = np.random.default_rng(t + depth)
    x, thr = _edge_matrix(rng, 96, 11, 32)
    sf, sb, lv = _stack(rng, t, depth, 11, 32)
    jtrees = JTR.Tree(*(jnp.asarray(a) for a in (sf, sb, lv)))
    ptrees = PTR.Tree(*(torch.from_numpy(a) for a in (sf, sb, lv)))
    xj, tj = jnp.asarray(x), jnp.asarray(thr)
    xt, tt = torch.from_numpy(x), torch.from_numpy(thr)
    np.testing.assert_allclose(
        PTR.predict_boosted_raw(xt, tt, ptrees, 0.02, 0.1).numpy(),
        np.asarray(JTR.predict_boosted_raw(
            xj, tj, jtrees, jnp.float32(0.02), jnp.float32(0.1)
        )),
        rtol=SUM_ATOL, atol=SUM_ATOL,
    )
    np.testing.assert_allclose(
        PTR.predict_forest_raw(xt, tt, ptrees).numpy(),
        np.asarray(JTR.predict_forest_raw(xj, tj, jtrees)),
        rtol=SUM_ATOL, atol=SUM_ATOL,
    )
    # the reference's host route sums in tree order (its native loop):
    # equal bit for bit
    assert native._load() is not None
    htrees = JTR.Tree(sf, sb, lv)
    assert np.array_equal(
        PTR.predict_boosted_raw(xt, tt, ptrees, 0.02, 0.1).numpy(),
        JTR.predict_boosted_host(x, thr, htrees, 0.02, 0.1))
    assert np.array_equal(PTR.predict_forest_raw(xt, tt, ptrees).numpy(),
                          JTR.predict_forest_host(x, thr, htrees))
