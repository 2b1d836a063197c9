"""The PyTorch port's bagging draws (``transmogrifai_tpu_torch.utils.prng``
and ``models.trees._bag_masks``) against ``jax.random`` and the JAX
package's ``trees._bag_masks``: the same keys, uniforms, Poisson counts and
masks, BIT-EQUAL at the shapes these tests use (the port's Knuth loop sums
correctly rounded f32 logarithms where XLA's are not, so a count could
differ where a running sum lands within an ulp of -lam; none does here)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.models import trees as JTR
from transmogrifai_tpu_torch.models import trees as PTR
from transmogrifai_tpu_torch.utils import prng

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

SEEDS = [0, 42, 7, 2**31 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_uniform_bit_equal(seed):
    jkey = jax.random.PRNGKey(np.uint32(seed))
    key = prng.prng_key(seed)
    assert np.array_equal(np.asarray(jkey), key)
    for num in (2, 5, 50):
        assert np.array_equal(np.asarray(jax.random.split(jkey, num)),
                              prng.split(key, num))
    for num in (1, 10, 1001):
        assert np.array_equal(
            np.asarray(jax.random.uniform(jkey, (num,))), prng.uniform(key, num)
        )


@pytest.mark.parametrize("lam", [0.5, 1.0, 3.0, 9.5])
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_poisson_knuth_bit_equal(seed, lam):
    jkey = jax.random.PRNGKey(np.uint32(seed))
    want = np.asarray(jax.random.poisson(jkey, lam, (5000,)))
    got = prng.poisson(prng.prng_key(seed), lam, 5000)
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


def test_poisson_zero_rate_and_unported_rates():
    assert not prng.poisson(prng.prng_key(1), 0.0, 17).any()
    with pytest.raises(NotImplementedError):
        prng.poisson(prng.prng_key(1), 10.0, 3)


@pytest.mark.parametrize("bootstrap", [True, False])
def test_bag_masks_match_the_reference(bootstrap):
    rng = np.random.default_rng(3)
    n, f = 600, 10
    row_mask = (rng.uniform(size=(3, n)) < 0.7).astype(np.float32)
    sub = np.array([1.0, 0.5, 1.0], dtype=np.float32)
    # lane 2's rate is so low that its mask comes out empty and falls back
    # to every feature
    col = np.array([1.0, 0.3, 1e-6], dtype=np.float32)
    tkeys = jax.random.split(jax.random.PRNGKey(np.uint32(42)), 4)
    ptkeys = prng.split(prng.prng_key(42), 4)
    for t in range(4):
        jr, jf = JTR._bag_masks(
            tkeys[t], jnp.asarray(sub), jnp.asarray(col), jnp.asarray(row_mask),
            n=n, f=f, bootstrap=bootstrap,
        )
        pr, pf = PTR._bag_masks(ptkeys[t], sub, col, row_mask, n, f, bootstrap)
        assert np.array_equal(np.asarray(jr), pr)
        assert np.array_equal(np.asarray(jf), pf)
        assert pf[2].all()
