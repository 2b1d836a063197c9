"""The PyTorch port's gradient histograms (``transmogrifai_tpu_torch.models.
hist``) against the JAX package's: the plain version of kernel K2 is held
to JAX's scatter histograms (bit for bit: both add each cell's rows in
ascending order) and to the Pallas bin-loop kernel in interpret mode
within ``ATOL``, across dead rows, slots >= M, unaligned N and F, and K=2.
The one-hot GEMM path is held to the reference's GEMM formulation. The
policy (``histogram_route``) and the wrapper's guards run without a card;
the CUDA kernel itself is compared with the plain version only where a
card is present."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.models import hist_pallas as HP
from transmogrifai_tpu_torch.models import hist as H
from transmogrifai_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

#: the reference's own tolerance for its kernels against scatter
#: (tests/test_hist_pallas.py): bf16 hi/lo splits in the TPU kernel
ATOL = 2e-4

CASES = [
    # (n, f, b, k, m): dead rows and slots >= m in every case
    (500, 5, 8, 1, 6),
    (301, 3, 5, 2, 3),
    (129, 37, 2, 2, 8),
    (1000, 4, 64, 2, 5),
]


def _data(n, f, b, k, m, seed=0):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, b, size=(n, f)).astype(np.int32)
    node = rng.integers(-1, m + 2, size=(k, n)).astype(np.int32)
    g = rng.normal(size=(k, n)).astype(np.float32)
    h = rng.uniform(0.1, 1, size=(k, n)).astype(np.float32)
    return binned, node, g, h


def _port(fn, binned, node, g, h, m, b, **kw):
    args = (torch.from_numpy(a) for a in (binned, node, g, h))
    return fn(*args, m, b, **kw).numpy()


@pytest.mark.parametrize("n,f,b,k,m", CASES)
def test_plain_version_matches_scatter_and_interpret_kernel(n, f, b, k, m):
    binned, node, g, h = _data(n, f, b, k, m, seed=n)
    got = _port(H.build_histogram_scatter_batched, binned, node, g, h, m, b)
    assert got.shape == (k, m, f, b, 2) and got.dtype == np.float32
    jargs = [jnp.asarray(a) for a in (binned, node, g, h)]
    scatter = np.asarray(HP.build_histogram_scatter_batched(*jargs, m, b))
    assert np.array_equal(got, scatter)
    kernel = np.asarray(HP.build_histogram_pallas_binloop(
        *jargs, m, b, row_tile=256, interpret=True
    ))
    np.testing.assert_allclose(got, kernel, rtol=0, atol=ATOL)
    # the wrapper takes the plain version for a CPU tensor
    assert np.array_equal(
        _port(H.build_histogram_binloop, binned, node, g, h, m, b), got
    )


def test_dead_rows_and_out_of_range_slots_add_nothing():
    binned, node, g, h = _data(300, 4, 6, 2, 3)
    node[0] = -1
    node[1] = 3  # == M: out of range
    out = _port(H.build_histogram_binloop, binned, node, g, h, 3, 6)
    assert not out.any()


def _reference_gemm(binned, node, g, h, m, b, lowp):
    """trees.py:409-430 (the closure ``build_histogram_gemm`` inside
    ``_grow_tree_impl``), with its loop-invariant code one-hot."""
    dt = jnp.bfloat16 if lowp else jnp.float32
    codes1h = jax.nn.one_hot(binned, b, dtype=dt).reshape(binned.shape[0], -1)
    node1h = jax.nn.one_hot(node, m, dtype=jnp.float32)
    gw = (node1h * g[:, :, None]).astype(dt)
    hw = (node1h * h[:, :, None]).astype(dt)
    hg = jnp.einsum("knm,nw->kmw", gw, codes1h,
                    preferred_element_type=jnp.float32)
    hh = jnp.einsum("knm,nw->kmw", hw, codes1h,
                    preferred_element_type=jnp.float32)
    return np.asarray(jnp.stack([hg, hh], axis=-1).reshape(
        node.shape[0], m, binned.shape[1], b, 2
    ))


@pytest.mark.parametrize("lowp", [False, True])
@pytest.mark.parametrize("n,f,b,k,m", CASES[:3])
def test_gemm_path_matches_the_reference_gemm(n, f, b, k, m, lowp):
    binned, node, g, h = _data(n, f, b, k, m, seed=n + 1)
    c1h = H.codes_one_hot(torch.from_numpy(binned), b)
    got = H.build_histogram_gemm(
        c1h, *(torch.from_numpy(a) for a in (node, g, h)), m, b, lowp=lowp
    ).numpy()
    want = _reference_gemm(*(jnp.asarray(a) for a in (binned, node, g, h)),
                           m, b, lowp)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if not lowp:
        plain = _port(H.build_histogram_scatter_batched, binned, node, g, h, m, b)
        np.testing.assert_allclose(got, plain, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n,k,m,case", [
    (200, 3, 4, "spread"),       # the original case
    (1500, 2, 5, "one_slot"),    # every row in one slot
    (1025, 2, 3, "all_dead"),    # -1 and slots >= M only
    (777, 2, 1, "spread"),       # M = 1
    (2049, 2, 6, "zero_weight"),
])
def test_node_order_is_a_stable_sort_by_slot(n, k, m, case):
    _, node, g, h = _data(n, 1, 2, k, m, seed=5)
    if case == "one_slot":
        node[:] = m - 1
    elif case == "all_dead":
        node[:] = np.where(np.arange(n) % 2 == 0, -1, m)
    elif case == "zero_weight":
        zero = np.random.default_rng(n).uniform(size=g.shape) < 0.4
        g[zero] = 0.0
        h[zero] = -0.0
    live = (g != 0) | (h != 0)
    order, start, count = (
        a.numpy() for a in H.node_order(
            torch.from_numpy(node), m, torch.from_numpy(g), torch.from_numpy(h))
    )
    for kk in range(k):
        for s in range(m):
            rows = order[kk, start[kk, s]:start[kk, s] + count[kk, s]]
            assert np.array_equal(rows, np.nonzero((node[kk] == s) & live[kk])[0])
        # the dead tail holds every other row, in ascending order
        tail = order[kk, int(count[kk].sum()):]
        assert np.array_equal(tail, np.nonzero(
            ~((node[kk] >= 0) & (node[kk] < m) & live[kk]))[0])


def test_zero_weight_rows_change_no_sum():
    """The kernel's wrapper drops rows whose grad and hess are both zero
    (+0.0 or -0.0): a sequential f32 sum starts at +0.0, never becomes
    -0.0, and adding a zero leaves its bits alone. The plain version with
    those rows marked dead gives the same bits, signs of zero included,
    with sums that cancel to zero on the way."""
    rng = np.random.default_rng(7)
    binned, node, _, _ = _data(600, 5, 4, 2, 3, seed=7)
    g = rng.choice(np.float32([-1.0, 1.0, 0.5, -0.5]), size=node.shape)
    h = rng.choice(np.float32([0.25, 1.0]), size=node.shape)
    zero = rng.uniform(size=node.shape) < 0.4
    g[zero] = np.where(rng.uniform(size=zero.sum()) < 0.5, 0.0, -0.0)
    h[zero] = np.where(rng.uniform(size=zero.sum()) < 0.5, 0.0, -0.0)
    full = _port(H.build_histogram_scatter_batched, binned, node, g, h, 3, 4)
    dropped = np.where(zero, -1, node).astype(np.int32)
    want = _port(H.build_histogram_scatter_batched, binned, dropped, g, h, 3, 4)
    assert np.array_equal(full.view(np.uint32), want.view(np.uint32))
    assert (full == 0).any()  # some cells did cancel or stay empty
    _, _, count = H.node_order(torch.from_numpy(node), 3, torch.from_numpy(g),
                               torch.from_numpy(h))
    assert int(count.sum()) == int(((node >= 0) & (node < 3) & ~zero).sum())


def test_route_follows_the_reference_policy():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert H.histogram_route(cpu, 10**6, 256) == "scatter"
    assert H.histogram_route(cuda, 4096, 256) == "gemm"
    assert H.histogram_route(cuda, 4097, 64) == "binloop"
    assert H.histogram_route(cuda, 16384, 2) == "binloop"
    assert H.histogram_route(cuda, 4097, 65) == "wide"
    assert H.histogram_route(cuda, 16384, 256) == "wide"


class TestWrapperGuards:
    def _as_cuda(self, monkeypatch):
        """The wrapper's device test says CUDA, the plain version is a trap
        and the library cache is fresh: a CUDA tensor must launch or raise."""
        monkeypatch.setattr(H, "_on_cuda", lambda x: True)
        monkeypatch.setattr(H, "_library", functools.cache(H._library.__wrapped__))

        def trap(*a, **k):
            raise AssertionError("fell back to the plain version")

        monkeypatch.setattr(H, "build_histogram_scatter_batched", trap)

    def _args(self, n=50, b=4):
        return [torch.from_numpy(a) for a in _data(n, 3, b, 2, 2)]

    def test_too_many_bins_raise_without_a_fallback(self, monkeypatch):
        self._as_cuda(monkeypatch)
        with pytest.raises(ValueError, match="bins"):
            H.build_histogram_binloop(*self._args(b=65), 2, 65)

    def test_failing_loader_raises(self, monkeypatch):
        self._as_cuda(monkeypatch)

        def broken(name):
            raise cuda_build.KernelBuildError(f"cannot build {name}")

        monkeypatch.setattr(cuda_build, "load_library", broken)
        before = H.build_histogram_binloop.launches
        with pytest.raises(cuda_build.KernelBuildError, match="hist_binloop"):
            H.build_histogram_binloop(*self._args(), 2, 4)
        assert H.build_histogram_binloop.launches == before

    @pytest.mark.parametrize("case", ["dtype", "shape", "noncontig"])
    def test_bad_inputs_raise(self, case):
        binned, node, g, h = self._args()
        if case == "dtype":
            g = g.double()
        elif case == "shape":
            node = node[:, :-1].contiguous()
        else:
            binned = torch.cat([binned, binned], dim=1)[:, ::2]
        with pytest.raises((TypeError, ValueError)):
            H.build_histogram_binloop(binned, node, g, h, 2, 4)

    def test_cpu_plain_version_does_not_count_launches(self):
        before = H.build_histogram_binloop.launches
        H.build_histogram_binloop(*self._args(), 2, 4)
        assert H.build_histogram_binloop.launches == before


def test_kernel_matches_plain_version_on_the_card():
    """Needs a CUDA card (skips here): the kernel is bit-identical to the
    plain float32 version, and to itself across launches, with zero-weight
    rows among the live ones, runs of many row tiles and several feature
    tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    extra = [(4099, 7, 5, 2, 3), (5000, 130, 2, 2, 3), (3000, 70, 32, 3, 4)]
    for n, f, b, k, m in CASES + extra:
        binned, node, g, h = _data(n, f, b, k, m)
        zero = np.random.default_rng(n).uniform(size=g.shape) < 0.3
        g[zero] = 0.0
        h[zero] = 0.0
        args = [torch.from_numpy(a).cuda() for a in (binned, node, g, h)]
        got = H.build_histogram_binloop(*args, m, b)
        again = H.build_histogram_binloop(*args, m, b)
        want = H.build_histogram_scatter_batched(
            *(a.cpu() for a in args), m, b
        )
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert torch.equal(got.cpu(), want)
