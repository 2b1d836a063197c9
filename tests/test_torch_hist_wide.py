"""Kernel K3 of the PyTorch port (``transmogrifai_tpu_torch.models.hist.
build_histogram_wide``, the wide-bin histogram) against the JAX package's:
its plain version is held to JAX's scatter histograms bit for bit (both add
each cell's rows in ascending order) and to the lane-packed Pallas kernel
``_build_histogram_pallas_batched`` in interpret mode within ``ATOL``, at
65, 256 and 300 bins, K = 1 and 3, ragged N, dead rows and slots >= M. The
grower routes wide groups above 4096 rows to it with the reference's node
chunk cap and grows the reference's trees. The wrapper never falls back to
the plain version for a CUDA tensor; the CUDA kernel itself is compared
with the plain version only where a card is present."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.models import hist_pallas as HP
from transmogrifai_tpu.models import trees as JTR
from transmogrifai_tpu_torch.models import hist as H
from transmogrifai_tpu_torch.models import trees as PTR
from transmogrifai_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

#: the reference's own tolerance for its kernels against scatter
#: (tests/test_hist_pallas.py): bf16 hi/lo splits in the TPU kernel
ATOL = 2e-4

CASES = [
    # (n, f, b, k, m): dead rows and slots >= m in every case
    (300, 3, 256, 1, 6),
    (301, 3, 65, 3, 3),
    (517, 4, 300, 3, 5),
    (129, 2, 256, 3, 2),
]


def _data(n, f, b, k, m, seed=0):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, b, size=(n, f)).astype(np.int32)
    node = rng.integers(-1, m + 2, size=(k, n)).astype(np.int32)
    g = rng.normal(size=(k, n)).astype(np.float32)
    h = rng.uniform(0.1, 1, size=(k, n)).astype(np.float32)
    return binned, node, g, h


def _port(fn, binned, node, g, h, m, b):
    return fn(*(torch.from_numpy(a) for a in (binned, node, g, h)), m, b).numpy()


@pytest.mark.parametrize("n,f,b,k,m", CASES)
def test_plain_version_matches_scatter_and_interpret_kernel(n, f, b, k, m):
    binned, node, g, h = _data(n, f, b, k, m, seed=n + b)
    got = _port(H.build_histogram_scatter_batched, binned, node, g, h, m, b)
    assert got.shape == (k, m, f, b, 2) and got.dtype == np.float32
    jargs = [jnp.asarray(a) for a in (binned, node, g, h)]
    scatter = np.asarray(HP.build_histogram_scatter_batched(*jargs, m, b))
    assert np.array_equal(got, scatter)
    kernel = np.asarray(HP.build_histogram_pallas_batched(
        *jargs, m, b, row_tile=256, interpret=True
    ))
    np.testing.assert_allclose(got, kernel, rtol=0, atol=ATOL)
    # the wrapper takes the plain version for a CPU tensor
    assert np.array_equal(_port(H.build_histogram_wide, binned, node, g, h, m, b),
                          got)


def test_dead_rows_out_of_range_slots_and_codes_add_nothing():
    binned, node, g, h = _data(300, 4, 256, 3, 3)
    node[0] = -1
    node[1] = 3  # == M: out of range
    node[2] = np.where(np.arange(300) % 2 == 0, -1, 5)
    assert not _port(H.build_histogram_wide, binned, node, g, h, 3, 256).any()


def test_route_takes_k3_above_64_bins_above_4096_rows():
    cuda = torch.device("cuda")
    assert H.histogram_route(cuda, 4097, 65) == "wide"
    assert H.histogram_route(cuda, 16384, 256) == "wide"
    assert H.histogram_route(cuda, 4096, 256) == "gemm"
    assert H.histogram_route(cuda, 16384, 64) == "binloop"


def _wide_problem(n, f_cont, f_bin, k, b, seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        rng.normal(size=(n, f_cont)),
        (rng.uniform(size=(n, f_bin)) < 0.3).astype(np.float64),
    ], axis=1).astype(np.float32)
    thr = JTR.quantile_thresholds(x, b)
    binned = np.array(JTR.bin_data(jnp.asarray(x), jnp.asarray(thr)))
    y = x[:, 0] - 0.5 * x[:, 1] + x[:, f_cont] + 0.3 * rng.normal(size=n)
    margin = rng.normal(scale=0.3, size=(k, n))
    g = (margin - y).astype(np.float32)
    h = np.ones((k, n), np.float32)
    rm = (rng.uniform(size=(k, n)) < 0.7).astype(np.float32)
    fm = np.ones((k, x.shape[1]), np.float32)
    groups = (np.arange(f_cont, f_cont + f_bin, dtype=np.int32),
              np.arange(f_cont, dtype=np.int32))
    return binned, g, h, rm, fm, groups


@pytest.mark.parametrize("b,chunk", [(256, 256), (300, 128)])
def test_grower_routes_wide_groups_to_k3(monkeypatch, b, chunk):
    """4200 rows: the card's routes (their plain versions on a CPU tensor)
    take the 2-bin group through K2 and the wide group through K3, in node
    chunks of the reference's kernel cap max(8, min(256, 2^19 / (8 b_pad)));
    the trees equal the JAX package's (lambda 0, as GBT grows them)."""
    binned, g, h, rm, fm, groups = _wide_problem(4200, 3, 2, 2, b, seed=b)
    monkeypatch.setattr(
        H, "histogram_route",
        lambda dev, n, nb: "binloop" if nb <= H.BINLOOP_MAX_BINS else "wide")
    calls = {"binloop": [], "wide": []}
    for name in calls:
        real = getattr(H, f"build_histogram_{name}")

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name].append((a[4], a[5]))  # (num_nodes, num_bins)
            return _real(*a, **kw)

        monkeypatch.setattr(H, f"build_histogram_{name}", counted)
    knobs = dict(reg_lambda=0.0, gamma=0.0, min_child_weight=5.0,
                 min_info_gain=0.0)
    jtree, jnode = jax.jit(functools.partial(
        JTR._grow_tree_impl, max_depth=9, num_bins=b, hist_impl="scatter"
    ))(jnp.asarray(binned), *(jnp.asarray(a) for a in (g, h, rm, fm)),
       feature_groups=tuple(map(jnp.asarray, groups)), **knobs)
    ptree, pnode = PTR._grow_tree_impl(
        torch.from_numpy(binned), *(torch.from_numpy(a) for a in (g, h, rm, fm)),
        max_depth=9, num_bins=b, feature_groups=groups, **knobs)
    assert np.array_equal(np.asarray(jtree.split_feat), ptree.split_feat.numpy())
    assert np.array_equal(np.asarray(jtree.split_bin), ptree.split_bin.numpy())
    assert np.array_equal(np.asarray(jnode), pnode.numpy())
    np.testing.assert_allclose(ptree.leaf_value.numpy(),
                               np.asarray(jtree.leaf_value),
                               rtol=1e-5, atol=1e-5, equal_nan=True)
    assert calls["wide"] and {nb for _, nb in calls["wide"]} == {b}
    assert {nb for _, nb in calls["binloop"]} == {2}
    assert max(m for m, _ in calls["wide"]) == chunk
    # one build per level, and at 128-slot chunks more at the deep levels
    assert len(calls["wide"]) == len(calls["binloop"]) >= 9
    assert (len(calls["wide"]) > 9) == (chunk < 256)


class TestWrapperGuards:
    def _as_cuda(self, monkeypatch):
        """The wrapper's device test says CUDA, the plain version is a trap
        and the library cache is fresh: a CUDA tensor must launch or raise."""
        monkeypatch.setattr(H, "_on_cuda", lambda x: True)
        monkeypatch.setattr(H, "_library", functools.cache(H._library.__wrapped__))

        def trap(*a, **k):
            raise AssertionError("fell back to the plain version")

        monkeypatch.setattr(H, "build_histogram_scatter_batched", trap)

    def _args(self, n=50, b=256):
        return [torch.from_numpy(a) for a in _data(n, 3, b, 2, 2)]

    def test_failing_loader_raises(self, monkeypatch):
        self._as_cuda(monkeypatch)

        def broken(name):
            raise cuda_build.KernelBuildError(f"cannot build {name}")

        monkeypatch.setattr(cuda_build, "load_library", broken)
        before = H.build_histogram_wide.launches
        with pytest.raises(cuda_build.KernelBuildError, match="hist_wide"):
            H.build_histogram_wide(*self._args(), 2, 256)
        assert H.build_histogram_wide.launches == before

    def test_too_many_bins_raise_without_a_fallback(self, monkeypatch):
        self._as_cuda(monkeypatch)
        b = H.HIST_WIDE_MAX_BINS + 1
        with pytest.raises(ValueError, match=str(H.HIST_WIDE_MAX_BINS)):
            H.build_histogram_wide(*self._args(n=8, b=b), 2, b)

    @pytest.mark.parametrize("case", ["dtype", "shape", "noncontig"])
    def test_bad_inputs_raise(self, case):
        binned, node, g, h = self._args()
        if case == "dtype":
            h = h.double()
        elif case == "shape":
            g = g[:, :-1].contiguous()
        else:
            node = torch.cat([node, node], dim=1)[:, ::2]
        with pytest.raises((TypeError, ValueError)):
            H.build_histogram_wide(binned, node, g, h, 2, 256)

    def test_cpu_plain_version_does_not_count_launches(self):
        before = H.build_histogram_wide.launches
        H.build_histogram_wide(*self._args(), 2, 256)
        assert H.build_histogram_wide.launches == before


def test_kernel_matches_plain_version_on_the_card():
    """Needs a CUDA card (skips here): K3 is bit-identical to the plain
    float32 version and to itself across launches, with zero-weight rows
    among the live ones, runs of many row tiles, one feature tile or
    several, and codes repeated within 32 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    extra = [(4099, 7, 300, 2, 3), (6000, 10, 256, 3, 2), (5000, 17, 65, 2, 4)]
    for n, f, b, k, m in CASES + extra:
        binned, node, g, h = _data(n, f, b, k, m)
        binned[: n // 2, 0] = 0  # long runs of one code
        zero = np.random.default_rng(n).uniform(size=g.shape) < 0.3
        g[zero] = 0.0
        h[zero] = 0.0
        args = [torch.from_numpy(a).cuda() for a in (binned, node, g, h)]
        got = H.build_histogram_wide(*args, m, b)
        again = H.build_histogram_wide(*args, m, b)
        want = H.build_histogram_scatter_batched(*(a.cpu() for a in args), m, b)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert torch.equal(got.cpu(), want)
