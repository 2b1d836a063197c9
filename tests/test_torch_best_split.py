"""Kernel K4 of the PyTorch port (``transmogrifai_tpu_torch.models.hist.
build_best_split``, the fused histogram and split search) against the JAX
package's ``build_best_split_pallas`` in interpret mode, on the reference
test's shape (N=200, F=11, B=8, M=4, K=3, per-fit lambda/gamma/min child
weight, one masked feature) and at 2, 32 and 128 bins: the best gains
within the reference test's own tolerance, the chosen (feature, bin)
achieving the best gain, -1 where no threshold is valid. Its plain version
equals the port's two-phase split search (``split_search`` over the
scatter histogram) bit for bit. The wrapper never falls back to the plain
version for a CUDA tensor; the CUDA kernel itself is compared with the
plain version only where a card is present."""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transmogrifai_tpu.models import hist_pallas as HP
from transmogrifai_tpu_torch.models import hist as H
from transmogrifai_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

#: tests/test_hist_pallas.py::test_fused_split_matches_two_phase
RTOL = ATOL = 1e-4

CASES = [
    # (n, f, b, m, k): the reference test's shape first
    (200, 11, 8, 4, 3),
    (200, 11, 2, 4, 3),
    (301, 37, 32, 5, 3),
    (400, 6, 128, 3, 3),
]


def _data(n, f, b, m, k, seed=3):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, b, (n, f)).astype(np.int32)
    node = rng.integers(-1, m, (k, n)).astype(np.int32)
    g = rng.normal(size=(k, n)).astype(np.float32)
    h = rng.uniform(0.1, 1, (k, n)).astype(np.float32)
    fmask = np.ones((k, f), dtype=np.float32)
    fmask[1, 0] = 0.0  # one disabled feature on one fit
    lam = np.asarray([1.0, 0.5, 0.0], dtype=np.float32)[:k]
    gam = np.asarray([0.0, 0.1, 0.0], dtype=np.float32)[:k]
    mcw = np.asarray([1.0, 1.0, 2.0], dtype=np.float32)[:k]
    return binned, node, g, h, fmask, lam, gam, mcw


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _gain_table(hist, fmask, lam, gam, mcw):
    """The reference test's numpy gains over a [K, M, F, B, 2] histogram."""
    hg, hh = hist[..., 0], hist[..., 1]
    gl, hl = np.cumsum(hg, axis=3)[..., :-1], np.cumsum(hh, axis=3)[..., :-1]
    gt, ht = hg.sum(axis=3, keepdims=True), hh.sum(axis=3, keepdims=True)
    gr, hr = gt - gl, ht - hl
    lam4, gam4, mcw4 = (v[:, None, None, None] for v in (lam, gam, mcw))
    with np.errstate(divide="ignore", invalid="ignore"):
        gain = 0.5 * (gl**2 / (hl + lam4) + gr**2 / (hr + lam4)
                      - gt**2 / (ht + lam4)) - gam4
    valid = (hl >= mcw4) & (hr >= mcw4) & (fmask[:, None, :, None] > 0)
    return np.where(valid, gain, -np.inf)


@pytest.mark.parametrize("n,f,b,m,k", CASES)
def test_plain_version_matches_the_interpret_kernel(n, f, b, m, k):
    args = _data(n, f, b, m, k, seed=n + b)
    binned, node, g, h, fmask, lam, gam, mcw = args
    bg, bf, bb = (a.numpy() for a in H.build_best_split(*_torch(args), m, b))
    assert bg.shape == bf.shape == bb.shape == (k, m)
    assert bg.dtype == np.float32 and bf.dtype == bb.dtype == np.int32
    jg, jf, _ = (np.asarray(a) for a in HP.build_best_split_pallas(
        *(jnp.asarray(a) for a in args), num_nodes=m, num_bins=b,
        interpret=True))
    np.testing.assert_allclose(bg, jg, rtol=RTOL, atol=ATOL)
    assert np.array_equal(bf == -1, jf == -1)
    hist = np.asarray(HP.build_histogram_scatter_batched(
        *(jnp.asarray(a) for a in (binned, node, g, h)), m, b))
    gain = _gain_table(hist, fmask, lam, gam, mcw)
    best = gain.reshape(k, m, -1).max(axis=2)
    np.testing.assert_allclose(bg, best, rtol=RTOL, atol=ATOL)
    for ki in range(k):
        for mi in range(m):
            if np.isfinite(best[ki, mi]):
                np.testing.assert_allclose(gain[ki, mi, bf[ki, mi], bb[ki, mi]],
                                           best[ki, mi], rtol=RTOL, atol=ATOL)
            else:
                assert bf[ki, mi] == -1 and bb[ki, mi] == 0


@pytest.mark.parametrize("n,f,b,m,k", CASES)
def test_plain_version_is_the_two_phase_split_search(n, f, b, m, k):
    """Bit for bit: the scatter histogram, then ``split_search`` (the
    grower's own), with -1 where no gain beats -inf."""
    args = _torch(_data(n, f, b, m, k, seed=n + 2 * b))
    binned, node, g, h, fmask, lam, gam, mcw = args
    got = H.build_best_split(*args, m, b)
    hist = H.build_histogram_scatter_batched(binned, node, g, h, m, b)
    gain, feat, bin_ = H.split_search(hist, fmask, lam, gam, mcw)
    none = gain == -torch.inf
    assert torch.equal(got[0], gain)
    assert torch.equal(got[1], torch.where(none, -1, feat))
    assert torch.equal(got[2], torch.where(none, 0, bin_))


def test_no_valid_threshold_gives_minus_one():
    binned, node, g, h, fmask, lam, gam, mcw = _data(200, 5, 4, 3, 3)
    node[0] = -1  # fit 0 has no rows
    fmask[1] = 0.0  # fit 1 has no feature
    mcw[2] = 1e9  # fit 2 has no child heavy enough
    bg, bf, bb = H.build_best_split(
        *_torch((binned, node, g, h, fmask, lam, gam, mcw)), 3, 4)
    assert (bf == -1).all() and (bb == 0).all() and (bg == -torch.inf).all()


def test_scalar_knobs_broadcast_over_the_fits():
    binned, node, g, h, fmask, *_ = _data(200, 5, 8, 3, 3)
    args = _torch((binned, node, g, h, fmask))
    got = H.build_best_split(*args, 1.0, 0.1, 2.0, 3, 8)
    want = H.build_best_split(*args, torch.full((3,), 1.0),
                              torch.full((3,), 0.1), torch.full((3,), 2.0), 3, 8)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_ties_take_the_lowest_feature_and_bin():
    """Two identical columns and a repeated pattern: equal gains resolve to
    the lowest (feature, bin), as the reference's flat argmax does."""
    rng = np.random.default_rng(0)
    col = rng.integers(0, 4, 300).astype(np.int32)
    binned = np.stack([col, col, col], axis=1)
    node = np.zeros((1, 300), np.int32)
    g = rng.normal(size=(1, 300)).astype(np.float32)
    h = np.ones((1, 300), np.float32)
    args = _torch((binned, node, g, h, np.ones((1, 3), np.float32)))
    bg, bf, bb = H.build_best_split(*args, 1.0, 0.0, 1.0, 1, 4)
    assert bf.item() == 0


class TestWrapperGuards:
    def _as_cuda(self, monkeypatch):
        """The wrapper's device test says CUDA, the plain version is a trap
        and the library cache is fresh: a CUDA tensor must launch or raise."""
        monkeypatch.setattr(H, "_on_cuda", lambda x: True)
        monkeypatch.setattr(H, "_library", functools.cache(H._library.__wrapped__))

        def trap(*a, **k):
            raise AssertionError("fell back to the plain version")

        monkeypatch.setattr(H, "best_split_plain", trap)
        monkeypatch.setattr(H, "build_histogram_scatter_batched", trap)

    def _args(self, b=8):
        return _torch(_data(100, 5, b, 3, 3))

    def test_failing_loader_raises(self, monkeypatch):
        self._as_cuda(monkeypatch)

        def broken(name):
            raise cuda_build.KernelBuildError(f"cannot build {name}")

        monkeypatch.setattr(cuda_build, "load_library", broken)
        before = H.build_best_split.launches
        with pytest.raises(cuda_build.KernelBuildError, match="best_split"):
            H.build_best_split(*self._args(), 3, 8)
        assert H.build_best_split.launches == before

    @pytest.mark.parametrize("b", [1, H.FUSED_SPLIT_MAX_BINS + 1])
    def test_bins_outside_the_domain_raise(self, monkeypatch, b):
        self._as_cuda(monkeypatch)
        with pytest.raises(ValueError, match="bins"):
            H.build_best_split(*self._args(b=b), 3, b)

    @pytest.mark.parametrize("case", ["fmask_shape", "fmask_dtype", "knob_len"])
    def test_bad_inputs_raise(self, case):
        binned, node, g, h, fmask, lam, gam, mcw = self._args()
        if case == "fmask_shape":
            fmask = fmask[:, :-1].contiguous()
        elif case == "fmask_dtype":
            fmask = fmask.double()
        else:
            lam = lam[:2]
        with pytest.raises(ValueError):
            H.build_best_split(binned, node, g, h, fmask, lam, gam, mcw, 3, 8)

    def test_cpu_plain_version_does_not_count_launches(self):
        before = H.build_best_split.launches
        H.build_best_split(*self._args(), 3, 8)
        assert H.build_best_split.launches == before


def test_kernel_matches_plain_version_on_the_card():
    """Needs a CUDA card (skips here): K4 equals its plain version on the
    CPU bit for bit (the same histogram sums, prefix blocks, window sums
    and separately rounded gain arithmetic) and itself across launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for n, f, b, m, k in CASES + [(2048, 70, 128, 16, 2), (2048, 918, 2, 128, 3)]:
        args = _torch(_data(n, f, b, m, k))
        dev = [a.cuda() for a in args]
        got = H.build_best_split(*dev, m, b)
        again = H.build_best_split(*dev, m, b)
        want = H.build_best_split(*args, m, b)
        torch.cuda.synchronize()
        for x, y, z in zip(got, again, want):
            assert torch.equal(x, y)
            assert torch.equal(x.cpu(), z)


def test_kernel_over_padded_codes_on_the_card():
    """Needs a CUDA card (skips here): K4 over codes padded to 16-byte rows
    (``pad_codes``, as the grower holds them) equals its plain version, one
    launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for n, f, b, m, k in [(2048, 918, 2, 128, 3), (2048, 10, 32, 128, 3),
                          (777, 13, 100, 9, 2)]:
        args = _torch(_data(n, f, b, m, k, seed=n + f))
        binned, node, g, h, fmask, lam, gam, mcw = [a.cuda() for a in args]
        k4 = H.build_best_split.launches
        got = H.build_best_split(H.pad_codes(binned), node, g, h, fmask, lam,
                                 gam, mcw, m, b)
        assert H.build_best_split.launches == k4 + 1
        want = H.best_split_plain(*args, m, b)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert torch.equal(x.cpu(), y)
