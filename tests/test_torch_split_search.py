"""The split search of the PyTorch port (``transmogrifai_tpu_torch.models.
hist.split_search`` and its plain version ``split_search_plain``) against
the JAX package's split arithmetic (``transmogrifai_tpu/models/trees.py``,
the gain and argmax after each feature group's histogram), run under
``jax.jit`` on the CPU as ``tests/test_torch_grow.py``'s
``TestReferenceArithmetic`` runs the reference's reductions: the same
gains, features and bins bit for bit at 2 to 4500 bins, ragged fits, slots
and features, masked features, ``lam = 0`` over empty slots (NaN gains) and
slots with no valid threshold. The ``count=`` path (slots with no row take
the result of an all-zero histogram without reading it) equals the plain
version. The wrapper never falls back to the plain version for a CUDA
tensor; the split-search kernel itself is compared with the plain version
only where a card is present."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu_torch.models import hist as H
from transmogrifai_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

BINS = [2, 5, 16, 17, 32, 64, 255, 256, 300, 4500]


@jax.jit
def _reference_split(hist, gmask, lam, gam, mcw):
    """The reference's split arithmetic over one group's histogram
    (transmogrifai_tpu/models/trees.py, after the histogram), lam, gam and
    mcw [K, 1, 1, 1]."""
    hg, hh = hist[..., 0], hist[..., 1]
    gl = jnp.cumsum(hg, axis=3)[..., :-1]
    hl = jnp.cumsum(hh, axis=3)[..., :-1]
    gt = hg.sum(axis=3, keepdims=True)
    ht = hh.sum(axis=3, keepdims=True)
    gr = gt - gl
    hr = ht - hl
    parent = (gt**2) / (ht + lam)
    gain = 0.5 * (gl**2 / (hl + lam) + gr**2 / (hr + lam) - parent) - gam
    valid = (hl >= mcw) & (hr >= mcw) & (gmask[:, None, :, None] > 0)
    gain = jnp.where(valid, gain, -jnp.inf)
    flat = gain.reshape(gain.shape[0], gain.shape[1], -1)
    best = jnp.argmax(flat, axis=2)
    best_gain = jnp.take_along_axis(flat, best[..., None], axis=2)[..., 0]
    nb = hist.shape[3] - 1
    return (best_gain, (best // nb).astype(jnp.int32),
            (best % nb).astype(jnp.int32))


def _case(k, m, f, b, seed, empty=0.0, lam=(1.0, 0.0, 0.5), mcw=(1.0, 0.0, 2.0)):
    """A histogram [K, M, F, B, 2] of sums of a few rows (hess >= 0), some
    slots empty (all zeros), the feature mask with holes (one fit with every
    feature off), and per-fit knobs."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, 6, (k, m, f, b, 1))
    g = (rng.normal(size=(k, m, f, b)) * rows[..., 0]).astype(np.float32)
    h = (rng.uniform(0.1, 1.0, (k, m, f, b)) * rows[..., 0]).astype(np.float32)
    h[rng.random((k, m, f, b)) < 0.3] = 0.0
    hist = np.stack([g, h], axis=-1)
    slot_empty = rng.random((k, m)) < empty
    hist[slot_empty] = 0.0
    count = np.where(slot_empty, 0, rng.integers(1, 100, (k, m))).astype(np.int32)
    gmask = (rng.random((k, f)) < 0.8).astype(np.float32)
    gmask[0, 0] = 1.0
    if k > 2:
        gmask[2] = 0.0
    cyc = lambda v: np.resize(np.float32(v), k)  # noqa: E731
    knobs = (cyc(lam), cyc([0.0, 0.1, 0.0]), cyc(mcw))
    return hist, gmask, knobs, count


def _ref(hist, gmask, knobs):
    lam, gam, mcw = (jnp.asarray(v)[:, None, None, None] for v in knobs)
    return [np.asarray(a) for a in _reference_split(
        jnp.asarray(hist), jnp.asarray(gmask), lam, gam, mcw)]


def _port(fn, hist, gmask, knobs, count=None):
    return [a.numpy() for a in fn(
        torch.from_numpy(hist), torch.from_numpy(gmask),
        *(torch.from_numpy(v) for v in knobs),
        None if count is None else torch.from_numpy(count))]


def _assert_same(got, want):
    assert np.array_equal(got[0], want[0], equal_nan=True)
    assert got[0].dtype == np.float32
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
    assert got[1].dtype == got[2].dtype == np.int32


@pytest.mark.parametrize("b", BINS)
def test_plain_version_is_the_reference_arithmetic(b):
    k, m, f = (3, 5, 7) if b < 1000 else (2, 3, 2)
    hist, gmask, knobs, _ = _case(k, m, f, b, seed=b)
    _assert_same(_port(H.split_search_plain, hist, gmask, knobs),
                 _ref(hist, gmask, knobs))


@pytest.mark.parametrize("k,m,f,b", [(1, 1, 1, 2), (4, 3, 918, 2),
                                     (2, 7, 10, 256), (3, 2, 33, 17)])
def test_ragged_shapes_and_scalar_knobs(k, m, f, b):
    hist, gmask, knobs, _ = _case(k, m, f, b, seed=k * m + f)
    want = _ref(hist, gmask, knobs)
    _assert_same(_port(H.split_search, hist, gmask, knobs), want)
    one = tuple(np.full(1, v[0], np.float32) for v in knobs)
    _assert_same(_port(H.split_search, hist, gmask, one),
                 _ref(hist, gmask, tuple(np.resize(v, k) for v in one)))


@pytest.mark.parametrize("b", [2, 32, 300])
def test_lam_zero_over_empty_slots_gives_nan(b):
    """GBT's knobs (lam 0): an empty slot's gains are 0/0 where its
    children may weigh 0 (mcw 0), and NaN is the argmax."""
    hist, gmask, knobs, _ = _case(3, 6, 4, b, seed=5, empty=0.5,
                                  lam=(0.0,), mcw=(0.0, 1.0, 0.0))
    want = _ref(hist, gmask, knobs)
    assert np.isnan(want[0]).any()
    _assert_same(_port(H.split_search_plain, hist, gmask, knobs), want)


def test_no_valid_threshold_gives_index_zero():
    hist, gmask, knobs, _ = _case(3, 4, 5, 8, seed=9, mcw=(1e9,))
    want = _ref(hist, gmask, knobs)
    assert (want[0] == -np.inf).all() and (want[1] == 0).all()
    _assert_same(_port(H.split_search_plain, hist, gmask, knobs), want)


@pytest.mark.parametrize("b", [2, 17, 256])
@pytest.mark.parametrize("lam,mcw", [((1.0, 0.0, 0.5), (1.0, 0.0, 2.0)),
                                     ((0.0,), (0.0,)), ((0.0,), (-1.0, 0.0, 3.0))])
def test_count_skips_empty_slots(b, lam, mcw):
    """Slots whose count is 0 take an all-zero histogram's result without
    reading it: equal to the plain version over the zeros, NaN gains (lam
    0, mcw <= 0) and all-off masks included."""
    hist, gmask, knobs, count = _case(3, 8, 6, b, seed=b + 1, empty=0.5,
                                      lam=lam, mcw=mcw)
    gmask[1, :2] = 0.0
    want = _port(H.split_search_plain, hist, gmask, knobs)
    _assert_same(_port(H.split_search, hist, gmask, knobs, count), want)
    _assert_same(_port(H.split_search_plain, hist, gmask, knobs, count), want)
    _assert_same(want, _ref(hist, gmask, knobs))


class TestWrapperGuards:
    def _as_cuda(self, monkeypatch):
        monkeypatch.setattr(H, "_on_cuda", lambda x: True)
        monkeypatch.setattr(H, "_library", functools.cache(H._library.__wrapped__))

        def trap(*a, **k):
            raise AssertionError("fell back to the plain version")

        monkeypatch.setattr(H, "split_search_plain", trap)

    def _args(self, b=8):
        hist, gmask, knobs, count = _case(3, 4, 5, b, seed=1)
        return ([torch.from_numpy(hist), torch.from_numpy(gmask)]
                + [torch.from_numpy(v) for v in knobs], torch.from_numpy(count))

    def test_failing_loader_raises(self, monkeypatch):
        self._as_cuda(monkeypatch)

        def broken(name):
            raise cuda_build.KernelBuildError(f"cannot build {name}")

        monkeypatch.setattr(cuda_build, "load_library", broken)
        args, count = self._args()
        before = H.split_search.launches
        with pytest.raises(cuda_build.KernelBuildError, match="split_search"):
            H.split_search(*args, count=count)
        assert H.split_search.launches == before

    @pytest.mark.parametrize("b", [1, H.HIST_WIDE_MAX_BINS + 1])
    def test_bins_outside_the_domain_raise(self, b):
        hist = torch.zeros((1, 1, 1, b, 2))
        one = torch.ones(1)
        with pytest.raises(ValueError, match="HIST_WIDE_MAX_BINS"):
            H.split_search(hist, torch.ones((1, 1)), one, one, one)

    @pytest.mark.parametrize("case", ["mask_shape", "knob_len", "count_dtype",
                                      "hist_dtype"])
    def test_bad_inputs_raise(self, case):
        (hist, gmask, lam, gam, mcw), count = self._args()
        if case == "mask_shape":
            gmask = gmask[:, :-1]
        elif case == "knob_len":
            lam = lam[:2]
        elif case == "count_dtype":
            count = count.long()
        else:
            hist = hist.double()
        with pytest.raises(ValueError):
            H.split_search(hist, gmask, lam, gam, mcw, count=count)

    def test_cpu_plain_version_does_not_count_launches(self):
        args, count = self._args()
        before = H.split_search.launches
        H.split_search(*args, count=count)
        assert H.split_search.launches == before


def test_split_kernel_matches_plain_version_on_the_card():
    """Needs a CUDA card (skips here): one launch per call, equal to the
    plain version on the card and on the CPU bit for bit (NaN where it has
    NaN), with and without ``count``, at 2 to 4500 bins, the training
    paths' group shapes among them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shapes = [(3, 5, 7, b) for b in BINS if b < 1000] + [
        (2, 3, 2, 4500), (6, 64, 918, 2), (18, 256, 10, 256), (6, 64, 10, 32)]
    for i, (k, m, f, b) in enumerate(shapes):
        hist, gmask, knobs, count = _case(k, m, f, b, seed=i, empty=0.4,
                                          lam=(1.0, 0.0), mcw=(1.0, 0.0, 10.0))
        cpu = [torch.from_numpy(a) for a in (hist, gmask, *knobs, count)]
        dev = [a.cuda() for a in cpu]
        want = H.split_search_plain(*cpu[:5], cpu[5])
        for cnt in (None, dev[5]):
            before = H.split_search.launches
            got = H.split_search(*dev[:5], count=cnt)
            assert H.split_search.launches == before + 1
            on_card = H.split_search_plain(*dev[:5], cnt)
            torch.cuda.synchronize()
            for x, y, z in zip(got, on_card, want):
                assert _same(x, y) and _same(x.cpu(), z)


def _same(x, y):
    """Equal values, NaN where the other has NaN."""
    return (torch.equal(x.isnan(), y.isnan())
            and torch.equal(torch.where(x.isnan(), 0, x),
                            torch.where(y.isnan(), 0, y)))
