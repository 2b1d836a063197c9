"""The leaf sums of the PyTorch port past the reference's one-hot budget
(``transmogrifai_tpu_torch.models.leaf_sum.leaf_sum``, the scatter-add form
of ``trees._segment_sum_small``) against the JAX package's
``_segment_sum_small`` on the CPU, bit for bit: 4096 slots over 30000 rows
of three fits, with the rows spread and with 90% of them in one slot (a
late boosting round). The grower takes this form for its depth-12 leaves
at 16384 rows and 18 fits. The wrapper never falls back to the plain
version for a CUDA tensor; the leaf-sum kernel itself is compared with the
plain version only where a card is present, at the training paths' shape
(18 fits x 16384 rows x 4096 slots)."""
import functools

import numpy as np
import pytest
import torch

import jax

from transmogrifai_tpu.models import trees as JTR
from transmogrifai_tpu_torch.models import hist as H
from transmogrifai_tpu_torch.models import leaf_sum as LS
from transmogrifai_tpu_torch.models import trees as PTR
from transmogrifai_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]


def _slots(rng, k, n, size, crowded: float):
    """Slots [K, N] int32: a share ``crowded`` of the rows in slot 7, the
    rest uniform over [0, size)."""
    idx = rng.integers(0, size, size=(k, n))
    return np.where(rng.random((k, n)) < crowded, 7, idx).astype(np.int32)


def _values(rng, k, n):
    """Grad-like values with exact zeros (rows a fold leaves out)."""
    v = rng.normal(size=(k, n)).astype(np.float32)
    v[rng.random((k, n)) < 0.2] = 0.0
    return v


@pytest.mark.parametrize("crowded", [0.0, 0.9])
def test_scatter_form_equals_the_reference(crowded):
    rng = np.random.default_rng(int(crowded * 10))
    n, size = 30000, 4096
    assert PTR._scatter_form(3, n, size)
    g, h = _values(rng, 3, n), np.abs(_values(rng, 3, n))
    idx = _slots(rng, 3, n, size, crowded)
    ref = jax.jit(JTR._segment_sum_small, static_argnums=2)
    want_g, want_h = (np.asarray(ref(v, idx, size)) for v in (g, h))
    got_g, got_h = LS.leaf_sum(torch.from_numpy(g), torch.from_numpy(h),
                               torch.from_numpy(idx), size)
    assert np.array_equal(got_g.numpy(), want_g)
    assert np.array_equal(got_h.numpy(), want_h)
    one = PTR._segment_sum_small(torch.from_numpy(g), torch.from_numpy(idx), size)
    assert np.array_equal(one.numpy(), want_g)


def test_one_array_form_sums_g_alone():
    """``leaf_sum(g, None, idx, size)``: out_g as with both arrays, out_h
    None (``_segment_sum_small``'s scatter form sums one array)."""
    rng = np.random.default_rng(5)
    g, h = torch.from_numpy(_values(rng, 2, 3000)), torch.ones((2, 3000))
    idx = torch.from_numpy(_slots(rng, 2, 3000, 600, 0.5))
    one_g, one_h = LS.leaf_sum(g, None, idx, 600)
    assert one_h is None
    assert torch.equal(one_g, LS.leaf_sum(g, h, idx, 600)[0])


def test_grower_takes_the_leaf_sum_past_the_budget(monkeypatch):
    """A depth-12 growth of 3 fits over 30000 rows sums its leaves through
    ``leaf_sum`` once (both arrays), not twice through the windowed form."""
    calls = []
    real = LS.leaf_sum

    def spy(g, h, idx, size):
        calls.append(size)
        return real(g, h, idx, size)

    monkeypatch.setattr(LS, "leaf_sum", spy)
    rng = np.random.default_rng(3)
    n = 30000
    binned = torch.from_numpy(rng.integers(0, 4, (n, 3)).astype(np.int32))
    g = torch.from_numpy(_values(rng, 3, n))
    h = torch.ones((3, n))
    ones = torch.ones((3, n))
    tree, node = PTR._grow_tree_impl(binned, g, h, ones, torch.ones((3, 3)),
                                     max_depth=12, num_bins=4)
    assert calls == [4096]
    want = LS.leaf_sum_plain(g, h, node, 4096)
    assert torch.equal(tree.leaf_value, -want[0] / (want[1] + 1.0))


class TestWrapperGuards:
    def _args(self):
        rng = np.random.default_rng(0)
        return (torch.from_numpy(_values(rng, 2, 50)),
                torch.from_numpy(_values(rng, 2, 50)),
                torch.from_numpy(_slots(rng, 2, 50, 16, 0.5)))

    def test_failing_loader_raises(self, monkeypatch):
        monkeypatch.setattr(H, "_on_cuda", lambda x: True)
        monkeypatch.setattr(LS, "_library",
                            functools.cache(LS._library.__wrapped__))

        def trap(*a, **k):
            raise AssertionError("fell back to the plain version")

        def broken(name):
            raise cuda_build.KernelBuildError(f"cannot build {name}")

        monkeypatch.setattr(LS, "leaf_sum_plain", trap)
        monkeypatch.setattr(cuda_build, "load_library", broken)
        before = LS.leaf_sum.launches
        with pytest.raises(cuda_build.KernelBuildError, match="leaf_sum"):
            LS.leaf_sum(*self._args(), 16)
        assert LS.leaf_sum.launches == before

    @pytest.mark.parametrize("case", ["g_dtype", "idx_dtype", "shape", "size"])
    def test_bad_inputs_raise(self, case):
        g, h, idx = self._args()
        size = 16
        if case == "g_dtype":
            g = g.double()
        elif case == "idx_dtype":
            idx = idx.long()
        elif case == "shape":
            h = h[:, :-1]
        else:
            size = 0
        with pytest.raises((TypeError, ValueError)):
            LS.leaf_sum(g, h, idx, size)

    def test_cpu_plain_version_does_not_count_launches(self):
        before = LS.leaf_sum.launches
        LS.leaf_sum(*self._args(), 16)
        assert LS.leaf_sum.launches == before


def test_leaf_sum_kernel_matches_plain_version_on_the_card():
    """Needs a CUDA card (skips here): the kernel's sums equal the plain
    version's on the CPU bit for bit at the grower's depth-12 shape, with
    the rows spread and with 90% of them in one slot, and at a ragged
    shape, and summing g alone; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed, (k, n, size, crowded) in enumerate([
            (18, 16384, 4096, 0.0), (18, 16384, 4096, 0.9),
            (3, 30000, 4096, 0.5), (1, 1001, 600, 0.3)]):
        rng = np.random.default_rng(seed)
        cpu = (torch.from_numpy(_values(rng, k, n)),
               torch.from_numpy(np.abs(_values(rng, k, n))),
               torch.from_numpy(_slots(rng, k, n, size, crowded)))
        want = LS.leaf_sum_plain(*cpu, size)
        before = LS.leaf_sum.launches
        got = LS.leaf_sum(*(a.cuda() for a in cpu), size)
        torch.cuda.synchronize()
        assert LS.leaf_sum.launches == before + 1
        for x, y in zip(got, want):
            assert torch.equal(x.cpu(), y)
        one_g, one_h = LS.leaf_sum(cpu[0].cuda(), None, cpu[2].cuda(), size)
        torch.cuda.synchronize()
        assert one_h is None and torch.equal(one_g.cpu(), want[0])
