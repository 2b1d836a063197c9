"""The PyTorch port's tree traversal (``transmogrifai_tpu_torch.models.
serve_trees``) against the JAX package's Pallas kernel in interpret mode and
its gather walk: the same numpy inputs through both, BIT-IDENTICAL per
(row, tree) leaf values across depths 1-10, ragged shapes, leaf-only trees
and -1 routing. The forest mean and boosted sum hold to the Pallas wrappers
within ``SUM_ATOL``. The wrapper's guards (dtype, shape, contiguity, and no
silent CPU fallback for a CUDA tensor) run without a card; the kernel
itself is compared with the plain walk only where a card is present.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.models import serve_pallas as SP
from transmogrifai_tpu.models import trees as JTR
from transmogrifai_tpu_torch.models import serve_trees as ST
from transmogrifai_tpu_torch.models import trees as PTR
from transmogrifai_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

#: f32 sums of up to 200 per-tree values taken in another order than the
#: reference's: each order is within (T-1)·2^-24 of the exact sum relative
#: to Σ|leaf|, which stays below 1e-5 for these leaf magnitudes
SUM_ATOL = 1e-5


def _random_stack(rng, t, depth, f, bins):
    w = 1 << depth
    return (
        rng.integers(-1, f, size=(t, depth, w)).astype(np.int32),
        rng.integers(0, bins, size=(t, depth, w)).astype(np.int32),
        rng.normal(size=(t, w)).astype(np.float32),
    )


def _pallas(binned, sf, sb, lv):
    return np.asarray(SP.serve_trees_pallas(
        jnp.asarray(binned), jnp.asarray(sf), jnp.asarray(sb),
        jnp.asarray(lv), interpret=True,
    ))


def _gather(binned, sf, sb, lv):
    per_tree = jax.vmap(
        lambda a, b, c: JTR.predict_tree(jnp.asarray(binned), JTR.Tree(a, b, c))
    )(jnp.asarray(sf), jnp.asarray(sb), jnp.asarray(lv))
    return np.asarray(per_tree).T


def _port(binned, sf, sb, lv):
    return ST.serve_trees(*(torch.from_numpy(a) for a in (binned, sf, sb, lv)))


class TestBitIdentity:
    @pytest.mark.parametrize("depth", [1, 2, 4, 6, 10])
    def test_matches_pallas_and_gather_across_depths(self, depth):
        rng = np.random.default_rng(depth)
        t, f, n, bins = 5, 7, 133, 16
        sf, sb, lv = _random_stack(rng, t, depth, f, bins)
        binned = rng.integers(0, bins, size=(n, f)).astype(np.int32)
        got = _port(binned, sf, sb, lv).numpy()
        assert got.shape == (n, t) and got.dtype == np.float32
        assert np.array_equal(got, _gather(binned, sf, sb, lv))
        assert np.array_equal(got, _pallas(binned, sf, sb, lv))

    @pytest.mark.parametrize("n,t", [(1, 1), (17, 3), (33, 9)])
    def test_ragged_rows_and_trees(self, n, t):
        rng = np.random.default_rng(100 + n)
        sf, sb, lv = _random_stack(rng, t, 3, 5, 8)
        binned = rng.integers(0, 8, size=(n, 5)).astype(np.int32)
        got = _port(binned, sf, sb, lv).numpy()
        assert got.shape == (n, t)
        assert np.array_equal(got, _pallas(binned, sf, sb, lv))
        assert np.array_equal(got, _gather(binned, sf, sb, lv))

    def test_leaf_only_trees(self):
        rng = np.random.default_rng(2)
        sf, sb, lv = _random_stack(rng, 4, 2, 3, 4)
        sf = np.full_like(sf, -1)
        binned = rng.integers(0, 4, size=(9, 3)).astype(np.int32)
        got = _port(binned, sf, sb, lv).numpy()
        # every row lands on leaf 0 of every tree
        assert np.array_equal(got, np.broadcast_to(lv[:, 0], (9, 4)))
        assert np.array_equal(got, _pallas(binned, sf, sb, lv))

    def test_minus_one_routes_left_and_walk_continues(self):
        # root is a leaf (-1): every row goes left, then node 0 of level 1
        # splits on feature 1 at bin 2; node 1 of level 1 is unreachable
        sf = np.array([[[-1, 0], [1, 0]]], dtype=np.int32)
        sb = np.array([[[99, 0], [2, 0]]], dtype=np.int32)
        lv = np.array([[10.0, 11.0, 12.0, 13.0]], dtype=np.float32)
        binned = np.array([[7, 0], [7, 2], [0, 3], [5, 9]], dtype=np.int32)
        got = _port(binned, sf, sb, lv).numpy()[:, 0]
        assert got.tolist() == [10.0, 10.0, 11.0, 11.0]
        assert np.array_equal(got, _pallas(binned, sf, sb, lv)[:, 0])

    def test_cpu_walk_does_not_count_launches(self):
        rng = np.random.default_rng(4)
        before = ST.serve_trees.launches
        _port(rng.integers(0, 4, size=(5, 3)).astype(np.int32),
              *_random_stack(rng, 2, 2, 3, 4))
        assert ST.serve_trees.launches == before


class TestReductions:
    def test_forest_mean_and_boosted_sum(self):
        rng = np.random.default_rng(5)
        sf, sb, lv = _random_stack(rng, 200, 4, 6, 8)
        binned = rng.integers(0, 8, size=(40, 6)).astype(np.int32)
        jtrees = JTR.Tree(jnp.asarray(sf), jnp.asarray(sb), jnp.asarray(lv))
        ptrees = PTR.Tree(*(torch.from_numpy(a) for a in (sf, sb, lv)))
        pb = torch.from_numpy(binned)
        fmean = ST.predict_forest(pb, ptrees).numpy()
        ref = np.asarray(
            SP.predict_forest_pallas(jnp.asarray(binned), jtrees, interpret=True)
        )
        np.testing.assert_allclose(fmean, ref, rtol=0, atol=SUM_ATOL)
        boosted = ST.predict_boosted(pb, ptrees, 0.3, 0.5).numpy()
        ref = np.asarray(SP.predict_boosted_pallas(
            jnp.asarray(binned), jtrees, jnp.float32(0.3), jnp.float32(0.5),
            interpret=True,
        ))
        np.testing.assert_allclose(boosted, ref, rtol=0, atol=SUM_ATOL)


def _tensors(rng):
    sf, sb, lv = _random_stack(rng, 3, 2, 4, 4)
    binned = rng.integers(0, 4, size=(6, 4)).astype(np.int32)
    return [torch.from_numpy(a) for a in (binned, sf, sb, lv)]


class TestWrapperGuards:
    @pytest.mark.parametrize("slot,bad", [
        (0, lambda x: x.float()),
        (1, lambda x: x.long()),
        (2, lambda x: x.to(torch.int16)),
        (3, lambda x: x.double()),
    ])
    def test_wrong_dtype_raises(self, slot, bad):
        args = _tensors(np.random.default_rng(7))
        args[slot] = bad(args[slot])
        with pytest.raises(TypeError):
            ST.serve_trees(*args)

    @pytest.mark.parametrize("case", ["noncontig", "split_bin", "leaf", "rank"])
    def test_bad_layout_raises(self, case):
        binned, sf, sb, lv = _tensors(np.random.default_rng(8))
        if case == "noncontig":
            binned = torch.cat([binned, binned], dim=1)[:, ::2]
        elif case == "split_bin":
            sb = sb[:, :1, :].contiguous()
        elif case == "leaf":
            lv = lv[:, :2].contiguous()
        else:
            binned = binned.reshape(-1)
        with pytest.raises(ValueError):
            ST.serve_trees(binned, sf, sb, lv)

    def _as_cuda(self, monkeypatch):
        """Route the wrapper's device test to the kernel branch and make the
        plain walk a trap: a CUDA tensor must never fall back to it. The
        library loader gets an empty cache of its own, so a library that an
        earlier test built and cached is never launched on CPU pointers."""
        monkeypatch.setattr(ST, "_on_cuda", lambda x: True)
        monkeypatch.setattr(
            ST, "_library", functools.cache(ST._library.__wrapped__)
        )

        def trap(*a, **k):
            raise AssertionError("fell back to the plain walk")

        monkeypatch.setattr(ST, "serve_trees_reference", trap)

    def test_cuda_tensor_without_nvcc_raises(self, monkeypatch, tmp_path):
        self._as_cuda(monkeypatch)
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.delenv("CUDA_HOME", raising=False)
        monkeypatch.setattr(cuda_build, "DEFAULT_CUDA_ROOT", str(tmp_path))
        monkeypatch.setattr(cuda_build, "_libs", {})
        monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
        before = ST.serve_trees.launches
        with pytest.raises(cuda_build.KernelBuildError, match="nvcc not found"):
            ST.serve_trees(*_tensors(np.random.default_rng(9)))
        assert ST.serve_trees.launches == before

    def test_cuda_tensor_with_failing_loader_raises(self, monkeypatch):
        self._as_cuda(monkeypatch)

        def broken(name):
            raise cuda_build.KernelBuildError(f"cannot build {name}")

        monkeypatch.setattr(cuda_build, "load_library", broken)
        with pytest.raises(cuda_build.KernelBuildError, match="serve_trees"):
            ST.serve_trees(*_tensors(np.random.default_rng(10)))


def test_kernel_matches_plain_walk_on_the_card():
    """Needs a CUDA card (skips here): the kernel at a ragged shape and at
    depth 10 is bit-identical to the plain walk on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed, (n, t, depth, f) in enumerate([(133, 5, 3, 7), (1000, 20, 10, 50)]):
        rng = np.random.default_rng(seed)
        sf, sb, lv = _random_stack(rng, t, depth, f, 32)
        binned = rng.integers(0, 32, size=(n, f)).astype(np.int32)
        args = [torch.from_numpy(a).cuda() for a in (binned, sf, sb, lv)]
        got = ST.serve_trees(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, ST.serve_trees_reference(*args))
