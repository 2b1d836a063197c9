"""The PyTorch port's tree traversal (``transmogrifai_tpu_torch.models.
serve_trees``) against the JAX package's Pallas kernel in interpret mode and
its gather walk: the same numpy inputs through both, BIT-IDENTICAL per
(row, tree) leaf values across depths 1-10, ragged shapes, leaf-only trees
and -1 routing. The forest mean and boosted sum hold to the Pallas wrappers
(the reference's device route, another summation order) within
``SUM_TOL``. The kernel's packed node layout (``PackedTrees``:
32-bit words in heap order, or word pairs where a model's features or bins
do not fit 16 bits, trees interleaved in tiles, the levels below 10 outside
the top array)
and its plain walk are held to the same oracles, bit for bit, at depths up
to 14. The wrapper's guards (dtype, shape, contiguity, and no
silent CPU fallback for a CUDA tensor) run without a card; the kernel
itself is compared with the plain walk only where a card is present.
"""
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.models import serve_pallas as SP
from transmogrifai_tpu.models import trees as JTR
from transmogrifai_tpu_torch.models import serve_trees as ST
from transmogrifai_tpu_torch.local.scoring import score_function
from transmogrifai_tpu_torch.models import trees as PTR
from transmogrifai_tpu_torch.utils import cuda_build
from transmogrifai_tpu_torch.workflow.persistence import load_workflow_model

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

#: the Pallas wrappers' reductions (the reference's device route) sum the
#: trees in another order than the port's tree order: the results differ in
#: the last ulp (measured: up to 3.8e-06 absolute, 7.5e-07 relative on
#: boosted margins up to 8.6; 1.3e-08 on forest means), held to the
#: reference's own host-versus-device bound, rtol = atol = 1e-6
#: (tests/test_predict_host.py)
SUM_TOL = 1e-6


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
        np.testing.assert_allclose(fmean, ref, rtol=SUM_TOL, atol=SUM_TOL)
        boosted = ST.predict_boosted(pb, ptrees, 0.3, 0.5).numpy()
        ref = np.asarray(SP.predict_boosted_pallas(
            jnp.asarray(binned), jtrees, jnp.float32(0.3), jnp.float32(0.5),
            interpret=True,
        ))
        np.testing.assert_allclose(boosted, ref, rtol=SUM_TOL, atol=SUM_TOL)


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
        monkeypatch.setattr(ST, "serve_packed_plain", trap)

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

    def test_packed_cuda_tensor_with_failing_loader_raises(self, monkeypatch):
        binned, sf, sb, lv = _tensors(np.random.default_rng(11))
        packed = ST.pack_trees(sf, sb, lv, num_features=binned.shape[1])
        self._as_cuda(monkeypatch)

        def broken(name):
            raise cuda_build.KernelBuildError(f"cannot build {name}")

        monkeypatch.setattr(cuda_build, "load_library", broken)
        before = ST.serve_trees.launches
        with pytest.raises(cuda_build.KernelBuildError, match="serve_trees"):
            ST.serve_trees_packed(binned, packed)
        assert ST.serve_trees.launches == before

    def test_packed_layout_mismatch_raises(self):
        binned, sf, sb, lv = _tensors(np.random.default_rng(12))
        packed = ST.pack_trees(sf, sb, lv, num_features=binned.shape[1])
        with pytest.raises(ValueError):
            ST.serve_trees_packed(binned, packed._replace(depth=3))
        with pytest.raises(TypeError):
            ST.serve_trees_packed(binned, packed._replace(
                leaf_value=packed.leaf_value.double()))

    def test_cuda_tensor_with_failing_loader_raises(self, monkeypatch):
        self._as_cuda(monkeypatch)

        def broken(name):
            raise cuda_build.KernelBuildError(f"cannot build {name}")

        monkeypatch.setattr(cuda_build, "load_library", broken)
        with pytest.raises(cuda_build.KernelBuildError, match="serve_trees"):
            ST.serve_trees(*_tensors(np.random.default_rng(10)))


class TestPackedLayout:
    @pytest.mark.parametrize("depth", [1, 10, 12, 14])
    @pytest.mark.parametrize("n,t", [(37, 3), (5, 1), (70, 6)])
    def test_packed_walk_matches_pallas_gather_and_reference(self, depth, n, t):
        rng = np.random.default_rng(1000 * depth + n)
        f, bins = 6, 8
        sf, sb, lv = _random_stack(rng, t, depth, f, bins)
        binned = rng.integers(0, bins, size=(n, f)).astype(np.int32)
        args = [torch.from_numpy(a) for a in (binned, sf, sb, lv)]
        want = ST.serve_trees_reference(*args).numpy()
        assert np.array_equal(want, _pallas(binned, sf, sb, lv))
        assert np.array_equal(want, _gather(binned, sf, sb, lv))
        for wide in (False, True):
            packed = ST.pack_trees_plain(*args[1:], wide=wide)
            assert packed.top_levels == min(depth, ST.TOP_LEVELS)
            assert packed.top.shape[0] == -(-t // packed.tile_trees)
            got = ST.serve_trees_packed(args[0], packed).numpy()
            assert got.dtype == np.float32 and np.array_equal(got, want)
        # the model packing picks 32-bit words for this stack
        assert not ST.pack_trees(*args[1:], num_features=f).wide

    def test_minus_one_node_keeps_walking_in_the_packed_layout(self):
        sf = np.array([[[-1, 0], [1, 0]]], dtype=np.int32)
        sb = np.array([[[99, 0], [2, 0]]], dtype=np.int32)
        lv = np.array([[10.0, 11.0, 12.0, 13.0]], dtype=np.float32)
        binned = np.array([[7, 0], [7, 2], [0, 3], [5, 9]], dtype=np.int32)
        args = [torch.from_numpy(a) for a in (binned, sf, sb, lv)]
        for wide in (False, True):
            packed = ST.pack_trees_plain(*args[1:], wide=wide)
            got = ST.serve_trees_packed(args[0], packed).numpy()[:, 0]
            assert got.tolist() == [10.0, 10.0, 11.0, 11.0]
        # padding trees of the tile are leaves (bin 0xFFFF, above every code)
        packed = ST.pack_trees_plain(*args[1:], wide=False)
        assert packed.tile_trees == 32 and (packed.top[0, :, 1:] == 0xFFFF).all()

    def test_depth_zero_stack(self):
        sf = np.zeros((3, 0, 1), np.int32)
        lv = np.array([[1.5], [2.5], [-1.0]], np.float32)
        binned = np.zeros((4, 2), np.int32)
        args = [torch.from_numpy(a) for a in (binned, sf, sf.copy(), lv)]
        packed = ST.pack_trees(*args[1:], num_features=2)
        got = ST.serve_trees_packed(args[0], packed).numpy()
        assert np.array_equal(got, np.broadcast_to(lv[:, 0], (4, 3)))

    def test_cpu_packing_equals_the_per_call_wide_packing(self, monkeypatch):
        """On the card ``serve_trees`` walks the wide packing of the split
        arrays, made per call with no read of their values; the walk over
        it equals the gather walk."""
        rng = np.random.default_rng(3)
        sf, sb, lv = (torch.from_numpy(a) for a in _random_stack(rng, 5, 4, 3, 9))
        binned = torch.from_numpy(rng.integers(0, 9, size=(11, 3)).astype(np.int32))
        walked = []

        def walk(b, packed):
            walked.append(packed)
            return ST.serve_packed_plain(b, packed)

        monkeypatch.setattr(ST, "_on_cuda", lambda x: True)
        monkeypatch.setattr(ST, "_walk", walk)
        got = ST.serve_trees(binned, sf, sb, lv)
        (a,) = walked
        b = ST.pack_trees_plain(sf, sb, lv, wide=True)
        assert a.wide and a.code_bytes == 4
        assert all(torch.equal(x, y) for x, y in zip(a[:4], b[:4]))
        assert torch.equal(got, ST.serve_trees_reference(binned, sf, sb, lv))

    @pytest.mark.parametrize("depth,wide,tile", [
        (3, False, 32), (9, False, 32), (10, False, 16), (12, False, 16),
        (14, False, 16), (8, True, 32), (10, True, 8), (12, True, 8),
    ])
    def test_tile_holds_the_top_levels(self, depth, wide, tile):
        assert ST.tile_trees_for(depth, wide) == tile
        nodes = (1 << min(depth, ST.TOP_LEVELS)) - 1
        assert tile * nodes * (8 if wide else 4) <= ST.TILE_NODE_BYTES

    @pytest.mark.parametrize("n,f,t,depth,order", [
        (8192, 10, 200, 10, "tile"),     # the serving main path: narrow rows
        (8192, 928, 200, 10, "chunk"),   # (a): wide rows
        (8192, 928, 50, 12, "chunk"),    # (b)
        (16384, 928, 20, 12, "chunk"),   # a training launch
    ])
    def test_launch_plan_picks_the_order_that_moves_fewer_bytes(
            self, n, f, t, depth, order):
        rng = np.random.default_rng(depth)
        sf, sb, lv = (torch.from_numpy(a)
                      for a in _random_stack(rng, t, depth, f, 32))
        packed = ST.pack_trees(sf, sb, lv, num_features=f)
        assert packed.code_bytes == 1
        plan = ST.launch_shape(packed, n, f)
        assert plan["order"] == order
        moved = plan["bytes_moved"]
        assert moved[order] == min(v for v in moved.values() if v is not None)
        groups = plan["threads"] // packed.tile_trees
        assert plan["chunk_rows"] % (groups * plan["walks"]) == 0
        stride = -(-f * packed.code_bytes // 16) * 16
        node_bytes = packed.top[0].numel() * 4
        smem = plan["buffers"] * node_bytes + plan["chunk_rows"] * stride * bool(
            plan["code_bytes"])
        assert smem <= ST.SMEM_BYTES

    def test_code_bytes_follow_the_live_split_bins(self):
        sf = torch.tensor([[[0, -1], [1, 0]]], dtype=torch.int32)
        for bins, want in (([254, 9], 1), ([255, 9], 2), ([65534, 9], 2),
                           ([70000, 9], 4), ([-1, 9], 4)):
            sb = torch.tensor([[[bins[0], 1 << 20], [bins[1], 0]]],
                              dtype=torch.int32)
            assert ST.code_bytes_for(sf, sb) == want


class TestWordLimits:
    def _stack(self, f, bin_value):
        sf = np.array([[[f - 1, 0], [0, -1]]], dtype=np.int32)
        sb = np.array([[[bin_value, 0], [3, 0]]], dtype=np.int32)
        lv = np.array([[1.0, 2.0, 3.0, 4.0]], dtype=np.float32)
        return sf, sb, lv

    @pytest.mark.parametrize("f,bin_value,wide", [
        (65536, 65534, False),   # the largest the word holds
        (65537, 65534, True),    # feature 65536 needs 17 bits
        (4, 65535, True),        # the bin of a leaf word
        (4, 65536, True),        # the bin needs 17 bits
        (4, -1, True),           # a negative bin
    ])
    def test_word_limits_and_the_wide_route(self, f, bin_value, wide):
        sf, sb, lv = self._stack(f, bin_value)
        rng = np.random.default_rng(f)
        binned = np.zeros((6, f), np.int32)
        # codes at, around and above the split bin and the 16-bit range
        binned[:, f - 1] = [bin_value - 1, bin_value, bin_value + 1, 0,
                            65535, 70000]
        binned[:, 0] = rng.integers(0, 8, size=6)
        args = [torch.from_numpy(a) for a in (binned, sf, sb, lv)]
        packed = ST.pack_trees(*args[1:], num_features=f)
        assert packed.wide == wide
        want = ST.serve_trees_reference(*args)
        assert torch.equal(ST.serve_trees_packed(args[0], packed), want)
        assert torch.equal(ST.serve_trees(*args), want)

    def test_dead_node_bins_do_not_force_the_wide_route(self):
        sf, sb, lv = self._stack(4, 5)
        sb[0, 1, 1] = 1 << 20  # under a -1 feature: never read
        packed = ST.pack_trees(*(torch.from_numpy(a) for a in (sf, sb, lv)),
                               num_features=4)
        assert not packed.wide


FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_serving")


@pytest.mark.parametrize("name", ["xgb", "rf"])
def test_packing_at_to_cpu_leaves_fixture_scores_unchanged(name):
    """A saved model placed on the CPU packs its stacks (32-bit words) and
    scores through the packed plain walk: its core equals the split-array
    walk's bit for bit, and the stored scores still hold within 1e-5."""
    path = os.path.join(FIXTURES, name)
    model = load_workflow_model(path, device="cpu")
    best = model.stage_plan()[-1].best_model.to("cpu")
    stacks, boosted = best._tree_stacks()
    assert all(isinstance(p, ST.PackedTrees) and not p.wide
               for p in best.device_stacks)
    x = np.random.default_rng(9).normal(size=(64, best.thresholds.shape[0]))
    x = x.astype(np.float32)
    binned = PTR.bin_data(torch.from_numpy(x),
                          torch.from_numpy(best.thresholds))
    for col, st in enumerate(stacks):
        tree = PTR.Tree(*(torch.tensor(np.asarray(a)) for a in st))
        per_tree = ST.serve_trees(binned, *tree)
        assert torch.equal(ST.serve_trees_packed(binned, best.device_stacks[col]),
                           per_tree)
    with open(os.path.join(path, "rows.json")) as fh:
        rows = json.load(fh)
    with np.load(os.path.join(path, "expected.npz")) as z:
        want = z["probability"]
    out = score_function(model, device="cpu").batch(rows)
    prob = np.array([[p["probability_0"], p["probability_1"]]
                     for p in (next(iter(r.values())) for r in out)])
    # the stored scores came from the reference's host route, which sums
    # in tree order as the port does: equal
    assert np.array_equal(prob, want)


def test_kernel_matches_plain_walk_on_the_card():
    """Needs a CUDA card (skips here): the kernel, per call and over a
    packed stack, at a ragged shape, at depths 10 and 12, at a width
    (F = 65537: feature 65536 needs 17 bits) only the wide layout holds and
    at the wide rows that take chunk order, is bit-identical to the plain
    walk on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the last two: wide rows (the codes staged per row chunk, tiles
    # streamed past them, two tiles and a deep stack)
    cases = [(133, 5, 3, 7), (1000, 20, 10, 50), (700, 9, 12, 30),
             (64, 6, 5, 65537), (3000, 40, 3, 928), (2000, 20, 12, 928)]
    for seed, (n, t, depth, f) in enumerate(cases):
        rng = np.random.default_rng(seed)
        sf, sb, lv = _random_stack(rng, t, depth, f, 32)
        binned = rng.integers(0, 32, size=(n, f)).astype(np.int32)
        host = [torch.from_numpy(a) for a in (sf, sb, lv)]
        args = [torch.from_numpy(binned).cuda()] + [a.cuda() for a in host]
        want = ST.serve_trees_reference(*args)
        packed = ST.pack_trees(*host, num_features=f)
        assert packed.wide == (f > ST.PACKED_MAX_FEATURES)
        got = ST.serve_trees(*args)
        got_packed = ST.serve_trees_packed(args[0], packed.to("cuda"))
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got_packed, want)
