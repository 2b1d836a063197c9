"""Sharded tree growth (``models/trees.py`` under a mesh) on
``tests/test_trees_sharded.py``'s cases and data (n = 333, which divides
no world, so the padding is held): forest, boosted, regression, deep
compaction and predictions, grown over a world of 2 ``gloo`` ranks on the
CPU. Held against the port's single-device fit (splits EQUAL, leaves
within the reference's rtol 1e-5 / atol 1e-6, dead slots NaN on both)
and against the JAX package's ``_fit_forest_batched_sharded`` /
``_fit_boosted_batched_sharded`` at the same shard count. A mesh of one
rank EQUALS the single-device fit; both ranks grow the same trees and
their collective tapes are identical; a kernel fault on one rank fails
every rank. Two tests need cards: a world-1
NCCL sharded fit EQUALS the unsharded one; and, on a host of several
cards, an NCCL world of one rank a card EQUALS the same world over
``gloo`` on the CPU, its splits the single-device fit's."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_fixtures"))
import parallel_cases as C  # noqa: E402
import world  # noqa: E402

from transmogrifai_tpu_torch.models import trees as TR  # noqa: E402
from transmogrifai_tpu_torch.parallel import make_mesh  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

CASES = tuple(C.tree_case_args())


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """[(results by case, tapes)] of the two ranks."""
    return world.run_world(2, "parallel_cases:tree_fits", (),
                           tmp_path_factory.mktemp("trees"))


@pytest.fixture(scope="module")
def single():
    return {name: C.run_tree_case(TR, case, None)
            for name, case in C.tree_case_args().items()}


def _assert_trees_match(a: dict, b: dict) -> None:
    """The reference's ``_assert_trees_match``: splits equal, live leaves
    within rtol 1e-5 / atol 1e-6, dead slots (0/0) NaN on both."""
    np.testing.assert_array_equal(a["split_feat"], b["split_feat"])
    np.testing.assert_array_equal(a["split_bin"], b["split_bin"])
    la, lb = a["leaf_value"], b["leaf_value"]
    live = np.isfinite(la)
    np.testing.assert_array_equal(live, np.isfinite(lb))
    np.testing.assert_allclose(la[live], lb[live], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_sharded_matches_single_device(sharded, single, case):
    got = sharded[0][0][case]
    _assert_trees_match(single[case], got)
    # margins (boosted) and mean-leaf outputs (forest): the reference's
    # margin tolerance
    np.testing.assert_allclose(got["outputs"], single[case]["outputs"],
                               rtol=1e-4, atol=1e-5)
    if "pred" in got:
        np.testing.assert_allclose(got["pred"], single[case]["pred"],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_sharded_matches_the_jax_package(sharded, case):
    import jax.numpy as jnp

    from transmogrifai_tpu.models import trees as JT
    from transmogrifai_tpu.parallel import make_mesh as jax_mesh

    spec = C.tree_case_args()[case]
    binned, y, masks = C.tree_data(**spec["data"])
    if spec["fn"] == "boosted_reg":
        y = y * 2.0 + binned[:, 0].astype(np.float32) * 0.1
    if spec["fn"] == "forest_ones":
        masks = np.ones((2, binned.shape[0]), np.float32)
    mesh = jax_mesh(n_data=2)
    if spec["fn"].startswith("forest"):
        trees = JT.fit_forest_batched(jnp.asarray(binned), jnp.asarray(y),
                                      jnp.asarray(masks), mesh=mesh,
                                      **spec["kw"])
    else:
        trees, _ = JT.fit_boosted_batched(jnp.asarray(binned), jnp.asarray(y),
                                          jnp.asarray(masks), mesh=mesh,
                                          **spec["kw"])
    ref = {"split_feat": np.asarray(trees.split_feat),
           "split_bin": np.asarray(trees.split_bin),
           "leaf_value": np.asarray(trees.leaf_value)}
    _assert_trees_match(ref, sharded[0][0][case])


@pytest.mark.parametrize("case", CASES)
def test_mesh_of_one_equals_single_device(single, case):
    got = C.run_tree_case(TR, C.tree_case_args()[case], make_mesh(n_data=1,
                                                                   device="cpu"))
    for key, want in single[case].items():
        np.testing.assert_array_equal(got[key], want)


def test_ranks_grow_the_same_trees_with_identical_tapes(sharded):
    (r0, t0), (r1, t1) = sharded
    for case in CASES:
        for key in r0[case]:
            np.testing.assert_array_equal(r0[case][key], r1[case][key])
    assert t0["hosts"]["0"] == t1["hosts"]["1"]
    names = {name for _, name in t0["hosts"]["0"]}
    # the reference's all-reduce points, and the outputs' gather
    assert names == {"tree_histogram", "tree_occupancy", "tree_leaf_sums",
                     "tree_rows"}


def test_mesh_refuses_depth_caps_and_lane_targets():
    """The reference's single-device-only routes (its ``trees.py:
    1253-1262``) raise under a mesh here too."""
    binned, y, masks = C.tree_data(n=40, f=4, k=2)
    mesh = make_mesh(n_data=1, device="cpu")
    b, m = torch.from_numpy(binned), torch.from_numpy(masks)
    with pytest.raises(NotImplementedError, match="depth caps"):
        TR.fit_forest_batched(b, torch.from_numpy(y), m, num_trees=1,
                              max_depth=3, num_bins=16, mesh=mesh,
                              max_depth_v=np.array([2, 3], np.int32))
    with pytest.raises(NotImplementedError, match="per-lane targets"):
        TR.fit_forest_batched(b, torch.from_numpy(np.stack([y, y])), m,
                              num_trees=1, max_depth=3, num_bins=16,
                              mesh=mesh)


def test_a_kernel_fault_on_one_rank_fails_every_rank(tmp_path):
    """No fallback: a kernel fault injected into rank 1's split search
    propagates out of its fit, and rank 0, waiting in the next all-reduce,
    fails too; no rank finishes the fit."""
    with pytest.raises(AssertionError) as err:
        world.run_world(2, "parallel_cases:kernel_fault_on", (1,), tmp_path)
    text = str(err.value)
    assert "rank 0 of 2 failed" in text and "rank 1 of 2 failed" in text
    assert "KernelLaunchError: injected split-search launch failure" in text


def test_world_one_nccl_sharded_fit_equals_unsharded_on_the_card(tmp_path):
    """Needs a CUDA card (skips here): one NCCL rank on the card; the
    sharded forest and boosted fits EQUAL the unsharded ones (an
    all-reduce over one rank is the identity)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import datetime

    import torch.distributed as dist

    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path}/store", world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(n_data=1)
        for case in ("forest", "boosted"):
            spec = C.tree_case_args()[case]
            want = C.run_tree_case(TR, spec, None, device="cuda")
            got = C.run_tree_case(TR, spec, mesh, device="cuda")
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])
    finally:
        dist.destroy_process_group()


def test_nccl_world_across_cards_on_the_card(tmp_path):
    """Needs two or more CUDA cards (skips here and on a one-card host):
    an NCCL world of one rank a card (up to four) fits the card phase's
    forest, boosted and 256-bin boosted trees ([16384, 128], depth 6).
    Every rank's trees EQUAL rank 0's and the same world's over ``gloo``
    on the CPU; their splits EQUAL the single-device card fit and their
    leaves lie within rtol 1e-5 / atol 1e-6; the tapes are identical."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    n = min(torch.cuda.device_count(), 4)
    nccl = world.run_world(n, "parallel_cases:card_fits", (None,),
                           tmp_path / "nccl", backend="nccl")
    cpu = world.run_world(n, "parallel_cases:card_fits", ("cpu",),
                          tmp_path / "cpu")
    single = C.card_fits("cuda:0", sharded=False)
    first, tapes0 = nccl[0]
    keys = ("split_feat", "split_bin", "leaf_value", "outputs")
    for rank, (got, tapes) in enumerate(nccl):
        assert tapes["hosts"][str(rank)] == tapes0["hosts"]["0"]
        for name in first:
            for key in keys:
                np.testing.assert_array_equal(got[name][key], first[name][key])
                np.testing.assert_array_equal(cpu[rank][0][name][key],
                                              first[name][key])
    for name in first:
        _assert_trees_match(single[name], first[name])
