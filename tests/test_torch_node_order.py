"""The row order of the PyTorch port's histogram kernels
(``transmogrifai_tpu_torch.models.hist.node_order``, kernel
``csrc/node_order.cu`` on the card) and the grower's sharing of it.

``node_order`` has no JAX counterpart: the reference's kernels one-hot every
row against every slot. Its plain version is held to a stable numpy sort of
the same keys at ragged shapes; histograms given a precomputed order equal
those without; and the grower, with the card's routes taken through their
plain versions, orders each node chunk once for all its feature groups and
still reproduces the training fixture the JAX package stored. The CUDA
kernels themselves are compared with the plain versions only where a card
is present."""
import json
import os

import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.models import gbdt as PG
from transmogrifai_tpu_torch.models import hist as H

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "torch_training")


def _slots(case, k, n, m, seed):
    """[K, N] slots, grad and hess for one ragged case."""
    rng = np.random.default_rng(seed)
    node = rng.integers(-1, m + 2, size=(k, n)).astype(np.int32)
    g = rng.normal(size=(k, n)).astype(np.float32)
    h = rng.uniform(0.1, 1, size=(k, n)).astype(np.float32)
    if case == "one_slot":
        node[:] = m - 1
    elif case == "all_dead":
        node[0] = -1
        node[1:] = m
    elif case == "zero_weight":
        zero = rng.uniform(size=(k, n)) < 0.4
        g[zero] = np.where(rng.uniform(size=zero.sum()) < 0.5, 0.0, -0.0)
        h[zero] = 0.0
    return node, g, h


def _want(node, g, h, m):
    """Stable numpy sort of the keys (slot, or m for a dead row)."""
    live = (node >= 0) & (node < m) & ((g != 0) | (h != 0))
    key = np.where(live, node, m)
    order = np.argsort(key, axis=1, kind="stable").astype(np.int32)
    count = np.stack([np.bincount(r, minlength=m + 1)[:m] for r in key])
    start = np.stack([np.concatenate([[0], np.cumsum(np.bincount(
        r, minlength=m + 1))[:m - 1]]) for r in key])
    return order, start.astype(np.int32), count.astype(np.int32)


CASES = [
    # (case, k, n, m): n not a multiple of the kernel's 32-row steps
    ("spread", 3, 200, 4),
    ("one_slot", 2, 1500, 5),
    ("all_dead", 2, 1025, 3),
    ("spread", 2, 777, 1),
    ("spread", 1, 3000, 300),
    ("zero_weight", 2, 2049, 6),
    # several steps per warp of the kernel's cluster of blocks
    ("spread", 1, 70001, 40),
]


@pytest.mark.parametrize("case,k,n,m", CASES)
def test_plain_version_is_a_stable_sort_by_slot(case, k, n, m):
    node, g, h = _slots(case, k, n, m, seed=n)
    got = [a.numpy() for a in H.node_order(
        torch.from_numpy(node), m, torch.from_numpy(g), torch.from_numpy(h))]
    for a, b in zip(got, _want(node, g, h, m)):
        assert a.dtype == np.int32 and np.array_equal(a, b)
    order, start, count = got
    for kk in range(k):
        for s in range(m):
            rows = order[kk, start[kk, s]:start[kk, s] + count[kk, s]]
            assert np.all(np.diff(rows) > 0)
            assert np.all(node[kk, rows] == s)


@pytest.mark.parametrize("wrapper,b", [("build_histogram_binloop", 5),
                                       ("build_histogram_wide", 300)])
def test_histogram_with_a_given_order_equals_one_without(wrapper, b):
    rng = np.random.default_rng(b)
    n, f, k, m = 1100, 4, 2, 5
    binned = torch.from_numpy(rng.integers(0, b, size=(n, f)).astype(np.int32))
    node, g, h = (torch.from_numpy(a) for a in _slots("zero_weight", k, n, m, b))
    fn = getattr(H, wrapper)
    rows = H.node_order(node, m, g, h)
    assert torch.equal(fn(binned, node, g, h, m, b, order=rows),
                       fn(binned, node, g, h, m, b))
    with pytest.raises(ValueError, match="order"):
        fn(binned, node, g, h, m + 1, b, order=rows)


class TestGuards:
    def test_bad_inputs_raise(self):
        node, g, h = (torch.from_numpy(a) for a in _slots("spread", 2, 50, 3, 0))
        with pytest.raises(TypeError):
            H.node_order(node.long(), 3, g, h)
        with pytest.raises(ValueError):
            H.node_order(node, 3, g[:, :-1].contiguous(), h)
        with pytest.raises(ValueError):
            H.node_order(node, 0, g, h)

    def test_cpu_plain_version_does_not_count_launches(self):
        node, g, h = (torch.from_numpy(a) for a in _slots("spread", 2, 50, 3, 0))
        before = H.node_order.launches
        H.node_order(node, 3, g, h)
        assert H.node_order.launches == before


@pytest.mark.parametrize("family", ["xgb", "rf", "gbtr", "rfr"])
def test_grower_shares_one_order_per_chunk_and_reproduces_fixture(
        monkeypatch, family):
    """The fixture's 5000 rows take the card's kernel routes (through their
    plain versions on CPU tensors): every chunk's histograms get the row
    order of one ``node_order`` call over that chunk's slots, and the fits
    equal the JAX package's stored ones."""
    monkeypatch.setattr(
        H, "histogram_route",
        lambda dev, n, nb: "binloop" if nb <= H.BINLOOP_MAX_BINS else "wide")
    calls = []
    real_order = H.node_order

    def order(node, m, g, h):
        out = real_order(node, m, g, h)
        calls.append([node, out, 0])
        return out

    monkeypatch.setattr(H, "node_order", order)
    for name in ("build_histogram_binloop", "build_histogram_wide"):
        real = getattr(H, name)

        def hist(binned, node, g, h, m, b, order=None, _real=real):
            last = calls[-1]
            assert node is last[0] and order is last[1]
            last[2] += 1
            return _real(binned, node, g, h, m, b, order=order)

        monkeypatch.setattr(H, name, hist)
    with np.load(os.path.join(FIXTURE, "table.npz")) as z:
        x, y, target, masks = z["x"], z["y"], z["target"], z["masks"]
    with open(os.path.join(FIXTURE, "config.json")) as fh:
        point = json.load(fh)["points"][family]
    with np.load(os.path.join(FIXTURE, f"{family}.npz")) as z:
        want = {k: z[k] for k in z.files}
    cls, label = {
        "xgb": (PG.XGBoostClassifier, y), "rf": (PG.RandomForestClassifier, y),
        "gbtr": (PG.GBTRegressor, target), "rfr": (PG.RandomForestRegressor, target),
    }[family]
    models = cls(device="cpu").fit_arrays_batched_masks(
        x, label, list(masks), [point])
    assert calls and all(c[2] >= 1 for c in calls)
    assert sum(c[2] for c in calls) > len(calls)  # shared by two groups
    stack = models[0][0]._sweep_stack
    assert np.array_equal(stack["trees"].split_feat, want["split_feat"])
    assert np.array_equal(stack["trees"].split_bin, want["split_bin"])
    np.testing.assert_allclose(stack["trees"].leaf_value, want["leaf_value"],
                               rtol=1e-5, atol=1e-5, equal_nan=True)
    np.testing.assert_allclose(stack["outputs"], want["outputs"],
                               rtol=1e-5, atol=1e-5)


def _card_slots(n, k, m, share, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    node = torch.randint(-1, m + 2, (k, n), generator=gen, device="cuda",
                         dtype=torch.int32)
    if share is not None:  # one slot holding that share of the rows
        live = torch.rand((k, n), generator=gen, device="cuda") < share
        node = torch.where(live, 0, -1).to(torch.int32)
    g = torch.randn((k, n), generator=gen, device="cuda")
    h = torch.rand((k, n), generator=gen, device="cuda") + 0.1
    zero = torch.rand((k, n), generator=gen, device="cuda") < 0.3
    return node, torch.where(zero, 0.0, g), torch.where(zero, 0.0, h)


def test_kernel_matches_plain_version_on_the_card():
    """Needs a CUDA card (skips here): the node-order kernel equals its
    plain version (order, start and count) at ragged shapes; K2 and K3 equal
    the CPU's plain histogram bit for bit at a root-shaped input (one slot
    holding 2/3 of 16384 rows: > 64 tiles) and at spread slots, with the
    codes as given and padded to 16-byte rows as the grower pads them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for case, k, n, m in CASES:
        node, g, h = (torch.from_numpy(a).cuda()
                      for a in _slots(case, k, n, m, seed=n))
        for a, b in zip(H.node_order(node, m, g, h),
                        H.node_order_plain(node, m, g, h)):
            assert torch.equal(a, b)
    for name, b, f in (("hist_binloop", 2, 40), ("hist_binloop", 32, 10),
                       ("hist_wide", 256, 10)):
        fn = H.build_histogram_binloop if name == "hist_binloop" else \
            H.build_histogram_wide
        for share in (2 / 3, None):
            n, k, m = 16384, 3, 8
            node, g, h = _card_slots(n, k, m, share, seed=b)
            binned = torch.randint(0, b, (n, f), device="cuda",
                                   dtype=torch.int32)
            want = H.build_histogram_scatter_batched(
                *(a.cpu() for a in (binned, node, g, h)), m, b)
            for codes in (binned, H.pad_codes(binned)):
                got = fn(codes, node, g, h, m, b)
                torch.cuda.synchronize()
                assert torch.equal(got.cpu(), want)
