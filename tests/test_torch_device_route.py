"""Served tree scores above 16384 rows: the PyTorch port against the JAX
package's device route, BIT FOR BIT.

For batches of more than ``TPTPU_HOST_PREDICT_MAX`` rows (default 16384)
the JAX package scores through ``predict_boosted_raw`` /
``predict_forest_raw``, whose XLA reduction over trees and leaves has an
order of its own (``transmogrifai_tpu_torch.models.tree_sum``'s docstring).
A numpy oracle of that order is held to the reference's device route over
depths 3-12 and 7-1100 trees, and to the one-hot budget's gather route at
depth 12 above 65536 rows; the port's ``predict_arrays`` is held to the
reference's on synthetic stacks; the plain
version of the new tree-sum mode is held to the oracle; and the routing is
checked on both sides of the threshold. (The serving fixtures above 16384
rows: ``test_torch_device_route_fixtures.py``.)

Both packages read ``TPTPU_HOST_PREDICT_MAX`` per call, and the route's
order depends on the batch only through that threshold and the one-hot
budget. The reference's one-hot select is [T, N, 2^depth], seconds to
minutes a case on the CPU at 16385 rows, so the cases run at a few hundred
rows with the threshold lowered below them; one case (200 depth-6 trees),
the routing test and the multiclass forest run above the default 16384
rows at the default threshold, and the gather case above 65536.

The shapes whose reduction the reference vectorizes (``ROADMAP.md`` C4:
lanes of 4 or 8 for at most 32 trees of depth 5 or less, ``fold_w`` at
depth 6 with 2 or 4 tree windows at powers of two) are held to the JAX
package's outputs recorded by
``tests/torch_fixtures/make_device_route_fixtures.py`` (90 cases of depth
1-6 and 15 tree counts, each at 64, 256, 300 and 2048 rows; three of them
checked against the live reference), so that every regime runs in a few
seconds.
"""
import functools
import os
from fractions import Fraction

import numpy as np
import pytest
import torch

from transmogrifai_tpu.models import gbdt as JG
from transmogrifai_tpu.models import trees as JTR
from transmogrifai_tpu_torch.models import gbdt as PG
from transmogrifai_tpu_torch.models import serve_trees as ST
from transmogrifai_tpu_torch.models import tree_sum as TS
from transmogrifai_tpu_torch.models import trees as PTR

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

W = 32
ETA, BASE = 0.02, 0.1
#: rows of a batch above the reference's default threshold
ABOVE = 16385
#: rows, and the lowered threshold, of the cases run below 16385 rows
FEW, FEW_MAX = 300, 256
#: the (depth, trees) case run above the default threshold
DEFAULT_CASE = (6, 200)


# --------------------------------------------------------------------------
# the numpy oracle of the device route's order
# --------------------------------------------------------------------------
def _centred(n):
    """(window, windows, leading zeros) of an axis of n."""
    if n <= W:
        return n, 1, 0
    count = -(-n // W)
    return W, count, (count * W - n) // 2


def _windowed(grid):
    """One level of XLA's windowed reduction of [A, B, N]: windows of 32 on
    both axes (padding centred), each summed in row-major order."""
    a, b, n = grid.shape
    wa, na, la = _centred(a)
    wb, nb, lb = _centred(b)
    pad = np.zeros((na * wa, nb * wb, n), np.float32)
    pad[la:la + a, lb:lb + b] = grid
    out = np.zeros((na, nb, n), np.float32)
    for i in range(na):
        for j in range(nb):
            acc = np.zeros(n, np.float32)
            for u in range(wa):
                for v in range(wb):
                    acc = acc + pad[i * wa + u, j * wb + v]
            out[i, j] = acc
    return out


def _fma32(a, x, c):
    """float32 a * x + c rounded once, exactly: each value's nearest float32
    (ties to even) to the exact rational result."""
    out = np.empty(len(x), np.float32)
    fa, fc = Fraction(float(np.float32(a))), Fraction(float(np.float32(c)))
    for i, xi in enumerate(np.asarray(x, np.float32)):
        exact = fa * Fraction(float(xi)) + fc
        near = np.float32(float(exact))
        cands = [near, np.nextafter(near, np.float32(np.inf)),
                 np.nextafter(near, np.float32(-np.inf))]

        def key(v):
            even = int(np.array(v, np.float32).view(np.uint32)) & 1
            return abs(Fraction(float(v)) - exact), even

        out[i] = min(cands, key=key)
    return out


def oracle(vals, leaves, depth, boosted, onehot=True):
    """The device route's output over [N, T] leaf values and leaf indices:
    level-1 partials per (tree window, leaf window), the recursive windows,
    a row-major sum, then the fused epilogue or the reciprocal mean."""
    n, t = vals.shape
    h = max(1, (1 << depth) // W) if onehot else 1
    _, tw, lo = _centred(t)
    grid = np.zeros((tw, h, n), np.float32)
    win = leaves >> 5 if h > 1 else np.zeros_like(leaves)
    rows = np.arange(n)
    for j in range(t):
        w = (j + lo) // W
        grid[w, win[:, j], rows] = grid[w, win[:, j], rows] + vals[:, j]
    while grid.shape[0] > W or grid.shape[1] > W:
        grid = _windowed(grid)
    acc = np.zeros(n, np.float32)
    for cell in grid.reshape(-1, n):
        acc = acc + cell
    if boosted:
        return _fma32(ETA, acc, BASE)
    return acc * (np.float32(1) / np.float32(t))


def _leaves(binned, sf, sb):
    """[N, T] leaf index of every (row, tree): the plain walk in numpy."""
    t, depth, _ = sf.shape
    n = binned.shape[0]
    node = np.zeros((t, n), np.int64)
    for lvl in range(depth):
        f = np.take_along_axis(sf[:, lvl, :], node, 1)
        b = np.take_along_axis(sb[:, lvl, :], node, 1)
        code = binned[np.arange(n)[None, :], np.maximum(f, 0)]
        node = node * 2 + ((f >= 0) & (code > b))
    return node.T


@functools.lru_cache(maxsize=None)
def _stack(n, t, depth, f=8, bins=32):
    rng = np.random.default_rng(n * 7 + t * 13 + depth)
    x = rng.normal(size=(n, f)).astype(np.float32)
    thr = JTR.quantile_thresholds(x, max_bins=bins)
    w = 1 << depth
    sf = rng.integers(-1, f, size=(t, depth, w)).astype(np.int32)
    sb = rng.integers(0, bins - 1, size=(t, depth, w)).astype(np.int32)
    lv = rng.normal(scale=0.1, size=(t, w)).astype(np.float32)
    return x, thr, sf, sb, lv


def _models(n, t, depth):
    x, thr, sf, sb, lv = _stack(n, t, depth)
    jt = JTR.Tree(sf, sb, lv)
    out = []
    for boosted in (True, False):
        pt = PTR.Tree(sf, sb, lv)
        if boosted:
            jm = JG.BoostedBinaryModel(thr, jt, ETA, BASE)
            pm = PG.BoostedBinaryModel(thr, pt, ETA, BASE)
        else:
            jm = JG.ForestClassifierModel(thr, [jt])
            pm = PG.ForestClassifierModel(thr, [pt])
        pm.to("cpu")
        out.append((boosted, jm, pm))
    return x, out


@functools.lru_cache(maxsize=None)
def _reference(n, t, depth, limit):
    """The JAX package's device-route core and predict_arrays, per family,
    with TPTPU_HOST_PREDICT_MAX at ``limit`` (computed once per case)."""
    old = os.environ.get("TPTPU_HOST_PREDICT_MAX")
    os.environ["TPTPU_HOST_PREDICT_MAX"] = str(limit)
    try:
        x, fams = _models(n, t, depth)
        out = {}
        for boosted, jm, _ in fams:
            assert not jm._use_host(x)
            trees, _ = jm._tree_stacks()
            # predict_arrays is this core and the float64 host tail
            core = jm._predict_stacks(x, trees, boosted)
            out[boosted] = (core[:, 0], jm.predictions_from_core(core))
        return out
    finally:
        if old is None:
            os.environ.pop("TPTPU_HOST_PREDICT_MAX")
        else:
            os.environ["TPTPU_HOST_PREDICT_MAX"] = old


def _case(depth, t):
    """(rows, threshold) of a (depth, trees) case (module docstring)."""
    if (depth, t) == DEFAULT_CASE:
        return ABOVE, 16384
    return FEW, FEW_MAX


ORACLE_CASES = [(d, t) for d in (3, 6, 10, 12) for t in (7, 33, 50, 200, 257)]


@pytest.mark.parametrize("depth,t", ORACLE_CASES)
def test_oracle_matches_the_reference_device_route(depth, t):
    n, limit = _case(depth, t)
    ref = _reference(n, t, depth, limit)
    x, thr, sf, sb, lv = _stack(n, t, depth)
    leaves = _leaves(JTR.bin_data_host(x, thr), sf, sb)
    vals = np.take_along_axis(lv, leaves.T, 1).T
    for boosted in (True, False):
        want = ref[boosted][0].astype(np.float32)
        got = oracle(vals, leaves, depth, boosted)
        assert np.count_nonzero(got != want) == 0, (boosted, depth, t)


@pytest.mark.parametrize("n,t,depth,onehot,limit", [
    (FEW, 1100, 3, True, FEW_MAX),   # the tree windows' axis windowed again
    (FEW, 7, 11, True, FEW_MAX),     # the leaf windows' axis windowed again
    (65537, 7, 12, False, 16384),    # the reference gathers the leaf table
])
def test_oracle_matches_the_reference_beyond_one_level(n, t, depth, onehot,
                                                       limit):
    ref = _reference(n, t, depth, limit)
    x, thr, sf, sb, lv = _stack(n, t, depth)
    leaves = _leaves(JTR.bin_data_host(x, thr), sf, sb)
    vals = np.take_along_axis(lv, leaves.T, 1).T
    assert TS.leaf_windows(n, depth) == (max(1, (1 << depth) // W)
                                         if onehot else 1)
    for boosted in (True, False):
        want = ref[boosted][0].astype(np.float32)
        assert np.count_nonzero(oracle(vals, leaves, depth, boosted, onehot)
                                != want) == 0
        if depth > 5:  # the one-hot and gather orders differ on these
            assert np.count_nonzero(oracle(vals, leaves, depth, boosted,
                                           not onehot) != want) > 0


def test_route_orders_differ_from_the_tree_order():
    """The oracle's inputs are ones where the route matters: the tree-order
    sum with separately rounded epilogues differs from the device route."""
    depth, t = DEFAULT_CASE
    n, limit = _case(depth, t)
    ref = _reference(n, t, depth, limit)
    x, thr, sf, sb, lv = _stack(n, t, depth)
    binned = PTR.bin_data(torch.from_numpy(x), torch.from_numpy(thr))
    per_tree = ST.serve_trees_reference(
        binned, *(torch.from_numpy(a) for a in (sf, sb, lv)))
    for boosted in (True, False):
        tree_order = TS.tree_sum_plain(per_tree, boosted, ETA, BASE).numpy()
        assert np.count_nonzero(tree_order != ref[boosted][0]) > 0


PORT_CASES = [(d, t) for d in (6, 10, 12) for t in (7, 50, 200)]


@pytest.mark.parametrize("depth,t", PORT_CASES)
def test_port_predict_arrays_equal_the_reference(depth, t, monkeypatch):
    """The port's ``predict_arrays`` (bin, K1's plain walk twice, the tree
    sum's device-route mode, the float64 epilogue) equals the reference's,
    every output, boosted and forest."""
    n, limit = _case(depth, t)
    ref = _reference(n, t, depth, limit)
    monkeypatch.setenv("TPTPU_HOST_PREDICT_MAX", str(limit))
    x, fams = _models(n, t, depth)
    for boosted, _, pm in fams:
        assert not pm._use_host(x)
        for got, want in zip(pm.predict_arrays(x), ref[boosted][1]):
            assert np.count_nonzero(got != want) == 0, (boosted, depth, t)


def test_multiclass_forest_equals_the_reference():
    """A forest of three class stacks: each stack in the route's order."""
    n, t, depth = ABOVE, 33, 6
    x, thr, _, _, _ = _stack(n, t, depth)
    stacks = [_stack(n + c, t, depth)[2:] for c in range(3)]
    jm = JG.ForestClassifierModel(thr, [JTR.Tree(*s) for s in stacks])
    pm = PG.ForestClassifierModel(thr, [PTR.Tree(*s) for s in stacks]).to("cpu")
    for got, want in zip(pm.predict_arrays(x), jm.predict_arrays(x)):
        assert np.count_nonzero(got != want) == 0


# --------------------------------------------------------------------------
# the tree sum's device-route mode and the routing
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n,t,h", [
    (40, 7, 1), (37, 33, 2), (64, 200, 32), (21, 257, 128), (9, 1100, 4),
    (5, 40, 1024), (3, 0, 1),
])
@pytest.mark.parametrize("boosted", [True, False])
def test_plain_device_route_equals_the_oracle(n, t, h, boosted):
    rng = np.random.default_rng(n * 100 + t + h)
    vals = (rng.normal(size=(n, t)) * 10.0 ** rng.integers(-3, 2, (n, t))) \
        .astype(np.float32)
    leaves = rng.integers(0, max(h, 1) * W, size=(n, t))
    depth = max(5, int(np.log2(h * W)))
    win = torch.from_numpy((leaves >> 5).astype(np.float32)) if h > 1 else None
    got = TS.tree_sum_device_route(torch.from_numpy(vals), win, h, depth,
                                   boosted, ETA, BASE).numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        want = oracle(vals, leaves, depth, boosted)
    assert got.dtype == np.float32 and got.shape == (n,)
    assert np.array_equal(got, want, equal_nan=True)


def test_fused_epilogue_rounds_once():
    """``fma(eta, total, base)`` with one rounding, against the exact
    rational result, on values where the separately rounded form and a
    float64 sum rounded again both differ from it somewhere."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=4000) * 10.0 ** rng.integers(-4, 3, 4000)) \
        .astype(np.float32)
    got = TS._fma32(ETA, torch.from_numpy(x), BASE).numpy()
    want = _fma32(ETA, x, BASE)
    assert np.array_equal(got, want)
    separate = np.float32(BASE) + np.float32(ETA) * x
    assert np.count_nonzero(separate != want) > 0


def test_device_route_input_checks():
    pt = torch.ones((4, 3))
    with pytest.raises(ValueError, match="no leaf_window"):
        TS.tree_sum_device_route(pt, torch.zeros((4, 3)), 1, 5, True)
    with pytest.raises(ValueError, match="leaf_window"):
        TS.tree_sum_device_route(pt, torch.zeros((4, 2)), 2, 6, True)
    with pytest.raises(ValueError, match="leaf windows"):
        TS.tree_sum_device_route(pt, None, 0, 5, True)
    with pytest.raises(ValueError, match="leaf windows"):
        TS.tree_sum_device_route(pt, torch.zeros((4, 3)), 4, 6, True)
    with pytest.raises(ValueError, match="trees"):
        TS.tree_sum_device_route(torch.ones((1, TS.MAX_ROUTE_TREES + 1)),
                                 None, 1, 5, True)
    before = TS.tree_sum_device_route.launches
    TS.tree_sum_device_route(pt, torch.zeros((4, 3)), 2, 6, False)
    assert TS.tree_sum_device_route.launches == before


def test_leaf_windows_follow_the_one_hot_budget():
    assert TS.leaf_windows(10**6, 5) == 1
    assert TS.leaf_windows(10**6, 9) == 16
    assert TS.leaf_windows(262144, 10) == 32
    assert TS.leaf_windows(262145, 10) == 1
    assert TS.leaf_windows(65536, 12) == 128
    assert TS.leaf_windows(65537, 12) == 1


def test_window_stack_walks_to_each_leafs_window():
    """K1 over ``window_stack`` gives leaf // 32 for every (row, tree)."""
    x, thr, sf, sb, lv = _stack(500, 9, 7)
    binned = PTR.bin_data(torch.from_numpy(x), torch.from_numpy(thr))
    packed = ST.pack_trees(*(torch.from_numpy(a) for a in (sf, sb, lv)),
                           num_features=x.shape[1])
    win = ST.serve_trees_packed(binned, ST.window_stack(packed)).numpy()
    leaves = _leaves(binned.numpy(), sf, sb)
    assert np.array_equal(win, (leaves >> 5).astype(np.float32))


@pytest.mark.parametrize("n,route", [(16384, "host"), (16385, "device")])
def test_routing_at_the_threshold(n, route, monkeypatch):
    """``predict_core`` sums in tree order at 16384 rows and in the device
    route's order at 16385, as the reference's ``_use_host`` decides."""
    monkeypatch.delenv("TPTPU_HOST_PREDICT_MAX", raising=False)
    calls = []
    real_tree, real_route = ST.tree_sum, ST.tree_sum_device_route

    def tree(*a, **k):
        calls.append("host")
        return real_tree(*a, **k)

    def device(*a, **k):
        calls.append("device")
        return real_route(*a, **k)

    monkeypatch.setattr(ST, "tree_sum", tree)
    monkeypatch.setattr(ST, "tree_sum_device_route", device)
    x, thr, sf, sb, lv = _stack(n, 3, 6, f=2)
    jm = JG.BoostedBinaryModel(thr, JTR.Tree(sf, sb, lv), ETA, BASE)
    pm = PG.BoostedBinaryModel(thr, PTR.Tree(sf, sb, lv), ETA, BASE).to("cpu")
    assert jm._use_host(x) == (route == "host") == pm._use_host(x)
    core = pm.predict_core(x)
    assert calls == [route]
    trees, _ = jm._tree_stacks()
    want = jm._predict_stacks(x, trees, True)
    if route == "device":  # the host route equals the reference only with
        assert np.array_equal(core, want)  # its native library


def _grid_depth(h):
    """A depth of 7 or more with room for ``h`` leaf windows: the shapes of
    the two card tests below keep the windowed grid's order (C4's orders
    have their own card test)."""
    return max(7, int(np.ceil(np.log2(h * W))))


def test_device_route_kernel_matches_plain_version_on_the_card():
    """Needs a CUDA card (skips here): the device-route mode equals its
    plain version bit for bit, boosted and forest, at two and three levels
    of windows, one leaf window, and ragged rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [(20000, 200, 2), (65536, 200, 32), (16385, 7, 1), (16385, 7, 2),
             (1001, 1100, 4), (333, 50, 128), (5, 1, 1)]
    for seed, (n, t, h) in enumerate(cases):
        rng = np.random.default_rng(seed)
        vals = torch.from_numpy(
            (rng.normal(size=(n, t)) * 10.0 ** rng.integers(-3, 2, (n, t)))
            .astype(np.float32)).cuda()
        win = (torch.from_numpy(rng.integers(0, h, (n, t)).astype(np.float32))
               .cuda() if h > 1 else None)
        for boosted in (True, False):
            before = TS.tree_sum_device_route.launches
            got = TS.tree_sum_device_route(vals, win, h, _grid_depth(h),
                                           boosted, ETA, BASE)
            assert TS.tree_sum_device_route.launches == before + 1
            want = TS.tree_sum_device_route_plain(vals, win, h, _grid_depth(h),
                                                  boosted, ETA, BASE)
            cpu = TS.tree_sum_device_route_plain(
                vals.cpu(), None if win is None else win.cpu(), h,
                _grid_depth(h), boosted, ETA, BASE)
            torch.cuda.synchronize()
            assert torch.equal(got, want) and torch.equal(got.cpu(), cpu)


def test_route_by_pairs_matches_plain_version_on_the_card():
    """Needs a CUDA card (skips here): the device-route mode's (row, tree
    window) decomposition equals its plain version bit for bit where the
    tree count is odd, even or a multiple of four, the leaf windows are
    kept in registers (up to 4) or in shared memory, the leaf windows are
    windowed again (128 of them), a slab holds 512 or 513 trees, the
    arrays start off a 16-byte boundary (plain loads), a slab of fewer rows
    holds thousands of trees, and where even one row does not fit the
    block's shared memory, so the tree windows come in chunks (30000 trees;
    2000 trees of 1024 leaf windows, windowed again on both axes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [(4099, 50, 128, False), (1000, 33, 3, False), (777, 66, 5, False),
             (100, 512, 2, False), (3000, 513, 2, False), (2000, 200, 32, True),
             (65, 7, 1, True), (301, 5001, 3, True), (70, 30000, 2, False),
             (37, 2000, 1024, True)]
    for seed, (n, t, h, offset) in enumerate(cases):
        rng = np.random.default_rng(100 + seed)

        def card(a):
            if not offset:
                return torch.from_numpy(a).cuda()
            flat = torch.empty(a.size + 1, dtype=torch.float32, device="cuda")
            view = flat[1:].view(a.shape)
            view.copy_(torch.from_numpy(a))
            return view

        vals_np = (rng.normal(size=(n, t)) * 10.0 ** rng.integers(-3, 2, (n, t))
                   ).astype(np.float32)
        win_np = rng.integers(0, h, (n, t)).astype(np.float32)
        vals = card(vals_np)
        win = card(win_np) if h > 1 else None
        for boosted in (True, False):
            before = TS.tree_sum_device_route.launches
            got = TS.tree_sum_device_route(vals, win, h, _grid_depth(h),
                                           boosted, ETA, BASE)
            assert TS.tree_sum_device_route.launches == before + 1
            cpu = TS.tree_sum_device_route_plain(
                torch.from_numpy(vals_np),
                torch.from_numpy(win_np) if h > 1 else None, h,
                _grid_depth(h), boosted, ETA, BASE)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), cpu)


# --------------------------------------------------------------------------
# the orders of ROADMAP.md C4: every regime of tree_sum's order table
# --------------------------------------------------------------------------
def _load_fixture_module(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(__file__), "torch_fixtures",
                           f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MR = _load_fixture_module("make_device_route_fixtures")
ORDERS = os.path.join(MR.OUT_DIR, "orders.npz")


@functools.lru_cache(maxsize=1)
def _orders():
    return dict(np.load(ORDERS))


@pytest.mark.parametrize("trees", MR.TREES)
@pytest.mark.parametrize("depth", MR.DEPTHS)
def test_device_route_orders_equal_the_reference(depth, trees):
    """At 64, 256, 300 and 2048 rows: the plain version of the route sum
    over K1's plain walk, and ``predict_device_route`` whole, EQUAL the
    JAX package's ``predict_boosted_raw`` / ``predict_forest_raw``
    (recorded by ``make_device_route_fixtures.py``), boosted and forest."""
    orders = _orders()
    for rows in MR.ROWS:
        x, thr, sf, sb, lv = MR.route_stack(depth, trees, rows)
        binned = PTR.bin_data(torch.from_numpy(x), torch.from_numpy(thr))
        packed = ST.pack_trees(*(torch.from_numpy(a) for a in (sf, sb, lv)),
                               num_features=x.shape[1])
        windows = ST.window_stack(packed)
        h = TS.leaf_windows(rows, depth)
        per_tree = ST.serve_trees_packed(binned, packed)
        win = ST.serve_trees_packed(binned, windows) if h > 1 else None
        for boosted in (True, False):
            want = orders[MR.key(depth, trees, rows, boosted)]
            plain = TS.tree_sum_device_route_plain(
                per_tree, win, h, depth, boosted, MR.ETA, MR.BASE).numpy()
            whole = ST.predict_device_route(binned, packed, windows, boosted,
                                            MR.ETA, MR.BASE).numpy()
            order = TS.route_order(trees, depth, h, rows)
            assert np.array_equal(plain, want), (rows, boosted, order)
            assert np.array_equal(whole, want), (rows, boosted, order)


@pytest.mark.parametrize("depth,trees,rows", [(3, 20, 300), (6, 50, 256),
                                              (1, 8, 64)])
def test_orders_fixture_is_the_live_reference(depth, trees, rows):
    """The recorded outputs are what the JAX package computes today."""
    orders = _orders()
    for k, v in MR.reference(depth, trees, rows).items():
        assert np.array_equal(orders[k], v), k


def test_route_order_table():
    """The order table of ``models/tree_sum.py``'s docstring, regime by
    regime (R1: lanes; R2: fold_w at the measured powers of two)."""
    R = TS.route_order
    assert [R(t, 3, 1, 300) for t in (1, 3, 4, 5, 7, 8, 9, 15, 16, 19, 20,
                                      23, 24, 27, 28, 31, 32, 33)] == [
        "grid", "grid", "lanes4", "grid", "grid", "lanes8", "grid", "grid",
        "lanes8", "lanes8", "lanes4", "lanes4", "lanes8", "lanes8", "lanes4",
        "lanes4", "lanes8", "grid"]
    assert [R(t, d, 1, 64) for d in (1, 4, 5) for t in (20, 28)] == \
        ["lanes8"] * 6
    assert R(50, 6, 2, 32768) == R(100, 6, 2, 65536) == R(33, 6, 2, 64) \
        == R(128, 6, 2, 4096) == R(64, 6, 2, 131072) == "fold_w"
    assert R(50, 6, 2, 40960) == R(50, 6, 2, 32) == R(50, 6, 2, 262144) \
        == "grid"
    assert R(50, 6, 2, 24576) == R(80, 6, 2, 32768) == R(20, 6, 2, 32768) \
        == R(50, 7, 4, 32768) == R(50, 6, 2, 300) == "grid"
    assert R(20, 7, 4, 300) == R(8, 10, 1, 10**6) == "grid"


def test_device_route_orders_on_the_card():
    """Needs a CUDA card (skips here): the kernel's lanes and fold_w orders
    equal the plain version bit for bit at R1 and R2 shapes, [32768, 50] at
    depth 6 and [20000, 20] at depth 4 among them, boosted and forest, with
    one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [(20000, 20, 4), (20000, 20, 3), (32768, 50, 6), (65536, 100, 6),
             (32768, 33, 6), (2048, 4, 2), (300, 8, 1), (16385, 32, 5),
             (1000, 28, 2), (5, 16, 5), (129, 23, 3)]
    for seed, (n, t, depth) in enumerate(cases):
        rng = np.random.default_rng(200 + seed)
        h = TS.leaf_windows(n, depth)
        vals_np = (rng.normal(size=(n, t)) * 10.0 ** rng.integers(-3, 2, (n, t))
                   ).astype(np.float32)
        win_np = rng.integers(0, h, (n, t)).astype(np.float32)
        vals = torch.from_numpy(vals_np).cuda()
        win = torch.from_numpy(win_np).cuda() if h > 1 else None
        assert TS.route_order(t, depth, h, n) != "grid"
        for boosted in (True, False):
            before = TS.tree_sum_device_route.launches
            got = TS.tree_sum_device_route(vals, win, h, depth, boosted, ETA,
                                           BASE)
            assert TS.tree_sum_device_route.launches == before + 1
            cpu = TS.tree_sum_device_route_plain(
                torch.from_numpy(vals_np),
                torch.from_numpy(win_np) if h > 1 else None, h, depth,
                boosted, ETA, BASE)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), cpu), (n, t, depth, boosted)
