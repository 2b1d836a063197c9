"""The PyTorch port's tree growth (``transmogrifai_tpu_torch.models.trees.
grow_tree_batched`` / ``_grow_tree_impl``) against the JAX package's on the
same seeded, tie-free numpy inputs: IDENTICAL ``split_feat``/``split_bin``
and leaf values within ``LEAF_TOL``, with and without feature groups, with
mixed per-lane depth caps, at depth 0, with a lane whose root does not
split, and above 4096 rows with the node chunks cut small so that the
chunk loop, the occupancy skip and the card's bin-loop route (its plain
version on the CPU) all run, above and below 4096 rows."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.models import trees as JTR
from transmogrifai_tpu_torch.models import hist as H
from transmogrifai_tpu_torch.models import trees as PTR

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

#: leaf values are -G/(H+lambda) over f32 sums of up to a few thousand
#: rows; the reference's one-hot reduction adds them in another order, so
#: they agree to f32 rounding of those sums (relative 1e-5 covers N·2^-24
#: at these sizes)
LEAF_TOL = dict(rtol=1e-5, atol=1e-5, equal_nan=True)


def _problem(n, f_cont, f_bin, k, seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        rng.normal(size=(n, f_cont)),
        (rng.uniform(size=(n, f_bin)) < 0.3).astype(np.float64),
    ], axis=1).astype(np.float32)
    thr = JTR.quantile_thresholds(x, 32)
    binned = np.array(JTR.bin_data(jnp.asarray(x), jnp.asarray(thr)))
    y = (x[:, 0] + x[:, f_cont] - 0.5 * x[:, 1]
         + 0.5 * rng.normal(size=n) > 0).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-rng.normal(scale=0.5, size=(k, n))))
    g = (p - y).astype(np.float32)
    h = (p * (1 - p)).astype(np.float32)
    rm = (rng.uniform(size=(k, n)) < 0.75).astype(np.float32)
    fm = np.ones((k, x.shape[1]), np.float32)
    groups = (np.arange(f_cont, f_cont + f_bin, dtype=np.int32),
              np.arange(f_cont, dtype=np.int32))
    return binned, g, h, rm, fm, groups


def _grow_both(binned, g, h, rm, fm, groups, hist_impl=None, **kw):
    static = dict(max_depth=kw.pop("max_depth"), num_bins=32)
    jfn = jax.jit(functools.partial(
        JTR._grow_tree_impl, **static, hist_impl=hist_impl,
    ))
    jtree, jnode = jfn(
        jnp.asarray(binned), *(jnp.asarray(a) for a in (g, h, rm, fm)),
        feature_groups=None if groups is None else tuple(map(jnp.asarray, groups)),
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()},
    )
    ptree, pnode = PTR._grow_tree_impl(
        torch.from_numpy(binned), *(torch.from_numpy(a) for a in (g, h, rm, fm)),
        **static, feature_groups=groups, **kw,
    )
    return jtree, jnode, ptree, pnode


def _assert_same(jtree, jnode, ptree, pnode):
    assert np.array_equal(np.asarray(jtree.split_feat), ptree.split_feat.numpy())
    assert np.array_equal(np.asarray(jtree.split_bin), ptree.split_bin.numpy())
    np.testing.assert_allclose(
        ptree.leaf_value.numpy(), np.asarray(jtree.leaf_value), **LEAF_TOL
    )
    assert np.array_equal(np.asarray(jnode), pnode.numpy())


KNOBS = dict(
    reg_lambda=np.array([1.0, 0.5, 2.0], np.float32),
    gamma=np.array([0.0, 0.1, 0.0], np.float32),
    min_child_weight=np.array([1.0, 5.0, 0.5], np.float32),
    min_info_gain=0.0,
)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("depth", [1, 3, 6])
def test_grow_matches_reference(grouped, depth):
    binned, g, h, rm, fm, groups = _problem(700, 4, 5, 3, seed=depth)
    got = _grow_both(binned, g, h, rm, fm, groups if grouped else None,
                     max_depth=depth, **KNOBS)
    _assert_same(*got)
    # the trees really split, at more than the root
    assert (got[2].split_feat.numpy()[:, -1] >= 0).any() or depth == 1


def test_mixed_per_lane_depth_caps():
    binned, g, h, rm, fm, groups = _problem(700, 4, 5, 3, seed=11)
    got = _grow_both(binned, g, h, rm, fm, groups, max_depth=5,
                     max_depth_v=np.array([2, 5, 3], np.int32), **KNOBS)
    _assert_same(*got)
    sf = got[2].split_feat.numpy()
    assert (sf[0, 2:] == -1).all() and (sf[2, 3:] == -1).all()
    assert (sf[1, 3:] >= 0).any()


def test_depth_zero_is_one_leaf():
    binned, g, h, rm, fm, groups = _problem(300, 3, 2, 3, seed=2)
    jtree, jnode, ptree, pnode = _grow_both(
        binned, g, h, rm, fm, groups, max_depth=0, **KNOBS
    )
    assert ptree.split_feat.shape == (3, 0, 1)
    assert ptree.leaf_value.shape == (3, 1)
    _assert_same(jtree, jnode, ptree, pnode)


def test_a_lane_whose_root_does_not_split():
    binned, g, h, rm, fm, groups = _problem(500, 4, 3, 3, seed=4)
    knobs = dict(KNOBS, min_info_gain=np.array([0.0, 1e9, 0.0], np.float32))
    got = _grow_both(binned, g, h, rm, fm, groups, max_depth=4, **knobs)
    _assert_same(*got)
    sf = got[2].split_feat.numpy()
    assert (sf[1] == -1).all() and (sf[0, 0, 0] >= 0)
    assert (got[3].numpy()[1] == 0).all()  # every row in the leftmost leaf


@pytest.mark.parametrize("route", ["scatter", "binloop"])
def test_above_4096_rows_in_small_chunks(monkeypatch, route):
    """4500 rows, the histogram budget cut so that each build covers two
    slots: deep levels take many chunks, and chunks past the live slots are
    skipped. ``binloop`` routes the builds through K2's wrapper (its plain
    version on a CPU tensor) with the card's chunk cap."""
    binned, g, h, rm, fm, groups = _problem(4500, 5, 4, 2, seed=9)
    monkeypatch.setattr(PTR, "HIST_BUDGET_ELEMS", 2 * 2 * 9 * 32)
    monkeypatch.setattr(PTR, "HIST_BUDGET_FLOOR", 1)
    monkeypatch.setattr(H, "histogram_route", lambda dev, b: route)
    calls = []
    real = H.build_histogram_binloop

    def counted(*a, **k):
        calls.append(a[4])  # num_nodes of this build
        return real(*a, **k)

    monkeypatch.setattr(H, "build_histogram_binloop", counted)
    knobs = {k: (v[:2] if isinstance(v, np.ndarray) else v)
             for k, v in KNOBS.items()}
    _assert_same(*_grow_both(binned, g, h, rm, fm, groups, max_depth=5, **knobs))
    if route == "binloop":
        assert calls and set(calls) == {2}


def test_gemm_route_matches_the_reference_gemm(monkeypatch):
    """At N <= 4096, where the reference grows with its float32 GEMM
    histograms, the card's route (K2's plain version here) grows the same
    trees."""
    card_route = functools.partial(H.histogram_route, torch.device("cuda"))
    monkeypatch.setattr(H, "histogram_route", lambda dev, b: card_route(b))
    assert H.histogram_route(None, 32) == "binloop"
    binned, g, h, rm, fm, groups = _problem(900, 4, 4, 3, seed=5)
    _assert_same(*_grow_both(binned, g, h, rm, fm, groups, hist_impl="gemm",
                             max_depth=4, **KNOBS))


def test_single_fit_grow_tree_matches_reference():
    binned, g, h, rm, fm, groups = _problem(600, 4, 5, 1, seed=12)
    jtree = JTR.grow_tree(
        jnp.asarray(binned), *(jnp.asarray(a[0]) for a in (g, h, rm, fm)),
        max_depth=4, num_bins=32, reg_lambda=0.5, min_child_weight=2.0,
        feature_groups=tuple(map(jnp.asarray, groups)),
    )
    ptree = PTR.grow_tree(
        torch.from_numpy(binned), *(torch.from_numpy(a[0]) for a in (g, h, rm, fm)),
        max_depth=4, num_bins=32, reg_lambda=0.5, min_child_weight=2.0,
        feature_groups=groups,
    )
    assert ptree.split_feat.shape == (4, 16)
    assert np.array_equal(np.asarray(jtree.split_feat), ptree.split_feat.numpy())
    assert np.array_equal(np.asarray(jtree.split_bin), ptree.split_bin.numpy())
    np.testing.assert_allclose(ptree.leaf_value.numpy(),
                               np.asarray(jtree.leaf_value), **LEAF_TOL)


@pytest.mark.parametrize("objective", ["binary:logistic", "reg:squarederror"])
def test_fit_boosted_matches_the_reference_re_traversal(objective):
    """The port's one-fit boosting (the batched loop at K=1, each row's leaf
    read from the grower's routing) against the reference's, which adds
    ``eta`` times a re-traversal of each tree: identical trees and the
    same training margin bits."""
    binned, _, _, rm, _, groups = _problem(800, 4, 5, 1, seed=13)
    y = (np.random.default_rng(13).uniform(size=800) < 0.4).astype(np.float32)
    kw = dict(num_rounds=4, max_depth=3, num_bins=32, eta=0.3, gamma=0.1,
              base_score=0.25, objective=objective)
    jtrees, jmargin = JTR.fit_boosted(
        jnp.asarray(binned), jnp.asarray(y), jnp.asarray(rm[0]),
        feature_groups=tuple(map(jnp.asarray, groups)), **kw,
    )
    ptrees, pmargin = PTR.fit_boosted(
        torch.from_numpy(binned), y, rm[0], feature_groups=groups, **kw,
    )
    assert ptrees.split_feat.shape == (4, 3, 8)
    assert np.array_equal(np.asarray(jtrees.split_feat), ptrees.split_feat.numpy())
    assert np.array_equal(np.asarray(jtrees.split_bin), ptrees.split_bin.numpy())
    np.testing.assert_allclose(ptrees.leaf_value.numpy(),
                               np.asarray(jtrees.leaf_value), **LEAF_TOL)
    assert np.array_equal(pmargin.numpy(), np.asarray(jmargin))


def test_host_syncs_one_per_grown_level():
    binned, g, h, rm, fm, groups = _problem(300, 3, 2, 3, seed=6)
    before = PTR.host_syncs
    _, _, ptree, _ = _grow_both(binned, g, h, rm, fm, groups, max_depth=3,
                                **KNOBS)
    grown = int((ptree.split_feat.numpy() >= 0).any(axis=(0, 2)).sum())
    assert PTR.host_syncs - before in (grown, grown + 1)


class TestReferenceArithmetic:
    """The pieces that make the port's fits bit-identical to the reference
    on the CPU, each held to the JAX operation it stands in for."""

    def test_sigmoid_and_exp(self):
        rng = np.random.default_rng(0)
        x = np.concatenate([rng.normal(size=200_000) * 6,
                            rng.uniform(-95, 95, size=20_000),
                            [0.0, -0.0, np.inf, -np.inf]]).astype(np.float32)
        with np.errstate(over="ignore"):
            assert np.array_equal(
                PTR._xla_sigmoid(torch.from_numpy(x)).numpy(),
                np.asarray(jax.jit(jax.nn.sigmoid)(x)),
            )
            assert np.array_equal(
                PTR._xla_exp(torch.from_numpy(x)).numpy(),
                np.asarray(jax.jit(jnp.exp)(x)),
            )

    @pytest.mark.parametrize("b", [2, 5, 16, 17, 32, 64, 255, 256, 300, 4500])
    def test_bin_cumsum_and_total(self, b):
        x = np.random.default_rng(b).normal(size=(2, 3, 4, b, 2)).astype(np.float32)
        cs = jax.jit(lambda a: jnp.cumsum(a, axis=3))(x)
        tot = jax.jit(lambda a: a.sum(axis=3, keepdims=True))(x)
        assert np.array_equal(H._cumsum_bins(torch.from_numpy(x)).numpy(),
                              np.asarray(cs))
        assert np.array_equal(H._xla_sum(torch.from_numpy(x), 3).unsqueeze(3).numpy(),
                              np.asarray(tot))

    @pytest.mark.parametrize("n,size", [(20, 8), (600, 64), (5000, 64), (700, 1024),
                                        (30000, 4096)])
    def test_leaf_sums(self, n, size):
        rng = np.random.default_rng(n)
        v = rng.normal(size=(3, n)).astype(np.float32)
        idx = rng.integers(0, size, size=(3, n)).astype(np.int32)
        want = jax.jit(JTR._segment_sum_small, static_argnums=2)(v, idx, size)
        got = PTR._segment_sum_small(torch.from_numpy(v), torch.from_numpy(idx), size)
        assert np.array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("n,size", [(891, 1024), (5000, 64), (33, 8)])
    def test_leaf_sums_crowded_slots(self, n, size):
        """Most rows in one or two slots (a late boosting round): every
        window holds up to 32 rows of one slot, added in row order."""
        rng = np.random.default_rng(n)
        v = rng.normal(size=(2, n)).astype(np.float32)
        idx = np.where(rng.random((2, n)) < 0.95, 3, 5).astype(np.int32)
        want = jax.jit(JTR._segment_sum_small, static_argnums=2)(v, idx, size)
        got = PTR._segment_sum_small(torch.from_numpy(v), torch.from_numpy(idx), size)
        assert np.array_equal(got.numpy(), np.asarray(want))

    def test_leaf_sums_crowded_slots_on_the_card(self):
        """The card's windowed leaf sums equal the CPU's when a window's 32
        rows share one slot (an accumulating index_put_ on the card sums
        such duplicates in another order)."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        rng = np.random.default_rng(7)
        for n, size in ((891, 1024), (16384, 64), (4000, 512)):
            v = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
            idx = torch.from_numpy(
                np.where(rng.random((3, n)) < 0.95, 3, 5).astype(np.int32))
            card = PTR._segment_sum_small(v.cuda(), idx.cuda(), size).cpu()
            assert torch.equal(card, PTR._segment_sum_small(v, idx, size))

    def test_fused_margin_update(self):
        rng = np.random.default_rng(1)
        m, s = (rng.normal(size=(2, 3000)).astype(np.float32) for _ in range(2))
        eta = np.array([0.02, 0.3], np.float32)
        want = jax.jit(lambda m, e, s: m + e[:, None] * s)(m, eta, s)
        got = PTR._fma32(torch.from_numpy(eta)[:, None], torch.from_numpy(s),
                         torch.from_numpy(m))
        assert np.array_equal(got.numpy(), np.asarray(want))
