"""The PyTorch port's per-row tree sum (``transmogrifai_tpu_torch.models.
tree_sum``) and the served tree scores built on it, against the JAX
package's serving arithmetic: BIT FOR BIT.

For batches of up to 16384 rows the JAX package serves on the host: its
native loop adds the trees in tree order into one float32 accumulator per
row (``native/tptpu_native.cpp`` ``tp_tree_predict_sum``), then takes
``base + eta * sum`` and ``sum / T`` as separately rounded float32
operations (``models/trees.py`` ``predict_boosted_host`` /
``predict_forest_host``). Without its native library it falls back to a
numpy pairwise sum, a different order; the tests that compare with the
reference therefore first require that the library loaded, and every case
is also held to a numpy tree-order oracle that does not depend on the host.

Above 16384 rows the reference takes its device route, whose summation
order differs from the tree order in the last ulp; the port follows it
there and its scores equal the reference's too (the order is pinned in
``test_torch_device_route.py``). The kernel itself is compared with the
plain version only where a card is present.
"""
import functools
import json
import os

import numpy as np
import pytest
import torch

from transmogrifai_tpu import native
from transmogrifai_tpu.local.scoring import score_function as jax_score_function
from transmogrifai_tpu.models import gbdt as JG
from transmogrifai_tpu.models import trees as JTR
from transmogrifai_tpu.workflow.persistence import (
    load_workflow_model as jax_load_workflow_model,
)
from transmogrifai_tpu_torch.local.scoring import score_function
from transmogrifai_tpu_torch.models import gbdt as PG
from transmogrifai_tpu_torch.models import serve_trees as ST
from transmogrifai_tpu_torch.models import tree_sum as TS
from transmogrifai_tpu_torch.models import trees as PTR
from transmogrifai_tpu_torch.utils import cuda_build
from transmogrifai_tpu_torch.workflow.persistence import load_workflow_model

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_serving")


def _oracle(per_tree: np.ndarray, boosted: bool, eta=0.0, base=0.0):
    """The tree-order float32 sum and epilogue, in numpy."""
    acc = np.zeros(per_tree.shape[0], np.float32)
    for t in range(per_tree.shape[1]):
        acc = acc + per_tree[:, t]
    if boosted:
        return np.float32(base) + np.float32(eta) * acc
    return acc / np.float32(per_tree.shape[1])


def _require_native():
    """The reference's host route sums in tree order only through its native
    library; without it the comparison would be with a pairwise sum."""
    if native._load() is None:
        pytest.fail("libtptpu.so did not load: the reference's host route "
                    "would sum pairwise, not in tree order")


def _per_tree(rng, n, t, scale=1.0):
    # values spread over magnitudes so that order matters in the last ulp
    v = rng.normal(scale=scale, size=(n, t)) * 10.0 ** rng.integers(-3, 2, (n, t))
    return v.astype(np.float32)


@pytest.mark.parametrize("n,t", [(1, 1), (37, 7), (256, 200), (130, 333)])
@pytest.mark.parametrize("boosted", [True, False])
def test_plain_version_equals_tree_order_oracle(n, t, boosted):
    rng = np.random.default_rng(n * 1000 + t)
    pt = _per_tree(rng, n, t)
    got = TS.tree_sum(torch.from_numpy(pt), boosted, eta=0.02, base_score=0.37)
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert np.array_equal(got.numpy(), _oracle(pt, boosted, 0.02, 0.37))


def test_order_matters_for_these_inputs():
    """The oracle's inputs are ones where another order gives other bits:
    a pairwise or a float64 sum differs from the tree-order sum."""
    rng = np.random.default_rng(3)
    pt = _per_tree(rng, 256, 200)
    tree_order = _oracle(pt, boosted=False)
    assert not np.array_equal(tree_order, pt.sum(axis=1) / np.float32(200))
    assert not np.array_equal(torch.from_numpy(pt).mean(dim=1).numpy(), tree_order)


def test_boosted_epilogue_rounds_product_and_sum_apart():
    """base + eta * sum with two roundings, not one fused multiply-add: for
    some of these sums the fused result differs, and the plain version
    takes the separately rounded one everywhere."""
    eta, base = np.float32(0.02), np.float32(0.37)
    pt = np.random.default_rng(0).normal(size=(1000, 1)).astype(np.float32)
    # an f32 product is exact in float64: one float64 add, then one
    # rounding to float32, is the fused result
    fused = (np.float64(eta) * pt[:, 0].astype(np.float64)
             + np.float64(base)).astype(np.float32)
    separate = base + eta * pt[:, 0]
    assert np.count_nonzero(fused != separate) > 0
    got = TS.tree_sum(torch.from_numpy(pt), True, eta=float(eta),
                      base_score=float(base)).numpy()
    assert np.array_equal(got, separate)


@pytest.mark.parametrize("t,depth", [(200, 6), (50, 10), (3, 1)])
def test_served_sums_equal_the_reference_host_route(t, depth):
    """The port's bin + traversal + tree sum equals the JAX package's
    ``predict_boosted_host`` / ``predict_forest_host`` bit for bit."""
    _require_native()
    rng = np.random.default_rng(t + depth)
    n, f, bins = 500, 9, 32
    x = rng.normal(size=(n, f)).astype(np.float32)
    thr = JTR.quantile_thresholds(x, max_bins=bins)
    w = 1 << depth
    sf = rng.integers(-1, f, size=(t, depth, w)).astype(np.int32)
    sb = rng.integers(0, bins - 1, size=(t, depth, w)).astype(np.int32)
    lv = (rng.normal(scale=0.1, size=(t, w))
          * 10.0 ** rng.integers(-2, 1, (t, w))).astype(np.float32)
    jtrees = JTR.Tree(sf, sb, lv)
    ptrees = PTR.Tree(*(torch.from_numpy(a) for a in (sf, sb, lv)))
    xt, tt = torch.from_numpy(x), torch.from_numpy(thr)
    want_b = JTR.predict_boosted_host(x, thr, jtrees, 0.02, 0.1)
    want_f = JTR.predict_forest_host(x, thr, jtrees)
    got_b = PTR.predict_boosted_raw(xt, tt, ptrees, 0.02, 0.1).numpy()
    got_f = PTR.predict_forest_raw(xt, tt, ptrees).numpy()
    assert np.array_equal(got_b, want_b)
    assert np.array_equal(got_f, want_f)
    # the same bits as the host-independent oracle over the leaf values
    per_tree = ST.serve_trees_reference(
        PTR.bin_data(xt, tt), *ptrees).numpy()
    assert np.array_equal(got_b, _oracle(per_tree, True, 0.02, 0.1))
    assert np.array_equal(got_f, _oracle(per_tree, False))


def _fixture(name):
    path = os.path.join(FIXTURES, name)
    with open(os.path.join(path, "rows.json")) as fh:
        rows = json.load(fh)
    return path, rows


def _flat(out):
    preds = [next(iter(r.values())) for r in out]
    return np.array([[p["prediction"], p["probability_0"], p["probability_1"],
                      p["rawPrediction_0"], p["rawPrediction_1"]] for p in preds])


@pytest.mark.parametrize("name", ["xgb", "rf"])
def test_fixture_scores_equal_the_reference(name):
    """Both serving fixtures: predictions, probabilities and raw scores of
    the port equal the JAX package's ``predict_arrays`` (0 differing
    cells), and the core equals the numpy tree-order oracle built from the
    reference's arrays."""
    _require_native()
    path, rows = _fixture(name)
    jm = jax_load_workflow_model(path)
    pm = load_workflow_model(path, device="cpu")
    want = _flat(jax_score_function(jm).batch(rows))
    got = _flat(score_function(pm, device="cpu").batch(rows))
    assert np.count_nonzero(got != want) == 0
    # the oracle from the reference's own arrays: its binning and walk
    # (exact integer logic), then the tree-order sum
    jsel = next(s for s in jm.fitted.values() if hasattr(s, "best_model"))
    psel = next(s for s in pm.fitted.values() if hasattr(s, "best_model"))
    best = jsel.best_model
    trees = getattr(best, "trees", None)
    trees = JG._host_trees(trees if trees is not None else best.forests_per_class[0])
    vec = np.asarray(_vector_of(pm, rows), np.float32)
    binned = JTR.bin_data_host(vec, best.thresholds)
    per_tree = JTR._traverse_host(binned, JTR.prepare_host_stack(trees)).T
    boosted = isinstance(best, JG.BoostedBinaryModel)
    oracle = (_oracle(per_tree, True, best.eta, best.base_score) if boosted
              else _oracle(per_tree, False))
    assert np.array_equal(psel.best_model.predict_core(vec)[:, 0],
                          oracle.astype(np.float64))


def _vector_of(model, rows):
    """The feature vector the port's plan hands its predictor."""
    from transmogrifai_tpu_torch.types.columns import column_from_values

    cols = {f.name: column_from_values(f.ftype, [r.get(f.name) for r in rows])
            for f in model.raw_features}
    plan = model.stage_plan()
    for stage in plan[:-1]:
        cols[stage.output_name] = stage.transform_columns(
            *[cols[n] for n in stage.input_names], num_rows=len(rows))
    return cols[plan[-1].input_names[-1]].values


@functools.lru_cache(maxsize=None)
def _twin_model(family: str):
    """A small flagship-flow model on a ``testkit.random_dataset`` twin of
    the Titanic table, trained and saved by the JAX package."""
    import importlib.util
    import tempfile

    spec = importlib.util.spec_from_file_location(
        "make_serving_fixtures", os.path.join(
            os.path.dirname(__file__), "torch_fixtures",
            "make_serving_fixtures.py"))
    MSF = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(MSF)

    ds = MSF.twin_dataset()
    cand = {
        "xgb": (JG.XGBoostClassifier(),
                {"num_round": [12], "eta": [0.3], "max_depth": [4]}),
        "rf": (JG.RandomForestClassifier(),
               {"num_trees": [9], "max_depth": [5]}),
    }[family]
    model = MSF.train(ds, cand)
    path = os.path.join(tempfile.mkdtemp(prefix=f"twin-{family}-"), "model")
    model.save(path)
    return model, path, MSF.scoring_rows(ds, 300)


@pytest.mark.parametrize("family", ["xgb", "rf"])
def test_testkit_twin_scores_equal_the_reference(family):
    _require_native()
    model, path, rows = _twin_model(family)
    want = _flat(jax_score_function(model).batch(rows))
    got = _flat(score_function(load_workflow_model(path, device="cpu"),
                               device="cpu").batch(rows))
    assert np.count_nonzero(got != want) == 0


def test_above_16384_rows_within_the_device_route_bound():
    """20000 rows: the reference's ``predict_arrays`` takes its device
    route; so does the port's, whose scores equal the reference's, bit for
    bit (before, the port kept the tree order there and was held to 1e-6:
    21572 of 40000 boosted cells differed, by up to 6.7e-8). The tree-order
    oracle differs from both."""
    rng = np.random.default_rng(20000)
    n, f, t, depth, bins = 20000, 8, 200, 6, 32
    x = rng.normal(size=(n, f)).astype(np.float32)
    thr = JTR.quantile_thresholds(x, max_bins=bins)
    w = 1 << depth
    sf = rng.integers(-1, f, size=(t, depth, w)).astype(np.int32)
    sb = rng.integers(0, bins - 1, size=(t, depth, w)).astype(np.int32)
    lv = rng.normal(scale=0.1, size=(t, w)).astype(np.float32)
    jtrees = JTR.Tree(sf, sb, lv)
    for jm, pm, boosted in [
        (JG.BoostedBinaryModel(thr, jtrees, 0.02, 0.1),
         PG.BoostedBinaryModel(thr, PTR.Tree(sf, sb, lv), 0.02, 0.1), True),
        (JG.ForestClassifierModel(thr, [jtrees]),
         PG.ForestClassifierModel(thr, [PTR.Tree(sf, sb, lv)]), False),
    ]:
        assert not jm._use_host(x) and not pm._use_host(x)
        pm.to("cpu")
        core = pm.predict_core(x)[:, 0]
        per_tree = ST.serve_trees_reference(
            PTR.bin_data(torch.from_numpy(x), torch.from_numpy(thr)),
            *(torch.from_numpy(a) for a in (sf, sb, lv))).numpy()
        assert not np.array_equal(core, _oracle(per_tree, boosted, 0.02, 0.1)
                                  .astype(np.float64))
        for got, want in zip(pm.predict_arrays(x), jm.predict_arrays(x)):
            assert np.count_nonzero(got != want) == 0


class TestWrapperGuards:
    def test_cpu_tensor_does_not_count_launches(self):
        before = TS.tree_sum.launches
        TS.tree_sum(torch.ones((4, 3)), True, 0.1, 0.0)
        TS.tree_sum(torch.ones((4, 3)), False)
        assert TS.tree_sum.launches == before

    @pytest.mark.parametrize("bad,exc", [
        (lambda: torch.ones((4, 3), dtype=torch.float64), TypeError),
        (lambda: torch.ones(4), ValueError),
        (lambda: torch.ones((2, 4, 3)), ValueError),
        (lambda: torch.ones((3, 4)).T, ValueError),
        (lambda: np.ones((4, 3), np.float32), TypeError),
    ])
    def test_bad_input_raises(self, bad, exc):
        with pytest.raises(exc):
            TS.tree_sum(bad(), True, 0.1, 0.0)

    def test_cuda_tensor_with_failing_loader_raises(self, monkeypatch):
        """A CUDA tensor launches the kernel or raises: never the plain
        version, and no launch counted."""
        monkeypatch.setattr(TS, "_on_cuda", lambda x: True)
        monkeypatch.setattr(TS, "_library", functools.cache(TS._library.__wrapped__))

        def trap(*a, **k):
            raise AssertionError("fell back to the plain version")

        def broken(name):
            raise cuda_build.KernelBuildError(f"cannot build {name}")

        monkeypatch.setattr(TS, "tree_sum_plain", trap)
        monkeypatch.setattr(cuda_build, "load_library", broken)
        before = TS.tree_sum.launches
        with pytest.raises(cuda_build.KernelBuildError, match="tree_sum"):
            TS.tree_sum(torch.ones((4, 3)), False)
        assert TS.tree_sum.launches == before

    def test_predicts_reduce_through_the_wrapper(self, monkeypatch):
        """``predict_boosted`` and ``predict_forest`` reduce through
        ``tree_sum`` (and nothing else)."""
        calls = []
        real = TS.tree_sum

        def spy(per_tree, boosted, eta=0.0, base_score=0.0):
            calls.append((tuple(per_tree.shape), boosted, eta, base_score))
            return real(per_tree, boosted, eta, base_score)

        monkeypatch.setattr(ST, "tree_sum", spy)
        rng = np.random.default_rng(5)
        sf = rng.integers(-1, 3, size=(4, 2, 4)).astype(np.int32)
        sb = rng.integers(0, 4, size=(4, 2, 4)).astype(np.int32)
        lv = rng.normal(size=(4, 4)).astype(np.float32)
        trees = PTR.Tree(*(torch.from_numpy(a) for a in (sf, sb, lv)))
        binned = torch.from_numpy(rng.integers(0, 4, (6, 3)).astype(np.int32))
        ST.predict_boosted(binned, trees, 0.5, 0.25)
        ST.predict_forest(binned, trees)
        assert calls == [((6, 4), True, 0.5, 0.25), ((6, 4), False, 0.0, 0.0)]


def test_kernel_matches_plain_version_on_the_card():
    """Needs a CUDA card (skips here): the kernel equals the plain version
    bit for bit, boosted and forest, at the serving shapes, a ragged shape
    and more trees than one staged tile holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [(8192, 200), (8192, 50), (1001, 7), (33, 129), (5, 1), (300, 513)]
    for seed, (n, t) in enumerate(cases):
        pt = torch.from_numpy(_per_tree(np.random.default_rng(seed), n, t)).cuda()
        for boosted in (True, False):
            before = TS.tree_sum.launches
            got = TS.tree_sum(pt, boosted, 0.02, 0.37)
            assert TS.tree_sum.launches == before + 1
            want = TS.tree_sum_plain(pt, boosted, 0.02, 0.37)
            cpu = TS.tree_sum_plain(pt.cpu(), boosted, 0.02, 0.37)
            torch.cuda.synchronize()
            assert torch.equal(got, want) and torch.equal(got.cpu(), cpu)
