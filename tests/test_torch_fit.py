"""The PyTorch port's tree estimators (``transmogrifai_tpu_torch.models.gbdt``
``XGBoostClassifier`` and ``RandomForestClassifier``) against the JAX
package's on the same seeded table (600 rows, 4 continuous columns, one
with NaN, and 6 binary ones), through ``fit_arrays``,
``fit_arrays_batched_masks`` and ``fit_model``: the SAME trees
(``split_feat``/``split_bin`` identical), leaf values and training outputs
within ``TOL``, and scores through both packages' ``predict_arrays`` with
equal predictions and probabilities (``PROB_ATOL`` is 0). The training
fixture the JAX package stored (``tests/fixtures/torch_training``, 5000
rows) is reproduced the same way."""
import json
import os

import numpy as np
import pytest
import torch

from transmogrifai_tpu.models import gbdt as JG
from transmogrifai_tpu_torch.models import gbdt as PG
from transmogrifai_tpu_torch.models import trees as PTR

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

#: leaf values and training outputs are f32 sums over rows and rounds taken
#: in another order than the reference's one-hot reductions (XGBoost's
#: sigmoid also differs in the last ulp now and then): they agree to a few
#: f32 ulps of values of order 1
TOL = dict(rtol=1e-5, atol=1e-5, equal_nan=True)
#: float64 probabilities from the f32 margins / mean leaves: the trees
#: are identical and both packages sum them in tree order on these batches
#: (<= 16384 rows, the reference's host route), so the scores are equal
PROB_ATOL = 0.0
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "torch_training")


def _table(n=600, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((n, 10), np.float32)
    x[:, :4] = rng.normal(size=(n, 4))
    x[rng.uniform(size=n) < 0.2, 1] = np.nan
    x[:, 4:] = rng.uniform(size=(n, 6)) < 0.3
    logit = (x[:, 0] - 0.8 * np.nan_to_num(x[:, 1]) + 1.5 * x[:, 4] - x[:, 5]
             + 0.5 * rng.normal(size=n))
    return x, (logit > 0).astype(np.float32)


X, Y = _table()
MASKS = [(np.arange(len(Y)) % 3 != i).astype(np.float32) for i in range(3)]


def _trees(model):
    """The (single) tree stack of a fitted model of either package."""
    t = getattr(model, "trees", None)
    if t is None:
        t = model.forests_per_class[0]
    t = JG._resolve_trees(t) if not isinstance(t, PTR.Tree) else t
    return [np.asarray(a) for a in t]


def _assert_same_model(jm, pm):
    jt, pt = _trees(jm), _trees(pm)
    assert np.array_equal(jt[0], pt[0])
    assert np.array_equal(jt[1], pt[1])
    np.testing.assert_allclose(pt[2], jt[2], **TOL)
    jpred, jprob, _ = jm.predict_arrays(X)
    ppred, pprob, _ = pm.predict_arrays(X)
    assert np.array_equal(jpred, ppred)
    np.testing.assert_allclose(pprob, jprob, rtol=0, atol=PROB_ATOL)


FAMILIES = {
    "xgb": (JG.XGBoostClassifier, PG.XGBoostClassifier,
            dict(num_round=10, max_depth=4)),
    "rf": (JG.RandomForestClassifier, PG.RandomForestClassifier,
           dict(num_trees=8, max_depth=4)),
}
GRIDS = {
    "xgb": [{"num_round": 10, "eta": 0.1, "gamma": 0.1, "max_depth": 4,
             "min_child_weight": w} for w in (1.0, 10.0)],
    "rf": [{"num_trees": 8, "max_depth": d, "min_instances_per_node": m,
            "min_info_gain": gain}
           for d in (2, 4) for m in (1, 10) for gain in (0.001, 0.1)],
}


@pytest.mark.parametrize("family", ["xgb", "rf"])
def test_fit_arrays_matches_reference(family):
    jcls, pcls, params = FAMILIES[family]
    jm = jcls(**params).fit_arrays(X, Y, MASKS[0])
    pm = pcls(**params, device="cpu").fit_arrays(X, Y, MASKS[0])
    _assert_same_model(jm, pm)


@pytest.mark.parametrize("family", ["xgb", "rf"])
def test_batched_masks_match_reference(family):
    jcls, pcls, _ = FAMILIES[family]
    jms = jcls().fit_arrays_batched_masks(X, Y, MASKS, GRIDS[family])
    pms = pcls(device="cpu").fit_arrays_batched_masks(X, Y, MASKS, GRIDS[family])
    stacks = set()
    for jrow, prow in zip(jms, pms):
        for jm, pm in zip(jrow, prow):
            _assert_same_model(jm, pm)
            assert pm._sweep_lane == jm._sweep_lane
            stacks.add(id(pm._sweep_stack))
            np.testing.assert_allclose(
                pm._sweep_stack["outputs"][pm._sweep_lane],
                np.asarray(jm._sweep_stack["outputs"])[jm._sweep_lane], **TOL,
            )
    # one batched fit per static group: xgb one, rf one per depth
    assert len(stacks) == (1 if family == "xgb" else 2)


def test_fit_model_through_a_dataset():
    from transmogrifai_tpu_torch import types as T
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.features.feature import Feature
    from transmogrifai_tpu_torch.types.columns import NumericColumn, VectorColumn

    ds = Dataset.of({
        "label": NumericColumn(T.RealNN, Y.astype(np.float64),
                               np.ones(len(Y), bool)),
        "vec": VectorColumn(T.OPVector, X),
    })
    label = Feature(name="label", ftype=T.RealNN, is_response=True)
    vec = Feature(name="vec", ftype=T.OPVector)
    est = PG.XGBoostClassifier(num_round=5, max_depth=3, device="cpu")
    model = est.set_input(label, vec).fit(ds)
    want = PG.XGBoostClassifier(num_round=5, max_depth=3, device="cpu").fit_arrays(
        X, Y, np.ones(len(Y), np.float32)
    )
    assert np.array_equal(_trees(model)[0], _trees(want)[0])
    assert model.output_name == est.output_name
    out = model.transform_columns(ds["label"], ds["vec"], num_rows=len(Y))
    assert np.array_equal(out.prediction, want.predict_arrays(X)[0])


@pytest.mark.parametrize("family", ["xgb", "rf"])
def test_multiclass_is_not_ported_yet(family):
    """Three classes fit one-vs-rest in both entry points, since the
    multiclass slice (the name is kept from when they raised): one stack per
    class, each EQUAL to the JAX package's, and equal scores."""
    jcls, pcls, params = FAMILIES[family]
    # three classes under every mask
    y3 = (np.arange(len(Y)) // 7 % 3).astype(np.float32)
    jm = jcls(**params).fit_arrays(X, y3, MASKS[0])
    pm = pcls(**params, device="cpu").fit_arrays(X, y3, MASKS[0])
    pb = pcls(device="cpu").fit_arrays_batched_masks(X, y3, MASKS, GRIDS[family][:1])
    jb = jcls().fit_arrays_batched_masks(X, y3, MASKS, GRIDS[family][:1])
    for jmod, pmod in [(jm, pm)] + [(j[0], p[0]) for j, p in zip(jb, pb)]:
        attr = "trees_per_class" if family == "xgb" else "forests_per_class"
        jst, pst = getattr(jmod, attr), getattr(pmod, attr)
        assert len(pst) == len(jst) == 3
        for jt, pt in zip(jst, pst):
            for a, b in zip(JG._resolve_trees(jt), pt):
                assert np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
        for got, want in zip(pmod.predict_arrays(X), jmod.predict_arrays(X)):
            assert np.array_equal(got, want)


def test_estimators_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PG.XGBoostClassifier(num_round=1).fit_arrays(X, Y, MASKS[0])


@pytest.mark.parametrize("family", ["xgb", "rf"])
def test_training_fixture_reproduced(family):
    """The JAX package's stored fit of the 5000-row fixture, reproduced
    lane by lane on the CPU."""
    with np.load(os.path.join(FIXTURE, "table.npz")) as z:
        x, y, masks = z["x"], z["y"], z["masks"]
    with open(os.path.join(FIXTURE, "config.json")) as fh:
        point = json.load(fh)["points"][family]
    with np.load(os.path.join(FIXTURE, f"{family}.npz")) as z:
        want = {k: z[k] for k in z.files}
    pcls = FAMILIES[family][1]
    models = pcls(device="cpu").fit_arrays_batched_masks(x, y, list(masks), [point])
    stack = models[0][0]._sweep_stack
    assert np.array_equal(stack["trees"].split_feat, want["split_feat"])
    assert np.array_equal(stack["trees"].split_bin, want["split_bin"])
    np.testing.assert_allclose(stack["trees"].leaf_value, want["leaf_value"], **TOL)
    np.testing.assert_allclose(stack["outputs"], want["outputs"], **TOL)
