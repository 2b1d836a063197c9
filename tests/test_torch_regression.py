"""The PyTorch port's tree regressors (``transmogrifai_tpu_torch.models.gbdt``
``XGBoostRegressor``, ``GBTRegressor`` and ``RandomForestRegressor``)
against the JAX package's on the same seeded table (600 rows, 4 continuous
columns, one with NaN, and 6 binary ones; a continuous target), at 32 and
256 bins, through ``fit_arrays``, ``fit_arrays_batched_masks`` (grids that
mix depths, GBT's Spark-named params, per-mask base scores) and
``fit_model``: the SAME trees (``split_feat``/``split_bin`` identical),
leaf values, base scores and training outputs within ``TOL``, and
predictions through both packages' ``predict_arrays`` within ``TOL``. The
fitted model classes load from the reference's ``get_params``/``get_arrays``
(``construct_stage``), and the 256-bin regression fits of the training
fixture the JAX package stored (``tests/fixtures/torch_training``, 5000
rows) are reproduced."""
import json
import os

import numpy as np
import pytest
import torch

from transmogrifai_tpu.models import gbdt as JG
from transmogrifai_tpu_torch.models import gbdt as PG
from transmogrifai_tpu_torch.models import trees as PTR
from transmogrifai_tpu_torch.workflow import persistence as PP

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

#: leaf values, base scores and outputs are f32 sums over rows and rounds
#: taken in another order than the reference's one-hot reductions: they
#: agree to a few f32 ulps of values of order 1 (tests/test_torch_fit.py)
TOL = dict(rtol=1e-5, atol=1e-5, equal_nan=True)
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "torch_training")


def _table(n=600, seed=1):
    rng = np.random.default_rng(seed)
    x = np.zeros((n, 10), np.float32)
    x[:, :4] = rng.normal(size=(n, 4))
    x[rng.uniform(size=n) < 0.2, 1] = np.nan
    x[:, 4:] = rng.uniform(size=(n, 6)) < 0.3
    y = (x[:, 0] - 0.8 * np.nan_to_num(x[:, 1]) + 1.5 * x[:, 4] - x[:, 5]
         + 0.5 * x[:, 2] * x[:, 3] + 0.5 * rng.normal(size=n))
    return x, y.astype(np.float32)


X, Y = _table()
MASKS = [(np.arange(len(Y)) % 3 != i).astype(np.float32) for i in range(3)]

FAMILIES = {
    "xgbr": (JG.XGBoostRegressor, PG.XGBoostRegressor,
             dict(num_round=6, max_depth=4, eta=0.3, min_child_weight=5.0)),
    "gbtr": (JG.GBTRegressor, PG.GBTRegressor,
             dict(max_iter=6, max_depth=4, min_instances_per_node=5)),
    "rfr": (JG.RandomForestRegressor, PG.RandomForestRegressor,
            dict(num_trees=5, max_depth=4, min_instances_per_node=5)),
}
GRIDS = {
    "xgbr": [{"num_round": 4, "eta": 0.1, "gamma": g, "max_depth": d,
              "min_child_weight": 5.0} for d in (2, 4) for g in (0.0, 0.5)],
    "gbtr": [{"max_iter": 4, "step_size": s, "max_depth": d,
              "min_instances_per_node": mi, "min_info_gain": 0.0}
             for d in (2, 4) for s, mi in ((0.1, 1), (0.3, 20))],
    "rfr": [{"num_trees": 3, "max_depth": d, "min_instances_per_node": mi,
             "min_info_gain": gain}
            for d in (2, 4) for mi, gain in ((1, 0.001), (20, 0.1))],
}


def _trees(model):
    t = model.trees
    t = JG._resolve_trees(t) if not isinstance(t, PTR.Tree) else t
    return [np.asarray(a) for a in t]


def _assert_same_model(jm, pm):
    assert type(pm).__name__ == type(jm).__name__
    jt, pt = _trees(jm), _trees(pm)
    assert np.array_equal(jt[0], pt[0])
    assert np.array_equal(jt[1], pt[1])
    np.testing.assert_allclose(pt[2], jt[2], **TOL)
    if hasattr(jm, "base_score"):
        assert pm.eta == pytest.approx(jm.eta)
        np.testing.assert_allclose(pm.base_score, jm.base_score, **TOL)
    jpred, jprob, jraw = jm.predict_arrays(X)
    ppred, pprob, praw = pm.predict_arrays(X)
    assert pprob is None and praw is None and jprob is None
    assert ppred.shape == (len(X),) and ppred.dtype == np.float64
    np.testing.assert_allclose(ppred, jpred, **TOL)


@pytest.mark.parametrize("bins", [32, 256])
@pytest.mark.parametrize("family", ["xgbr", "gbtr", "rfr"])
def test_fit_arrays_matches_reference(family, bins):
    jcls, pcls, params = FAMILIES[family]
    jm = jcls(**params, max_bins=bins).fit_arrays(X, Y, MASKS[0])
    pm = pcls(**params, max_bins=bins, device="cpu").fit_arrays(X, Y, MASKS[0])
    _assert_same_model(jm, pm)


@pytest.mark.parametrize("bins", [32, 256])
@pytest.mark.parametrize("family", ["xgbr", "gbtr", "rfr"])
def test_batched_masks_match_reference(family, bins):
    jcls, pcls, _ = FAMILIES[family]
    grid = [dict(p, max_bins=bins) for p in GRIDS[family]]
    jms = jcls().fit_arrays_batched_masks(X, Y, MASKS, grid)
    pms = pcls(device="cpu").fit_arrays_batched_masks(X, Y, MASKS, grid)
    stacks = set()
    for mi, (jrow, prow) in enumerate(zip(jms, pms)):
        for jm, pm in zip(jrow, prow):
            _assert_same_model(jm, pm)
            assert pm._sweep_lane == jm._sweep_lane
            stacks.add(id(pm._sweep_stack))
            np.testing.assert_allclose(
                pm._sweep_stack["outputs"][pm._sweep_lane],
                np.asarray(jm._sweep_stack["outputs"])[jm._sweep_lane], **TOL,
            )
            if family != "rfr":
                # each mask's fit starts from its own mean target
                want = Y[MASKS[mi] > 0].astype(np.float64).mean()
                assert pm.base_score == pytest.approx(want, rel=1e-6)
    # one batched fit per depth group
    assert len(stacks) == 2


def test_gbt_maps_spark_params_onto_the_boosting_knobs():
    est = PG.GBTRegressor(max_iter=7, step_size=0.2, max_depth=3,
                          min_instances_per_node=12, min_info_gain=0.01,
                          device="cpu")
    assert est._normalize_boost({**est.get_params()}) == {
        "num_round": 7, "eta": 0.2, "reg_lambda": 0.0, "gamma": 0.0,
        "min_child_weight": 12.0, "min_info_gain": 0.01, "max_depth": 3,
        "max_bins": 32,
    }
    m = est.fit_arrays(X, Y, MASKS[1])
    assert (m.eta, est.num_round, est.min_child_weight) == (0.2, 7, 12.0)
    assert _trees(m)[0].shape[0] == 7


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
    est = PG.GBTRegressor(max_iter=3, max_depth=3, max_bins=256, device="cpu")
    model = est.set_input(label, vec).fit(ds)
    want = JG.GBTRegressor(max_iter=3, max_depth=3, max_bins=256).fit_arrays(
        X, Y, np.ones(len(Y), np.float32))
    _assert_same_model(want, model)
    assert model.output_name == est.output_name
    out = model.transform_columns(ds["label"], ds["vec"], num_rows=len(Y))
    assert np.array_equal(out.prediction, model.predict_arrays(X)[0])
    assert out.probability is None


@pytest.mark.parametrize("family", ["xgbr", "rfr"])
def test_models_load_from_the_reference_arrays(family):
    """``construct_stage`` (what ``load_workflow_model`` calls per stage)
    builds the port's model from the reference's saved params and arrays,
    and it predicts what the reference's model predicts."""
    jcls, _, params = FAMILIES[family]
    jm = jcls(**params, max_bins=256).fit_arrays(X, Y, MASKS[2])
    name = type(jm).__name__
    assert name in PP.STAGE_CLASSES
    pm = PP.construct_stage(name, jm.get_params(), jm.get_arrays()).to("cpu")
    assert type(pm).__name__ == name
    _assert_same_model(jm, pm)
    for key, value in jm.get_arrays().items():
        assert np.array_equal(pm.get_arrays()[key], np.asarray(value),
                              equal_nan=True)


@pytest.mark.parametrize("family", ["gbtr", "rfr"])
def test_training_fixture_reproduced(family):
    """The JAX package's stored 256-bin regression fits of the 5000-row
    fixture, reproduced lane by lane on the CPU."""
    with np.load(os.path.join(FIXTURE, "table.npz")) as z:
        x, target, masks = z["x"], z["target"], z["masks"]
    with open(os.path.join(FIXTURE, "config.json")) as fh:
        point = json.load(fh)["points"][family]
    with np.load(os.path.join(FIXTURE, f"{family}.npz")) as z:
        want = {k: z[k] for k in z.files}
    pcls = FAMILIES[family][1]
    models = pcls(device="cpu").fit_arrays_batched_masks(
        x, target, list(masks), [point])
    stack = models[0][0]._sweep_stack
    assert point["max_bins"] == 256
    assert np.array_equal(stack["trees"].split_feat, want["split_feat"])
    assert np.array_equal(stack["trees"].split_bin, want["split_bin"])
    np.testing.assert_allclose(stack["trees"].leaf_value, want["leaf_value"], **TOL)
    np.testing.assert_allclose(stack["outputs"], want["outputs"], **TOL)
