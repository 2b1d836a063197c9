"""The data-parallel plane's cases, run on every rank of a spawned world
(``world.run_world(n, "parallel_cases:<case>", args, tmp_path)``) and, for
the references, in the test process itself. Numpy only plus the port: the
ranks never import JAX. Every input is made here from a seed, so the
parent and every rank see the same arrays.

Each case returns plain numpy results; the parent compares the ranks with
each other (bit-equal), with the port's single-device run, and with the
JAX package on its simulated CPU devices.
"""
from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------- inputs


def reduction_inputs(seed: int = 0) -> dict:
    """The reductions' inputs, at the reference tests' shapes
    (``tests/test_parallel.py``; row counts that do not divide 2 or 4)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=640)
    return {
        "x": rng.normal(size=(1001, 7)),
        "x_offset": rng.normal(loc=2e4, scale=1.0, size=(640, 3)),
        "x_corr": np.stack([base + 2e4, 0.5 * base + rng.normal(size=640)
                            + 1e4], axis=1),
        "x_xtx": rng.normal(size=(130, 5)).astype(np.float32),
        "codes": rng.integers(0, 16, size=(333, 4)).astype(np.int32),
        "codes_w": rng.integers(0, 8, size=(100, 2)).astype(np.int32),
        "w": rng.random(100).astype(np.float32),
        "g": (rng.random((97, 6)) > 0.5).astype(np.float64),
        "y": np.eye(3)[rng.integers(0, 3, 97)],
    }


def tree_data(n: int = 333, f: int = 12, k: int = 3, seed: int = 0,
              max_bins: int = 16):
    """``tests/test_trees_sharded.py``'s data: (binned [n, f] int32, y,
    masks [k, n]); n = 333 divides no world, so the padding is held."""
    from transmogrifai_tpu_torch.models import trees as TR

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = (x @ rng.normal(size=f) + 0.3 * rng.normal(size=n) > 0).astype(
        np.float32)
    thr = TR.quantile_thresholds(x, max_bins=max_bins)
    binned = TR.bin_data(torch.from_numpy(x), torch.from_numpy(thr)).numpy()
    masks = (rng.random((k, n)) > 0.2).astype(np.float32)
    return binned, y, masks


def glm_data(seed: int = 0):
    """(x [200, 6], y binary, y continuous, mask) for the GLM fits."""
    rng = np.random.default_rng(seed)
    n, d = 203, 6
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32)
    y = (x @ w > 0).astype(np.float32)
    y_lin = (x @ w + 0.1 * rng.normal(size=n)).astype(np.float32)
    return x, y, y_lin, np.ones(n, dtype=np.float32)


def sweep_lanes(k: int, n: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    masks = (rng.random((k, n)) > 0.25).astype(np.float32)
    regs = np.linspace(0.01, 0.2, k).astype(np.float32)
    ens = np.linspace(0.0, 0.5, k).astype(np.float32)
    return masks, regs, ens


# ------------------------------------------------------------ rank cases
def _mesh(n_model: int = 1):
    from transmogrifai_tpu_torch.parallel import make_mesh

    return make_mesh(n_model=n_model, device="cpu")


def reductions(repeat: int = 2) -> list:
    """The five reductions (and pcentered_gram's large-mean case), run
    ``repeat`` times: [run][name] -> numpy results."""
    from transmogrifai_tpu_torch.parallel import reductions as R

    mesh = _mesh()
    d = reduction_inputs()
    runs = []
    for _ in range(repeat):
        runs.append({
            "pcolumn_stats": R.pcolumn_stats(d["x"], mesh),
            "pcolumn_stats_offset": R.pcolumn_stats(d["x_offset"], mesh),
            "pcentered_gram": R.pcentered_gram(d["x_corr"], mesh),
            "pxtx": R.pxtx(d["x_xtx"], mesh),
            "phistogram": R.phistogram(d["codes"], 16, mesh),
            "phistogram_w": R.phistogram(d["codes_w"], 8, mesh,
                                         weights=d["w"]),
            "pcontingency": R.pcontingency(d["g"], d["y"], mesh),
        })
    runs.append(stats_routes())
    return runs


def _stats_run(dtype, seed: int = 5) -> dict:
    """``utils/stats.py``'s column stats, correlation and contingency
    tables of a 200 x 6 input made from ``seed``."""
    from transmogrifai_tpu_torch.utils import stats as S

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(200, 6))
    g = (rng.random((200, 4)) > 0.5).astype(np.float64)
    y = np.eye(2)[rng.integers(0, 2, 200)]
    xt = torch.from_numpy(x).to(dtype)
    cs = S.column_stats_tensor(xt)
    corr = S.correlation_tensor(xt).cpu().numpy()
    tab = S.contingency_tables(torch.from_numpy(g).to(dtype), [[0, 1], [2, 3]],
                               torch.from_numpy(y).to(dtype))
    return {"mean": cs.mean, "variance": cs.variance, "min": cs.min,
            "max": cs.max, "corr": corr, "tables": tab}


def own_sanity(rank: int) -> list:
    """The sanity checker's per-column statistics of a ``train()`` under
    ``set_parallelism(None)`` on a table of ``rank``'s own."""
    from transmogrifai_tpu_torch.models.logistic import LogisticRegression
    from transmogrifai_tpu_torch.selector import (
        BinaryClassificationModelSelector,
    )
    from transmogrifai_tpu_torch.utils import uid

    uid.reset()
    sel = BinaryClassificationModelSelector(seed=7, models=[
        (LogisticRegression(device="cpu", max_iter=10),
         {"reg_param": [0.1]})])
    model, _ = _flow(workflow_table(n=200, seed=3 + rank), "label", sel,
                     mesh="none")
    summ = next(s.metadata["sanityCheckerSummary"]
                for s in model.fitted.values()
                if s.metadata.get("sanityCheckerSummary"))
    return [[c["mean"], c["variance"], c["corr_label"]]
            for c in summ["columns"]]


def stats_routes() -> dict:
    """``utils/stats.py`` at a 200 x 6 input on its one-rank route and,
    with the threshold dropped to 0, on its mesh route under the world's
    data mesh (``base``, ``mesh``). With the threshold at 0 and no
    execution mesh, each rank's statistics of its own input (``own``) and,
    in a world of two, of a ``train()`` under ``set_parallelism(None)`` on
    its own table (``own_sanity``)."""
    from transmogrifai_tpu_torch.parallel.mesh import (
        use_execution_mesh, world_rank, world_size,
    )
    from transmogrifai_tpu_torch.utils import stats as S

    out = {"base": _stats_run(torch.float64)}
    saved = S._DEVICE_THRESHOLD
    S._DEVICE_THRESHOLD = 0
    try:
        with use_execution_mesh(_mesh()):
            out["mesh"] = _stats_run(torch.float32)
        with use_execution_mesh(None):
            out["own"] = _stats_run(torch.float32, seed=6 + world_rank())
        if world_size() == 2:
            out["own_sanity"] = own_sanity(world_rank())
    finally:
        S._DEVICE_THRESHOLD = saved
    return out


def tree_fits(device: str = "cpu") -> dict:
    """``tests/test_trees_sharded.py``'s five cases, sharded over the
    world: numpy trees (and outputs) by case."""
    from transmogrifai_tpu_torch.models import trees as TR
    from transmogrifai_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device=device)
    out = {}
    for name, kw in tree_case_args().items():
        out[name] = run_tree_case(TR, kw, mesh, device)
    return out


def tree_case_args() -> dict:
    """The cases' (data, fit) arguments."""
    return {
        "forest": dict(data={}, fn="forest", kw=dict(
            num_trees=4, max_depth=4, num_bins=16,
            subsample_rate=np.array([1.0, 0.8, 0.9], np.float32),
            colsample_rate=np.array([1.0, 0.7, 1.0], np.float32),
            min_instances=1.0, seed=7)),
        "boosted": dict(data={}, fn="boosted", kw=dict(
            num_rounds=6, max_depth=3, num_bins=16,
            eta=np.array([0.3, 0.1, 0.2], np.float32), reg_lambda=1.0,
            min_child_weight=1.0, objective="binary:logistic")),
        "regression": dict(data=dict(seed=2), fn="boosted_reg", kw=dict(
            num_rounds=4, max_depth=3, num_bins=16, eta=0.3,
            objective="reg:squarederror")),
        "deep": dict(data=dict(n=30, f=6), fn="forest_ones", kw=dict(
            num_trees=2, max_depth=7, num_bins=16, subsample_rate=1.0,
            colsample_rate=1.0, bootstrap=False, seed=3)),
        "predictions": dict(data=dict(n=256, k=2), fn="forest", kw=dict(
            num_trees=3, max_depth=4, num_bins=16, seed=11)),
    }


def run_tree_case(TR, case: dict, mesh, device: str = "cpu") -> dict:
    """One case through the port (``mesh`` None: one device). Returns the
    trees' arrays, the training outputs and, for ``predictions``, each
    lane's served forest mean on the training rows."""
    binned, y, masks = tree_data(**case["data"])
    kw = dict(case["kw"])
    dev = torch.device(device)
    b = torch.from_numpy(binned).to(dev)
    fn = case["fn"]
    if fn == "boosted_reg":
        y = y * 2.0 + binned[:, 0].astype(np.float32) * 0.1
    if fn == "forest_ones":
        masks = np.ones((2, binned.shape[0]), np.float32)
    yt = torch.from_numpy(y).to(dev)
    mt = torch.from_numpy(masks).to(dev)
    if fn.startswith("forest"):
        trees, outs = TR.fit_forest_batched(b, yt, mt, mesh=mesh,
                                            return_outputs=True, **kw)
    else:
        trees, outs = TR.fit_boosted_batched(b, yt, mt, mesh=mesh, **kw)
    res = {"split_feat": trees.split_feat.cpu().numpy(),
           "split_bin": trees.split_bin.cpu().numpy(),
           "leaf_value": trees.leaf_value.cpu().numpy(),
           "outputs": outs.cpu().numpy()}
    if fn == "forest" and "seed" in kw and kw["seed"] == 11:
        from transmogrifai_tpu_torch.models import serve_trees as ST

        res["pred"] = np.stack([
            ST.predict_forest(b, TR.Tree(*(a[k] for a in trees)))
            .cpu().numpy() for k in range(masks.shape[0])])
    return res


def glm_fits() -> dict:
    """data_parallel_fit (logistic, linear), grid_parallel_fit on a 2 x 2
    mesh (world 4) or 1 x world, and sweep_parallel_fit, each with the
    world's layouts."""
    from transmogrifai_tpu_torch.models import solvers as S
    from transmogrifai_tpu_torch.parallel import (
        data_parallel_fit, grid_parallel_fit, make_mesh, sweep_parallel_fit,
    )
    from transmogrifai_tpu_torch.parallel.mesh import world_size

    x, y, y_lin, mask = glm_data()
    data = make_mesh(device="cpu")
    out = {}
    p = data_parallel_fit(S.fit_logistic_binary, data, x, y, mask, 0.05,
                          0.0, num_iters=100)
    out["dp_logistic"] = (p.weights.numpy(), p.intercept.numpy())
    p = data_parallel_fit(S.fit_linear, data, x, y_lin, mask, 0.01, 0.0,
                          num_iters=200)
    out["dp_linear"] = (p.weights.numpy(), p.intercept.numpy())
    n_model = 2 if world_size() % 2 == 0 else 1
    grid = make_mesh(n_data=world_size() // n_model, n_model=n_model,
                     device="cpu")
    g = 6
    regs = np.linspace(0.0, 0.3, g).astype(np.float32)
    gp = grid_parallel_fit(S.fit_logistic_binary, grid, x[:64], y[:64],
                           mask[:64], [regs, np.zeros(g, np.float32)],
                           num_iters=20)
    out["grid"] = (gp.weights.numpy(), gp.intercept.numpy())
    masks, sregs, sens = sweep_lanes(3, len(y))
    for name, mesh in (("data", data), ("grid", grid)):
        lin = sweep_parallel_fit(S.fit_linear_batched, "t_sweep_lin", mesh,
                                 x, y_lin, masks, sregs, sens, num_iters=60,
                                 fit_intercept=True)
        log = sweep_parallel_fit(S.fit_logistic_binary_batched,
                                 "t_sweep_log", mesh, x, y, masks, sregs,
                                 sens, num_iters=60, fit_intercept=True,
                                 standardization=True)
        out[f"sweep_{name}"] = (lin.weights.numpy(), lin.intercept.numpy(),
                                log.weights.numpy(), log.intercept.numpy())
    return out


def ring_inputs() -> dict:
    """ring_segments' matrices, drawn in its order."""
    rng = np.random.default_rng(0)
    out = {name: rng.normal(size=shape).astype(np.float32)
           for name, shape in (("ring_gram", (64, 13)),
                               ("ring_gram_wide", (32, 200)))}
    xc = rng.normal(size=(100, 9))
    xc[:, 3] = 2.0
    out["ring_corr"] = xc
    n, k = 1000, 7
    out["seg"] = rng.integers(0, k, n)
    out["vals"] = rng.normal(size=n).astype(np.float32)
    return out


def ring_segments() -> dict:
    """ring_gram / ring_corr (``tests/test_ring.py``'s contracts) and the
    segment reductions (``TestSegmentReductions``)."""
    from transmogrifai_tpu_torch.parallel import (
        aggregate_events_on_device, psegment_reduce, ring_corr, ring_gram,
    )

    mesh = _mesh()
    out = {}
    d = ring_inputs()
    for name in ("ring_gram", "ring_gram_wide"):
        out[name] = ring_gram(d[name], mesh)
    out["ring_corr"] = ring_corr(d["ring_corr"], mesh)
    k = 7
    seg, vals = d["seg"], d["vals"]
    for op in ("sum", "max", "min", "mean", "count", "or"):
        out[f"seg_{op}"] = psegment_reduce(vals, seg, k, mesh, op=op)
    out["seg_pad_max"] = psegment_reduce(
        np.array([5.0, -3.0, 7.0], np.float32), np.array([0, 1, 0]), 2,
        mesh, op="max")
    out["events"] = aggregate_events_on_device(
        ["u1", "u2", "u1", "u3", "u2", "u1"],
        np.array([1.0, 10.0, 2.0, 100.0, 20.0, 4.0], np.float32), mesh)
    return out


def multihost() -> dict:
    """host_row_slice, read_host_block with a retried transient failure,
    ingest_global_array and global_column_stats."""
    from transmogrifai_tpu_torch.parallel import multihost as M
    from transmogrifai_tpu_torch.resilience.retry import (
        RetryPolicy, TransientError,
    )

    mesh = M.make_multihost_mesh(device="cpu")
    rng = np.random.default_rng(0)
    num_rows = 1003
    full = rng.normal(loc=5.0, size=(num_rows, 4)).astype(np.float32)
    out = {"padded": M.padded_rows(num_rows, mesh)}
    sl = M.host_row_slice(num_rows, mesh)
    out["slice"] = (sl.start, sl.stop)
    calls = []

    def flaky(s):
        calls.append(s)
        if len(calls) == 1:
            raise TransientError("injected transient read failure")
        return full[s]

    policy = RetryPolicy(max_attempts=3, base_delay=0.0, max_delay=0.0,
                         sleep=lambda _: None)
    block = M.read_host_block(flaky, num_rows, mesh, retry_policy=policy)
    out["block"] = block
    out["attempts"] = len(calls)
    g = M.ingest_global_array(lambda s: full[s], num_rows, mesh)
    out["global_shape"] = g.shape
    out["gathered"] = g.gather().cpu().numpy()
    out["stats"] = M.global_column_stats(full[sl], mesh, num_rows)
    # the device seam under a world: the rank's card, modulo the host's
    # cards (ranks sharing one card land on it)
    from unittest import mock

    from transmogrifai_tpu_torch.utils import device as D

    for count in (1, 4):
        with mock.patch.object(torch.cuda, "device_count",
                               return_value=count):
            out[f"card{count}"] = D._world_card()
    return out


# ------------------------------------------------------------- workflow
def workflow_table(n: int = 600, seed: int = 3, package: str = "port"):
    """A typed table from ``testkit.random_dataset`` (a numeric with 20%
    missing, a numeric, three pick lists, noise, a numeric 99% missing)
    and columns made from it: ``label`` binary, ``label3`` three classes,
    and ``leak``, the binary label plus noise. ``package="jax"`` makes the
    same table with the JAX package's types (the tests' comparisons)."""
    import importlib

    root = {"port": "transmogrifai_tpu_torch", "jax": "transmogrifai_tpu"}[package]
    TK = importlib.import_module(f"{root}.testkit")
    T = importlib.import_module(f"{root}.types")
    column_from_values = importlib.import_module(
        f"{root}.types.columns").column_from_values

    gens = {
        "age": TK.RandomReal.normal(40.0, 12.0).with_probability_of_empty(0.2),
        "fare": TK.RandomReal.uniform(0.0, 100.0),
        "sex": TK.RandomText.from_domain(["male", "female"], ftype=T.PickList),
        "embarked": TK.RandomText.from_domain(["S", "C", "Q"],
                                              ftype=T.PickList),
        "pclass": TK.RandomText.from_domain(["1", "2", "3"], ftype=T.PickList),
        "noise": TK.RandomReal.normal(0.0, 1.0),
        # nearly empty: the raw feature filter's blocklist
        "sparse": TK.RandomReal.normal(0.0, 1.0).with_probability_of_empty(
            0.99),
    }
    ds = TK.random_dataset(gens, n=n, seed=seed)
    # the same draws as random_dataset's columns (its per-column seeds)
    raw = {name: g.with_seed(seed + 1000 * i).limit(n)
           for i, (name, g) in enumerate(gens.items())}
    age = np.array([np.nan if v is None else v for v in raw["age"]])
    fare = np.array(raw["fare"], dtype=np.float64)
    female = np.array([v == "female" for v in raw["sex"]], float)
    first = np.array([v == "1" for v in raw["pclass"]], float)
    noise = np.random.default_rng(seed).normal(size=n)
    score = (-0.04 * np.nan_to_num(age - 40.0) + 0.02 * (fare - 50.0)
             + 1.5 * female + 0.8 * first + 0.7 * noise)
    label = (score > 0.3).astype(np.float64)
    label3 = np.digitize(score, np.quantile(score, [1 / 3, 2 / 3])).astype(
        np.float64)
    # a leak of the label: the sanity checker's drop
    leak = label + 0.01 * np.random.default_rng(seed + 1).normal(size=n)
    return (ds.with_column("leak", column_from_values(T.Real, leak))
              .with_column("label", column_from_values(T.RealNN, label))
              .with_column("label3", column_from_values(T.RealNN, label3)))


def _flow(ds, response: str, selector, *, mesh, rff: bool = False):
    """from_dataset -> transmogrify -> sanity check -> selector -> train
    under ``mesh`` (``"none"``: one device)."""
    from transmogrifai_tpu_torch.features import from_dataset
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.workflow.workflow import Workflow

    others = [c for c in ("label", "label3") if c != response]
    label, preds = from_dataset(ds.drop(others), response=response)
    vec = transmogrify(list(preds))
    checked = label.sanity_check(vec, remove_bad_features=True, device="cpu")
    pred = selector.set_input(label, checked).get_output()
    wf = Workflow().set_result_features(pred).set_input_dataset(
        ds.drop(others)).set_parallelism(None if mesh == "none" else mesh)
    if rff:
        wf = wf.with_raw_feature_filter(min_fill=0.05)
    return wf.train(), pred


def jax_selector_contract(n_data: int | None) -> dict:
    """The selector contract of :func:`workflow_contracts` in the JAX
    package, on the same table: ``train()`` under ``make_mesh(n_data=)``
    on its CPU devices, or on one device (None). Test-only: it imports
    the JAX package."""
    from transmogrifai_tpu.features import from_dataset
    from transmogrifai_tpu.models.gbdt import XGBoostClassifier
    from transmogrifai_tpu.models.logistic import LogisticRegression
    from transmogrifai_tpu.ops.transmogrify import transmogrify
    from transmogrifai_tpu.parallel import make_mesh
    from transmogrifai_tpu.selector import BinaryClassificationModelSelector
    from transmogrifai_tpu.utils import uid
    from transmogrifai_tpu.workflow.workflow import Workflow

    ds = workflow_table(package="jax").drop(["label3"])
    uid.reset()
    sel = BinaryClassificationModelSelector(seed=7, models=[
        (LogisticRegression(), {"reg_param": [0.01, 0.1]}),
        (XGBoostClassifier(num_round=8), {"eta": [0.3], "max_depth": [3]}),
    ])
    label, preds = from_dataset(ds, response="label")
    checked = label.sanity_check(transmogrify(list(preds)),
                                 remove_bad_features=True)
    pred = sel.set_input(label, checked).get_output()
    mesh = None if n_data is None else make_mesh(n_data=n_data)
    model = (Workflow().set_result_features(pred).set_input_dataset(ds)
             .set_parallelism(mesh).train())
    return {"selector": model.summary_json()["modelSelectorSummary"],
            "selector_probs": np.asarray(
                model.score(dataset=ds)[pred.name].probability)}


def workflow_contracts(world: bool = True) -> dict:
    """``tests/test_workflow_mesh.py``'s five contracts, trained under the
    world's data mesh (``world``) or on one device: selector summaries,
    holdout metrics, scores, the RFF and sanity decisions, the MLP's
    probabilities and a single-device model's scores with and without the
    mesh installed."""
    from transmogrifai_tpu_torch.models.gbdt import (
        RandomForestClassifier, XGBoostClassifier,
    )
    from transmogrifai_tpu_torch.models.logistic import LogisticRegression
    from transmogrifai_tpu_torch.models.mlp import MLPClassifier
    from transmogrifai_tpu_torch.parallel.mesh import (
        make_mesh, use_execution_mesh,
    )
    from transmogrifai_tpu_torch.selector import (
        BinaryClassificationModelSelector, MultiClassificationModelSelector,
    )
    from transmogrifai_tpu_torch.utils import uid

    mesh = make_mesh(device="cpu") if world else "none"
    ds = workflow_table()
    out = {}

    uid.reset()
    sel = BinaryClassificationModelSelector(seed=7, models=[
        (LogisticRegression(device="cpu"), {"reg_param": [0.01, 0.1]}),
        (XGBoostClassifier(num_round=8, device="cpu"),
         {"eta": [0.3], "max_depth": [3]}),
    ])
    model, pred = _flow(ds, "label", sel, mesh=mesh)
    out["selector"] = model.summary_json()["modelSelectorSummary"]
    out["selector_probs"] = np.asarray(
        model.score(dataset=ds.drop(["label3"]))[pred.name].probability)

    uid.reset()
    sel = BinaryClassificationModelSelector(seed=7, models=[
        (LogisticRegression(device="cpu"), {"reg_param": [0.1]})])
    model, pred = _flow(ds, "label", sel, mesh=mesh, rff=True)
    summary = model.summary_json()
    sanity = next(s for s in model.fitted.values()
                  if type(s).__name__ == "FeatureRemovalModel")
    out["rff"] = {
        "blocklist": sorted(summary.get("blocklistedFeatures", [])),
        "kept": [int(i) for i in sanity.indices_to_keep],
        "summary": summary["modelSelectorSummary"],
    }

    uid.reset()
    sel = MultiClassificationModelSelector(seed=11, models=[
        (LogisticRegression(device="cpu"), {"reg_param": [0.01, 0.1]}),
        (RandomForestClassifier(num_trees=10, device="cpu"),
         {"max_depth": [3]}),
    ])
    model, _ = _flow(ds, "label3", sel, mesh=mesh)
    out["multiclass"] = model.summary_json()["modelSelectorSummary"]

    rng = np.random.default_rng(3)
    x = rng.normal(size=(400, 12)).astype(np.float32)
    y = (x @ rng.normal(size=12) > 0).astype(np.float64)
    est = MLPClassifier(hidden_layers=(16,), max_iter=60, seed=5,
                        device="cpu")
    with use_execution_mesh(None if mesh == "none" else mesh):
        m = est.fit_arrays(x, y, np.ones(400, np.float32))
    pred_mlp, prob_mlp, _ = m.predict_arrays(x)
    out["mlp"] = (pred_mlp, prob_mlp)

    uid.reset()
    sel = BinaryClassificationModelSelector(seed=7, models=[
        (XGBoostClassifier(num_round=8, device="cpu"), {"max_depth": [3]})])
    model, pred = _flow(ds, "label", sel, mesh="none")
    data = ds.drop(["label3"])
    with use_execution_mesh(None):
        single = np.asarray(model.score(dataset=data)[pred.name].probability)
    with use_execution_mesh(None if mesh == "none" else mesh):
        meshed = np.asarray(model.score(dataset=data)[pred.name].probability)
    out["scoring"] = (single, meshed)
    return out


# ---------------------------------------------------------- on the card
#: the card phase's fits: [rows, features] at 32 bins, depth 6, a few
#: trees, and one 256-bin fit (kernel K3's route)
CARD_ROWS, CARD_FEATS, CARD_DEPTH = 16384, 128, 6


def card_data(rows: int = CARD_ROWS, feats: int = CARD_FEATS, seed: int = 21):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, feats)).astype(np.float32)
    y = (x[:, :8] @ rng.normal(size=8) + 0.5 * rng.normal(size=rows)
         > 0).astype(np.float32)
    masks = (rng.random((2, rows)) > 0.2).astype(np.float32)
    return x, y, masks


def card_fits(device: str | None = "cuda", sharded: bool = True,
              rows: int = CARD_ROWS, feats: int = CARD_FEATS) -> dict:
    """A forest and a boosted fit at 32 bins (two lanes each) and a
    boosted fit at 256 bins, over the world's data mesh (``sharded``) or
    on one device (``device`` None: the rank's card): each fit's trees,
    training outputs, seconds and the launches of K2, K3, the row order
    and the split search it made."""
    import time

    from transmogrifai_tpu_torch.models import hist as H
    from transmogrifai_tpu_torch.models import trees as TR
    from transmogrifai_tpu_torch.parallel import make_mesh

    from transmogrifai_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    mesh = make_mesh(device=dev) if sharded else None
    x, y, masks = card_data(rows, feats)
    counted = {"hist_binloop": H.build_histogram_binloop,
               "hist_wide": H.build_histogram_wide,
               "node_order": H.node_order, "split_search": H.split_search}
    out = {}
    yt = torch.from_numpy(y).to(dev)
    for bins, fits in ((32, ("forest", "boosted")), (256, ("boosted_256",))):
        thr = torch.from_numpy(TR.quantile_thresholds(x, max_bins=bins))
        binned = TR.bin_data(torch.from_numpy(x).to(dev), thr.to(dev))
        for name in fits:
            before = {k: fn.launches for k, fn in counted.items()}
            t0 = time.perf_counter()
            if name == "forest":
                trees, outs = TR.fit_forest_batched(
                    binned, yt, torch.from_numpy(masks).to(dev), num_trees=3,
                    max_depth=CARD_DEPTH, num_bins=bins,
                    subsample_rate=np.array([1.0, 0.8], np.float32), seed=5,
                    mesh=mesh, return_outputs=True)
            else:
                k = 2 if bins == 32 else 1
                trees, outs = TR.fit_boosted_batched(
                    binned, yt, torch.from_numpy(masks[:k]).to(dev),
                    num_rounds=3 if bins == 32 else 2, max_depth=CARD_DEPTH,
                    num_bins=bins, eta=0.3, mesh=mesh)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out[name] = {
                "split_feat": trees.split_feat.cpu().numpy(),
                "split_bin": trees.split_bin.cpu().numpy(),
                "leaf_value": trees.leaf_value.cpu().numpy(),
                "outputs": outs.cpu().numpy(),
                "seconds": time.perf_counter() - t0,
                "launches": {k: fn.launches - before[k]
                             for k, fn in counted.items()},
            }
    return out


def kernel_fault_on(rank: int) -> dict:
    """The forest case of ``tree_fits`` with a kernel fault injected into
    ``rank``'s split search: that rank raises, and the others' next
    collective fails with it (no rank carries on)."""
    from transmogrifai_tpu_torch.models import hist as H
    from transmogrifai_tpu_torch.models import trees as TR
    from transmogrifai_tpu_torch.parallel import make_mesh
    from transmogrifai_tpu_torch.parallel.mesh import world_rank
    from transmogrifai_tpu_torch.utils.cuda_build import KernelLaunchError

    if world_rank() == rank:
        def fault(*a, **kw):
            raise KernelLaunchError("injected split-search launch failure")

        H.split_search = fault
    return run_tree_case(TR, tree_case_args()["forest"],
                         make_mesh(device="cpu"))
