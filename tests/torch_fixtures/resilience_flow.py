"""The resilience, telemetry and streaming slice's scenarios, run the same
way through either package: the port's tests
(``tests/test_torch_resilience_flow.py``) run each one through the JAX
package and the port on the same seeded inputs and compare the results,
the fixture generator (``make_resilience_fixtures.py``) stores the JAX
package's results of the card's retrain loop, and ``chip_smoke.py``'s
``resilience`` phase runs the card's scenarios through the port alone.

``package(name, device)`` gathers one package's entry points into a
namespace (``"jax"`` or ``"port"``; the port's estimators and closures on
``device``). This module imports no package at import time, so
``chip_smoke.py`` loads it without JAX. Every scenario returns plain JSON
values.

* readers: ``events(...)`` seeded event records; ``reader_outputs(P)``
  the aggregate, conditional, joined, joined-aggregate and catalog
  readers' datasets over them; ``aggregator_results(P)`` every default
  aggregator's fold of seeded values; ``avro_round_trip(P, path)`` and
  ``parquet_round_trip(P, path)`` a typed table through each format.
* ``stream_case(P, ...)``: ``stream_ingest`` over seeded records in
  chunks, with faults scripted: the summary, the buffered rows and the
  reduced fit stats.
* ``tree_flow(P, ...)``: a binary flow (transmogrify, SanityChecker, an
  XGBoost selector) whose ``train`` the checkpoint scenarios crash and
  resume; ``fitted_arrays(model)``.
* ``recorded_train(P, run_dir)``: the LR flagship flow with a progress
  callback and a run directory: the RUN report and the pulses.
* ``retrain_loop(P, tmp, ...)``: a two-replica fleet over the serving
  fixture ``xgb`` under the virtual-time load test, its closure's drift
  sentinel polled by a ``RetrainController`` whose warm-start trainer
  fits a small XGBoost flow on the collected rows; ``shift_feature`` on
  two features forms the drift quorum and ``crash_retrain`` kills the
  first attempt after layer 0.
"""
from __future__ import annotations

import json
import os
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
SERVING = os.path.join(ROOT, "tests", "fixtures", "torch_serving")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_resilience")
RESULTS = os.path.join(FIXTURE, "jax_results.json")

#: a GLM lane of a resumed model against the uninterrupted one, and the
#: port's logistic scores against the JAX package's
GLM_ATOL = 1e-6


def package(name: str, device: str = "cpu"):
    """One package's entry points for this slice's scenarios."""
    ns = types.SimpleNamespace(name=name, device=device)
    if name == "jax":
        import transmogrifai_tpu as pkg
        from transmogrifai_tpu import types as T
        from transmogrifai_tpu.dataset import Dataset
        from transmogrifai_tpu.features import FeatureBuilder, aggregators
        from transmogrifai_tpu.features import from_dataset
        from transmogrifai_tpu.local import scoring
        from transmogrifai_tpu.models.gbdt import XGBoostClassifier
        from transmogrifai_tpu.models.logistic import LogisticRegression
        from transmogrifai_tpu.ops.transmogrify import transmogrify
        from transmogrifai_tpu.prep import SanityChecker
        from transmogrifai_tpu import readers, serving
        from transmogrifai_tpu.readers import parquet, streaming
        from transmogrifai_tpu.resilience import (
            checkpoint, faults, retrain, sentinel,
        )
        from transmogrifai_tpu.selector import model_selector
        from transmogrifai_tpu.telemetry import events, export, runlog, spans
        from transmogrifai_tpu.types import columns
        from transmogrifai_tpu.utils import avro, uid
        from transmogrifai_tpu.workflow import stream
        from transmogrifai_tpu.workflow.persistence import load_workflow_model
        from transmogrifai_tpu.workflow.workflow import Workflow

        ns.load = load_workflow_model
        ns.score = scoring.score_function
        ns.est = lambda cls, **kw: cls(**kw)
        ns.selector = lambda **kw: model_selector.BinaryClassificationModelSelector(**kw)
    else:
        import transmogrifai_tpu_torch as pkg
        from transmogrifai_tpu_torch import types as T
        from transmogrifai_tpu_torch.dataset import Dataset
        from transmogrifai_tpu_torch.features import (
            FeatureBuilder, aggregators,
        )
        from transmogrifai_tpu_torch.features import from_dataset
        from transmogrifai_tpu_torch.local import scoring
        from transmogrifai_tpu_torch.models.gbdt import XGBoostClassifier
        from transmogrifai_tpu_torch.models.logistic import LogisticRegression
        from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
        from transmogrifai_tpu_torch.prep import SanityChecker
        from transmogrifai_tpu_torch import readers, serving
        from transmogrifai_tpu_torch.readers import parquet, streaming
        from transmogrifai_tpu_torch.resilience import (
            checkpoint, faults, retrain, sentinel,
        )
        from transmogrifai_tpu_torch.selector import model_selector
        from transmogrifai_tpu_torch.telemetry import (
            events, export, runlog, spans,
        )
        from transmogrifai_tpu_torch.types import columns
        from transmogrifai_tpu_torch.utils import avro, uid
        from transmogrifai_tpu_torch.workflow import stream
        from transmogrifai_tpu_torch.workflow.persistence import (
            load_workflow_model,
        )
        from transmogrifai_tpu_torch.workflow.workflow import Workflow

        ns.load = lambda path: load_workflow_model(path, device=device)
        ns.score = lambda model, **kw: scoring.score_function(
            model, device=device, **kw)
        ns.est = lambda cls, **kw: cls(device=device, **kw)
        ns.selector = lambda **kw: (
            model_selector.BinaryClassificationModelSelector(
                device=device, **kw))
    ns.pkg, ns.T, ns.Dataset, ns.columns = pkg, T, Dataset, columns
    ns.FeatureBuilder, ns.aggregators = FeatureBuilder, aggregators
    ns.from_dataset, ns.transmogrify = from_dataset, transmogrify
    ns.SanityChecker, ns.XGBoostClassifier = SanityChecker, XGBoostClassifier
    ns.LogisticRegression = LogisticRegression
    ns.readers, ns.parquet, ns.streaming, ns.avro = (
        readers, parquet, streaming, avro)
    ns.checkpoint, ns.faults, ns.retrain, ns.sentinel = (
        checkpoint, faults, retrain, sentinel)
    ns.serving, ns.events, ns.export, ns.runlog, ns.spans = (
        serving, events, export, runlog, spans)
    ns.stream, ns.uid, ns.Workflow = stream, uid, Workflow
    return ns


def plain(v):
    """JSON-able copy: numpy scalars and arrays, tuples, sets and enums
    made plain, NaN kept as the string ``"nan"`` so results compare."""
    if isinstance(v, dict):
        return {str(k): plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    if isinstance(v, (set, frozenset)):
        return sorted(plain(x) for x in v)
    if isinstance(v, np.ndarray):
        return plain(v.tolist())
    if isinstance(v, np.generic):
        return plain(v.item())
    if isinstance(v, float) and v != v:
        return "nan"
    return v


def dataset_of(ds) -> dict:
    """A dataset's columns as plain lists (vectors as row lists)."""
    return {name: plain(ds[name].to_list() if hasattr(ds[name], "to_list")
                        else ds[name].values)
            for name in sorted(ds.columns)}


# ------------------------------------------------------------------ readers
def events(n_users: int = 30, n_events: int = 400, seed: int = 11) -> list:
    """Seeded event records: user, millisecond timestamp, an amount (20%
    missing), a tag, a flag, a tag set, a purchase marker and a label."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_events):
        amount = float(np.round(rng.normal(50.0, 20.0), 3))
        out.append({
            "user": f"u{int(rng.integers(0, n_users)):03d}",
            "ts": int(rng.integers(0, 1_000_000)),
            "amount": None if rng.random() < 0.2 else amount,
            "tag": ("red", "green", "blue", "")[int(rng.integers(0, 4))],
            "flag": bool(rng.random() < 0.3),
            "tags": sorted({f"t{int(k)}" for k in
                            rng.integers(0, 6, int(rng.integers(0, 3)))}),
            "purchase": bool(rng.random() < 0.15),
            "label": float(rng.random() < 0.4),
            "i": i,
        })
    return out


def _event_features(P):
    FB = P.FeatureBuilder
    amount = FB.Real("amount").extract(lambda r: r["amount"]).as_predictor()
    tag = FB.PickList("tag").extract(
        lambda r: r["tag"] or None).as_predictor()
    flag = FB.Binary("flag").extract(lambda r: r["flag"]).as_predictor()
    tags = FB.MultiPickList("tags").extract(
        lambda r: set(r["tags"])).as_predictor()
    label = FB.RealNN("label").extract(lambda r: r["label"]).as_response()
    return [amount, tag, flag, tags, label]


def reader_outputs(P) -> dict:
    """Every event reader's dataset over ``events()``."""
    R = P.readers
    recs = events()
    key = lambda r: r["user"]  # noqa: E731
    ts = lambda r: r["ts"]  # noqa: E731
    feats = _event_features(P)
    out = {}
    for name, cutoff, pw, rw in (
        ("aggregate_all", R.CutOffTime.no_cutoff(), None, None),
        ("aggregate_cutoff", R.CutOffTime.unix_epoch(500_000), None, None),
        ("aggregate_windows", R.CutOffTime.unix_epoch(500_000), 200_000,
         150_000),
    ):
        reader = R.DataReaders.Aggregate.records(recs, key, R.AggregateParams(
            timestamp_fn=ts, cutoff_time=cutoff, predictor_window_ms=pw,
            response_window_ms=rw))
        out[name] = dataset_of(reader.generate_dataset(feats))
    for keep in ("MIN", "MAX", "RANDOM"):
        for drop in (False, True):
            reader = R.DataReaders.Conditional.records(
                recs, key, R.ConditionalParams(
                    timestamp_fn=ts, target_condition=lambda r: r["purchase"],
                    timestamp_to_keep=getattr(R.TimeStampToKeep, keep),
                    drop_if_target_condition_not_met=drop, seed=3,
                    response_window_ms=300_000, predictor_window_ms=300_000,
                    now_ms=2_000_000))
            out[f"conditional_{keep.lower()}_{int(drop)}"] = dataset_of(
                reader.generate_dataset(feats))
    # joins: a profile table on the left, the aggregated events on the right
    profiles = [{"user": f"u{k:03d}", "age": float(20 + k)}
                for k in range(0, 40, 3)]
    FB = P.FeatureBuilder
    age = FB.Real("age").extract(lambda r: r["age"]).as_predictor()
    left = R.SimpleReader(profiles, key_fn=key)
    right = R.AggregateReader(recs, key_fn=key, aggregate_params=(
        R.AggregateParams(timestamp_fn=ts,
                          cutoff_time=R.CutOffTime.no_cutoff())))
    for jt in ("INNER", "LEFT_OUTER", "OUTER"):
        joined = R.JoinedReader(left, right, getattr(R.JoinType, jt),
                                left_features=[age],
                                right_features=feats[:2])
        out[f"joined_{jt.lower()}"] = dataset_of(
            joined.generate_dataset([age] + feats[:2]))
    # the joined aggregate: per-event rows on the right, filtered by time
    # against a per-user anchor on the left
    anchors = [{"user": f"u{k:03d}", "anchor": 400_000 + 1000 * k}
               for k in range(30)]
    anchor = FB.Date("anchor").extract(lambda r: r["anchor"]).as_predictor()
    evts = [dict(r, evt_ts=r["ts"]) for r in recs]
    evt_ts = FB.Date("evt_ts").extract(lambda r: r["evt_ts"]).as_predictor()
    amount2 = FB.Real("amount").extract(lambda r: r["amount"]).as_predictor()
    agg = R.JoinedReader(
        R.SimpleReader(anchors, key_fn=key), R.SimpleReader(evts, key_fn=key),
        R.JoinType.LEFT_OUTER, left_features=[anchor],
        right_features=[evt_ts, amount2],
    ).with_secondary_aggregation(R.TimeBasedFilter(
        condition=R.TimeColumn("anchor", keep=False),
        primary=R.TimeColumn("evt_ts", keep=False),
        time_window_ms=250_000))
    out["joined_aggregate"] = dataset_of(
        agg.generate_dataset([anchor, evt_ts, amount2]))
    return out


#: (feature type, values) folded by ``aggregator_of`` in both packages
def _aggregator_inputs(T) -> list:
    rng = np.random.default_rng(5)
    nums = [None if rng.random() < 0.2 else float(np.round(rng.normal(), 4))
            for _ in range(40)]
    texts = [None if rng.random() < 0.1 else
             ("a", "b", "c", "b")[int(rng.integers(0, 4))] for _ in range(40)]
    return [
        (T.Real, nums), (T.RealNN, [v or 0.0 for v in nums]),
        (T.Currency, nums), (T.Integral, [None if v is None else int(v * 10)
                                          for v in nums]),
        (T.Percent, [None if v is None else abs(v) / 3 for v in nums]),
        (T.Date, [None if v is None else int(abs(v) * 1e6) for v in nums]),
        (T.DateTime, [None if v is None else int(abs(v) * 1e7) for v in nums]),
        (T.Binary, [None if v is None else v > 0 for v in nums]),
        (T.PickList, texts), (T.Text, texts), (T.TextArea, texts),
        (T.MultiPickList, [set() if t is None else {t, "z"} for t in texts]),
        (T.TextList, [[] if t is None else [t] for t in texts]),
        (T.Geolocation, [[] if v is None else [10 * v, 20 * v, 1.0]
                         for v in nums]),
        (T.RealMap, [{} if v is None else {"k": v, t or "n": 1.0}
                     for v, t in zip(nums, texts)]),
        (T.TextMap, [{} if t is None else {"k": t} for t in texts]),
        (T.BinaryMap, [{} if v is None else {"k": v > 0} for v in nums]),
        (T.DateMap, [{} if v is None else {"k": int(abs(v) * 1e6)}
                     for v in nums]),
    ]


def aggregator_results(P) -> dict:
    """Each default aggregator's fold (``present(plus*(prepare(v)))``) of
    seeded values, in order and reversed."""
    out = {}
    for ftype, values in _aggregator_inputs(P.T):
        agg = P.aggregators.aggregator_of(ftype)
        out[ftype.__name__] = {
            "aggregator": type(agg).__name__,
            "folds": [plain(agg(values)), plain(agg(values[::-1]))]}
    return out


AVRO_SCHEMA = {
    "type": "record", "name": "Row", "fields": [
        {"name": "id", "type": "long"},
        {"name": "x", "type": ["null", "double"]},
        {"name": "city", "type": ["null", "string"]},
        {"name": "ok", "type": "boolean"},
        {"name": "tags", "type": {"type": "array", "items": "string"}},
        {"name": "scores", "type": {"type": "map", "values": "double"}},
    ],
}


def avro_rows(n: int = 60) -> list:
    rng = np.random.default_rng(17)
    return [{"id": i,
             "x": None if rng.random() < 0.2 else float(rng.normal()),
             "city": None if rng.random() < 0.1 else
             ("sf", "nyc", "ber")[int(rng.integers(0, 3))],
             "ok": bool(rng.random() < 0.5),
             "tags": [f"t{int(k)}" for k in rng.integers(0, 4, 2)],
             "scores": {"a": float(rng.random())}} for i in range(n)]


def avro_round_trip(P, path: str) -> dict:
    """``write_avro`` then the AvroReader's inferred dataset."""
    P.avro.write_avro(path, AVRO_SCHEMA, avro_rows())
    return {"records": plain(P.avro.read_avro(path)),
            "dataset": dataset_of(P.parquet.infer_avro_dataset(path))}


def parquet_round_trip(P, path: str) -> dict:
    """A typed dataset through ``write_parquet`` / ``read_parquet``."""
    T, C = P.T, P.columns
    rows = avro_rows()
    ds = P.Dataset.of({
        "x": C.column_from_values(T.Real, [r["x"] for r in rows]),
        "city": C.column_from_values(T.PickList, [r["city"] for r in rows]),
        "ok": C.column_from_values(T.Binary, [r["ok"] for r in rows]),
        "tags": C.column_from_values(T.TextList, [r["tags"] for r in rows]),
    })
    P.parquet.write_parquet(ds, path)
    back = P.parquet.read_parquet(path)
    return {"dataset": dataset_of(back),
            "types": {n: type(back[n]).__name__ + ":"
                      + back[n].feature_type.__name__ for n in back.columns}}


# ------------------------------------------------------------------- stream
def stream_records(n: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a, b = float(rng.normal()), float(rng.normal())
        out.append({"x1": a, "x2": None if rng.random() < 0.1 else b,
                    "city": ("sf", "nyc", "ber")[int(rng.integers(0, 3))],
                    "label": float(a + 0.5 * (b or 0.0) > 0)})
    return out


def stream_features(P):
    FB = P.FeatureBuilder
    return [FB.RealNN("label").extract(lambda r: r["label"]).as_response(),
            FB.Real("x1").extract(lambda r: r["x1"]).as_predictor(),
            FB.Real("x2").extract(lambda r: r["x2"]).as_predictor(),
            FB.PickList("city").extract(lambda r: r["city"]).as_predictor()]


def stream_case(P, n: int = 300, chunk: int = 40, cap: int | None = None,
                faults: tuple = (), crash_after: int | None = None,
                ckpt_dir: str | None = None, inflight: int = 2) -> dict:
    """``stream_ingest`` over ``n`` seeded records in chunks of ``chunk``;
    ``faults`` names FaultPlan calls (``("tear_stream_chunk", 2)``);
    with ``crash_after`` the ingest crashes after that chunk and resumes
    from the cursor in ``ckpt_dir``."""
    P.uid.reset()
    P.stream.STREAM_STATS.reset_for_tests()
    recs = stream_records(n)
    reader = P.streaming.StreamingReader(
        [recs[i:i + chunk] for i in range(0, n, chunk)])
    feats = stream_features(P)
    plan = P.faults.FaultPlan()
    for name, *args in faults:
        getattr(plan, name)(*args)
    ckpt = None if ckpt_dir is None else P.checkpoint.CheckpointManager(
        ckpt_dir)
    crashed = False
    with P.faults.installed(plan):
        if crash_after is not None:
            plan.crash_after_chunk(crash_after)
            try:
                P.stream.stream_ingest(reader, feats, checkpoint=ckpt,
                                       max_buffer_rows=cap, inflight=inflight)
            except P.faults.SimulatedCrash:
                crashed = True
        ds, summary = P.stream.stream_ingest(
            reader, feats, checkpoint=ckpt, resume=crash_after is not None,
            max_buffer_rows=cap, inflight=inflight)
    one_shot = P.stream.ChunkStatsReducer()
    full = P.readers.SimpleReader(recs).generate_dataset(feats)
    one_shot.fold_dataset(full)
    return plain({
        "crashed": crashed, "fired": plan.fired, "summary": summary,
        "rows": dataset_of(ds),
        "oneShotStats": one_shot.finalize(),
        "ledger": P.stream.STREAM_STATS.snapshot(),
    })


# -------------------------------------------------------------- checkpoints
def binary_ds(P, n: int = 200, seed: int = 0):
    rng = np.random.default_rng(seed)
    x1, x2, x3 = rng.normal(size=n), rng.normal(size=n), rng.normal(size=n)
    label = (x1 + 0.5 * x2 - 0.3 * x3 + 0.3 * rng.normal(size=n) > 0)
    C, T = P.columns, P.T
    return P.Dataset.of({
        "label": C.column_from_values(T.RealNN, label.astype(float)),
        "x1": C.column_from_values(T.Real, x1),
        "x2": C.column_from_values(T.Real, x2),
        "x3": C.column_from_values(T.Real, x3),
    })


#: the tree flow's XGBoost grid (two points) and the LR flow's
TREE_GRID = {"num_round": [8], "max_depth": [3], "eta": [0.3],
             "min_child_weight": [1.0, 5.0]}
LR_GRID = {"reg_param": [0.01, 0.1], "elastic_net_param": [0.1]}


def twin_ds(P):
    """The serving fixtures' twin (``make_serving_fixtures.twin_dataset``)
    drawn with the package's own testkit."""
    tk = P.pkg.testkit if hasattr(P.pkg, "testkit") else None
    if tk is None:
        import importlib

        tk = importlib.import_module(P.pkg.__name__ + ".testkit")
    ds = tk.random_dataset({
        "age": tk.RandomReal.normal(30, 14).with_probability_of_empty(0.2),
        "fare": tk.RandomReal.log_normal(3.0, 1.0).with_probability_of_empty(
            0.05),
        "ticket_score": tk.RandomReal.uniform(0, 1).with_probability_of_empty(
            0.1),
        "sibsp": tk.RandomIntegral.integrals(0, 6),
        "embarked": tk.RandomText.pick_lists(["S", "C", "Q"],
                                             [0.7, 0.2, 0.1]),
    }, n=891, seed=891)
    age = np.where(ds["age"].mask, ds["age"].values, 30.0)
    fare = np.where(ds["fare"].mask, ds["fare"].values, 0.0)
    emb_c = np.array([v == "C" for v in ds["embarked"].values], dtype=float)
    noise = np.random.default_rng(891).normal(0.0, 0.7, size=891)
    score = (0.04 * age - 0.3 * np.log1p(np.abs(fare)) + 0.5 * emb_c
             - 0.2 * ds["sibsp"].values.astype(float) + noise)
    return ds.with_column("label", P.columns.column_from_values(
        P.T.RealNN, (score < 0.2).astype(float)))


def tree_flow(P, ds, family: str = "xgb", workflow_cv: bool = False):
    """``(workflow, pred)``: transmogrify, SanityChecker, a selector over
    XGBoost (``family="xgb"``), logistic regression (``"lr"``) or both
    (``"both"``), 2 folds."""
    P.uid.reset()
    resp, preds = P.from_dataset(ds, response="label")
    vec = P.transmogrify(list(preds))
    checker = (P.SanityChecker(remove_bad_features=True)
               if P.name == "jax" else
               P.SanityChecker(remove_bad_features=True, device=P.device))
    checked = resp.transform_with(checker, vec)
    models = []
    if family in ("xgb", "both"):
        models.append((P.est(P.XGBoostClassifier), TREE_GRID))
    if family in ("lr", "both"):
        models.append((P.est(P.LogisticRegression), LR_GRID))
    pred = P.selector(seed=5, models=models, num_folds=2).set_input(
        resp, checked).get_output()
    wf = _one_device(P, P.Workflow().set_result_features(pred)
                     .set_input_dataset(ds))
    if workflow_cv:
        wf = wf.with_workflow_cv()
    return wf, pred


def _one_device(P, wf):
    """The JAX package trains on one device: a pytest run's virtual
    devices would shard its tree histograms and change the last ulp of its
    leaves (the port's trees are the single device's)."""
    return wf.set_parallelism(None) if P.name == "jax" else wf


def fitted_arrays(model) -> dict:
    """Every fitted array of a model, keyed by stage position and name
    (uids differ between runs)."""
    out = {}
    for i, stage in enumerate(model.fitted.values()):
        get = getattr(stage, "get_arrays", None)
        if get is not None:
            for k, v in get().items():
                out[f"{i}:{type(stage).__name__}:{k}"] = np.asarray(v)
    return out


def crash_resume(P, ckpt_dir: str, family: str = "xgb",
                 at: str = "before_selector", workflow_cv: bool = False,
                 ds=None, reference=None) -> dict:
    """Crash the flow after a layer, resume it from ``ckpt_dir``, and train
    it uninterrupted (unless ``reference`` is that model already): the
    fired faults, the layer directories, the candidate checkpoint hits, and
    both models. ``at="before_selector"`` crashes after the layer before
    the selector's; ``at="after_selector"`` after the selector's own layer,
    so the resume restores every stage; ``at="selector"`` there too, but
    the selector's layer checkpoint is then removed as a kill during its
    save would leave it (the atomic write never shows a partial one), so
    the resume restores the earlier layers and the selector consumes its
    candidate checkpoints."""
    ds = binary_ds(P) if ds is None else ds
    wf, pred = tree_flow(P, ds, family, workflow_cv)
    num_layers = _num_layers(P, pred)
    k = num_layers - (2 if at == "before_selector" else 1)
    plan = P.faults.FaultPlan().crash_after_layer(k)
    with P.faults.installed(plan):
        try:
            wf.train(checkpoint_dir=ckpt_dir)
            crashed = False
        except P.faults.SimulatedCrash:
            crashed = True
    layers = sorted(os.listdir(os.path.join(ckpt_dir, "layers")))
    if at == "selector":
        import shutil

        shutil.rmtree(os.path.join(ckpt_dir, "layers", f"layer-{k:03d}"))
    resumed = wf.train(checkpoint_dir=ckpt_dir, resume=True)
    wf2, pred2 = tree_flow(P, ds, family, workflow_cv)
    ref = wf2.train() if reference is None else reference
    attempts = resumed.fitted[pred.origin_stage.uid].summary.get(
        "candidateAttempts") or []
    return {"crashed": crashed, "fired": plain(plan.fired),
            "layers": layers, "numLayers": num_layers,
            "attempts": [{k: a[k] for k in ("modelName", "attempts",
                                              "excluded", "fromCheckpoint")}
                         for a in attempts],
            "hits": sum(bool(a["fromCheckpoint"]) for a in attempts),
            "resumed": resumed, "reference": ref, "ds": ds,
            "pred": pred, "pred2": pred2}


def _num_layers(P, pred) -> int:
    if P.name == "jax":
        from transmogrifai_tpu.workflow.dag import compute_dag
    else:
        from transmogrifai_tpu_torch.workflow.dag import compute_dag
    return len(compute_dag([pred]))


# -------------------------------------------------------------- run reports
def recorded_train(P, run_dir: str | None = None, family: str = "lr",
                   workflow_cv: bool = False):
    """The checkpoint flow trained with a progress callback and a run
    directory: ``(model, progress events)``."""
    ds = binary_ds(P, seed=3)
    wf, _ = tree_flow(P, ds, family, workflow_cv)
    pulses: list = []
    model = wf.train(progress=pulses.append, run_dir=run_dir)
    return model, pulses


def report_shape(report: dict) -> dict:
    """The key sets of a RUN report: the envelope, the ``run`` payload,
    each phase, layer, fold and candidate record, and the memory block."""
    run = report["run"]
    return {
        "envelope": sorted(report),
        "run": sorted(run),
        "phases": sorted(run["phases"]),
        "phase": sorted({k for c in run["phases"].values() for k in c}),
        "layer": sorted({k for c in run["layers"] for k in c}),
        "fold": sorted({k for c in run["folds"] for k in c}),
        "candidate": sorted({k for c in run["candidates"] for k in c}),
        "deviceMemory": sorted(run["deviceMemory"]),
        "metrics": sorted(report["metrics"]),
        "layers": len(run["layers"]),
        "folds": len(run["folds"]),
        "candidates": [c["model"] for c in run["candidates"]],
    }


def pulse_order(pulses: list) -> list:
    """The progress pulses' order: (event, phase | layer index | fold)."""
    return [[p["event"], p.get("phase", p.get("index", p.get("fold")))]
            for p in pulses]


# ------------------------------------------------------------- retrain loop
#: the retrain loop: a virtual-time fleet at ``rate`` requests/s; the
#: canary compares ``min_canary_served`` requests and tolerates a drop of
#: ``quality_drop`` in its agreement with the stale model (the refreshed
#: model, fitted on 192 collected rows, agrees with it on about 82% of the
#: fixture's rows)
RETRAIN = {"rate": 400.0, "duration": 2.0, "seed": 9, "service_time": 0.002,
           "replicas": 2, "collect_rows": 192, "chunk_rows": 64,
           "min_canary_served": 64, "quality_drop": 0.3,
           "shift": {"age": 60.0, "fare": 400.0}}


def fixture_rows(name: str = "xgb") -> list:
    with open(os.path.join(SERVING, name, "rows.json")) as fh:
        return json.load(fh)


def retrain_build(P):
    """The warm-start trainer's workflow over the collected rows: the
    serving twin's predictors and label, an XGBoost selector (10 rounds,
    depth 4), 2 folds."""
    T, C, FB = P.T, P.columns, P.FeatureBuilder

    def build(chunks, ctx):
        rows = [r for c in chunks for r in c]
        P.uid.reset()
        ds = P.Dataset.of({
            "label": C.column_from_values(
                T.RealNN, [float(r["label"]) for r in rows]),
            "age": C.column_from_values(T.Real, [r["age"] for r in rows]),
            "fare": C.column_from_values(T.Real, [r["fare"] for r in rows]),
            "ticket_score": C.column_from_values(
                T.Real, [r["ticket_score"] for r in rows]),
            "sibsp": C.column_from_values(
                T.Integral, [r["sibsp"] for r in rows]),
            "embarked": C.column_from_values(
                T.PickList, [r["embarked"] for r in rows]),
        })
        resp, preds = P.from_dataset(ds, response="label")
        vec = P.transmogrify(list(preds))
        sel = P.selector(seed=7, num_folds=2, models=[(
            P.est(P.XGBoostClassifier),
            {"num_round": [10], "max_depth": [4], "eta": [0.3]})])
        pred = sel.set_input(resp, vec).get_output()
        return _one_device(P, P.Workflow().set_result_features(pred)
                           .set_input_dataset(ds))

    del FB
    return build


def retrain_loop(P, ckpt_dir: str, trainer=None, kernel_fault=None,
                 on_canary=None) -> dict:
    """The fleet's retrain loop (``RETRAIN``): returns the controller's
    state sequence, its history and ledger, the events it emitted, the
    load test's report and the registry's decision. ``trainer`` replaces
    the warm-start trainer; ``on_canary(fleet)`` runs once when the
    canary starts (the card counts K1's launches from there)."""
    c = RETRAIN
    P.events.reset_for_tests()
    model = P.load(os.path.join(SERVING, "xgb"))
    drift = P.sentinel.DriftConfig(window=64, chunks=4, min_rows=32,
                                   js_threshold=0.35)
    fn = P.score(model, drift=drift)
    plan = P.faults.FaultPlan()
    for feature, offset in c["shift"].items():
        plan.shift_feature(feature, offset=offset, times=10 ** 9)
    plan.crash_retrain(after_layer=0)
    trainer = trainer or P.retrain.warm_start_workflow_trainer(
        retrain_build(P), checkpoint_dir=ckpt_dir,
        score_fn_of=lambda m: P.score(m))
    holder: dict = {"states": [], "canary_at": None}

    def on_fleet(fleet):
        reg = P.serving.ModelRegistry(fleet)
        ctl = P.retrain.RetrainController(
            fleet, reg, trainer, drift_source=fn.drift,
            config=P.retrain.RetrainConfig(
                quorum=2, collect_rows=c["collect_rows"],
                chunk_rows=c["chunk_rows"],
                min_canary_served=c["min_canary_served"],
                max_retrains=1, drift_check_every=0.05,
                tolerances=P.runlog.RunTolerances(
                    quality_drop=c["quality_drop"])))
        holder.update(ctl=ctl, reg=reg)

        def tick(t):
            state = ctl.tick(t)
            if not holder["states"] or holder["states"][-1] != state:
                holder["states"].append(state)
                if state == "canarying" and on_canary is not None:
                    on_canary(fleet)
        return tick

    with P.faults.installed(plan):
        try:
            report = P.serving.run_fleet_loadtest(
                fn, fixture_rows(), rate=c["rate"], duration=c["duration"],
                replicas=c["replicas"], seed=c["seed"],
                service_time=lambda n: c["service_time"], plan=plan,
                on_fleet=on_fleet)
        finally:
            if "ctl" in holder:
                holder["ctl"].close()
    ctl = holder["ctl"]
    kinds = [e["kind"] for e in P.events.recent(500)
             if e["kind"].startswith(("retrain_", "drift_"))]
    history = [{k: v for k, v in h.items() if k not in ("at", "detail")}
               for h in ctl.history]
    ledger = ctl.ledger()
    return plain({
        "states": holder["states"], "history": history,
        "ledger": {k: v for k, v in ledger.items()
                   if k != "deviceMemoryHighWater"},
        "deviceMemoryHighWater": ledger["deviceMemoryHighWater"],
        "events": kinds, "fired": sorted(set(f[0] for f in plan.fired)),
        "dropped": report["dropped"], "reconciled": report["reconciled"],
        "serving": holder["reg"].serving,
    })
