#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Run from the repository root. It builds the port's CUDA kernels from
``transmogrifai_tpu_torch/csrc/`` into ``transmogrifai_tpu_torch/_build/``
(one ``nvcc`` per source, all started together), checks each kernel
against its plain PyTorch version on the card, then drives the port's two
paths:

* serving: the committed fixture models
  (``tests/fixtures/torch_serving/{xgb,rf,lr}``, trained and saved by the
  JAX package) are loaded with ``load_workflow_model`` and answer requests
  through ``score_function`` on ``cuda``; their scores are held to the ones
  the JAX package stored (the tree models' equal, the logistic model's
  within 1e-6). Kernel K1 (the traversal) walks the stacks the
  models packed once; it is checked bit for bit, per call and over packed
  stacks, at synthetic shapes ((a)-(f): a depth-15 stack, a width only the
  two-word layout holds, codes past 16 bits among them) and at the main
  path's own trees, the packing is timed on its own, and the predictor's
  device span is broken down by kernel group;
* training: ``XGBoostClassifier`` and ``RandomForestClassifier`` fit the
  default selector's grids over 3 fold masks of a seeded 16384 x 928 table
  at the flagship vector's width (``fit_arrays_batched_masks``), every
  histogram through kernel K2; the fitted lanes score through
  ``predict_arrays`` (kernel K1) and agree with the fit's own outputs, a
  second XGBoost fit is bit-identical, and the training fixture the JAX
  package stored (``tests/fixtures/torch_training``) is reproduced. K2's
  launches of one XGBoost round and of the first tree of each forest depth
  group are captured during that run, then each is relaunched, held
  against the plain version and timed; their mean, weighted by how often
  each tree recurs on the path, is K2's entry in the kernels line. K1's
  launches while the lanes are scored are captured the same way, one per
  (family, depth, trees) group, weighted by the group's launches;
* regression training: ``GBTRegressor`` and ``RandomForestRegressor`` fit
  the regression selector's grids on the same table's continuous target
  with a 256-bin sketch: the continuous columns' histograms through kernel
  K3 and the indicators' through K2. The lanes score through K1, a second
  GBT fit is bit-identical, the fixture's 256-bin regression fits are
  reproduced, and K3's launches of the middle GBT round and the first
  forest tree of each depth group are captured, relaunched and timed as
  K2's are;
* small fits: 3000-row XGBoost and RF fits take K2 on the card and equal
  the same fits on the CPU bit for bit; their histograms are timed through
  K2 and through the one-hot GEMM pair over the same launches;
* the tree sum: every tree model's [N, T] leaf values are reduced per row
  in tree order by the ``tree_sum`` kernel (``csrc/tree_sum.cu``), the
  JAX package's serving arithmetic, so the xgb and rf fixtures' scores
  equal the stored ones. The kernel is held bit for bit against its plain
  version at synthetic shapes and at the calls captured on the serving and
  both training paths, and timed there beside one ``torch.sum(dim=1)`` in
  interleaved pairs of readings (16 at (a), (b) and serving's calls, with
  the SM clock sampled by ``nvidia-smi`` beside each reading; a sign test
  over the pairs gives the verdict, phase ``tree_sum against torch.sum``);
* serving above 16384 rows: the xgb and rf fixtures' models and depth-10
  twins score a 20000-row batch through ``predict_arrays``, which walks
  each stack twice (leaf values, leaf windows) and reduces in the JAX
  package's device-route order (the tree sum's second mode,
  ``tree_sum_device_route``); every output must equal the same call on the
  CPU bit for bit. The mode is held against its plain version at
  synthetic shapes and at the calls captured there, and timed;
* GLM serving and training: the ``lr`` fixture (a JAX-saved flagship twin
  whose selector picked ``LogisticRegression``) is served on the card
  within 1e-6 of its stored scores; ``LogisticRegression`` and
  ``LinearRegression`` sweep the selectors' default 8-point grid over the
  training table's 3 fold masks (24 lanes run as 32) on the card, with one
  host sync per sweep (counted by CUDA's sync debug mode), a bit-identical
  second sweep, every lane scored through ``predict_arrays`` on the card,
  and the training fixture's JAX-fitted lanes reproduced within the
  tests' tolerances.

* the fit side of the flagship flow (``fit_side`` phases): the 891-row
  typed twin and its CSV twin (``tests/fixtures/torch_fit_side``, written
  with the JAX package's results by
  ``tests/torch_fixtures/make_fit_side_fixtures.py``) go through
  ``infer_csv_dataset`` / ``from_dataset``, ``transmogrify`` and
  ``sanity_check`` in ``fit_and_transform_dag`` with the SanityChecker's
  statistics on the card: vectors and metadata equal the JAX package's,
  keep-sets and drop reasons too, statistics within the CPU tests'
  tolerances; a JAX-saved model with a ``SmartTextModel`` stage scores its
  rows on the card equal to the JAX package's scores. A 16384-row table of
  1423 vector columns (``tests/torch_fixtures/fit_side_tables.py``, the
  statistics' float32 route) gives host seconds per step and the stats'
  device time, and its vector and keep-set on the card equal the CPU's and
  its keep-set the JAX package's. The twin's checked vector then trains
  ``XGBoostClassifier.fit_arrays`` at the xgb fixture's point and is
  scored: trees and scores equal the CPU's, with K2, the row order, K1 and
  the tree sum counted in that run.

* the split search: every histogram's best split per slot is one launch of
  the split-search kernel (``csrc/split_search.cu``, K4's split stage over
  the histogram K2 or K3 wrote), held bit for bit against its plain
  version at synthetic shapes (2 to 4500 bins, half the slots empty) and
  at the calls captured on both training paths' chosen trees
  (``SplitCapture``), one launch a call, and timed against its bound; the
  training windows report its device time as a group of its own;
* the leaf sums: past the reference's one-hot budget (the depth-12 groups
  at 16384 rows: 18 lanes x 4096 slots) a grown tree's leaf sums are the
  leaf-sum kernel (``csrc/leaf_sum.cu``) over the row order, held bit for
  bit against the CPU's plain version at the spread and crowded shapes and
  at the first call of each training path (``LeafCapture``); the training
  fixture's leaves and outputs are held to EQUALITY with the JAX
  package's, and the GBT regressor's depth-12 group at 256 bins to the
  same fit on the CPU.

* ``train()``, the whole five-line flow (``train_*`` phases):
  ``from_dataset`` -> ``transmogrify`` -> ``sanity_check`` ->
  ``BinaryClassificationModelSelector()`` (its default candidates and
  grids: logistic regression 8 points, random forest 18, XGBoost 2; 3-fold
  CV and the refit lane, the families on a thread pool) ->
  ``Workflow().train()`` on the card. ``train_flagship`` runs it on the
  891-row typed twin, once as it is, once with ``with_workflow_cv()`` and
  once with only the tree candidates (``train_flagship trees``, whose
  winner is a tree family), and holds each to the selector fixture the JAX
  package made at the same grids (``tests/fixtures/torch_selector``,
  written by ``tests/torch_fixtures/make_selector_fixtures.py``): tree
  candidates EQUAL, logistic ones within ``CARD_LR_METRIC_TOL``, the
  winner and grid equal, a tree winner's metrics and holdout scores EQUAL
  (a logistic one's within the stated tolerances); a save and load round
  trip and ``score_function``'s ``fn.batch`` equal ``model.score``.
  ``train_wide`` runs the flow on ``fit_side_tables.wide_table()`` (16384
  rows, 1423 vector columns) with the default candidates, and on
  ``wide_hash_table()`` (16384 rows, 1419 vector columns) with the tree
  candidates only (``train_wide trees``, the model ``fused_serving``
  scores fused): ``train()``'s seconds split
  by part and family, the card's busy share over the train, the kernels'
  launches, and the winner's refit lane against a direct refit on the same
  mask (a tree winner's trees EQUAL; a logistic winner's weights within
  ``LR_LANE_TOL``, which a neighbouring grid point's fit and a fold's must
  exceed). A tree winner's holdout must run through K1 and the tree sum.
  Any excluded family or NaN lane fails the phase.

* the fused scoring graph (``fused_serving``, ``compiler/fused.py``): the
  xgb, rf and lr fixtures' rows tiled to 20000 rows (bucket 24576, padded)
  and 65536 rows, above the default ``TPTPU_HOST_PREDICT_MAX``, through
  ``.batch`` and ``.columns``: the fused scores EQUAL the staged loop's on
  the card (the logistic model's within 1e-6) and the port's fused path on
  the CPU; every batch a dispatch, no fallback. The default selector's tree
  candidates trained on ``fit_side_tables.wide_hash_table()`` (16384 rows,
  1419 vector columns, a hash-only SmartText member) score 65536 fresh rows
  through ``.columns``: fused EQUAL staged, ``quantized=True`` EQUAL the
  float32 plane. A fused batch after the first makes exactly one upload and
  one download (``torch.profiler``'s memcpy activities) and one host sync
  (``count_syncs``), and launches K1 twice and the device-route sum once a
  stack (``FusedLaunches`` counts them apart from the staged batches);
  its device span is broken down by group (members, gathers, ``bin_data``,
  K1, the sum). ``train_wide``'s model and the CSV twin's (SmartText
  members of Pivot and Hash slots) build no program, with the JAX
  package's reason, and score staged. Rows/s of both paths at both sizes.
  The twins' tree models and ``text_xgb`` above the cutoff EQUAL the JAX
  package's scores (``tests/fixtures/torch_fused/jax_scores.npz``);
* every feature type (``train_all_types``): the 22 type groups of
  ``transmogrify``'s default dispatch (``tests/torch_fixtures/
  all_types.py``, 16384 rows) through ``sanity_check`` on the card, the
  default tree candidates at the CPU tests' small grids and ``train()``,
  then 20000 fresh rows scored
  above the cutoff (staged: the fused planner refuses the plan); the
  vector, keep-set, selector summary (at the CPU tests' small grids) and
  scores EQUAL the port's CPU runs; ``train()``'s seconds, the card's
  busy share and every kernel's launches;
* the DSL's stages and the raw feature filter (``train_dsl``, last):
  ``tests/torch_fixtures/dsl_flow.py``'s F1 (16384 rows of the full-width
  table with a sparse, a leaking and a drifting column and a numeric map;
  arithmetic, scalers, log / sqrt, fixed and decision-tree bucketizers and
  a percentile calibrator; the default tree candidates at the small
  grids;
  ``with_raw_feature_filter`` against 16384 drifted scoring rows) through
  ``train()`` on the card, then 20000 fresh rows (staged: the planner
  refuses the bucketizer members). The filter's results and blocklist
  EQUAL the same filter on the CPU, the vector and keep-set the CPU's
  feature side, the scores the saved model's on the CPU; the small-grid
  flow on the card EQUALS the JAX package's fixture
  (``tests/fixtures/torch_dsl``) at 4096 rows and the port's CPU run at
  ``DSL_CPU_ROWS``. F2 (the arithmetic, scaler and log stages over
  ``wide_hash_table``) fuses with those stages as its host prefix: 65536
  fresh rows fused EQUAL staged, one upload, one download, one sync.
* the featurize plane (``featurize_plane``, before the hardened
  closure): every phase above runs on it, as it is the default route (native host kernels from
  ``native/tptpu_native.cpp``, built by ``transmogrifai_tpu_torch/
  native.py`` into ``_build/`` with ``g++`` beside the CUDA builds; the
  chunked pool; COO hash planes from 4096 rows; fused block assembly in
  the scoring closure). The phase prints the library's build and ABI, the
  sha256 of ``native/libtptpu.so`` (the JAX package's build, never touched)
  at the start and the end of the run, and ``nproc``; then ``transmogrify``
  fit and transform over ``wide_hash_table(65536)`` on the plane and on
  the plain routes (``TPTPU_DISABLE_NATIVE``, one thread): EQUAL vectors
  (the sparse plane densified), metadata and keep-sets (the SanityChecker
  on the card), with the host seconds and ``featurizeStats`` of each; the
  model ``fused_serving`` trained on that table scoring 8192-row batches
  staged (after the first, each batch assembles into one buffer: EQUAL
  the plane-off closure's scores) and 65536 rows fused, the fusion
  planner's widths cross-checked, EQUAL staged, one upload, one download,
  one sync.
* the hardened scoring closure (``serving_hardening``, last): the three
  serving fixtures (their training profiles loaded) at 8192 rows staged
  and 65536 fused, held to ``tests/fixtures/torch_hardening/
  jax_results.json`` (the JAX closure's results, ``tests/torch_fixtures/
  make_hardening_fixtures.py``; the scenarios are ``tests/torch_fixtures/
  hardening.py``): (a) the default closure EQUAL the all-off one and the
  JAX package's scores, clean counters, the same launches, one upload /
  download / sync a fused batch; (b) four malformed rows quarantined
  exactly; (c) a covered stage's breaker opened by a fault plan routes a
  65536-row batch staged and defaulted, its probe closes it, the next
  batch fuses; (d) a shifted feature alerts alone, the report EQUAL; (e) a
  ``KernelLaunchError`` injected into K1's launch propagates out of
  ``.batch`` and ``.columns`` with no quarantine, breaker failure or
  fallback; (f) host rows/s default against all-off and seconds per
  family.

Kernel K4, the fused split search, is on no path of the reference (its
policy never takes it); it is held against its plain version at the
reference's fused-route shapes, timed whole (its row order and its
kernel), and beside the two-phase route on the same inputs (the row order,
K2 or K3, then the split-search kernel). The device-route tree sum is timed beside one
``torch.sum(dim=1)`` in 16 interleaved pairs at (a), (b) and serving's
calls, and in 2 at (g)-(j), the reduced orders of ``ROADMAP.md`` C4 (lanes
of 8 and 4, ``fold_w``), which (g)-(l) hold to the plain version.

Every phase that fails raises, and the script exits non-zero with no result
line; it never falls back to the CPU.

The line before the last is ``{"kernels": [...]}`` with each kernel's
launches on its path, its error against the plain version, and its time,
the plain version's time, the card's lower bound and a library call's time
where one exists. The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_serving")
TRAIN_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_training")
DEV = "cuda"
#: H100 SXM memory rate (NVIDIA data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM non-tensor fp32 / int32 rate, operations per second
SCALAR_OPS_PER_S = 67e12
#: H100 SXM L2 cache, bytes
L2_BYTES = 50 * 2**20
#: score tolerance against the JAX package's stored scores, per serving
#: fixture: the tree models are summed in the reference's own order (the
#: tree_sum kernel), so their scores are equal; the logistic model's core
#: is float64 x @ w + b in another summation order (tests/test_torch_glm.py)
PROB_ATOL = {"xgb": 0.0, "rf": 0.0, "lr": 1e-6}
BUCKET_ROWS = 8192  # the reference's scoring bucket cap
#: unit roundoff of float32: a sequential f32 sum of n terms is within
#: n * U32 * sum|term| of the exact sum
U32 = 2.0 ** -24

#: kernel K2 shapes: (N, F, B, K, M). (a) the flagship vector's indicator
#: group, (b) its continuous group, both with the XGBoost grid's 6 lanes;
#: (c) ragged, with dead rows and slots >= M; (d) the reference kernel's
#: own tuning shape (hist_pallas.py:390-393); (e) the continuous group's
#: root level (the 256-slot chunk, every live row in slot 0)
K2_SHAPES = {
    "a_narrow": (16384, 918, 2, 6, 64),
    "b_wide": (16384, 10, 32, 6, 64),
    "c_ragged": (4099, 7, 5, 2, 3),
    "d_tuning": (1 << 20, 500, 32, 1, 64),
    "e_root": (16384, 10, 32, 6, 256),
}
#: kernel K3 shapes: (N, F, B, K, M). (a) the GBT grid's root level over
#: the 10 continuous columns at 256 bins (18 lanes, the 256-slot chunk,
#: every live row in slot 0); (b) a deep level, slots spread; (c) ragged,
#: with dead rows and slots >= M; (d) a large single fit
K3_SHAPES = {
    "a_gbt_root": (16384, 10, 256, 18, 256),
    "b_deep": (16384, 10, 256, 18, 256),
    "c_ragged": (4099, 3, 300, 2, 3),
    "d_large": (1 << 20, 64, 256, 1, 64),
}
#: row-order kernel shapes: (N, K, M, slots drawn). (a) a root level of
#: the XGBoost grid (every live row in one slot); (b) the RF grid's
#: 256-slot chunk; (c) ragged, with slots >= M; (d) a large single fit;
#: (e) more slots than the grower's chunks hold
ORDER_SHAPES = {
    "a_root": (16384, 6, 256, 1),
    "b_chunk": (16384, 18, 256, 256),
    "c_ragged": (4099, 2, 3, 5),
    "d_tiled": (1 << 20, 1, 64, 64),
    "e_many_slots": (5000, 2, 3000, 2900),
}
#: kernel K4 shapes: (N, F, B, K, M), the reference's fused route (N <=
#: 2048, B <= 128) at the flagship width: (a) the indicator group, (b) the
#: continuous group at 32 bins, (c) the reference test's ragged shape
#: (tests/test_hist_pallas.py:72-122), (d) 128 bins
K4_SHAPES = {
    "a_narrow": (2048, 918, 2, 6, 128),
    "b_wide": (2048, 10, 32, 6, 128),
    "c_ragged": (200, 11, 8, 3, 4),
    "d_128_bins": (2048, 64, 128, 2, 128),
}
#: the training table: 16384 rows (above the 4096 where the reference
#: leaves the GEMM histogram) at the flagship vector's width, 10 continuous
#: columns (3 with ~20% NaN) and 918 indicator columns (~5% ones)
TRAIN_ROWS, TRAIN_CONT, TRAIN_BIN = 16384, 10, 918
#: the default selector's grids (selector/model_selector.py:55-64,
#: :166-191), over 3 fold masks
XGB_GRID = [
    {"num_round": 200, "eta": 0.02, "gamma": 0.8, "max_depth": 10,
     "min_child_weight": w, "max_bins": 32} for w in (1.0, 10.0)
]
RF_GRID = [
    {"max_depth": d, "min_info_gain": gain, "min_instances_per_node": mi,
     "num_trees": 50, "max_bins": 32}
    for d in (3, 6, 12) for gain in (0.001, 0.01, 0.1) for mi in (10, 100)
]
#: the regression selector's tree grids (model_selector.py:166-181,
#: :493-515) with a 256-bin sketch: 18 points each, 3 depth groups of 6
#: points over 3 fold masks
REG_BINS = 256
GBT_GRID = [
    {"max_depth": d, "min_info_gain": gain, "min_instances_per_node": mi,
     "max_iter": 20, "max_bins": REG_BINS}
    for d in (3, 6, 12) for gain in (0.001, 0.01, 0.1) for mi in (10, 100)
]
RFR_GRID = [dict(p, max_bins=REG_BINS) for p in RF_GRID]
#: fits at or below the reference's GEMM row count (4096): the training
#: table's first rows, 32 bins, 3 fold masks, one small grid point each
SMALL_ROWS = 3000
SMALL_FITS = {
    "xgb": ("XGBoostClassifier", {"num_round": 10, "eta": 0.3, "gamma": 0.0,
                                  "max_depth": 6, "min_child_weight": 1.0,
                                  "max_bins": 32}),
    "rf": ("RandomForestClassifier", {"num_trees": 10, "max_depth": 6,
                                      "min_info_gain": 0.001,
                                      "min_instances_per_node": 10,
                                      "max_bins": 32}),
}


#: the script's start, for the seconds each phase line carries as ``t``
T0 = time.perf_counter()


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields,
                      "t": round(time.perf_counter() - T0, 3)}), flush=True)


def time_ms(torch, fn, arg_sets, reps: int = 20, rounds: int = 7) -> float:
    """Median per-call device time over ``rounds`` groups of ``reps``
    calls, with CUDA events, after one warm-up call. Successive calls take
    successive entries of ``arg_sets``, so with enough copies of the inputs
    each call finds them out of L2."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    times, i = [], 0
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
            i += 1
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


#: profiler sessions ``device_ms`` tries before it turns to CUDA events
PROFILE_TRIES = 2
#: readings in a row taken with CUDA events after which ``device_ms`` tries
#: one profiler session, not ``PROFILE_TRIES``, until a session succeeds
#: (a card whose profiler drops its sessions would otherwise spend minutes
#: of the run retaking them)
PROFILE_STREAK = 4
#: readings of the run taken with CUDA events after which every later
#: reading takes CUDA events without a session: a profiler that drops
#: sessions now and then over the whole run never makes a streak (on an H100 80GB HBM3 at 700 W
#: whose profiler did so: 249 fallbacks and 764 sessions retaken, a wall
#: of 1057 s, against 568 s where the profiler kept its sessions)
PROFILE_BUDGET = 8


def device_ms(torch, fn, arg_sets, calls: int = 12) -> float:
    """Device time per call of ``fn`` from ``torch.profiler``, successive
    calls taking successive entries of ``arg_sets``, after one warm-up
    call: for each kernel (or copy) the calls launch, its mean device time
    times the launches it makes per call, summed. Unlike ``time_ms`` it
    leaves out the gaps in which the card waits for the host to issue the
    next kernel.

    On the card a session sometimes misses a few of its activities, or all
    of them. The mean per kernel is unmoved by a missed launch, where a sum
    over the session would fall short; launches per call are rounded from
    the count, so a kernel seen fewer than 3/4 of the expected times (or a
    session that saw none) makes the session be taken again, after a
    growing pause. After ``PROFILE_TRIES`` such sessions (one, after
    ``PROFILE_STREAK`` such readings in a row; none, after
    ``PROFILE_BUDGET`` in the run) the reading is taken with
    CUDA events (``time_ms``, which holds any host gaps) and reported in a
    ``device_ms fallback`` phase of its own: a dropped capture is never
    returned as a reading."""
    from torch.profiler import ProfilerActivity, profile

    fn(*arg_sets[0])
    torch.cuda.synchronize()
    tries = (0 if device_ms.event_fallbacks >= PROFILE_BUDGET
             else 1 if device_ms.fallback_streak >= PROFILE_STREAK
             else PROFILE_TRIES)
    for attempt in range(tries):
        time.sleep(0.25 * attempt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                fn(*arg_sets[i % len(arg_sets)])
            torch.cuda.synchronize()
        per_call, seen, expected = 0.0, 0, 0
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA or not evt.count:
                continue
            launches = max(1, round(evt.count / calls))
            per_call += evt.self_device_time_total / evt.count * launches
            seen += evt.count
            expected += launches * calls
        device_ms.missed_activities += expected - seen
        if per_call > 0 and 4 * seen >= 3 * expected:
            device_ms.last_source = "profiler"
            device_ms.fallback_streak = 0
            return per_call / 1e3
        device_ms.empty_sessions += 1
    ms = time_ms(torch, fn, arg_sets, reps=calls, rounds=3)
    device_ms.event_fallbacks += 1
    device_ms.fallback_streak += 1
    device_ms.last_source = "cuda_events"
    phase("device_ms fallback", fn=getattr(fn, "__name__", str(fn)),
          empty_sessions=tries, event_ms=ms)
    return ms


#: activities the sessions of ``device_ms`` missed (of the launches their
#: calls made), sessions it took again, and readings it took with CUDA
#: events after ``PROFILE_TRIES`` of them
device_ms.missed_activities = 0
device_ms.empty_sessions = 0
device_ms.event_fallbacks = 0
device_ms.fallback_streak = 0
#: where the last reading came from: "profiler" or "cuda_events"
device_ms.last_source = None


def sourced_ms(torch, fn, arg_sets, **kw) -> tuple[float, str]:
    """``device_ms`` and where the reading came from."""
    ms = device_ms(torch, fn, arg_sets, **kw)
    return ms, device_ms.last_source


def source_counts(rows, key: str = "device_ms_source") -> dict:
    """How many of ``rows``' readings came from the profiler and how many
    from the CUDA-event fallback."""
    out = {"profiler": 0, "cuda_events": 0}
    for r in rows:
        out[r[key]] += 1
    return out


def same_layout_clone(a):
    """A copy of ``a`` with its strides: a view of the first columns of a
    wider row-major array (the grower's padded codes, ``hist.pad_codes``)
    is copied into an array as wide, so the kernels read it as they read the
    grower's."""
    if a.dim() == 2 and a.stride(1) == 1 and a.stride(0) > a.shape[1]:
        wide = a.new_zeros((a.shape[0], a.stride(0)))
        wide[:, :a.shape[1]] = a
        return wide[:, :a.shape[1]]
    return a.clone()


def l2_cold_copies(args, touched_bytes: int) -> list:
    """``args`` and enough clones of it that one pass over them touches at
    least four times the L2, so that a timed call reads from HBM."""
    k = min(64, max(2, -(-4 * L2_BYTES // max(touched_bytes, 1))))
    return [args] + [[same_layout_clone(a) for a in args] for _ in range(k - 1)]


def random_stack(rng, t, depth, f, bins):
    """Random [T, depth, 2^depth] split arrays (-1 anywhere) and leaves."""
    w = 1 << depth
    return (
        rng.integers(-1, f, size=(t, depth, w)).astype(np.int32),
        rng.integers(0, bins, size=(t, depth, w)).astype(np.int32),
        rng.normal(size=(t, w)).astype(np.float32),
    )


#: K1 shapes: (N, F, T, depth, bins). (a) the default XGBoost point at
#: the flagship vector's width and the scoring bucket cap; (b) the RF grid's
#: deepest point; (c) ragged, with leaf-only trees; (d) trees deeper than
#: shared memory holds (levels 10-14 read from global memory); (e) a width
#: only the wide (two-word) layout holds (feature 65536 needs 17 bits);
#: (f) split bins at the packed word's limit and codes past 16 bits, which
#: the models' path also walks as two-word nodes. (a), (b) and the main
#: path are timed
K1_SHAPES = {
    "a_xgb_flagship": (BUCKET_ROWS, 928, 200, 10, 32),
    "b_rf": (BUCKET_ROWS, 928, 50, 12, 32),
    "c_ragged": (133, 7, 5, 3, 8),
    "d_deep": (2000, 50, 5, 15, 32),
    "e_wide_features": (256, 65537, 12, 8, 32),
    "f_codes_past_16_bits": (1024, 40, 16, 8, 1 << 16),
}
K1_TIMED = ("a_xgb_flagship", "b_rf", "main_path")


def k1_inputs() -> dict:
    """{label: (binned, split_feat, split_bin, leaf_value, timed)} numpy
    inputs of K1's phases, from a seeded generator; ``main_path`` is the
    xgb serving fixture's 200 depth-10 trees over an [8192, 10] plane of
    its bins."""
    rng = np.random.default_rng(0)
    out = {}
    for label, (n, f, t, depth, bins) in K1_SHAPES.items():
        sf, sb, lv = random_stack(rng, t, depth, f, bins)
        if label.startswith("c"):
            sf[[1, 3]] = -1  # leaf-only trees
        top = 80000 if label.startswith("f") else bins
        binned = rng.integers(0, top, size=(n, f)).astype(np.int32)
        out[label] = (binned, sf, sb, lv, label in K1_TIMED)
    with np.load(os.path.join(FIXTURES, "xgb", "arrays.npz")) as z:
        arrays = {k.rsplit("__", 1)[-1]: z[k] for k in z.files
                  if "__best__" in k}
    bins = arrays["thresholds"].shape[1] + 1
    binned = rng.integers(0, bins, size=(BUCKET_ROWS, arrays["thresholds"].shape[0]))
    out["main_path"] = (binned.astype(np.int32), arrays["split_feat"],
                        arrays["split_bin"], arrays["leaf_value"], True)
    return out


def traversal_touched_bytes(torch, binned, split_feat, split_bin) -> int:
    """Bytes one traversal must move on these inputs: each binned code,
    split_feat, split_bin and leaf value that the walk reads, once (all 4
    bytes), plus the N*T f32 output written once. Level l reads only node
    slots [0, 2^l), and only the nodes some row reaches, so the split
    arrays give at most 2*T*(2^depth - 1) words, not 2*T*depth*W; a -1
    node's split_bin and binned code are never read. The visited set is
    found by the plain walk's own routing."""
    n, f = binned.shape
    t, depth, _ = split_feat.shape
    dev = binned.device
    rows = torch.arange(n, device=dev).expand(t, n)
    trees = torch.arange(t, device=dev)[:, None].expand(t, n)
    codes_read = torch.zeros((n, f), dtype=torch.bool, device=dev)
    node = torch.zeros((t, n), dtype=torch.long, device=dev)
    words = n * t  # the output
    for lvl in range(depth):
        seen = torch.zeros((t, 1 << lvl), dtype=torch.bool, device=dev)
        seen[trees, node] = True
        live = split_feat[:, lvl, : 1 << lvl] >= 0
        words += int(seen.sum()) + int((seen & live).sum())
        feat = torch.gather(split_feat[:, lvl, :].long(), 1, node)
        thr = torch.gather(split_bin[:, lvl, :].long(), 1, node)
        ok = feat >= 0
        codes_read[rows[ok], feat[ok]] = True
        code = binned[rows, feat.clamp(min=0)]
        node = node * 2 + (ok & (code > thr)).long()
    leaves = torch.zeros((t, 1 << depth), dtype=torch.bool, device=dev)
    leaves[trees, node] = True
    words += int(codes_read.sum()) + int(leaves.sum())
    return 4 * words


def traversal_bound_ms(nbytes, n, t, depth) -> tuple[float, str]:
    """The larger of ``nbytes`` over the memory rate and 3 integer
    operations per (row, tree, level) over the scalar rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = 3 * n * t * depth / SCALAR_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def same_values(torch, a, b) -> bool:
    """Equal shapes and values, NaN where the other has NaN (a forest's leaf
    that no training row reached holds 0/0)."""
    return a.shape == b.shape and torch.equal(a.isnan(), b.isnan()) and \
        torch.equal(a.nan_to_num(), b.nan_to_num())


def packed_clone(packed):
    """A copy of a ``PackedTrees`` in new device memory."""
    return packed._replace(top=packed.top.clone(), bottom=packed.bottom.clone(),
                           leaf_value=packed.leaf_value.clone(),
                           leaf_tiles=packed.leaf_tiles.clone())


def traversal_accuracy(torch, ST, name, args, packed) -> dict:
    """K1 per call (``serve_trees``: the split arrays packed into two-word
    nodes on the card, then the walk) and over the stack packed once on the
    host (``serve_trees_packed``) against the plain walk on the same card
    tensors, bit for bit; raise where either differs."""
    want = ST.serve_trees_reference(*args)
    got = ST.serve_trees(*args)
    got_packed = ST.serve_trees_packed(args[0], packed)
    torch.cuda.synchronize()
    for label, out in (("per call", got), ("packed", got_packed)):
        if not same_values(torch, out, want):
            bad = (out != want).sum().item() if out.shape == want.shape else "shape"
            raise AssertionError(f"serve_trees {name} ({label}): kernel != "
                                 f"plain walk ({bad})")
    return {"max_abs_err": max(
        (out - want).nan_to_num().abs().max().item() if want.numel() else 0.0
        for out in (got, got_packed))}


def traversal_times(torch, ST, args, packed, host_pack_s=None) -> dict:
    """K1 with the inputs out of L2, on both yardsticks: CUDA-event groups
    (``time_ms``, PRs 1-4's) and the profiler's device time
    (``device_ms``), per call (``kernel_ms``: the per-call packing and the
    walk) and over the packed stack (``packed_ms``: the models' path); the
    per-call packing alone (``pack_device_ms``); the plain walk; the
    bound."""
    n, _ = args[0].shape
    t, depth, _ = args[1].shape
    nbytes = traversal_touched_bytes(torch, *args[:3])
    bound, by = traversal_bound_ms(nbytes, n, t, depth)
    cold = l2_cold_copies(args, nbytes)
    cold_packed = [[c[0], packed if i == 0 else packed_clone(packed)]
                   for i, c in enumerate(cold)]
    out = {
        "kernel_ms": time_ms(torch, ST.serve_trees, cold),
        "kernel_device_ms": device_ms(torch, ST.serve_trees, cold),
        "packed_ms": time_ms(torch, ST.serve_trees_packed, cold_packed),
        "packed_device_ms": device_ms(torch, ST.serve_trees_packed, cold_packed),
        "packed_ms_l2_warm": time_ms(torch, ST.serve_trees_packed,
                                     [[args[0], packed]]),
        "pack_device_ms": device_ms(
            torch, lambda sf, sb, lv: ST.pack_trees_plain(sf, sb, lv, True),
            [c[1:] for c in cold]),
        "plain_ms": time_ms(torch, ST.serve_trees_reference, cold, reps=3,
                            rounds=5),
        "layout": "wide" if packed.wide else "32-bit words",
        "launch": ST.launch_shape(packed, n, args[0].shape[1]),
        "traversal_touched_bytes": nbytes, "arg_copies": len(cold),
        "bound_ms": bound, "bound_by": by,
    }
    if host_pack_s is not None:
        out["host_pack_s"] = host_pack_s
    del cold, cold_packed
    return out


def check_traversal(torch, ST, name, binned, sf, sb, lv, timed: bool) -> dict:
    """K1 on numpy inputs: the stack packed on the host as a model packs
    it (``pack_trees``, timed), the card's results against the plain walk
    (``traversal_accuracy``); with ``timed``, ``traversal_times``."""
    host = [torch.from_numpy(a) for a in (sf, sb, lv)]
    s = time.perf_counter()
    packed = ST.pack_trees(*host, num_features=binned.shape[1]).to(DEV)
    torch.cuda.synchronize()
    host_pack_s = time.perf_counter() - s
    args = [torch.from_numpy(binned).to(DEV)] + [a.to(DEV) for a in host]
    n, f = binned.shape
    t, depth, _ = sf.shape
    out = {"shape": {"N": n, "F": f, "T": t, "depth": depth},
           "top_levels": packed.top_levels,
           **traversal_accuracy(torch, ST, name, args, packed)}
    if timed:
        out.update(traversal_times(torch, ST, args, packed, host_pack_s))
    return out


class K1Capture:
    """Records the first K1 launch of every (family, depth, trees) group
    that scoring the fitted lanes makes (``serve_trees_packed``, the
    models' path), with how many launches each group makes. It adds no
    launch: every call reaches the wrapper once."""

    def __init__(self, ST):
        self.ST = ST
        self.real = ST.serve_trees_packed
        self.family = None
        self.records: dict[tuple, dict] = {}

    def __enter__(self):
        def hook(binned, packed):
            key = (self.family, packed.depth, packed.num_trees)
            rec = self.records.get(key)
            if rec is None:
                self.records[key] = {"binned": binned, "packed": packed,
                                     "count": 1}
            else:
                rec["count"] += 1
            return self.real(binned, packed)

        self.ST.serve_trees_packed = hook
        return self

    def __exit__(self, *exc):
        self.ST.serve_trees_packed = self.real
        return False


def check_k1_launches(torch, ST, records: dict) -> dict:
    """Each captured training launch of K1 relaunched against the plain walk
    (``traversal_accuracy``) and timed (``traversal_times``); the summary
    weighs each by how many launches its group made."""
    rows = []
    for (family, depth, t), rec in records.items():
        binned, packed = rec["binned"], rec["packed"]
        args = [binned, *ST.unpack_trees(packed)]
        name = f"{family} depth {depth} T={t}"
        rows.append({
            "family": family, "depth": depth, "T": t, "N": binned.shape[0],
            "F": binned.shape[1], "weight": rec["count"],
            **traversal_accuracy(torch, ST, name, args, packed),
            **traversal_times(torch, ST, args, packed),
        })
        rec["binned"] = rec["packed"] = None
    if not rows:
        raise AssertionError("no serve_trees launch of the training path was "
                             "captured")
    total = sum(r["weight"] for r in rows)

    def mean(key):
        return sum(r["weight"] * r[key] for r in rows) / total

    return {
        "basis": "mean per launch, each captured launch weighted by the "
                 "launches of its (family, depth, trees) group",
        "launches": total,
        **{key: mean(key) for key in (
            "packed_ms", "packed_device_ms", "kernel_ms", "kernel_device_ms",
            "pack_device_ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
        else "operations",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "captured": rows,
    }


#: tree-sum shapes: (N, T, boosted). (a) the main path's xgb winner (200
#: rounds) and (b) its rf (50 trees) at the scoring bucket cap; (c) ragged;
#: (d) more trees than one staged tile holds, a row count off the block
TREE_SUM_SHAPES = {
    "a_boosted_main": (BUCKET_ROWS, 200, True),
    "b_forest_main": (BUCKET_ROWS, 50, False),
    "c_ragged": (1001, 7, True),
    "d_two_tiles": (333, 257, False),
}


def tree_sum_bound_ms(n: int, t: int) -> tuple[float, str]:
    """The tree sum reads [N, T] f32 once and writes [N] f32; it adds N*T
    values and takes N epilogues (two operations each)."""
    by_bytes = (n * t + n) * 4 / HBM_BYTES_PER_S * 1e3
    by_ops = (n * t + 2 * n) / SCALAR_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_tree_sum(torch, TS, name, per_tree, boosted, eta, base,
                   timed: bool, pairs: int = 2) -> dict:
    """The tree-sum kernel against its plain version on the same card
    tensor and on a CPU copy, bit for bit (NaN where the other has NaN: a
    forest leaf no training row reached holds 0/0); with ``timed``, its
    time and one ``torch.sum(dim=1)``'s (the library call for the sum
    alone) on both yardsticks, in turns (``compare_device_ms``, ``pairs``
    pairs of readings), with the inputs out of L2, the plain version's and
    the bound."""
    got = TS.tree_sum(per_tree, boosted, eta, base)
    want = TS.tree_sum_plain(per_tree, boosted, eta, base)
    cpu = TS.tree_sum_plain(per_tree.cpu(), boosted, eta, base)
    torch.cuda.synchronize()
    if not (same_values(torch, got, want) and same_values(torch, got.cpu(), cpu)):
        bad = int((got != want).sum().item())
        raise AssertionError(f"tree_sum {name}: kernel != plain version "
                             f"({bad} rows)")
    n, t = per_tree.shape
    out = {"shape": {"N": n, "T": t}, "boosted": bool(boosted),
           "max_abs_err": float((got - want).nan_to_num().abs().max().item())
           if n else 0.0, "bit_identical": True}
    if timed:
        bound, by = tree_sum_bound_ms(n, t)
        cold = l2_cold_copies([per_tree], per_tree.numel() * 4)

        def kernel(pt):
            return TS.tree_sum(pt, boosted, eta, base)

        def plain(pt):
            return TS.tree_sum_plain(pt, boosted, eta, base)

        def library(pt):
            return torch.sum(pt, dim=1)

        out.update(compare_device_ms(torch, kernel, library, cold, pairs))
        out.update({
            "plain_ms": time_ms(torch, plain, cold, reps=3, rounds=5),
            "bound_ms": bound, "bound_by": by, "arg_copies": len(cold),
        })
        del cold
    return out


#: kernel / library pairs of the tree sum's comparisons that decide whether
#: it is slower than one torch.sum (the tree order at (a), (b) and
#: serving's captured calls); the others take 2
MUST_PAIRS = 8
#: one-sided sign-test level at which a side is called faster
SIGN_LEVEL = 0.05


class ClockSampler:
    """The card's SM clock, sampled every ``period_ms`` by ``nvidia-smi``
    (a process of its own, stopped when the block ends) while a comparison
    runs; ``between`` gives the samples taken inside a span of wall time.
    Samples are diagnostics: where ``nvidia-smi`` gives none, readings
    carry no clock."""

    query = "timestamp,clocks.sm"

    def __init__(self, period_ms: int = 10):
        self.period_ms = period_ms
        self.samples: list[tuple[float, float]] = []
        self.proc = self.thread = None

    def _read(self):
        from datetime import datetime

        for line in self.proc.stdout:
            try:
                stamp, mhz = line.split(",")
                at = datetime.strptime(stamp.strip(),
                                       "%Y/%m/%d %H:%M:%S.%f").timestamp()
                self.samples.append((at, float(mhz)))
            except ValueError:
                continue

    def __enter__(self):
        import threading

        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.query}",
                 "--format=csv,noheader,nounits",
                 f"--loop-ms={self.period_ms}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            return self
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()
        give_up = time.time() + 5.0
        while not self.samples and time.time() < give_up \
                and self.proc.poll() is None:
            time.sleep(0.01)
        return self

    def __exit__(self, *exc):
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
            self.thread.join(timeout=5)
        return False

    def between(self, t0: float, t1: float) -> list[float]:
        return [mhz for at, mhz in list(self.samples) if t0 <= at <= t1]


def sign_p(wins: int, n: int) -> float:
    """One-sided sign-test p-value: at least ``wins`` of ``n`` fair tosses."""
    return sum(math.comb(n, k) for k in range(wins, n + 1)) / 2 ** n if n \
        else 1.0


def pair_verdict(kernel_runs, library_runs, sources) -> dict:
    """Pairs of readings taken side by side: how often the kernel took less
    device time than the library call, over the pairs whose readings both
    came from the profiler, and the sign test's verdict on that count."""
    used = [(k, l) for k, l, (sk, sl) in zip(kernel_runs, library_runs, sources)
            if sk == sl == "profiler" and k != l]
    wins = sum(k < l for k, l in used)
    p_fast, p_slow = sign_p(wins, len(used)), sign_p(len(used) - wins, len(used))
    return {"pairs": len(kernel_runs), "pairs_used": len(used),
            "kernel_wins": wins,
            "p_kernel_faster": p_fast, "p_kernel_slower": p_slow,
            "verdict": "kernel faster" if p_fast < SIGN_LEVEL
            else "kernel slower" if p_slow < SIGN_LEVEL
            else "level within the noise"}


def compare_device_ms(torch, kernel, library, cold, pairs: int = 2) -> dict:
    """A kernel and the library call for the same function, timed in turns
    on the same inputs: each on CUDA-event groups, then ``pairs`` pairs of
    device-time readings (``device_ms``), the kernel first in the even pairs
    and the library call first in the odd ones (kernel, library, library,
    kernel, ...). ``device_ms`` and ``library_device_ms`` are the means of
    each side's readings. With more than 2 pairs the card's SM clock is
    sampled beside every reading (``ClockSampler``), the readings and clocks
    are split by their place in the pair (first or second), and the sign
    test over the pairs gives the verdict (``pair_verdict``)."""
    out = {"ms": time_ms(torch, kernel, cold),
           "library_ms": time_ms(torch, library, cold)}
    runs = {"kernel": [], "library": []}
    srcs = {"kernel": [], "library": []}
    clocks = {"kernel": [], "library": []}
    places = {"first": [], "second": []}
    with (ClockSampler() if pairs > 2 else contextlib.nullcontext()) as clk:
        for i in range(pairs):
            order = ("kernel", "library") if i % 2 == 0 else ("library", "kernel")
            for place, side in zip(("first", "second"), order):
                t0 = time.time()
                ms, src = sourced_ms(torch, kernel if side == "kernel"
                                     else library, cold)
                t1 = time.time()
                runs[side].append(ms)
                srcs[side].append(src)
                mhz = clk.between(t0, t1) if clk is not None else []
                clocks[side].append(statistics.mean(mhz) if mhz else None)
                places[place].append((side, ms, clocks[side][-1]))
    out.update({
        "device_ms": statistics.mean(runs["kernel"]),
        "device_ms_runs": runs["kernel"],
        "device_ms_source": "profiler"
        if all(s == "profiler" for s in srcs["kernel"]) else "cuda_events",
        "library_device_ms": statistics.mean(runs["library"]),
        "library_device_ms_runs": runs["library"],
        "run_sources": list(zip(srcs["kernel"], srcs["library"])),
    })
    if pairs > 2:
        def place_summary(rows):
            sides = {side: [ms for sd, ms, _ in rows if sd == side]
                     for side in ("kernel", "library")}
            mhz = [c for _, _, c in rows if c is not None]
            return {**{f"{side}_ms": statistics.mean(v) for side, v in
                       sides.items()},
                    "clock_mhz": statistics.mean(mhz) if mhz else None}

        out["paired"] = {
            **pair_verdict(runs["kernel"], runs["library"], out["run_sources"]),
            "kernel_median_ms": statistics.median(runs["kernel"]),
            "library_median_ms": statistics.median(runs["library"]),
            "sources": source_counts(
                [{"s": x} for x in srcs["kernel"] + srcs["library"]], "s"),
            "clock_samples": len(clk.samples),
            "kernel_clock_mhz": clocks["kernel"],
            "library_clock_mhz": clocks["library"],
            "first_in_pair": place_summary(places["first"]),
            "second_in_pair": place_summary(places["second"]),
        }
    return out


class TreeSumCapture:
    """Records the first tree-sum call of every (path, N, T, boosted) group
    that the predictors make (through ``serve_trees``'s name for it), with
    how many calls each group makes. It adds no launch."""

    def __init__(self, ST):
        self.ST = ST
        self.real = ST.tree_sum
        self.path = None
        self.records: dict[tuple, dict] = {}

    def __enter__(self):
        def hook(per_tree, boosted, eta=0.0, base_score=0.0):
            key = (self.path, per_tree.shape[0], per_tree.shape[1], bool(boosted))
            rec = self.records.get(key)
            if rec is None:
                self.records[key] = {"per_tree": per_tree.clone(), "eta": eta,
                                     "base": base_score, "count": 1}
            else:
                rec["count"] += 1
            return self.real(per_tree, boosted, eta, base_score)

        self.ST.tree_sum = hook
        return self

    def __exit__(self, *exc):
        self.ST.tree_sum = self.real
        return False


def check_tree_sum_path(torch, TS, records: dict, path: str,
                        pairs: int = 2) -> dict:
    """Each tree-sum call captured on ``path`` relaunched against the plain
    version and timed (right after the path ran: the profiler misses more
    activities late in a long run); the means weighted by each group's
    calls. With more than 2 ``pairs``, the weighted sums of each pair's
    readings over the groups are compared pair by pair too
    (``pair_verdict``)."""
    rows = []
    for key in [k for k in records if k[0] == path]:
        _, n, t, boosted = key
        rec = records.pop(key)
        rows.append({"weight": rec["count"], **check_tree_sum(
            torch, TS, f"{path} N={n} T={t}", rec["per_tree"], boosted,
            rec["eta"], rec["base"], timed=True, pairs=pairs)})
    if not rows:
        raise AssertionError(f"no tree_sum call of the {path} path was captured")
    total = sum(r["weight"] for r in rows)
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
            "bound_ms")
    extra = {}
    if pairs > 2:
        def weighted(key):
            return [sum(r["weight"] * r[key][i] for r in rows) / total
                    for i in range(pairs)]

        def source(i):
            both = all(r["run_sources"][i] == ("profiler", "profiler")
                       for r in rows)
            return ("profiler",) * 2 if both else ("cuda_events",) * 2

        extra["paired"] = pair_verdict(
            weighted("device_ms_runs"), weighted("library_device_ms_runs"),
            [source(i) for i in range(pairs)])
    return {
        **extra,
        "basis": "mean per launch, each captured call weighted by the calls "
                 "of its (N, T, boosted) group",
        "launches": total,
        "device_ms_sources": source_counts(rows),
        **{k: sum(r["weight"] * r[k] for r in rows) / total for k in keys},
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
        else "operations",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "captured": rows,
    }


#: the tree sum's device-route mode: (N, T, leaf windows, boosted). (a) 200
#: depth-6 rounds (2 leaf windows) above the 16384-row threshold; (b) 200
#: depth-10 rounds (32 windows) at 65536 rows; untimed (c) ragged, depth <= 5
#: (one window, no window array) and (d) ragged, 2 windows; (e) three levels
#: of windows (T > 1024); (f) depth 12 (128 windows, three levels)
#: (N, T, H, depth, boosted); (g)-(l) are the shapes whose order the
#: reference vectorizes (ROADMAP.md C4; tree_sum.route_order): lanes of 8
#: and 4 (R1), fold_w over 2 and 4 tree windows (R2)
ROUTE_SHAPES = {
    "a_depth6": (20000, 200, 2, 6, True),
    "b_depth10": (65536, 200, 32, 10, True),
    "c_ragged_one_window": (16385, 7, 1, 5, False),
    "d_ragged": (16385, 7, 2, 6, True),
    "e_many_trees": (1001, 1100, 4, 7, False),
    "f_depth12": (4099, 50, 128, 12, True),
    "g_r1_lanes8": (20000, 20, 1, 4, True),
    "h_r1_lanes4": (20000, 20, 1, 3, False),
    "i_r2_fold_w": (32768, 50, 2, 6, False),
    "j_r2_fold_w4": (65536, 100, 2, 6, True),
    "k_r1_lanes8_ragged": (16385, 27, 1, 5, False),
    "l_r2_fold_w_33": (32768, 33, 2, 6, True),
}
#: the shapes timed against their bound and one torch.sum(dim=1)
ROUTE_TIMED = ("a", "b", "g", "h", "i", "j")
#: rows of the device-route serving batch (above the reference's 16384)
ROUTE_ROWS = 20000


def route_bound_ms(n: int, t: int, h: int) -> tuple[float, str]:
    """The device-route sum reads [N, T] f32 values (and as many leaf
    windows where H > 1) once and writes [N] f32; it adds N*T values into
    their windows, folds the windows and takes N epilogues."""
    arrays = 2 if h > 1 else 1
    by_bytes = (arrays * n * t + n) * 4 / HBM_BYTES_PER_S * 1e3
    folds = -(-t // 32) * h
    by_ops = n * (t + folds + 2) / SCALAR_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_tree_sum_route(torch, TS, name, per_tree, win, h, depth, boosted,
                         eta, base, timed: bool, pairs: int = 2) -> dict:
    """The device-route mode against its plain version on the same card
    tensors and on CPU copies, bit for bit; with ``timed``, its times as
    ``check_tree_sum`` takes them (the library call: one
    ``torch.sum(dim=1)``, the same function in another order, in ``pairs``
    pairs of readings), and its time over its bound."""
    got = TS.tree_sum_device_route(per_tree, win, h, depth, boosted, eta,
                                   base)
    want = TS.tree_sum_device_route_plain(per_tree, win, h, depth, boosted,
                                          eta, base)
    cpu = TS.tree_sum_device_route_plain(
        per_tree.cpu(), None if win is None else win.cpu(), h, depth, boosted,
        eta, base)
    torch.cuda.synchronize()
    if not (same_values(torch, got, want) and same_values(torch, got.cpu(), cpu)):
        bad = int((got != want).sum().item())
        raise AssertionError(f"tree_sum_device_route {name}: kernel != plain "
                             f"version ({bad} rows)")
    n, t = per_tree.shape
    out = {"shape": {"N": n, "T": t, "H": h, "depth": depth},
           "order": TS.route_order(t, depth, h, n), "boosted": bool(boosted),
           "max_abs_err": float((got - want).nan_to_num().abs().max().item())
           if n else 0.0, "bit_identical": True}
    if timed:
        bound, by = route_bound_ms(n, t, h)
        args = [per_tree] if win is None else [per_tree, win]
        cold = l2_cold_copies(args, sum(a.numel() for a in args) * 4)

        def kernel(pt, w=None):
            return TS.tree_sum_device_route(pt, w, h, depth, boosted, eta,
                                            base)

        def plain(pt, w=None):
            return TS.tree_sum_device_route_plain(pt, w, h, depth, boosted,
                                                  eta, base)

        def library(pt, w=None):
            return torch.sum(pt, dim=1)

        out.update(compare_device_ms(torch, kernel, library, cold, pairs))
        out.update({
            "plain_ms": time_ms(torch, plain, cold, reps=2, rounds=3),
            "bound_ms": bound, "bound_by": by, "arg_copies": len(cold),
            "device_ms_over_bound": out["device_ms"] / bound,
        })
        del cold
    return out


class RouteCapture:
    """Records the first device-route tree sum of every (N, T, H, depth,
    boosted) group that the predictors make (through ``serve_trees``'s name for
    it), with how many calls each group makes. It adds no launch."""

    def __init__(self, ST):
        self.ST = ST
        self.real = ST.tree_sum_device_route
        self.records: dict[tuple, dict] = {}

    def __enter__(self):
        def hook(per_tree, leaf_window, num_windows, depth, boosted, eta=0.0,
                 base_score=0.0):
            key = (per_tree.shape[0], per_tree.shape[1], num_windows, depth,
                   bool(boosted))
            rec = self.records.get(key)
            if rec is None:
                self.records[key] = {
                    "per_tree": per_tree.clone(),
                    "win": None if leaf_window is None else leaf_window.clone(),
                    "eta": eta, "base": base_score, "count": 1}
            else:
                rec["count"] += 1
            return self.real(per_tree, leaf_window, num_windows, depth,
                             boosted, eta, base_score)

        self.ST.tree_sum_device_route = hook
        return self

    def __exit__(self, *exc):
        self.ST.tree_sum_device_route = self.real
        return False


def plan_vector(model, rows: list[dict], n: int) -> np.ndarray:
    """The feature vector a model's plan hands its predictor for ``rows``,
    repeated to ``n`` rows."""
    from transmogrifai_tpu_torch.types.columns import column_from_values

    cols = {f.name: column_from_values(f.ftype, [r.get(f.name) for r in rows])
            for f in model.raw_features}
    plan = model.stage_plan()
    for stage in plan[:-1]:
        cols[stage.output_name] = stage.transform_columns(
            *[cols[name] for name in stage.input_names], num_rows=len(rows))
    vec = np.asarray(cols[plan[-1].input_names[-1]].values, np.float32)
    return np.resize(vec, (n, vec.shape[1]))


def route_twins(G, TR):
    """Depth-10 twins of the serving models, from a seed: 200 boosted rounds
    and a 50-tree forest over 10 features at 32 bins (name -> a function
    making the model), with their batch of ``ROUTE_ROWS`` rows."""
    rng = np.random.default_rng(10)
    f, bins, depth = 10, 32, 10
    x = rng.normal(size=(ROUTE_ROWS, f)).astype(np.float32)
    thr = TR.quantile_thresholds(x, max_bins=bins)
    sf, sb, lv = random_stack(rng, 200, depth, f, bins - 1)
    boosted = TR.Tree(sf, sb, (lv * 0.1).astype(np.float32))
    sf, sb, lv = random_stack(rng, 50, depth, f, bins - 1)
    forest = TR.Tree(sf, sb, (lv * 0.1).astype(np.float32))
    return x, {
        "xgb depth-10 twin": lambda: G.BoostedBinaryModel(thr, boosted, 0.02, 0.1),
        "rf depth-10 twin": lambda: G.ForestClassifierModel(thr, [forest]),
    }


def best_of(model):
    return next(s for s in model.fitted.values()
                if hasattr(s, "best_model")).best_model


def device_route_path(torch, G, ST, TS, TR, load_workflow_model) -> dict:
    """The serving path above 16384 rows: the xgb and rf fixtures' models
    (loaded as a user loads them, so placed on the card) and depth-10 twins
    score ``ROUTE_ROWS`` rows through ``predict_arrays``, which sums in the
    reference's device-route order; every output must equal the same call
    on the CPU bit for bit (the plain route the CPU tests hold to the JAX
    package). The device-route sum's and K1's counts are read around the
    card's calls, and the sums captured for timing."""
    cases = []
    for name in ("xgb", "rf"):
        path, rows, _ = load_fixture(name)
        card = best_of(load_workflow_model(path))
        cpu = best_of(load_workflow_model(path, device="cpu")).to("cpu")
        cases.append((f"{name} fixture", card, cpu,
                      plan_vector(load_workflow_model(path, device="cpu"),
                                  rows, ROUTE_ROWS)))
    x, twins = route_twins(G, TR)
    for name, make in twins.items():
        cases.append((name, make().to(DEV), make().to("cpu"), x))
    TS.tree_sum_device_route.launches = 0
    ST.serve_trees.launches = 0
    outs = {}
    with RouteCapture(ST) as cap:
        for name, card, _, vec in cases:
            outs[name] = card.predict_arrays(vec)
    route_launches = TS.tree_sum_device_route.launches
    k1_launches = ST.serve_trees.launches
    TS.tree_sum_device_route.launches = 0
    ST.serve_trees.launches = 0
    if route_launches == 0 or k1_launches == 0:
        raise AssertionError(f"the device route launched tree_sum_device_route "
                             f"{route_launches} and serve_trees {k1_launches} "
                             "times")
    result = {"rows": ROUTE_ROWS, "route_launches": route_launches,
              "serve_trees_launches": k1_launches, "models": {}}
    for name, card, cpu, vec in cases:
        if card.device is None or card.device.type != torch.device(DEV).type:
            raise AssertionError(f"{name}: the model did not predict on the card")
        want = cpu.predict_arrays(vec)
        diff = [int(np.count_nonzero(~((a == b) | (np.isnan(a) & np.isnan(b)))))
                for a, b in zip(outs[name], want)]
        if any(diff):
            raise AssertionError(f"{name}: card scores differ from the CPU's "
                                 f"(differing cells {diff})")
        stack = card.device_stacks[0]
        result["models"][name] = {"T": stack.num_trees, "depth": stack.depth,
                                  "stacks": len(card.device_stacks),
                                  "differing_cells": 0}
    result["_records"] = cap.records
    return result


def check_route_path(torch, TS, records: dict, pairs: int = 2) -> dict:
    """Each device-route sum captured on the serving path relaunched
    against the plain version and timed; the means weighted by each
    group's calls, and with more than 2 ``pairs`` the weighted sums of each
    pair's readings compared pair by pair (``pair_verdict``)."""
    rows = []
    for (n, t, h, depth, boosted), rec in records.items():
        rows.append({"weight": rec["count"], **check_tree_sum_route(
            torch, TS, f"serving N={n} T={t} H={h} depth={depth}",
            rec["per_tree"], rec["win"], h, depth, boosted, rec["eta"],
            rec["base"], timed=True, pairs=pairs)})
    if not rows:
        raise AssertionError("no device-route sum of the serving path was "
                             "captured")
    total = sum(r["weight"] for r in rows)
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
            "bound_ms")
    extra = {}
    if pairs > 2:
        def weighted(key):
            return [sum(r["weight"] * r[key][i] for r in rows) / total
                    for i in range(pairs)]

        def source(i):
            both = all(r["run_sources"][i] == ("profiler", "profiler")
                       for r in rows)
            return ("profiler",) * 2 if both else ("cuda_events",) * 2

        extra["paired"] = pair_verdict(
            weighted("device_ms_runs"), weighted("library_device_ms_runs"),
            [source(i) for i in range(pairs)])
    means = {k: sum(r["weight"] * r[k] for r in rows) / total for k in keys}
    return {
        **extra,
        "basis": "mean per launch, each captured call weighted by the calls "
                 "of its (N, T, H, boosted) group",
        "device_ms_over_bound": means["device_ms"] / means["bound_ms"],
        "launches": total,
        "device_ms_sources": source_counts(rows),
        **means,
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
        else "operations",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "captured": rows,
    }


def count_syncs(torch, fn):
    """(fn(), the host syncs it made): CUDA's sync debug mode warns at every
    operation that makes the host wait for the card (a device-to-host copy,
    a blocking upload, ``.item()``); the warnings are counted."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    return out, len(syncs), sorted({str(w.message)[:120] for w in syncs})


#: the selectors' default GLM grid (selector/model_selector.py:51-53:
#: REGULARIZATION x ELASTIC_NET, MAX_ITER_LIN, FIT_INTERCEPT), the binary
#: selector's LogisticRegression and the regression selector's
#: LinearRegression (:497-506) alike; 8 points x 3 folds = 24 lanes, run
#: padded to 32
GLM_GRID = [
    {"reg_param": r, "elastic_net_param": e, "max_iter": 50,
     "fit_intercept": True}
    for e in (0.1, 0.5) for r in (0.001, 0.01, 0.1, 0.2)
]
#: against the JAX package's stored lanes (tests/test_torch_glm.py): linear
#: (rtol, atol) = (1e-5, 2e-6); logistic rtol = atol = 0.0135
GLM_LINEAR_TOL = (1e-5, 2e-6)
GLM_LOGISTIC_TOL = 0.0135
GLM_PREDICT_ATOL = 1e-6


def glm_lane_errors(models, want_w, want_b) -> tuple:
    """(weights' and intercepts' max abs difference, the lanes' weights
    [masks, points, D] and intercepts [masks, points])."""
    got_w = np.array([[m.weights for m in row] for row in models])
    got_b = np.array([[m.intercept for m in row] for row in models])
    return (float(np.abs(got_w - want_w).max()),
            float(np.abs(got_b - want_b).max()), got_w, got_b)


def glm_within(family, got, want) -> bool:
    rtol, atol = ((GLM_LOGISTIC_TOL, GLM_LOGISTIC_TOL) if family == "lr"
                  else GLM_LINEAR_TOL)
    return bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))


def glm_train_path(torch, x, y, target, masks) -> dict:
    """The GLM slice's training path: ``LogisticRegression`` and
    ``LinearRegression`` sweep the default grid over the 3 fold masks of
    the training table (NaN read as 0), on the card; seconds per sweep on
    the host clock, ending in the collector's download, and the host syncs
    a sweep makes; a second sweep bit-identical; every lane scored through
    ``predict_arrays`` on the card against the float64 ``x @ w + b``; then
    the training fixture's lanes against the JAX package's."""
    from transmogrifai_tpu_torch.models.linear import LinearRegression
    from transmogrifai_tpu_torch.models.logistic import LogisticRegression

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the GLM fits need float32")
    xg = np.nan_to_num(x)
    out = {"rows": xg.shape[0], "features": xg.shape[1],
           "lanes": len(GLM_GRID) * len(masks), "padded_lanes": 32}
    for family, cls, label in (("lr", LogisticRegression, y),
                               ("linr", LinearRegression, target)):
        est = cls(device=DEV)
        s = time.perf_counter()
        first, syncs, kinds = count_syncs(
            torch, lambda: est.fit_arrays_batched_masks(xg, label, masks, GLM_GRID))
        first_s = time.perf_counter() - s
        secs = []
        for _ in range(2):
            s = time.perf_counter()
            again = est.fit_arrays_batched_masks(xg, label, masks, GLM_GRID)
            secs.append(time.perf_counter() - s)
        same = all(np.array_equal(a.weights, b.weights)
                   and np.array_equal(a.intercept, b.intercept)
                   for ra, rb in zip(first, again) for a, b in zip(ra, rb))
        if not same:
            raise AssertionError(f"glm_train {family}: a second sweep is not "
                                 "bit-identical")
        if syncs != 1:
            raise AssertionError(f"glm_train {family}: a sweep made {syncs} "
                                 f"host syncs, not 1: {kinds}")
        worst = 0.0
        xd = xg.astype(np.float64)
        for row in first:
            for m in row:
                pred, prob, raw = m.predict_arrays(xg)
                if m.device is None or m.device.type != torch.device(DEV).type:
                    raise AssertionError(f"{m}: predicted off the card")
                core = xd @ m.weights + m.intercept
                got = raw[:, 1] if family == "lr" else pred
                if not np.isfinite(got).all() or got.shape != (xg.shape[0],):
                    raise AssertionError(f"{m}: bad predictions {got.shape}")
                worst = max(worst, float(np.abs(got - core).max()))
        if worst > GLM_PREDICT_ATOL:
            raise AssertionError(f"glm_train {family}: predict_arrays differs "
                                 f"from x @ w + b by {worst}")
        out[family] = {"seconds_first": first_s, "seconds": secs,
                       "host_syncs_per_sweep": syncs,
                       "refit_bit_identical": True,
                       "predict_max_abs_err_vs_f64_core": worst}
    out["fixture"] = check_glm_fixture(torch)
    return out


def check_glm_fixture(torch) -> dict:
    """The JAX package's stored GLM sweeps of the training fixture (5000
    rows, NaN read as 0, 3 folds x the default grid), reproduced on the
    card within the tests' tolerances; the measured differences."""
    from transmogrifai_tpu_torch.models.linear import LinearRegression
    from transmogrifai_tpu_torch.models.logistic import LogisticRegression

    with np.load(os.path.join(TRAIN_FIXTURE, "table.npz")) as z:
        x, y, target, masks = (np.nan_to_num(z["x"]), z["y"], z["target"],
                               z["masks"])
    with open(os.path.join(TRAIN_FIXTURE, "config.json")) as fh:
        grids = json.load(fh)["glm_grids"]
    out = {}
    for family, cls, label in (("lr", LogisticRegression, y),
                               ("linr", LinearRegression, target)):
        with np.load(os.path.join(TRAIN_FIXTURE, f"{family}.npz")) as z:
            want_w, want_b = z["weights"], z["intercept"]
        models = cls(device=DEV).fit_arrays_batched_masks(
            x, label, list(masks), grids[family])
        dw, db, got_w, got_b = glm_lane_errors(models, want_w, want_b)
        out[family] = {"weights_max_abs_err": dw, "intercept_max_abs_err": db}
        if not (glm_within(family, got_w, want_w)
                and glm_within(family, got_b, want_b)):
            raise AssertionError(
                f"glm fixture {family}: lanes differ from the JAX package's "
                f"(weights {dw}, intercepts {db})")
    return out


def load_fixture(name: str):
    path = os.path.join(FIXTURES, name)
    with open(os.path.join(path, "rows.json")) as fh:
        rows = json.load(fh)
    with np.load(os.path.join(path, "expected.npz")) as z:
        want = {k: z[k] for k in z.files}
    return path, rows, want


def check_scores(name: str, out: list[dict], want: dict) -> float:
    """The scores of ``out`` against the stored ones (tiled to its length):
    equal predictions, probabilities and raw scores within the fixture's
    ``PROB_ATOL``; returns the largest difference."""
    preds = [next(iter(r.values())) for r in out]
    prob = np.array([[p["probability_0"], p["probability_1"]] for p in preds])
    raw = np.array([[p["rawPrediction_0"], p["rawPrediction_1"]] for p in preds])
    pred = np.array([p["prediction"] for p in preds])
    reps = -(-len(preds) // len(want["prediction"]))
    w_prob = np.tile(want["probability"], (reps, 1))[: len(preds)]
    w_raw = np.tile(want["raw"], (reps, 1))[: len(preds)]
    w_pred = np.tile(want["prediction"], reps)[: len(preds)]
    if prob.shape != w_prob.shape or not np.isfinite(prob).all():
        raise AssertionError(f"{name}: bad probability block {prob.shape}")
    err = max(float(np.abs(prob - w_prob).max()),
              float(np.abs(raw - w_raw).max()))
    if err > PROB_ATOL[name] or not np.array_equal(pred, w_pred):
        raise AssertionError(
            f"{name}: scores differ from the JAX package's (max err {err} > "
            f"{PROB_ATOL[name]})"
        )
    return err


def stage_seconds(torch, model, rows: list[dict]) -> dict[str, float]:
    """Where one batch's time goes: the scoring closure's steps timed one
    by one on the host clock (raw columns, each stage class, rendering the
    result dicts), and the predictor's span on the device between CUDA
    events (upload, binning, traversal, reduction, download)."""
    from transmogrifai_tpu_torch.models.base import PredictorModel
    from transmogrifai_tpu_torch.types.columns import column_from_values

    out: dict[str, float] = {}
    s = time.perf_counter()
    cols = {
        f.name: column_from_values(f.ftype, [r.get(f.name) for r in rows])
        for f in model.raw_features
    }
    out["raw_columns"] = time.perf_counter() - s
    for stage in model.stage_plan():
        args = [cols[name] for name in stage.input_names]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        s = time.perf_counter()
        start.record()
        cols[stage.output_name] = stage.transform_columns(*args, num_rows=len(rows))
        end.record()
        torch.cuda.synchronize()
        key = type(stage).__name__
        out[key] = out.get(key, 0.0) + time.perf_counter() - s
        if isinstance(stage, PredictorModel):
            out["predictor_device_span"] = start.elapsed_time(end) / 1e3
            out["predictor_breakdown"] = predictor_breakdown(
                torch, stage, args, len(rows), out["predictor_device_span"])
    s = time.perf_counter()
    for f in model.result_features:
        cols[f.name].to_list()
    out["render"] = time.perf_counter() - s
    return out


def predictor_breakdown(torch, stage, args, num_rows: int,
                        span_s: float) -> dict:
    """The predictor's device span (``span_s``, between CUDA events, run
    unprofiled) broken down from one run of the stage under
    ``torch.profiler``: device ms of the upload and the download (memcpy),
    of ``bin_data``'s loop over thresholds (the kernels under its range),
    of K1, and of the rest (the per-family reduction and the epilogue's
    device part); the host gaps are the span less all of them."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from transmogrifai_tpu_torch.models import trees as TR

    real_bin = TR.bin_data

    def bin_data(*a, **kw):
        with record_function("predictor.bin_data"):
            return real_bin(*a, **kw)

    TR.bin_data = bin_data
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            stage.transform_columns(*args, num_rows=num_rows)
            torch.cuda.synchronize()
    finally:
        TR.bin_data = real_bin
    ms = {"upload": 0.0, "download": 0.0, "K1 serve_trees": 0.0,
          "tree_sum": 0.0}
    total = 0.0
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", 0.0)
        # the range's card-side annotation spans its kernels and the gaps
        # between them: not device work of its own
        if not t or evt.device_type != torch.autograd.DeviceType.CUDA \
                or evt.key == "predictor.bin_data":
            continue
        total += t / 1e3
        name = evt.key.lower()
        key = ("upload" if "htod" in name else "download" if "dtoh" in name
               else "K1 serve_trees" if "serve_trees" in name
               else "tree_sum" if "tree_sum" in name else None)
        if key:
            ms[key] += t / 1e3
    ms["bin_data"] = sum(e.device_time_total for e in prof.events()
                         if e.name == "predictor.bin_data" and e.device_type
                         == torch.autograd.DeviceType.CPU) / 1e3
    if not total:
        return {"device_ms": "not measured"}
    ms["reduction and epilogue"] = total - sum(ms.values())
    return {"device_ms": ms, "device_total_ms": total,
            "span_ms": span_s * 1e3,
            "host_gaps_ms": span_s * 1e3 - total}


def hist_inputs(torch, n, f, b, k, m, ragged: bool, seed: int):
    """Codes, slots, grad and hess on the card from a seeded generator.
    Slots are drawn from [-1, M) (dead rows), or [-1, M + 2) when ragged
    (slots >= M too)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    hi = m + 2 if ragged else m
    return [
        torch.randint(0, b, (n, f), generator=gen, device=DEV, dtype=torch.int32),
        torch.randint(-1, hi, (k, n), generator=gen, device=DEV, dtype=torch.int32),
        torch.randn((k, n), generator=gen, device=DEV),
        torch.rand((k, n), generator=gen, device=DEV) * 0.9 + 0.1,
    ]


def hist_bound(torch, binned, node, g, h, m, b) -> tuple[float, str, int]:
    """(bound ms, "bytes" or "operations", bytes): the codes of rows live
    in some lane, node/grad/hess read once and the histogram written once
    over the memory rate; 2 f32 adds per live (lane, row, feature) over the
    scalar rate. A live row has a slot in [0, M) and a nonzero grad or
    hess (a zero-weight row changes no sum)."""
    n, f = binned.shape
    k = node.shape[0]
    live = (node >= 0) & (node < m) & ((g != 0) | (h != 0))
    nbytes = (int(live.any(dim=0).sum()) * f * 4 + 3 * k * n * 4
              + k * m * f * b * 2 * 4)
    ops = 2 * f * int(live.sum())
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / SCALAR_OPS_PER_S * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes", nbytes
    return by_ops, "operations", nbytes


def gemm_library_ms(torch, binned, node, g, h, m, b) -> float:
    """The reference's GEMM formulation as the library yardstick: weighted
    node one-hots [K*M, N] times a prebuilt code one-hot [N, F*B], two f32
    ``torch.matmul``s. Rows go in chunks that keep the code one-hot under
    4 GiB; the timed work is the matmul pairs only (the one-hots are built
    outside the timed calls, as the reference builds the code one-hot once
    per fit)."""
    n, f = binned.shape
    k = node.shape[0]
    rows = max(1, min(n, (1 << 30) // (f * b)))
    total = 0.0
    for r0 in range(0, n, rows):
        sl = slice(r0, min(n, r0 + rows))
        c1h = torch.nn.functional.one_hot(binned[sl].long(), b).reshape(
            sl.stop - sl.start, f * b).to(torch.float32)
        live = (node[:, sl] >= 0) & (node[:, sl] < m)
        n1h = torch.nn.functional.one_hot(
            torch.where(live, node[:, sl], 0).long(), m
        ).to(torch.float32) * live[..., None]
        gw = (n1h * g[:, sl, None]).permute(0, 2, 1).reshape(k * m, -1).contiguous()
        hw = (n1h * h[:, sl, None]).permute(0, 2, 1).reshape(k * m, -1).contiguous()

        def pair(gw=gw, hw=hw, c1h=c1h):
            return torch.matmul(gw, c1h), torch.matmul(hw, c1h)

        total += time_ms(torch, pair, [[]], reps=3, rounds=3)
        del c1h, n1h, gw, hw
    return total


#: the histogram kernels' wrappers in ``models/hist.py``, by kernel name
HIST_WRAPPERS = {"hist_binloop": "build_histogram_binloop",
                 "hist_wide": "build_histogram_wide"}


def hist_kernel(H, kernel: str):
    """The wrapper of histogram kernel ``kernel``, looked up at call time."""
    return getattr(H, HIST_WRAPPERS[kernel])


def hist_accuracy(torch, H, kernel, name, args, m, b, got, cpu_check: bool) -> dict:
    """``got``, the histogram kernel ``kernel`` built of ``args``, against
    the float64 plain version as the yardstick, each cell within count *
    2^-24 * sum|term| (the bound of a sequential f32 sum), and a relaunch
    bit-identical to it; with ``cpu_check`` also bit-identical to the plain
    f32 version on the CPU, which adds each cell's rows in ascending order
    as the kernel does."""
    binned, node, g, h = args
    name = f"{kernel} {name}"
    again = hist_kernel(H, kernel)(*args, m, b)
    plain = H.build_histogram_scatter_batched
    want = plain(binned, node, g.double(), h.double(), m, b)
    mag = plain(binned, node, g.abs().double(), h.abs().double(), m, b)
    ones = torch.ones_like(g, dtype=torch.float64)
    count = plain(binned, node, ones, ones, m, b)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches differ")
    err = (got.double() - want).abs()
    tol = count * U32 * mag
    ratio = (err / tol.clamp(min=1e-300)).max().item() if err.numel() else 0.0
    if not bool((err <= tol).all()):
        raise AssertionError(
            f"{name}: max err {err.max().item()} beyond the f32 "
            f"summation bound (max over cells of err/tol {ratio})"
        )
    out = {
        "max_abs_err": err.max().item() if err.numel() else 0.0,
        "max_err_over_tol": ratio,
        "bit_identical_relaunch": True,
    }
    del want, mag, count, ones, err, tol, again
    if cpu_check:
        cpu = plain(*(a.cpu() for a in args), m, b)
        if not torch.equal(got.cpu(), cpu):
            raise AssertionError(f"{name}: differs from the sequential plain "
                                 "version")
        out["bit_identical_to_cpu_plain"] = True
    return out


def order_bound(torch, node, m) -> tuple[float, str]:
    """(bound ms, "bytes"): ``node_order`` reads node, grad and hess once
    and writes order, start and count once."""
    k, n = node.shape
    nbytes = 4 * (3 * k * n + k * n + 2 * k * m)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def hist_times(torch, H, kernel, args, m, b, reps: int = 5,
               library: bool = True) -> dict:
    """On ``args``, with the inputs out of L2: the histogram kernel's device
    time per wrapper call (the row-order kernel and the histogram kernel;
    ``kernel_ms``), the histogram kernel's alone given the row order
    (``kernel_only_ms``, as the grower calls it once a chunk's order is
    made) and the row order's alone (``order_ms``), and the wrapper's time
    between CUDA events (``wrapper_ms``, which also holds any wait for the
    host); the f32 plain version's device time; the GEMM pair's (the
    library call; only with ``library``); and the bound."""
    plain = H.build_histogram_scatter_batched
    bound, by, nbytes = hist_bound(torch, *args, m, b)
    cold = l2_cold_copies(args, nbytes)
    ordered = [a + [H.node_order(a[1], m, a[2], a[3])] for a in cold]

    def k2(*a):
        return hist_kernel(H, kernel)(*a, m, b)

    def k2_ordered(*a):
        return hist_kernel(H, kernel)(*a[:4], m, b, order=a[4])

    def order(*a):
        return H.node_order(a[1], m, a[2], a[3])

    def p32(*a):
        return plain(*a, m, b)

    out = {
        "kernel_ms": device_ms(torch, k2, cold),
        "kernel_only_ms": device_ms(torch, k2_ordered, ordered),
        "order_ms": device_ms(torch, order, cold),
        "wrapper_ms": time_ms(torch, k2, cold, reps=reps, rounds=5),
        "plain_ms": device_ms(torch, p32, cold, calls=4),
        "library_ms": gemm_library_ms(torch, *args, m, b) if library else None,
        "bound_ms": bound, "bound_by": by, "touched_bytes": nbytes,
        "arg_copies": len(cold),
    }
    del cold, ordered
    return out


def check_node_order(torch, H, node, g, h, m, timed: bool = True) -> dict:
    """The row-order kernel (``node_order``) on card tensors against its
    plain version on the same tensors and on the CPU: order, start and count
    equal element for element, and a relaunch equal too; then, with
    ``timed``, timed with the inputs out of L2 against the plain version,
    one stable ``torch.sort`` of the slots (the library call: it gives the
    order, not the runs) and the bound."""
    got = H.node_order(node, m, g, h)
    again = H.node_order(node, m, g, h)
    want = H.node_order_plain(node, m, g, h)
    cpu = H.node_order_plain(node.cpu(), m, g.cpu(), h.cpu())
    torch.cuda.synchronize()
    err = 0
    for name, a, b, c, d in zip(("order", "start", "count"), got, again, want,
                                cpu):
        diff = max(int((a - other.to(a.device)).abs().max()) if a.numel() else 0
                   for other in (b, c, d))
        if diff:
            raise AssertionError(f"node_order: {name} differs from the plain "
                                 "version's or between launches by up to "
                                 f"{diff}")
        err = max(err, diff)
    if not timed:
        return {"bit_identical_to_plain": True, "max_abs_err": err}
    bound, by = order_bound(torch, node, m)
    cold = l2_cold_copies([node, g, h], 16 * node.numel())
    ms, source = sourced_ms(torch, lambda a, b, c: H.node_order(a, m, b, c),
                            cold)
    out = {
        "bit_identical_to_plain": True, "max_abs_err": err,
        "ms": ms, "device_ms_source": source,
        "plain_ms": device_ms(
            torch, lambda a, b, c: H.node_order_plain(a, m, b, c), cold,
            calls=4),
        "library_ms": device_ms(
            torch, lambda a, b, c: torch.sort(a, dim=1, stable=True), cold),
        "bound_ms": bound, "bound_by": by,
    }
    del cold
    return out


def check_order_shape(torch, H, n, k, m, slots, seed: int) -> dict:
    """The row-order kernel at a synthetic shape (``check_node_order``):
    slots drawn from [-1, slots), about a tenth of the rows of zero grad and
    hess."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    node = torch.randint(-1, slots, (k, n), generator=gen, device=DEV,
                         dtype=torch.int32)
    g = torch.randn((k, n), generator=gen, device=DEV)
    h = torch.rand((k, n), generator=gen, device=DEV) * 0.9 + 0.1
    zero = torch.rand((k, n), generator=gen, device=DEV) < 0.1
    g[zero] = 0.0
    h[zero] = 0.0
    return {"shape": {"N": n, "K": k, "M": m, "slots_drawn": slots},
            **check_node_order(torch, H, node, g, h, m)}


def check_hist(torch, H, kernel, name, n, f, b, k, m, timed: bool, seed: int,
               root: bool = False) -> dict:
    """A histogram kernel on the card at a synthetic shape, against its
    plain version (``hist_accuracy``); with ``timed``, ``hist_times``. With
    ``root`` every live row sits in slot 0 (a root level: about 2/3 of the
    rows live per fit, as under a 3-fold mask). The codes are padded to
    16-byte rows as the grower pads them, except at a ragged shape."""
    ragged = name.startswith("c")
    args = hist_inputs(torch, n, f, b, k, m, ragged=ragged, seed=seed)
    if not ragged:  # the grower's layout; ragged shapes keep unpadded rows
        args[0] = H.pad_codes(args[0])
    if root:
        gen = torch.Generator(device=DEV).manual_seed(seed + 100)
        live = torch.rand((k, n), generator=gen, device=DEV) < 2 / 3
        args[1] = torch.where(live, 0, -1).to(torch.int32)
    got = hist_kernel(H, kernel)(*args, m, b)
    out = {
        "shape": {"N": n, "F": f, "B": b, "K": k, "M": m},
        "slots": "every live row in slot 0" if root else "spread",
        "tolerance": "per cell: rows * 2^-24 * sum|term| (sequential f32 sum)",
        **hist_accuracy(torch, H, kernel, name, args, m, b, got,
                        cpu_check=n * f <= 16 * 2**20),
    }
    if timed:
        out.update(hist_times(torch, H, kernel, args, m, b))
    return out


class KernelCapture:
    """Records one histogram kernel's launches on chosen trees of the
    training path: the inputs the wrapper was given and the histogram it
    returned, with the tree and the level they belong to. It adds no
    launch: every call reaches the wrapper once, as the grower made it.

    ``trees`` maps each family to the tree it captures in every depth group
    (the grower's calls are counted per ``max_depth``): a boosting round,
    or 0 for the first tree of a forest. Call ``start(family)`` before each
    fit."""

    def __init__(self, H, TR, kernel: str, trees: dict[str, int]):
        self.H, self.TR = H, TR
        self.attr = HIST_WRAPPERS[kernel]
        self.kernel = getattr(H, self.attr)
        self.grow = TR._grow_tree_impl
        self.trees = trees
        self.family = None
        self.records: list[dict] = []
        self._grown: dict[int, int] = {}
        self._tree = None

    def _grow_hook(self, *a, **kw):
        depth = kw["max_depth"]
        i = self._grown.get(depth, 0)
        self._grown[depth] = i + 1
        label = None
        if i == self.trees[self.family]:
            label = f"{self.family} depth {depth} tree {i + 1}"
        self._tree = None if label is None else (label, self.TR.host_syncs)
        try:
            return self.grow(*a, **kw)
        finally:
            self._tree = None

    def start(self, family: str) -> None:
        self.family, self._grown = family, {}

    def __enter__(self):
        def kernel_hook(binned, node, g, h, m, b, order=None):
            # the wrapper counts its launch on the name it is called by,
            # which is this hook while the capture is on
            out = self.kernel(binned, node, g, h, m, b, order=order)
            if self._tree is not None:
                label, syncs = self._tree
                self.records.append({
                    "family": self.family, "tree": label,
                    "level": self.TR.host_syncs - syncs - 1,
                    "args": [binned, node, g, h], "m": m, "b": b, "out": out,
                })
            return out

        kernel_hook.launches = self.kernel.launches
        self.TR._grow_tree_impl = self._grow_hook
        setattr(self.H, self.attr, kernel_hook)
        return self

    def __exit__(self, *exc):
        self.kernel.launches = getattr(self.H, self.attr).launches
        self.TR._grow_tree_impl = self.grow
        setattr(self.H, self.attr, self.kernel)
        return False


#: the main path's captured launches: every one is checked against its
#: plain version; the first of each tree and every ``MAIN_TIMED_EVERY``-th
#: are timed (each timing takes several profiler sessions: timing every
#: launch took about 110 s of the whole script, every 4th about 35 s)
MAIN_TIMED_EVERY = 8


def check_main_launches(torch, H, kernel, records, weights: dict,
                        library_per_tree: bool = False,
                        cpu_check: bool = True, timed_every: int = 1) -> dict:
    """Each captured main-path launch of a histogram kernel held against
    its plain version (``hist_accuracy``: the relaunch must equal the main
    path's own histogram bit for bit; the first launch of each tree also
    against the CPU's plain version), its row order too; the first launch
    of each tree and every ``timed_every``-th launch timed (``hist_times``).
    The summary weighs each timed launch by how often its tree recurs on
    the path (``weights``: rounds for boosting, trees per group for a
    forest), which estimates the mean launch of the whole path. With
    ``library_per_tree`` the GEMM pair is timed at the first launch of each
    tree only, and the library mean is taken over those; without
    ``cpu_check`` no launch is held against the CPU's plain version."""
    rows, seen = [], set()
    for i, rec in enumerate(records):
        args, m, b = rec["args"], rec["m"], rec["b"]
        binned, node, g, h = args
        counts = H.node_order(node, m, g, h)[2]
        name = f"{rec['tree']} level {rec['level']} B={b}"
        first = rec["tree"] not in seen
        timed = first or i % timed_every == 0
        row = {
            "tree": rec["tree"], "level": rec["level"],
            "N": binned.shape[0], "F": binned.shape[1], "B": b,
            "K": node.shape[0], "M": m,
            "slotted_rows": int(((node >= 0) & (node < m)).sum()),
            "live_rows": int(counts.sum()),
            "longest_slot_run": int(counts.max()),
            **hist_accuracy(torch, H, kernel, name, args, m, b, rec["out"],
                            cpu_check=first and cpu_check),
            **(hist_times(torch, H, kernel, args, m, b, reps=3,
                          library=first or not library_per_tree)
               if timed else {}),
            "node_order": check_node_order(torch, H, node, g, h, m,
                                           timed=timed),
        }
        seen.add(rec["tree"])
        row["weight"] = weights[rec["family"]]
        rows.append(row)
        rec["out"] = None
    if not rows:
        raise AssertionError(f"no {kernel} launch of the training path was "
                             "captured")
    timed_rows = [r for r in rows if "kernel_ms" in r]

    def mean(key, subset=timed_rows):
        return (sum(r["weight"] * r[key] for r in subset)
                / sum(r["weight"] for r in subset))

    by_bytes, by_ops = (
        sum(r["weight"] * r["bound_ms"] for r in timed_rows
            if r["bound_by"] == by)
        for by in ("bytes", "operations")
    )
    return {
        "basis": "mean per timed launch (the first of each tree and every "
                 f"{timed_every}th), each launch weighted by how often its "
                 "tree recurs on the path",
        "weights": weights, "captured_launches": len(rows),
        "timed_launches": len(timed_rows),
        "estimated_path_launches": sum(r["weight"] for r in rows),
        "ms": mean("kernel_ms"), "wrapper_ms": mean("wrapper_ms"),
        "kernel_only_ms": mean("kernel_only_ms"), "order_ms": mean("order_ms"),
        "plain_ms": mean("plain_ms"),
        "library_ms": mean("library_ms", [r for r in timed_rows
                                          if r["library_ms"] is not None]),
        "library_basis": ("first launch of each tree" if library_per_tree
                          else "every captured launch"),
        "bound_ms": mean("bound_ms"),
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_err_over_tol": max(r["max_err_over_tol"] for r in rows),
        "node_order": {
            **{key: mean(key, [r["node_order"] | {"weight": r["weight"]}
                               for r in timed_rows])
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
            "max_abs_err": max(r["node_order"]["max_abs_err"] for r in rows),
            "ms_sources": source_counts([r["node_order"] for r in timed_rows]),
        },
        "launches": rows,
    }


#: the main-path summaries' per-launch means that ``combine_paths`` merges
PATH_MEANS = ("ms", "wrapper_ms", "kernel_only_ms", "order_ms", "plain_ms",
              "library_ms", "bound_ms")


def combine_paths(summaries: dict, weights: dict, keys=PATH_MEANS,
                  ms_key: str = "ms") -> dict:
    """Main-path summaries of several paths (``check_main_launches``) as
    one: each per-launch mean in ``keys`` weighted by the path's estimated
    launches (``weights``), the worst error, and each path's ``ms_key``."""
    total = sum(weights.values())
    out = {key: sum(weights[p] * s[key] for p, s in summaries.items()) / total
           for key in keys}
    by_bytes = sum(weights[p] * s["bound_ms"] for p, s in summaries.items()
                   if s.get("bound_by", "bytes") == "bytes")
    out["bound_by"] = "bytes" if 2 * by_bytes >= out["bound_ms"] * total \
        else "operations"
    out["max_abs_err"] = max(s["max_abs_err"] for s in summaries.values())
    out["ms_by_path"] = {p: s[ms_key] for p, s in summaries.items()}
    out["estimated_path_launches"] = total
    return out


def train_table(n: int, seed: int = 0):
    """The training table (``TRAIN_*``): float32 x [n, 928], the binary
    label y, the continuous regression target (the score y thresholds) and
    3 fold masks."""
    rng = np.random.default_rng(seed)
    x = np.empty((n, TRAIN_CONT + TRAIN_BIN), dtype=np.float32)
    x[:, :TRAIN_CONT] = rng.normal(size=(n, TRAIN_CONT))
    x[:, TRAIN_CONT:] = rng.uniform(size=(n, TRAIN_BIN)) < 0.05
    for c in range(3):
        x[rng.uniform(size=n) < 0.2, c] = np.nan
    z = np.nan_to_num(x)
    score = (z[:, 0] - 0.8 * z[:, 3] + 1.5 * z[:, 10] - z[:, 11]
             + 0.7 * z[:, 12] + 0.5 * z[:, 4] * z[:, 5]
             + rng.normal(0.0, 0.7, size=n))
    masks = [(np.arange(n) % 3 != i).astype(np.float32) for i in range(3)]
    return x, (score > 0).astype(np.float32), score.astype(np.float32), masks


def fit_family(torch, est, x, y, masks, grid):
    """(models[mask][point], seconds, host syncs) of one batched fit."""
    from transmogrifai_tpu_torch.models import trees as TR

    syncs = TR.host_syncs
    torch.cuda.synchronize()
    s = time.perf_counter()
    models = est.fit_arrays_batched_masks(x, y, masks, grid)
    torch.cuda.synchronize()
    return models, time.perf_counter() - s, TR.host_syncs - syncs


def stacks_of(models) -> list[dict]:
    seen, out = set(), []
    for row in models:
        for m in row:
            if id(m._sweep_stack) not in seen:
                seen.add(id(m._sweep_stack))
                out.append(m._sweep_stack)
    return out


def check_lanes_score(x, models, boosted: bool, regression: bool = False) -> dict:
    """Every fitted lane scored through ``predict_arrays`` on the card (the
    serve_trees kernel) against the fit's own training output: margins
    (boosted) or mean leaves (forest) of R trees, summed in another order
    than the fit's, within R * 2^-22 * scale, where scale bounds the sum of
    the terms' magnitudes (eta * R * max|leaf| for a boosted lane, max|leaf|
    for a forest); predictions finite and of the expected shape, with a
    probability block for a classifier and none for a ``regression``
    (whose prediction is the score itself). Each model is first placed on
    its fit's device on its own, so that the host seconds of placement (the
    packing of its stacks, then the copy to the card) are reported apart."""
    worst, n, place_s = 0.0, x.shape[0], 0.0
    for row in models:
        for m in row:
            s = time.perf_counter()
            m.to(m.default_device)
            place_s += time.perf_counter() - s
            core = m.predict_core(x)[:, 0]
            pred, prob, _ = m.predict_arrays(x)
            if regression:
                if prob is not None or not np.array_equal(pred, core):
                    raise AssertionError(f"{m}: a regression predicts its score")
            elif prob.shape != (n, 2) or not np.isfinite(prob).all():
                raise AssertionError(f"{m}: bad probability block {prob.shape}")
            if pred.shape != (n,) or not np.isfinite(pred).all():
                raise AssertionError(f"{m}: bad prediction block {pred.shape}")
            want = np.asarray(m._sweep_stack["outputs"][m._sweep_lane], np.float64)
            trees = m._tree_stacks()[0][0]
            rounds = trees.split_feat.shape[0]
            leaf = float(np.nanmax(np.abs(trees.leaf_value)))
            scale = max(1.0, float(np.abs(want).max()),
                        abs(m.eta) * rounds * leaf if boosted else leaf)
            tol = rounds * 2.0 ** -22 * scale
            err = float(np.abs(core - want).max())
            if not err <= tol:
                raise AssertionError(
                    f"{m}: predict_arrays differs from the fit's output by "
                    f"{err} > {tol}"
                )
            worst = max(worst, err / tol)
    lanes = sum(len(r) for r in models)
    return {"lanes": lanes, "max_err_over_tol": worst,
            "placement_s": place_s, "placement_s_per_model": place_s / lanes}


def check_train_fixture(torch) -> dict:
    """The JAX package's stored fits of the training fixture, reproduced on
    the card: identical split arrays, and leaves and outputs EQUAL the
    stored ones (NaN where they hold NaN: a forest leaf no training row
    reached)."""
    from transmogrifai_tpu_torch.models import gbdt as G
    from transmogrifai_tpu_torch.models import hist as H

    with np.load(os.path.join(TRAIN_FIXTURE, "table.npz")) as z:
        x, y, target, masks = z["x"], z["y"], z["target"], z["masks"]
    with open(os.path.join(TRAIN_FIXTURE, "config.json")) as fh:
        points = json.load(fh)["points"]
    out = {}
    for name, cls, label in (
        ("xgb", G.XGBoostClassifier, y), ("rf", G.RandomForestClassifier, y),
        ("gbtr", G.GBTRegressor, target), ("rfr", G.RandomForestRegressor, target),
    ):
        with np.load(os.path.join(TRAIN_FIXTURE, f"{name}.npz")) as z:
            want = {k: z[k] for k in z.files}
        k3 = H.build_histogram_wide.launches
        models = cls(device=DEV).fit_arrays_batched_masks(
            x, label, list(masks), [points[name]])
        k3 = H.build_histogram_wide.launches - k3
        if points[name]["max_bins"] > H.BINLOOP_MAX_BINS and k3 == 0:
            raise AssertionError(f"train_fixture {name}: no hist_wide launch")
        stack = models[0][0]._sweep_stack
        trees = stack["trees"]
        same = (np.array_equal(trees.split_feat, want["split_feat"])
                and np.array_equal(trees.split_bin, want["split_bin"]))
        if not same:
            bad = int(((trees.split_feat != want["split_feat"])
                       | (trees.split_bin != want["split_bin"])).sum())
            raise AssertionError(f"train_fixture {name}: {bad} split entries "
                                 "differ from the JAX package's")
        leaf_diff = int((~((trees.leaf_value == want["leaf_value"])
                           | (np.isnan(trees.leaf_value)
                              & np.isnan(want["leaf_value"])))).sum())
        out_diff = int((stack["outputs"] != want["outputs"]).sum())
        if leaf_diff or out_diff:
            raise AssertionError(
                f"train_fixture {name}: {leaf_diff} leaf values and "
                f"{out_diff} outputs differ from the JAX package's")
        out[name] = {"splits_identical": True, "leaves_equal": True,
                     "outputs_equal": True,
                     "max_bins": points[name]["max_bins"],
                     "hist_wide_launches": k3}
    return out


#: the GBT regressor's depth-12 group at 256 bins, one round, fitted on the
#: card and on the CPU: its first ``GBT_DEPTH12_POINTS`` grid points (the
#: scatter-add leaf sums' shape: 3 fold lanes a point x 16384 rows x 4096
#: slots; the group's 6 points took 32-40 s on the CPU)
GBT_DEPTH12_ROUNDS = 1
GBT_DEPTH12_POINTS = 2


def check_gbt_depth12_cpu(torch, x, target, masks) -> dict:
    """The GBT regressor's depth-12 grid group (its first
    ``GBT_DEPTH12_POINTS`` points x 3 fold masks) at 256 bins for
    ``GBT_DEPTH12_ROUNDS`` round on the card and on the CPU: every tree cell
    (splits and leaves) and every output equal."""
    from transmogrifai_tpu_torch.models import gbdt as G
    from transmogrifai_tpu_torch.models import leaf_sum as LS

    grid = [dict(p, max_iter=GBT_DEPTH12_ROUNDS) for p in GBT_GRID
            if p["max_depth"] == 12][:GBT_DEPTH12_POINTS]
    leaf_sums = LS.leaf_sum.launches
    card, card_s, _ = fit_family(torch, G.GBTRegressor(device=DEV), x, target,
                                 masks, grid)
    leaf_sums = LS.leaf_sum.launches - leaf_sums
    t0 = time.perf_counter()
    cpu = G.GBTRegressor(device="cpu").fit_arrays_batched_masks(
        x, target, masks, grid)
    cpu_s = time.perf_counter() - t0
    differing = 0
    for a, b in zip(stacks_of(card), stacks_of(cpu)):
        for p, q in zip(a["trees"], b["trees"]):
            differing += int((~((np.asarray(p) == np.asarray(q))
                                | (np.isnan(np.asarray(p, np.float64))
                                   & np.isnan(np.asarray(q, np.float64))))).sum())
        differing += int((a["outputs"] != b["outputs"]).sum())
    if differing or not leaf_sums:
        raise AssertionError(f"GBT depth-12 group: {differing} tree cells and "
                             f"outputs differ from the CPU's ({leaf_sums} "
                             "leaf_sum launches)")
    return {"lanes": len(grid) * len(masks), "rounds": GBT_DEPTH12_ROUNDS,
            "max_bins": REG_BINS, "differing_cells": 0,
            "leaf_sum_launches": leaf_sums, "card_s": card_s, "cpu_s": cpu_s}


def check_small_fits(torch) -> dict:
    """Fits of 4096 rows or fewer, which the card now gives K2 (the
    port's former route took the float64 one-hot GEMM pair there): an
    XGBoost fit and an RF fit of ``SMALL_ROWS`` rows of the training table
    at 32 bins over 3 fold masks on the card equal the same fits on the CPU,
    splits exactly and leaves and outputs bit for bit. Their histograms are
    then timed on the card both ways over the same launches: K2 as the
    grower runs it (each chunk's row order, then each group's histogram)
    against the former route's GEMM pair (``build_histogram_gemm``, with
    the code one-hots built outside the timed calls, once per fit as that
    route built them)."""
    from transmogrifai_tpu_torch.models import gbdt as G
    from transmogrifai_tpu_torch.models import hist as H

    x, y, _, masks = train_table(SMALL_ROWS, seed=3)
    out = {"rows": SMALL_ROWS, "features": x.shape[1], "masks": len(masks)}
    for name, (cls_name, point) in SMALL_FITS.items():
        cls = getattr(G, cls_name)
        cpu = cls(device="cpu").fit_arrays_batched_masks(x, y, masks, [point])
        records, real = [], H.build_histogram_binloop

        def hook(binned, node, g, h, m, b, order=None, real=real,
                 records=records):
            hist = real(binned, node, g, h, m, b, order=order)
            records.append((binned, node, g, h, m, b, order))
            return hist

        hook.launches = real.launches
        H.build_histogram_binloop = hook
        try:
            card = cls(device=DEV).fit_arrays_batched_masks(x, y, masks, [point])
        finally:
            real.launches = hook.launches
            H.build_histogram_binloop = real
        if not records:
            raise AssertionError(f"small fit {name}: no hist_binloop launch")
        if not same_fits(card, cpu):
            raise AssertionError(f"small fit {name}: the card's trees differ "
                                 "from the CPU's")
        one_hots = {id(r[0]): H.codes_one_hot(r[0], r[5]) for r in records}

        def via_k2():
            orders = {}
            for binned, node, g, h, m, b, order in records:
                if id(order) not in orders:
                    orders[id(order)] = H.node_order(node, m, g, h)
                H.build_histogram_binloop(binned, node, g, h, m, b,
                                          order=orders[id(order)])

        def via_gemm(lowp=name == "rf"):
            for binned, node, g, h, m, b, _ in records:
                H.build_histogram_gemm(one_hots[id(binned)], node, g, h, m, b,
                                       lowp=lowp)

        out[name] = {
            "point": point, "splits_and_leaves_equal_cpu": True,
            "histograms": len(records),
            "k2_ms": device_ms(torch, via_k2, [[]], calls=3),
            "gemm_pair_ms": device_ms(torch, via_gemm, [[]], calls=3),
        }
        del records, one_hots
    return out


def where_time_goes_train(torch, title: str, fits) -> dict:
    """A window of a training path, ``fits`` a list of (estimator class, x,
    label, masks, grid): run once to warm, once unprofiled for its wall
    time and once
    under ``torch.profiler`` for device time by kernel group (the
    profiler's own host tracing stretches that run's wall clock, so the
    busy share is taken against the unprofiled wall), with its host syncs,
    its histogram kernels' launches and the host seconds spent drawing
    bagging masks."""
    from torch.profiler import ProfilerActivity, profile

    from transmogrifai_tpu_torch.models import hist as H
    from transmogrifai_tpu_torch.models import leaf_sum as LS
    from transmogrifai_tpu_torch.models import trees as TR

    bag_s = [0.0]
    real_bag = TR._bag_masks

    def timed_bag(*a, **kw):
        s = time.perf_counter()
        try:
            return real_bag(*a, **kw)
        finally:
            bag_s[0] += time.perf_counter() - s

    def window():
        for cls, x, label, masks, grid in fits:
            cls(device=DEV).fit_arrays_batched_masks(x, label, masks, grid)
        torch.cuda.synchronize()

    def counts():
        return {**{k: hist_kernel(H, k).launches for k in HIST_WRAPPERS},
                "node_order": H.node_order.launches,
                "split_search": H.split_search.launches,
                "leaf_sum": LS.leaf_sum.launches}

    window()  # warm: the first run of a window pays one-time costs
    torch.cuda.synchronize()
    s = time.perf_counter()
    window()
    plain_wall = time.perf_counter() - s
    TR._bag_masks = timed_bag
    try:
        syncs = TR.host_syncs
        launches = counts()
        torch.cuda.synchronize()
        s = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                OrderAudit(H, LS) as audit:
            window()
        wall = time.perf_counter() - s
        syncs = TR.host_syncs - syncs
        launches = {k: v - launches[k] for k, v in counts().items()}
    finally:
        TR._bag_masks = real_bag
    groups = {"split search (split_search kernel)": ("split_search",),
              "leaf sums (leaf_sum kernel)": ("leaf_sum",),
              "K2 hist_binloop": ("hist_binloop",),
              "K3 hist_wide": ("hist_wide",),
              "row order for K2/K3 (node_order)": ("node_order",),
              "GEMM": ("gemm", "matmul", "cutlass"),
              "compaction, routing lookups (index, gather, scatter)": (
                  "index", "gather", "scatter")}
    # the kernels a row order made of torch calls (a sort, a scatter_add
    # of counts, a cumsum) would be found by, by name; the keys also catch
    # every other sort, scan or scatter_add of the window
    name_keys = ("node_order", "sort", "radix", "scan", "scatter_add")
    name_keys_ms = 0.0
    dev_ms = {g: 0.0 for g in groups}
    dev_ms["elementwise and reductions (group merge, routing)"] = 0.0
    total = 0.0
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0.0)
        if not t or getattr(evt, "device_type", None) not in (None, torch.autograd.DeviceType.CUDA):
            continue
        t = t / 1e3
        total += t
        name = evt.key.lower()
        if any(k in name for k in name_keys):
            name_keys_ms += t
        for g, keys in groups.items():
            if any(k in name for k in keys):
                dev_ms[g] += t
                break
        else:
            dev_ms["elementwise and reductions (group merge, routing)"] += t
    out = {
        "window": title,
        "wall_s": plain_wall, "wall_s_profiled": wall,
        "device_ms": dev_ms if total else "not measured",
        "device_busy_share": (total / 1e3 / plain_wall) if total else "not measured",
        "row_order_by_name_keys_ms": name_keys_ms if total else "not measured",
        "host_syncs": syncs, "bagging_draw_s": bag_s[0],
    }
    if audit.faults or audit.orders + audit.leaf_orders != launches["node_order"]:
        raise AssertionError(f"{title}: row order not shared per chunk: "
                             f"{sorted(set(audit.faults))}")
    out["node_order_launches"] = launches["node_order"]
    out["node_order_launches_of_leaf_sums"] = audit.leaf_orders
    out["histograms_per_node_order"] = audit.hists / max(audit.orders, 1)
    for kernel, group in (("hist_binloop", "K2 hist_binloop"),
                          ("hist_wide", "K3 hist_wide"),
                          ("split_search", "split search (split_search kernel)"),
                          ("leaf_sum", "leaf sums (leaf_sum kernel)")):
        out[f"{kernel}_launches"] = launches[kernel]
        out[f"{kernel}_ms_per_launch"] = (
            dev_ms[group] / launches[kernel]
            if total and launches[kernel] else "not measured")
    return out


def train_path(torch, x, y, masks) -> dict:
    """The training main path, with K2's, the split search's, the leaf
    sum's and K1's counts read around it and K2's launches and the split
    searches on some of its trees captured (``KernelCapture``,
    ``SplitCapture``)."""
    from transmogrifai_tpu_torch.models import gbdt as G
    from transmogrifai_tpu_torch.models import hist as H
    from transmogrifai_tpu_torch.models import leaf_sum as LS
    from transmogrifai_tpu_torch.models import serve_trees as ST
    from transmogrifai_tpu_torch.models import trees as TR

    H.build_histogram_binloop.launches = 0
    H.node_order.launches = 0
    H.split_search.launches = 0
    LS.leaf_sum.launches = 0
    ST.serve_trees.launches = 0
    trees = {"xgb": XGB_GRID[0]["num_round"] // 2, "rf": 0}
    with KernelCapture(H, TR, "hist_binloop", trees) as cap, \
            SplitCapture(H, TR, trees) as scap:
        cap.start("xgb")
        scap.start("xgb")
        xgb, xgb_s, xgb_syncs = fit_family(
            torch, G.XGBoostClassifier(device=DEV), x, y, masks, XGB_GRID)
        k2_xgb = H.build_histogram_binloop.launches
        split_xgb = H.split_search.launches
        cap.start("rf")
        scap.start("rf")
        rf, rf_s, rf_syncs = fit_family(
            torch, G.RandomForestClassifier(device=DEV), x, y, masks, RF_GRID)
    orders = H.node_order.launches
    splits = H.split_search.launches
    leaf_sums = LS.leaf_sum.launches
    H.split_search.launches = 0
    LS.leaf_sum.launches = 0
    if splits == 0 or split_xgb == 0 or splits == split_xgb or leaf_sums == 0:
        raise AssertionError(f"training launched split_search {split_xgb} of "
                             f"{splits} times and leaf_sum {leaf_sums} times")
    with K1Capture(ST) as k1cap:
        k1cap.family = "xgb"
        xgb_score = check_lanes_score(x, xgb, boosted=True)
        k1cap.family = "rf"
        rf_score = check_lanes_score(x, rf, boosted=False)
    k2 = H.build_histogram_binloop.launches
    k1 = ST.serve_trees.launches
    H.build_histogram_binloop.launches = 0
    H.node_order.launches = 0
    ST.serve_trees.launches = 0
    if k2 == 0 or k2_xgb == 0 or k2 == k2_xgb:
        raise AssertionError(f"training did not launch hist_binloop in both "
                             f"families ({k2_xgb} of {k2})")
    if k1 == 0:
        raise AssertionError("scoring the fitted lanes never launched serve_trees")
    again, again_s, _ = fit_family(torch, G.XGBoostClassifier(device=DEV),
                                   x, y, masks, XGB_GRID)
    H.build_histogram_binloop.launches = 0
    if not same_fits(xgb, again):
        raise AssertionError("a second XGBoost fit is not bit-identical")
    return {
        "rows": TRAIN_ROWS, "features": x.shape[1],
        "xgb": {"lanes": len(XGB_GRID) * 3, "seconds": xgb_s,
                "seconds_refit": again_s, "host_syncs": xgb_syncs,
                "hist_binloop_launches": k2_xgb, "scoring": xgb_score},
        "rf": {"lanes": len(RF_GRID) * 3, "groups": len(stacks_of(rf)),
               "seconds": rf_s, "host_syncs": rf_syncs,
               "hist_binloop_launches": k2 - k2_xgb, "scoring": rf_score},
        "hist_binloop_launches": k2, "node_order_launches": orders,
        "split_search_launches": splits,
        "split_search_launches_by_family": {"xgb": split_xgb,
                                            "rf": splits - split_xgb},
        "leaf_sum_launches": leaf_sums,
        "serve_trees_launches_scoring": k1,
        "refit_bit_identical": True,
        "_records": cap.records, "_k1_records": k1cap.records,
        "_split_records": scap.records,
    }


class OrderAudit:
    """Follows the grower's calls of ``node_order`` and of the histogram
    wrappers in order: every histogram must be given the row order of the
    last ``node_order`` call, made over the same slot tensor, and every
    ``node_order`` call must serve at least one histogram, except the one
    each leaf sum makes inside its own call (``leaf_orders``). It adds no
    launch (each hook calls its wrapper once and keeps its count)."""

    NAMES = ("node_order", *HIST_WRAPPERS.values())

    def __init__(self, H, LS):
        self.H, self.LS = H, LS
        self.real = {name: getattr(H, name) for name in self.NAMES}
        self.real_leaf = LS.leaf_sum
        self.orders = self.hists = self.leaf_orders = 0
        self.faults: list[str] = []
        self._last = None  # (slot tensor, histograms served)
        self._in_leaf_sum = False

    def _order_hook(self):
        def hook(node, m, g, h):
            if self._in_leaf_sum:
                self.leaf_orders += 1
                return self.real["node_order"](node, m, g, h)
            self._close()
            self.orders += 1
            out = self.real["node_order"](node, m, g, h)
            self._last = [node, out, 0]
            return out
        return hook

    def _leaf_hook(self):
        def hook(g, h, idx, size):
            self._in_leaf_sum = True
            try:
                return self.real_leaf(g, h, idx, size)
            finally:
                self._in_leaf_sum = False
        return hook

    def _hist_hook(self, name):
        def hook(binned, node, g, h, m, b, order=None):
            self.hists += 1
            last = self._last
            if last is None or node is not last[0] or order is not last[1]:
                self.faults.append(f"{name} without its chunk's order")
            else:
                last[2] += 1
            return self.real[name](binned, node, g, h, m, b, order=order)
        return hook

    def _close(self):
        if self._last is not None and self._last[2] == 0:
            self.faults.append("a node_order call served no histogram")

    def __enter__(self):
        hooks = {"node_order": self._order_hook(),
                 **{n: self._hist_hook(n) for n in HIST_WRAPPERS.values()}}
        for name, hook in hooks.items():
            hook.launches = self.real[name].launches
            setattr(self.H, name, hook)
        leaf = self._leaf_hook()
        leaf.launches = self.real_leaf.launches
        self.LS.leaf_sum = leaf
        return self

    def __exit__(self, *exc):
        self._close()
        for name, real in self.real.items():
            real.launches = getattr(self.H, name).launches
            setattr(self.H, name, real)
        self.real_leaf.launches = self.LS.leaf_sum.launches
        self.LS.leaf_sum = self.real_leaf
        return False


def same_fits(models, again) -> bool:
    """Every stack of two batched fits equal bit for bit, trees and outputs."""
    pairs = list(zip(stacks_of(models), stacks_of(again)))
    return bool(pairs) and all(
        all(np.array_equal(p, q, equal_nan=True)
            for p, q in zip(a["trees"], b["trees"]))
        and np.array_equal(a["outputs"], b["outputs"])
        for a, b in pairs
    )


def train_regression_path(torch, x, target, masks) -> dict:
    """The regression training path at a 256-bin sketch: GBT and the
    random forest at the regression selector's grids over the table's
    continuous target, with K3's, K2's and K1's counts read around it and
    K3's and K2's launches and the split searches on the middle GBT round
    and the first forest tree of each depth group captured
    (``KernelCapture``, ``SplitCapture``); the split search's and the leaf
    sum's counts are read around the fits too."""
    from transmogrifai_tpu_torch.models import gbdt as G
    from transmogrifai_tpu_torch.models import hist as H
    from transmogrifai_tpu_torch.models import leaf_sum as LS
    from transmogrifai_tpu_torch.models import serve_trees as ST
    from transmogrifai_tpu_torch.models import trees as TR

    H.build_histogram_wide.launches = 0
    H.build_histogram_binloop.launches = 0
    H.node_order.launches = 0
    H.split_search.launches = 0
    LS.leaf_sum.launches = 0
    ST.serve_trees.launches = 0
    out, fitted = {}, {}
    trees = {"gbt": GBT_GRID[0]["max_iter"] // 2, "rfr": 0}
    with KernelCapture(H, TR, "hist_wide", trees) as cap, \
            KernelCapture(H, TR, "hist_binloop", trees) as cap2, \
            SplitCapture(H, TR, trees) as scap:
        for family, cls, grid in (("gbt", G.GBTRegressor, GBT_GRID),
                                  ("rfr", G.RandomForestRegressor, RFR_GRID)):
            cap.start(family)
            cap2.start(family)
            scap.start(family)
            k3 = H.build_histogram_wide.launches
            k2 = H.build_histogram_binloop.launches
            ss = H.split_search.launches
            ls = LS.leaf_sum.launches
            models, secs, syncs = fit_family(torch, cls(device=DEV), x, target,
                                             masks, grid)
            k3 = H.build_histogram_wide.launches - k3
            k2 = H.build_histogram_binloop.launches - k2
            ss = H.split_search.launches - ss
            ls = LS.leaf_sum.launches - ls
            if k3 == 0 or k2 == 0 or ss == 0 or ls == 0:
                raise AssertionError(
                    f"{family}: the wide group took {k3} hist_wide launches, "
                    f"the indicators {k2} hist_binloop launches, the split "
                    f"search {ss} and the leaf sums {ls}; all must run")
            fitted[family] = models
            out[family] = {"lanes": len(grid) * len(masks),
                           "groups": len(stacks_of(models)), "seconds": secs,
                           "host_syncs": syncs, "hist_wide_launches": k3,
                           "hist_binloop_launches": k2,
                           "split_search_launches": ss,
                           "leaf_sum_launches": ls}
    k3 = H.build_histogram_wide.launches
    k2 = H.build_histogram_binloop.launches
    orders = H.node_order.launches
    splits = H.split_search.launches
    leaf_sums = LS.leaf_sum.launches
    H.split_search.launches = 0
    LS.leaf_sum.launches = 0
    with K1Capture(ST) as k1cap:
        for family, models in fitted.items():
            k1cap.family = family
            out[family]["scoring"] = check_lanes_score(
                x, models, boosted=family == "gbt", regression=True)
    k1 = ST.serve_trees.launches
    if k1 == 0:
        raise AssertionError("scoring the regression lanes never launched "
                             "serve_trees")
    H.build_histogram_wide.launches = 0
    H.build_histogram_binloop.launches = 0
    H.node_order.launches = 0
    ST.serve_trees.launches = 0
    again, again_s, _ = fit_family(torch, G.GBTRegressor(device=DEV), x, target,
                                   masks, GBT_GRID)
    H.build_histogram_wide.launches = 0
    H.build_histogram_binloop.launches = 0
    H.node_order.launches = 0
    if not same_fits(fitted["gbt"], again):
        raise AssertionError("a second GBT fit is not bit-identical")
    out["gbt"]["seconds_refit"] = again_s
    return {
        "rows": x.shape[0], "features": x.shape[1], "max_bins": REG_BINS,
        **out,
        "hist_wide_launches": k3, "hist_binloop_launches": k2,
        "node_order_launches": orders, "split_search_launches": splits,
        "leaf_sum_launches": leaf_sums,
        "serve_trees_launches_scoring": k1, "refit_bit_identical": True,
        "_records": cap.records, "_records_k2": cap2.records,
        "_k1_records": k1cap.records, "_split_records": scap.records,
    }


def best_split_inputs(n, f, b, k, m, seed: int):
    """CPU tensors for K4, from a seeded numpy generator as the reference's
    test makes them (``tests/test_hist_pallas.py:72-122``): codes, slots in
    [-1, M), grad, hess, a feature mask with feature 0 off in fit 1, and
    per-fit lambda, gamma and min child weight."""
    import torch

    rng = np.random.default_rng(seed)
    fmask = np.ones((k, f), np.float32)
    fmask[1 % k, 0] = 0.0
    cycle = lambda v: np.resize(np.float32(v), k)  # noqa: E731
    arrays = (
        rng.integers(0, b, (n, f)).astype(np.int32),
        rng.integers(-1, m, (k, n)).astype(np.int32),
        rng.normal(size=(k, n)).astype(np.float32),
        rng.uniform(0.1, 1, (k, n)).astype(np.float32),
        fmask, cycle([1.0, 0.5, 0.0]), cycle([0.0, 0.1, 0.0]),
        cycle([1.0, 1.0, 2.0]),
    )
    return [torch.from_numpy(a) for a in arrays]


#: operations per (slot, feature, threshold) of the gain: 2 subtractions,
#: 3 squares, 3 denominators, 3 divides, the sum, the 0.5 and gamma, and 2
#: compares; and per (slot, feature, bin) 2 prefix and 2 total adds
GAIN_OPS, SCAN_OPS = 16, 4


def best_split_bound(torch, binned, node, g, h, m, b) -> tuple[float, str]:
    """(bound ms, "bytes" or "operations"): the codes of rows live in some
    fit, node/grad/hess, the mask and knobs read once and the [K, M]
    results written once over the memory rate; the histogram's 2 adds per
    live (fit, row, feature) and the scan and gains of every (fit, slot)
    that holds a live row over the scalar rate."""
    n, f = binned.shape
    k = node.shape[0]
    live = (node >= 0) & (node < m) & ((g != 0) | (h != 0))
    slots = torch.zeros((k, m), dtype=torch.bool, device=node.device)
    slots[torch.nonzero(live)[:, 0], node[live].long()] = True
    nbytes = (int(live.any(dim=0).sum()) * f * 4 + 3 * k * n * 4 + k * f * 4
              + 3 * k * 4 + 3 * k * m * 4)
    ops = (2 * f * int(live.sum())
           + int(slots.sum()) * f * (GAIN_OPS * (b - 1) + SCAN_OPS * b))
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_best_split(torch, H, name, n, f, b, k, m, seed: int) -> dict:
    """K4 on the card against its plain version on the CPU over copies of
    the same inputs, bit for bit, and a relaunch bit-identical; timed whole
    (``ms``: its row order and its kernel), against its plain version on the
    card (``plain_ms``: the scatter histogram and ``split_search_plain``)
    and against the two-phase route on the same inputs (``two_phase_ms``:
    the row order, the histogram kernel the policy picks, K2 or K3, then the
    split-search kernel)."""
    cpu = best_split_inputs(n, f, b, k, m, seed)
    args = [a.to(DEV) for a in cpu]
    binned, node, g, h, fmask, lam, gam, mcw = args
    got = H.build_best_split(*args, m, b)
    again = H.build_best_split(*args, m, b)
    want = H.best_split_plain(*cpu, m, b)
    torch.cuda.synchronize()
    label = f"best_split {name}"
    if not all(torch.equal(p, q) for p, q in zip(got, again)):
        raise AssertionError(f"{label}: two launches differ")
    if not all(same_values(torch, p.cpu(), q) for p, q in zip(got, want)):
        bad = int(((got[1].cpu() != want[1]) | (got[2].cpu() != want[2])).sum())
        raise AssertionError(f"{label}: {bad} slots differ from the plain "
                             "version's")
    route = H.histogram_route(binned.device, b)
    cold = l2_cold_copies(args, binned.numel() * 4 + 12 * node.numel())

    def fused(*a):
        return H.build_best_split(*a, m, b)

    def two_phase(binned, node, g, h, fmask, lam, gam, mcw):
        order = H.node_order(node, m, g, h)
        hist = hist_kernel(H, f"hist_{route}")(binned, node, g, h, m, b,
                                               order=order)
        return H.split_search(hist, fmask, lam, gam, mcw, count=order[2])

    def plain(*a):
        return H.best_split_plain(*a, m, b)

    bound, by = best_split_bound(torch, binned, node, g, h, m, b)
    out = {
        "shape": {"N": n, "F": f, "B": b, "K": k, "M": m},
        "bit_identical_to_cpu_plain": True, "max_abs_err": 0.0,
        "bit_identical_relaunch": True,
        "no_valid_split_slots": int((got[1] == -1).sum()),
        "launches_per_call": kernels_per_call(torch, fused, cold[0]),
        "ms": device_ms(torch, fused, cold),
        "two_phase_ms": device_ms(torch, two_phase, cold),
        "two_phase_route": f"row order + {route} histogram + split_search "
                           "kernel",
        "plain_ms": device_ms(torch, plain, cold, calls=2),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "arg_copies": len(cold),
    }
    del cold
    return out


#: split-search shapes: (K, M, F, B, share of empty slots). (a) the
#: classifiers' indicator group at a 64-slot chunk (6 lanes); (b) their
#: continuous group at 32 bins; (c) the regression path's 256-bin group at
#: its 256-slot chunk (18 lanes), a deep level with half the slots empty;
#: (d) the regression indicators at that chunk; untimed (e) ragged, 300
#: bins (the blocked prefix recurses) and (f) 4500 bins (three levels)
SPLIT_SHAPES = {
    "a_narrow": (6, 64, 918, 2, 0.0),
    "b_cont32": (6, 64, 10, 32, 0.0),
    "c_wide256": (18, 256, 10, 256, 0.5),
    "d_reg_narrow": (18, 256, 918, 2, 0.5),
    "e_ragged_300": (3, 5, 7, 300, 0.4),
    "f_4500": (2, 3, 2, 4500, 0.3),
}
#: operations per (slot, feature, threshold) of the split stage's gain
#: (GAIN_OPS, below) and per (slot, feature, bin) of its prefix and total
SPLIT_SCAN_OPS = 4


def split_inputs(torch, k, m, f, b, empty: float, seed: int):
    """Card tensors of a split search: a histogram [K, M, F, B, 2] of sums
    of a few rows (hess >= 0, some cells empty), a share ``empty`` of the
    slots all zero with count 0, a feature mask with holes, per-fit knobs
    (lambda 1 and 0, so that empty slots meet 0/0)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    shape = (k, m, f, b)
    rows = torch.randint(1, 6, shape, generator=gen, device=DEV).float()
    g = torch.randn(shape, generator=gen, device=DEV) * rows
    h = torch.rand(shape, generator=gen, device=DEV) * rows
    h = torch.where(torch.rand(shape, generator=gen, device=DEV) < 0.3, 0.0, h)
    hist = torch.stack([g, h], dim=-1)
    slot_empty = torch.rand((k, m), generator=gen, device=DEV) < empty
    hist[slot_empty] = 0.0
    count = torch.where(slot_empty, 0, torch.randint(
        1, 100, (k, m), generator=gen, device=DEV)).to(torch.int32)
    gmask = (torch.rand((k, f), generator=gen, device=DEV) < 0.8).float()
    gmask[0, 0] = 1.0
    lam = torch.tensor([1.0, 0.0] * k, device=DEV)[:k].contiguous()
    gam = torch.tensor([0.0, 0.1, 0.0] * k, device=DEV)[:k].contiguous()
    mcw = torch.tensor([1.0, 0.0, 10.0] * k, device=DEV)[:k].contiguous()
    return [hist.contiguous(), gmask, lam, gam, mcw, count]


def split_bound_ms(hist, count) -> tuple[float, str]:
    """The split search reads the histogram of the slots that hold a row
    (all of them without ``count``) and the count, and writes 12 bytes per
    (fit, slot); its gains take ``GAIN_OPS`` operations per threshold and
    the prefix and total ``SPLIT_SCAN_OPS`` per bin of those slots."""
    k, m, f, b, _ = hist.shape
    live = k * m if count is None else int((count != 0).sum())
    nbytes = live * f * b * 8 + 12 * k * m + (0 if count is None else 4 * k * m)
    ops = live * f * (GAIN_OPS * (b - 1) + SPLIT_SCAN_OPS * b)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def kernels_per_call(torch, fn, args, calls: int = 4) -> float:
    """Device kernels (and copies) per call of ``fn(*args)``, counted by
    ``torch.profiler`` over ``calls`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    seen = sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return seen / calls


def check_split(torch, H, name, args, want=None, timed: bool = True,
                cpu_check: bool = True) -> dict:
    """The split-search kernel on ``args`` (hist, gmask, lam, gam, mcw,
    count) against its plain version on the card and, with ``cpu_check``,
    on the CPU, bit for bit (NaN where the other has NaN), and against the
    main path's own result ``want`` where given; one launch per call; with
    ``timed`` its device time, the plain version's and the bound."""
    hist, gmask, lam, gam, mcw, count = args
    before = H.split_search.launches
    got = H.split_search(hist, gmask, lam, gam, mcw, count=count)
    if H.split_search.launches != before + 1:
        raise AssertionError(f"split_search {name}: not one launch")
    plain = H.split_search_plain(hist, gmask, lam, gam, mcw, count)
    torch.cuda.synchronize()
    checks = [plain] + ([want] if want is not None else [])
    if cpu_check:
        checks.append(H.split_search_plain(*(a.cpu() for a in args[:5]),
                                           None if count is None else count.cpu()))
    for other in checks:
        if not all(same_values(torch, x.cpu(), y.cpu())
                   for x, y in zip(got, other)):
            bad = int((got[1].cpu() != other[1].cpu()).sum())
            raise AssertionError(f"split_search {name}: kernel != plain "
                                 f"version ({bad} features)")
    k, m, f, b, _ = hist.shape
    out = {"shape": {"K": k, "M": m, "F": f, "B": b},
           "empty_slots": None if count is None else int((count == 0).sum()),
           "bit_identical": True, "cpu_checked": cpu_check,
           "max_abs_err": 0.0}
    if timed:
        bound, by = split_bound_ms(hist, count)
        cold = l2_cold_copies(list(args), hist.numel() * 4)

        def kernel(*a):
            return H.split_search(*a[:5], count=a[5])

        def plain_fn(*a):
            return H.split_search_plain(*a)

        out.update({
            "launches_per_call": kernels_per_call(torch, kernel, cold[0]),
            "ms": device_ms(torch, kernel, cold),
            "ms_source": device_ms.last_source,
            "wrapper_ms": time_ms(torch, kernel, cold, reps=5, rounds=5),
            "plain_ms": time_ms(torch, plain_fn, cold, reps=2, rounds=3),
            "plain_launches_per_call": kernels_per_call(torch, plain_fn,
                                                        cold[0], calls=1),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "arg_copies": len(cold),
        })
        del cold
    return out


class SplitCapture(KernelCapture):
    """Records the split search's calls on chosen trees of a training path
    (``KernelCapture``'s trees): its inputs and the result the grower got.
    It adds no launch."""

    def __init__(self, H, TR, trees: dict[str, int]):
        self.H, self.TR = H, TR
        self.attr = "split_search"
        self.kernel = H.split_search
        self.grow = TR._grow_tree_impl
        self.trees = trees
        self.family = None
        self.records: list[dict] = []
        self._grown: dict[int, int] = {}
        self._tree = None

    def __enter__(self):
        def split_hook(hist, gmask, lam, gam, mcw, count=None):
            out = self.kernel(hist, gmask, lam, gam, mcw, count=count)
            if self._tree is not None:
                label, syncs = self._tree
                self.records.append({
                    "family": self.family, "tree": label,
                    "level": self.TR.host_syncs - syncs - 1,
                    "args": [hist, gmask, lam, gam, mcw, count], "out": out})
            return out

        split_hook.launches = self.kernel.launches
        self.TR._grow_tree_impl = self._grow_hook
        self.H.split_search = split_hook
        return self


def check_split_launches(torch, H, records, weights: dict,
                         timed_every: int = 1) -> dict:
    """Each captured split search of a training path relaunched against its
    plain version and the path's own result (the first of each tree also
    against the CPU's plain version); the first call of each tree and every
    ``timed_every``-th call timed; the means weighted by how often each
    tree recurs on the path (``weights``), as K2's are."""
    rows, seen = [], set()
    for i, rec in enumerate(records):
        hist = rec["args"][0]
        k, m, f, b, _ = hist.shape
        first = rec["tree"] not in seen
        seen.add(rec["tree"])
        row = {"tree": rec["tree"], "level": rec["level"], "K": k, "M": m,
               "F": f, "B": b, "weight": weights[rec["family"]],
               **check_split(torch, H, f"{rec['tree']} level {rec['level']} "
                             f"B={b}", rec["args"], want=rec["out"],
                             timed=first or i % timed_every == 0,
                             cpu_check=first)}
        rows.append(row)
        rec["out"] = rec["args"] = None
    if not rows:
        raise AssertionError("no split_search call of the training path was "
                             "captured")
    timed_rows = [r for r in rows if "ms" in r]

    def mean(key):
        return (sum(r["weight"] * r[key] for r in timed_rows)
                / sum(r["weight"] for r in timed_rows))

    return {
        "basis": "mean per timed call (the first of each tree and every "
                 f"{timed_every}th), each call weighted by how often its tree "
                 "recurs on the path",
        "weights": weights, "captured_calls": len(rows),
        "timed_calls": len(timed_rows),
        "estimated_path_calls": sum(r["weight"] for r in rows),
        "launches_per_call": max(r["launches_per_call"] for r in timed_rows),
        **{key: mean(key) for key in ("ms", "wrapper_ms", "plain_ms",
                                      "bound_ms")},
        "ms_over_bound": mean("ms") / mean("bound_ms"),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                   for r in timed_rows) else "operations",
        "ms_sources": source_counts(timed_rows, "ms_source"),
        "max_abs_err": 0.0, "bit_identical": True,
        "calls": rows,
    }


#: leaf-sum shapes: (K, N, slots, share of rows in one slot). The grower's
#: depth-12 leaves at 16384 rows and 18 fits (the RF and GBT depth-12
#: groups), (a) rows spread over the slots, (b) 90% of them in one (a late
#: boosting round); untimed (c) ragged
LEAF_SHAPES = {
    "a_spread": (18, 16384, 4096, 0.0),
    "b_crowded": (18, 16384, 4096, 0.9),
    "c_ragged": (3, 30001, 600, 0.5),
}


def leaf_inputs(torch, k, n, size, crowded: float, seed: int):
    """Card tensors of a leaf sum: grad-like g (a fifth exact zeros), h >=
    0 and slots, a share ``crowded`` of the rows in slot 7."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    g = torch.randn((k, n), generator=gen, device=DEV)
    g = torch.where(torch.rand((k, n), generator=gen, device=DEV) < 0.2, 0.0, g)
    h = torch.rand((k, n), generator=gen, device=DEV)
    idx = torch.randint(0, size, (k, n), generator=gen, device=DEV)
    idx = torch.where(torch.rand((k, n), generator=gen, device=DEV) < crowded,
                      7, idx).to(torch.int32)
    return [g, h, idx]


def leaf_bound_ms(k, n, size) -> tuple[float, str]:
    """The leaf sum reads slots, g and h once (12 bytes per row and fit)
    and writes 8 bytes per (fit, slot); it adds 2 values per row."""
    by_bytes = (12 * k * n + 8 * k * size) / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * k * n / SCALAR_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_leaf_sum(torch, H, LS, name, args, size, timed: bool) -> dict:
    """The leaf-sum kernel against its plain version on the CPU bit for bit
    (the plain version on the card, an ``index_add_`` per fit, adds a
    slot's rows with atomics in another order: its differing cells are
    reported); with
    ``timed`` its device time with the row order made inside the call
    (``ms``) and given it (``kernel_only_ms``), the plain version's on the
    card, one ``index_put_(accumulate=True)`` of both arrays (the library
    call) and the bound."""
    g, h, idx = args
    k, n = idx.shape
    got = LS.leaf_sum(g, h, idx, size)
    cpu = LS.leaf_sum_plain(g.cpu(), h.cpu(), idx.cpu(), size)
    card_plain = LS.leaf_sum_plain(g, h, idx, size)
    torch.cuda.synchronize()
    for x, y in zip(got, cpu):
        if not torch.equal(x.cpu(), y):
            raise AssertionError(f"leaf_sum {name}: kernel != plain version "
                                 f"({int((x.cpu() != y).sum())} cells)")
    largest = max(int(torch.bincount(r.long(), minlength=size).max())
                  for r in idx)
    out = {"shape": {"K": k, "N": n, "slots": size},
           "largest_slot_rows": largest, "bit_identical_to_cpu": True,
           "max_abs_err": 0.0,
           "card_plain_differing_cells": sum(
               int((x != y).sum()) for x, y in zip(got, card_plain))}
    if timed:
        bound, by = leaf_bound_ms(k, n, size)
        cold = l2_cold_copies(list(args), 12 * k * n)
        ordered = [a + [H.node_order(a[2], size, a[0], a[1])] for a in cold]
        lib = LS._library()
        lane = torch.arange(k, device=DEV)[:, None].expand(k, n)

        def kernel(*a):
            return LS.leaf_sum(*a, size)

        def kernel_only(g_, h_, idx_, order):
            rows, start, count = order
            out_g = torch.empty((k, size), device=DEV)
            out_h = torch.empty_like(out_g)
            lib.tp_leaf_sum(rows.data_ptr(), start.data_ptr(), count.data_ptr(),
                            g_.data_ptr(), h_.data_ptr(), out_g.data_ptr(),
                            out_h.data_ptr(), n, k, size,
                            torch.cuda.current_stream().cuda_stream)
            return out_g, out_h

        def plain(*a):
            return LS.leaf_sum_plain(*a, size)

        def library(g_, h_, idx_):
            out2 = torch.zeros((k, size, 2), device=DEV)
            return out2.index_put_((lane, idx_.long()),
                                   torch.stack([g_, h_], dim=-1),
                                   accumulate=True)

        out.update({
            "ms": device_ms(torch, kernel, cold),
            "kernel_only_ms": device_ms(torch, kernel_only, ordered),
            "order_ms": device_ms(torch, lambda g_, h_, i_: H.node_order(
                i_, size, g_, h_), cold),
            "plain_ms": device_ms(torch, plain, cold, calls=4),
            "library_ms": device_ms(torch, library, cold, calls=4),
            "bound_ms": bound, "bound_by": by, "arg_copies": len(cold),
        })
        del cold, ordered
    return out


class LeafCapture:
    """Records the first leaf-sum call of each (path, K, N, slots) group,
    with how many calls each group makes. It adds no launch."""

    def __init__(self, LS):
        self.LS = LS
        self.real = LS.leaf_sum
        self.path = None
        self.records: dict[tuple, dict] = {}

    def __enter__(self):
        def hook(g, h, idx, size):
            key = (self.path, *idx.shape, size)
            rec = self.records.get(key)
            if rec is None:
                self.records[key] = {"args": [g.clone(), h.clone(), idx.clone()],
                                     "size": size, "count": 1}
            else:
                rec["count"] += 1
            return self.real(g, h, idx, size)

        hook.launches = self.real.launches
        self.LS.leaf_sum = hook
        return self

    def __exit__(self, *exc):
        self.real.launches = self.LS.leaf_sum.launches
        self.LS.leaf_sum = self.real
        return False


def check_leaf_path(torch, H, LS, records: dict) -> dict:
    """Each captured leaf-sum group relaunched against the CPU's plain
    version and timed; the means weighted by each group's calls."""
    rows = []
    for (path, k, n, size), rec in records.items():
        rows.append({"path": path, "weight": rec["count"], **check_leaf_sum(
            torch, H, LS, f"{path} K={k} N={n} S={size}", rec["args"], size,
            timed=True)})
    records.clear()
    if not rows:
        raise AssertionError("no leaf_sum call of the training paths was "
                             "captured")
    total = sum(r["weight"] for r in rows)
    return {
        "basis": "mean per call, each captured call weighted by the calls of "
                 "its (path, K, N, slots) group",
        "launches": total,
        **{key: sum(r["weight"] * r[key] for r in rows) / total
           for key in ("ms", "kernel_only_ms", "order_ms", "plain_ms",
                       "library_ms", "bound_ms")},
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
        else "operations",
        "max_abs_err": 0.0, "captured": rows,
    }


FIT_SIDE = os.path.join(ROOT, "tests", "fixtures", "torch_fit_side")
#: the fit side's statistics against the JAX package's stored ones, per
#: route (label correlations absolute, means and variances relative to
#: their magnitude where it exceeds 1), as the CPU tests hold them (tests/test_torch_fit_side.py,
#: tests/test_torch_sanity_checker.py): torch and numpy reduce in other
#: orders on the float64 route; the float32 route's gram is XLA's on the CPU
FIT_STATS_ATOL = {"float64": 1e-12, "float32": 2e-5}
#: the xgb serving fixture's grid point (make_serving_fixtures.py)
TO_TRAIN_POINT = {"num_round": 200, "eta": 0.02, "gamma": 0.8,
                  "max_depth": 10, "min_child_weight": 1.0, "max_bins": 32}


def fit_side_flow(ds, response: str, device):
    """The flagship flow's feature side through the port's entry points:
    (vector column, checked column, the SanityChecker's summary, the fitted
    stages)."""
    from transmogrifai_tpu_torch.features import from_dataset
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.workflow.fit import fit_and_transform_dag

    resp, preds = from_dataset(ds, response=response)
    vec = transmogrify(preds)
    checked = resp.sanity_check(vec, remove_bad_features=True, device=device)
    data, fitted = fit_and_transform_dag(ds, [checked])
    summary = fitted[checked.origin_stage.uid].metadata["sanityCheckerSummary"]
    return data[vec.name], data[checked.name], summary, fitted


def keep_and_reasons(summary) -> tuple[list[int], dict]:
    cols = summary["columns"]
    return ([j for j, c in enumerate(cols) if not c["dropped"]],
            {str(j): c["reasons"] for j, c in enumerate(cols) if c["dropped"]})


def check_fit_fixture(name: str, vec, summary, route: str) -> dict:
    """Hold a fit-side run to what the JAX package stored for ``name``:
    vector bit for bit and metadata column for column (where stored),
    keep-set, reasons and column names equal, statistics within the
    route's tolerance. Returns the largest statistic differences and
    ``vector_checked``: whether the fixture stores the vector (the wide
    table's stores its keep-set only), so whether the vector was held."""
    with open(os.path.join(FIT_SIDE, f"{name}.json")) as fh:
        want = json.load(fh)
    arrays = np.load(os.path.join(FIT_SIDE, f"{name}.npz"))
    if "vector" in arrays.files:
        if not np.array_equal(vec.values, arrays["vector"]):
            raise AssertionError(f"fit_side {name}: the vector differs from "
                                 "the JAX package's")
        got_meta = [{k: (list(v) if isinstance(v, tuple) else v)
                     for k, v in c.to_json().items()}
                    for c in vec.metadata.columns]
        if got_meta != want["metadata"]:
            raise AssertionError(f"fit_side {name}: vector metadata differs")
    keep, reasons = keep_and_reasons(summary)
    if keep != want["keep"] or reasons != want["reasons"]:
        raise AssertionError(f"fit_side {name}: keep-set or drop reasons "
                             "differ from the JAX package's")
    if [c["name"] for c in summary["columns"]] != want["names"]:
        raise AssertionError(f"fit_side {name}: column names differ")
    errs = {}
    for key in ("mean", "variance", "corr_label"):
        got = np.array([c[key] for c in summary["columns"]], dtype=np.float64)
        ref = arrays[key]
        if key == "corr_label":
            err = float(np.nanmax(np.abs(got - ref)))
        else:  # relative to the magnitude where it exceeds 1
            err = float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)))
        if not err <= FIT_STATS_ATOL[route]:
            raise AssertionError(f"fit_side {name}: {key} off by {err} "
                                 f"(tolerance {FIT_STATS_ATOL[route]})")
        errs[key] = err
    return {"columns": len(keep) + len(reasons), "kept": len(keep),
            "vector_checked": "vector" in arrays.files,
            "stats_max_err": errs, "stats_tolerance": FIT_STATS_ATOL[route],
            "route": route}


def fit_side_flagship(torch, smi: str) -> tuple[dict, np.ndarray, np.ndarray]:
    """The 891-row typed twin (stored by the fixture generator) and the CSV
    twin through the feature side on the card, each held to the JAX
    package's stored results; then the JAX-saved model with a
    ``SmartTextModel`` stage scores its stored rows on the card. Returns
    (phase fields, the typed twin's checked vector, its label)."""
    from transmogrifai_tpu_torch import load_workflow_model, score_function
    from transmogrifai_tpu_torch import types as PT
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.readers import infer_csv_dataset
    from transmogrifai_tpu_torch.types.columns import column_from_values

    with open(os.path.join(FIT_SIDE, "flagship_table.json")) as fh:
        table = json.load(fh)
    typed = Dataset.of({
        k: column_from_values(PT.feature_type_by_name(table["schema"][k]), v)
        for k, v in table["columns"].items()})
    out = {"card": smi}
    checked_x = None
    for name, load, response in (
            ("flagship", lambda: typed, "label"),
            ("csv", lambda: infer_csv_dataset(
                os.path.join(FIT_SIDE, "titanic_twin.csv")), "survived")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ds = load()
        vec, checked, summary, _ = fit_side_flow(ds, response, None)
        torch.cuda.synchronize()
        row = check_fit_fixture(name, vec, summary, "float64")
        row["host_s"] = time.perf_counter() - t0
        row["rows"], row["vector_columns"] = vec.values.shape
        out[name] = row
        if name == "flagship":
            checked_x = np.asarray(checked.values, dtype=np.float32)
    path = os.path.join(FIT_SIDE, "csv_model")
    model = load_workflow_model(path)
    if "SmartTextModel" not in {type(s).__name__ for s in model.fitted.values()}:
        raise AssertionError("csv_model holds no SmartTextModel stage")
    with open(os.path.join(path, "rows.json")) as fh:
        rows = json.load(fh)
    scored = score_function(model).batch(rows)
    want = np.load(os.path.join(path, "expected.npz"))
    label = model.result_features[0].name
    prob = np.array([[r[label]["probability_0"], r[label]["probability_1"]]
                     for r in scored])
    if not np.array_equal(prob, want["probability"]):
        raise AssertionError("csv_model: the card's scores differ from the "
                             "JAX package's")
    out["csv_model"] = {"rows": len(rows), "scores_equal_jax": True}
    y = np.asarray(typed["label"].values, dtype=np.float32)
    return out, checked_x, y


def stats_device_ms(torch, fit, sessions: int = 3) -> dict:
    """Device time of one SanityChecker fit on the card from
    ``torch.profiler`` (every kernel and copy it launched, summed), with
    the five largest by name. The profiler can miss activities, so the fit
    is profiled ``sessions`` times and the session that saw the most
    activities is read (the count of each is reported); CUDA events around
    one call if no session recorded device time."""
    from torch.profiler import ProfilerActivity, profile

    fit()
    torch.cuda.synchronize()
    best, seen = None, []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fit()
            torch.cuda.synchronize()
        rows = [(evt.key, evt.self_device_time_total / 1e3, evt.count)
                for evt in prof.key_averages()
                if evt.device_type == torch.autograd.DeviceType.CUDA
                and evt.count]
        seen.append(sum(c for _, _, c in rows))
        if best is None or seen[-1] > sum(c for _, _, c in best):
            best = rows
    total = sum(ms for _, ms, _ in best)
    if total > 0:
        top = sorted(best, key=lambda r: -r[1])[:5]
        return {"device_ms": total, "source": "profiler",
                "activities_per_session": seen,
                "top": [{"name": k[:80], "ms": ms, "count": c}
                        for k, ms, c in top]}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fit()
    end.record()
    torch.cuda.synchronize()
    return {"device_ms": start.elapsed_time(end), "source": "cuda_events",
            "activities_per_session": seen}


def fit_side_wide(torch, smi: str) -> dict:
    """The full-width table (``tests/torch_fixtures/fit_side_tables.py``:
    16384 rows, 1423 vector columns, the float32 statistics route): host
    seconds of the transmogrify fit and transform and of the
    SanityChecker's fit on the card, the stats' device time, then the flow
    through ``fit_and_transform_dag`` on the card and on the CPU: vectors
    and keep-sets equal bit for bit, and the keep-set and reasons equal to
    the JAX package's stored ones."""
    sys.path.insert(0, os.path.join(ROOT, "tests", "torch_fixtures"))
    from fit_side_tables import wide_table

    from transmogrifai_tpu_torch import types as PT
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.features import from_dataset
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.stages.base import Estimator
    from transmogrifai_tpu_torch.types.columns import column_from_values
    from transmogrifai_tpu_torch.workflow.dag import compute_dag

    t0 = time.perf_counter()
    schema, columns = wide_table()
    ds = Dataset.of({
        k: column_from_values(PT.feature_type_by_name(schema[k]), v)
        for k, v in columns.items()})
    build_s = time.perf_counter() - t0
    resp, preds = from_dataset(ds, response="label")
    vec = transmogrify(preds)
    checked = resp.sanity_check(vec, remove_bad_features=True)
    fit_s = transform_s = 0.0
    data = ds
    for layer in compute_dag([vec]):
        t0 = time.perf_counter()
        models = [s.fit(data) if isinstance(s, Estimator) else s for s in layer]
        fit_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        for m in models:
            data = m.transform(data)
        transform_s += time.perf_counter() - t0
    checker = checked.origin_stage
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checker.fit(data)
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    stats = stats_device_ms(torch, lambda: checker.fit(data))

    t0 = time.perf_counter()
    card_vec, _, card_summary, _ = fit_side_flow(ds, "label", None)
    torch.cuda.synchronize()
    flow_s = time.perf_counter() - t0
    cpu_vec, _, cpu_summary, _ = fit_side_flow(ds, "label", "cpu")
    if not np.array_equal(card_vec.values, cpu_vec.values):
        raise AssertionError("fit_side wide: the vector differs from the CPU's")
    if keep_and_reasons(card_summary) != keep_and_reasons(cpu_summary):
        raise AssertionError("fit_side wide: the card's keep-set or reasons "
                             "differ from the CPU's")
    row = check_fit_fixture("wide", card_vec, card_summary, "float32")
    n, d = card_vec.values.shape
    return {"card": smi, "rows": n, "vector_columns": d,
            "correlation_elements": n * (d + 1),
            "float32_matmul_precision": torch.get_float32_matmul_precision(),
            "table_build_s": build_s, "transmogrify_fit_s": fit_s,
            "transmogrify_transform_s": transform_s,
            "sanity_check_fit_s": check_s, "flow_s": flow_s,
            "stats": stats, "vector_and_keep_equal_cpu": True, **row}


def fit_side_to_train(torch, G, H, ST, TS, x, y, smi: str) -> dict:
    """The flagship twin's checked vector into ``XGBoostClassifier.fit_arrays``
    at the xgb fixture's point, then scored, on the card with the launch
    counts of K2, the row order, the split search, K1 and the tree sum read
    around exactly this run; trees and scores equal the same fit on the
    CPU."""
    mask = np.ones(len(y), dtype=np.float32)
    counted = {"hist_binloop": H.build_histogram_binloop, "node_order": H.node_order,
               "split_search": H.split_search, "serve_trees": ST.serve_trees,
               "tree_sum": TS.tree_sum}
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = G.XGBoostClassifier(**TO_TRAIN_POINT).fit_arrays(x, y, mask)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    card_pred = card.predict_arrays(x)
    launches = {k: fn.launches for k, fn in counted.items()}
    for fn in counted.values():
        fn.launches = 0
    if not all(launches.values()):
        raise AssertionError(f"fit_side to_train: a kernel never ran {launches}")
    t0 = time.perf_counter()
    cpu = G.XGBoostClassifier(device="cpu", **TO_TRAIN_POINT).fit_arrays(x, y, mask)
    cpu_fit_s = time.perf_counter() - t0
    cpu_pred = cpu.predict_arrays(x)
    same_trees = all(np.array_equal(np.asarray(a), np.asarray(b))
                     for a, b in zip(card.trees, cpu.trees))
    if not (same_trees and card.base_score == cpu.base_score
            and np.array_equal(card.thresholds, cpu.thresholds)):
        raise AssertionError("fit_side to_train: the card's trees differ "
                             "from the CPU's")
    if not all(np.array_equal(a, b) for a, b in zip(card_pred, cpu_pred)):
        raise AssertionError("fit_side to_train: the card's scores differ "
                             "from the CPU's")
    return {"card": smi, "rows": x.shape[0], "features": x.shape[1],
            "point": TO_TRAIN_POINT, "fit_s": fit_s, "cpu_fit_s": cpu_fit_s,
            "launches": launches, "trees_equal_cpu": True,
            "scores_equal_cpu": True}


# ----------------------------------------------------------- train() (A6)
SELECTOR_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_selector")
#: summary keys left out of the comparison: the planes the port does not
#: have yet (None in its summary) and featurizeStats, this process's ledger
UNPORTED_SUMMARY_KEYS = ("compileStats", "featurizeStats",
                         "distributedResilience")
#: families whose lanes are not bit-identical to the JAX package's (their
#: GEMMs block differently); every tree family's value must be EQUAL
GLM_FAMILIES = ("LogisticRegression", "LinearRegression")
#: the logistic candidates' CV metric values and a logistic winner's
#: train and holdout AuROC / AuPR on the card against the JAX package's
#: stored ones (measured on an H100 before this was stated: 1.42e-4 and
#: 1.68e-4 for the candidates, 3.1e-5 for the metrics), and a logistic
#: winner's holdout probabilities (measured 1.34e-3; their margins, 6.5e-3
#: apart, are reported)
CARD_LR_METRIC_TOL = 3e-4
CARD_LR_SCORE_TOL = 3e-3
#: a logistic lane's weights against another fit of the same mask and
#: point in a batch of another lane count, on the card (measured on an
#: H100 before this was stated: 1.25e-3 at the full-width table)
LR_LANE_TOL = 3e-3
#: the default candidates of the tree-only flows, whose winner is a tree
#: family (the selector fixture's ``selector_trees``)
TREE_FAMILIES = ("OpRandomForestClassifier", "OpXGBoostClassifier")


class TrainTimer:
    """Host seconds of ``Workflow.train()``'s parts, taken by wrapping the
    port's functions for the block: the reader; the DAG fit
    (``fit_and_transform_dag``) less the selector's fit (the fit side);
    each family's sweep (``Validator._sweep_family``, by class, summed over
    threads); the selector's fit less its validation (the refit and the
    train metrics); the holdout's transform and evaluation; workflow CV's
    per-fold refits and sweeps; the raw feature filter
    (``RawFeatureFilter.compute_exclusions``, inside the reader's part:
    the scoring rows are read there too)."""

    def __init__(self):
        import threading

        self.seconds: dict[str, float] = {}
        self.lock = threading.Lock()
        self.patches = []

    def _wrap(self, owner, attr: str, key):
        real = getattr(owner, attr)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                k = key(*a) if callable(key) else key
                with self.lock:
                    self.seconds[k] = self.seconds.get(k, 0.0) + (
                        time.perf_counter() - t0)

        self.patches.append((owner, attr, real))
        setattr(owner, attr, timed)

    def __enter__(self):
        from transmogrifai_tpu_torch.prep import raw_feature_filter as RFF
        from transmogrifai_tpu_torch.readers import core as RC
        from transmogrifai_tpu_torch.selector import model_selector as MS
        from transmogrifai_tpu_torch.selector import validators as V
        from transmogrifai_tpu_torch.workflow import cv as CV
        from transmogrifai_tpu_torch.workflow import workflow as W

        self._wrap(RC.DatasetReader, "generate_dataset", "reader")
        self._wrap(RFF.RawFeatureFilter, "compute_exclusions", "rff")
        self._wrap(W, "fit_and_transform_dag", "dag_fit")
        self._wrap(W, "apply_transformations_dag", "holdout")
        self._wrap(CV, "workflow_cv_results", "workflow_cv")
        self._wrap(MS.ModelSelector, "fit_arrays", "selector")
        self._wrap(MS.SelectedModel, "evaluate_holdout", "holdout")
        self._wrap(V.Validator, "validate", "validate")
        self._wrap(V.Validator, "_sweep_family",
                   lambda _self, est, *a: f"sweep {type(est).__name__}")
        return self

    def __exit__(self, *exc):
        for owner, attr, real in reversed(self.patches):
            setattr(owner, attr, real)
        return False

    def split(self, total: float) -> dict:
        s = self.seconds
        out = {"train_s": total, "reader_s": s.get("reader", 0.0),
               "fit_side_s": s.get("dag_fit", 0.0) - s.get("selector", 0.0),
               "validate_s": s.get("validate", 0.0),
               "refit_and_train_metrics_s": s.get("selector", 0.0)
               - s.get("validate", 0.0),
               "holdout_s": s.get("holdout", 0.0)}
        if "workflow_cv" in s:
            out["workflow_cv_s"] = s["workflow_cv"]
        if "rff" in s:
            out["rff_s"] = s["rff"]
        out["family_sweep_s"] = {k[len("sweep "):]: v for k, v in s.items()
                                 if k.startswith("sweep ")}
        return out


class UtilizationSampler(ClockSampler):
    """The card's ``utilization.gpu`` (the share of each sample period in
    which a kernel ran), sampled by ``nvidia-smi`` while a block runs."""

    query = "timestamp,utilization.gpu"


def path_counters(H, LS, ST, TS) -> dict:
    return {"hist_binloop": H.build_histogram_binloop,
            "hist_wide": H.build_histogram_wide, "node_order": H.node_order,
            "split_search": H.split_search, "leaf_sum": LS.leaf_sum,
            "serve_trees": ST.serve_trees, "tree_sum": TS.tree_sum,
            "tree_sum_device_route": TS.tree_sum_device_route}


#: ``train_wide trees``' tree grids: the default grids with fewer rounds,
#: for the whole script's time (``train_wide`` and ``train_flagship trees``
#: run the default grids): RF 10 trees over every default depth (the
#: depth-12 groups still pass the one-hot budget, so the leaf sums run),
#: XGBoost 20 rounds
WIDE_TREES_CUTS = {"RandomForestClassifier": {"num_trees": [10]},
                   "XGBoostClassifier": {"num_round": [20]}}


def train_flow(torch, ds, response: str, workflow_cv: bool,
               trees_only: bool = False, cuts: dict | None = None):
    """The five-line flow on the card at the default selector (with only
    its tree candidates if ``trees_only``; ``cuts`` overrides grid values
    by family), with the uid counter reset as the fixture generator resets
    the JAX package's: (model, prediction feature, selector, train()
    seconds split)."""
    from transmogrifai_tpu_torch.features import from_dataset
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.selector import BinaryClassificationModelSelector
    from transmogrifai_tpu_torch.selector.model_selector import make_candidates
    from transmogrifai_tpu_torch.utils import uid
    from transmogrifai_tpu_torch.workflow.workflow import Workflow

    uid.reset()
    label, predictors = from_dataset(ds, response=response)
    checked = label.sanity_check(transmogrify(list(predictors)),
                                 remove_bad_features=True)
    models = (make_candidates("BinaryClassification", TREE_FAMILIES)
              if trees_only else None)
    if cuts and models:
        models = [(e, {**g, **cuts.get(type(e).__name__, {})})
                  for e, g in models]
    selector = BinaryClassificationModelSelector(models=models)
    pred = selector.set_input(label, checked).get_output()
    wf = Workflow().set_result_features(pred).set_input_dataset(ds)
    if workflow_cv:
        wf = wf.with_workflow_cv()
    torch.cuda.synchronize()
    with TrainTimer() as timer:
        t0 = time.perf_counter()
        model = wf.train()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    return model, pred, selector, timer.split(total)


def check_lanes(name: str, summary: dict) -> None:
    """No family excluded, no NaN lane."""
    excluded = [a for a in summary["candidateAttempts"] if a["excluded"]]
    if excluded:
        raise AssertionError(f"{name}: excluded families {excluded}")
    bad = [r for r in summary["validationResults"]
           if not all(math.isfinite(v) for v in r["metricValues"])]
    if bad:
        raise AssertionError(f"{name}: non-finite lanes {bad}")


def same_json(a, b) -> bool:
    return (json.dumps(a, sort_keys=True, default=float)
            == json.dumps(b, sort_keys=True, default=float))


def same_summary(a: dict, b: dict) -> bool:
    """Two selector summaries EQUAL but for their ``featurizeStats``, each
    run's own ledger (seconds, pool use), of which only the keys must
    match."""
    ledger = "featurizeStats"
    return (set(a[ledger]) == set(b[ledger])
            and same_json({k: v for k, v in a.items() if k != ledger},
                          {k: v for k, v in b.items() if k != ledger}))


def check_summary_against(name: str, summary: dict, want: dict, tol: float,
                          metric_keys: tuple) -> dict:
    """A train()'s selector summary against the JAX package's stored one:
    candidates (names, uids, grids) equal, tree candidates' values EQUAL,
    logistic ones within ``tol``, the winner and grid equal, every other key
    EQUAL but a logistic winner's train and holdout metrics (each of
    ``metric_keys`` within ``tol``, the rest reported). Returns the measured
    differences."""
    got = {k: v for k, v in summary.items() if k not in UNPORTED_SUMMARY_KEYS}
    if set(got) != set(want):
        raise AssertionError(f"{name}: summary keys {sorted(got)} differ")
    gr, wr = got["validationResults"], want["validationResults"]
    ident = [(r["modelName"], r["modelUID"], json.dumps(r["grid"], sort_keys=True))
             for r in gr]
    if ident != [(r["modelName"], r["modelUID"],
                  json.dumps(r["grid"], sort_keys=True)) for r in wr]:
        raise AssertionError(f"{name}: candidates differ from the fixture's")
    glm_diff = 0.0
    for g, w in zip(gr, wr):
        if g["modelName"] in GLM_FAMILIES:
            glm_diff = max(glm_diff, float(np.max(np.abs(
                np.subtract(g["metricValues"], w["metricValues"])))))
        elif g["metricValues"] != w["metricValues"]:
            raise AssertionError(f"{name}: tree candidate {g} differs from the "
                                 f"JAX package's {w}")
    if not glm_diff <= tol:
        raise AssertionError(f"{name}: logistic candidates {glm_diff} apart "
                             f"(tolerance {tol})")
    if (got["bestModelType"], got["bestGrid"]) != (want["bestModelType"],
                                                   want["bestGrid"]):
        raise AssertionError(f"{name}: winner {got['bestModelType']} "
                             f"{got['bestGrid']}, the JAX package's "
                             f"{want['bestModelType']} {want['bestGrid']}")
    ranked = sorted((r["metricMean"] for r in wr), reverse=True)
    glm_winner = want["bestModelType"] in GLM_FAMILIES
    metric_diff = {}
    for key in ("trainEvaluation", "holdoutEvaluation"):
        if not glm_winner:
            if not same_json(got[key], want[key]):
                raise AssertionError(f"{name}: {key} differs (tree winner)")
            metric_diff[key] = 0.0
            continue
        metric_diff[key] = {
            k: float(np.max(np.abs(np.subtract(got[key][k], want[key][k]))))
            for k, v in want[key].items() if isinstance(v, (int, float, list))}
        for k in metric_keys:
            if not metric_diff[key][k] <= tol:
                raise AssertionError(f"{name}: {key} {k} off by "
                                     f"{metric_diff[key][k]}")
    rest = [k for k in got if k not in (
        "validationResults", "trainEvaluation", "holdoutEvaluation")]
    if not same_json({k: got[k] for k in rest}, {k: want[k] for k in rest}):
        raise AssertionError(f"{name}: summary fields {rest} differ")
    return {"candidates": len(gr), "winner": got["bestModelType"],
            "grid": got["bestGrid"], "tree_candidates_equal": True,
            "logistic_max_diff": glm_diff, "logistic_tolerance": tol,
            "jax_top2_margin": ranked[0] - ranked[1],
            "metric_max_diff": metric_diff}


def check_against_selector_fixture(name: str, summary: dict, scores) -> dict:
    """A train()'s selector summary (``check_summary_against``, logistic
    values and a logistic winner's AuROC / AuPR within
    ``CARD_LR_METRIC_TOL``) and holdout scores against what the JAX package
    stored at the default grids: a tree winner's scores EQUAL, a logistic
    one's within ``CARD_LR_SCORE_TOL``. Returns the measured differences."""
    with open(os.path.join(SELECTOR_FIXTURE, f"{name}.json")) as fh:
        fx = json.load(fh)
    want_scores = np.load(os.path.join(SELECTOR_FIXTURE, f"{name}.npz"))
    row = check_summary_against(name, summary, fx["summary"],
                                CARD_LR_METRIC_TOL, ("AuROC", "AuPR"))
    glm_winner = row["winner"] in GLM_FAMILIES
    score_diff = {}
    for key in ("prediction", "probability", "raw"):
        d = float(np.max(np.abs(np.asarray(scores[key]) - want_scores[key])))
        score_diff[key] = d
        limit = CARD_LR_SCORE_TOL if glm_winner and key != "raw" else 0.0
        if glm_winner and key == "raw":
            continue  # margins: reported
        if not d <= limit:
            raise AssertionError(f"{name}: holdout {key} off by {d}")
    return {**row, "score_max_diff": score_diff,
            "score_tolerance": CARD_LR_SCORE_TOL if glm_winner else 0.0}


def column_arrays(col) -> dict:
    return {"prediction": np.asarray(col.prediction),
            "probability": np.asarray(col.probability),
            "raw": np.asarray(col.raw)}


def check_round_trip(model, ds, pred) -> dict:
    """A save and load round trip on the card, and ``fn.batch`` of
    ``score_function(model)``, each equal to ``model.score`` on ``ds``."""
    import tempfile

    from transmogrifai_tpu_torch import load_workflow_model, score_function

    want = column_arrays(model.score(ds)[pred.name])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model")
        t0 = time.perf_counter()
        model.save(path)
        save_s = time.perf_counter() - t0
        loaded = load_workflow_model(path)
    got = column_arrays(loaded.score(ds)[pred.name])
    if not all(np.array_equal(got[k], want[k]) for k in want):
        raise AssertionError("save/load: the loaded model's scores differ")
    rows = ds.rows()
    t0 = time.perf_counter()
    out = score_function(model).batch(rows)
    batch_s = time.perf_counter() - t0
    name = pred.name
    prob = np.array([[r[name]["probability_0"], r[name]["probability_1"]]
                     for r in out])
    if not (np.array_equal(prob, want["probability"]) and np.array_equal(
            [r[name]["prediction"] for r in out], want["prediction"])):
        raise AssertionError("score_function: fn.batch differs from model.score")
    return {"save_s": save_s, "round_trip_equal": True,
            "fn_batch_equal_score": True, "fn_batch_rows": len(rows),
            "fn_batch_s": batch_s}


#: the selector fixture's flows: name -> (workflow CV, tree candidates only)
SELECTOR_FLOWS = {"selector": (False, False), "workflow_cv": (True, False),
                  "selector_trees": (False, True)}


def train_flagship(torch, smi: str, name: str, counters) -> dict:
    """The five-line flow ``name`` of ``SELECTOR_FLOWS`` on the flagship
    twin (the fit-side fixture's typed table) on the card, held to the
    selector fixture the JAX package made (``tests/fixtures/
    torch_selector``), with ``train()``'s host seconds split and the
    kernels' launches read around exactly the train. A tree winner's
    holdout is scored through K1 and the tree sum."""
    from transmogrifai_tpu_torch import types as PT
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.types.columns import column_from_values

    workflow_cv, trees_only = SELECTOR_FLOWS[name]
    with open(os.path.join(FIT_SIDE, "flagship_table.json")) as fh:
        table = json.load(fh)
    ds = Dataset.of({
        k: column_from_values(PT.feature_type_by_name(table["schema"][k]), v)
        for k, v in table["columns"].items()})
    for fn in counters.values():
        fn.launches = 0
    model, pred, selector, seconds = train_flow(torch, ds, "label", workflow_cv,
                                                trees_only)
    launches = {k: fn.launches for k, fn in counters.items()}
    summary = model.summary_json()["modelSelectorSummary"]
    check_lanes(f"train_flagship {name}", summary)
    with open(os.path.join(SELECTOR_FIXTURE, f"{name}.json")) as fh:
        holdout_idx = json.load(fh)["holdout_idx"]
    holdout = ds.take(np.asarray(holdout_idx))
    scores = column_arrays(model.score(holdout)[pred.name])
    out = {"card": smi, "rows": ds.num_rows, "train_rows": model.train_rows,
           "holdout_rows": model.holdout_rows, **seconds,
           "launches": launches,
           **check_against_selector_fixture(name, summary, scores),
           **check_round_trip(model, holdout, pred)}
    for fn in counters.values():
        fn.launches = 0
    required = ["hist_binloop", "node_order", "split_search"]
    if summary["bestModelType"] not in GLM_FAMILIES:
        required += ["serve_trees", "tree_sum"]
    for k in required:
        if not launches[k]:
            raise AssertionError(f"train_flagship {name}: {k} never ran")
    return out


def profiled_busy_share(torch, ds, trees_only: bool, cuts=None) -> dict:
    """The busy share of a second train of ``ds`` under ``torch.profiler``
    (CUDA activity: the kernels' and copies' device time over the profiled
    wall, which the profiler stretches), where nvidia-smi gave no
    utilization samples."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        train_flow(torch, ds, "label", False, trees_only, cuts)
    wall = time.perf_counter() - t0
    total = sum(evt.self_device_time_total for evt in prof.key_averages()
                if evt.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    return {"device_busy_share": total / wall if total else "not measured",
            "busy_share_source": "torch.profiler over a second train",
            "profiled_wall_s": wall}


def train_wide(torch, smi: str, counters, trees_only: bool = False) -> dict:
    """The five-line flow at full width: ``fit_side_tables.wide_table()``
    (16384 rows, 1423 vector columns) through the default selector, or with
    ``trees_only`` ``wide_hash_table()`` (16384 rows, 1419 vector columns,
    a hash-only SmartText member: the model ``fused_serving`` scores fused)
    through its tree candidates only, on the card: train()'s
    seconds split, the card's busy share over the train (nvidia-smi's
    utilization.gpu, sampled every 100 ms), launches per kernel; no family
    excluded and no NaN lane; the winner's refit equal to a direct
    ``fit_arrays_batched_masks`` refit on the same mask (a tree winner's
    trees EQUAL, a logistic one's weights within ``LR_LANE_TOL``); a tree
    winner's holdout scored through K1 and the tree sum; ``model.score`` of
    the holdout rows equal to ``score_function``'s."""
    sys.path.insert(0, os.path.join(ROOT, "tests", "torch_fixtures"))
    from fit_side_tables import WIDE_SEED, wide_table

    from transmogrifai_tpu_torch import types as PT
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.types.columns import column_from_values

    if trees_only:
        table = "wide_hash_table"
        ds = wide_hash_dataset(WIDE_HASH_TRAIN_ROWS, WIDE_SEED)
    else:
        table = "wide_table"
        schema, columns = wide_table()
        ds = Dataset.of({
            k: column_from_values(PT.feature_type_by_name(schema[k]), v)
            for k, v in columns.items()})
    for fn in counters.values():
        fn.launches = 0
    with UtilizationSampler(period_ms=100) as util:
        t0 = time.time()
        model, pred, selector, seconds = train_flow(
            torch, ds, "label", False, trees_only,
            WIDE_TREES_CUTS if trees_only else None)
        t1 = time.time()
    launches = {k: fn.launches for k, fn in counters.items()}
    for fn in counters.values():
        fn.launches = 0
    busy = util.between(t0, t1)
    busy_share = {"device_busy_share": sum(busy) / len(busy) / 100.0,
                  "busy_share_source": "nvidia-smi utilization.gpu every "
                  "100 ms over the train", "busy_samples": len(busy)} \
        if busy else profiled_busy_share(
            torch, ds, trees_only, WIDE_TREES_CUTS if trees_only else None)
    summary = model.summary_json()["modelSelectorSummary"]
    check_lanes("train_wide", summary)
    if trees_only and summary["bestModelType"] in GLM_FAMILIES:
        raise AssertionError("train_wide trees: a logistic winner")
    # every sweep grows trees; the depth-12 groups pass the one-hot budget;
    # a tree winner's holdout is scored through K1 and the tree sum
    required = ["hist_binloop", "node_order", "split_search", "leaf_sum"]
    if summary["bestModelType"] not in GLM_FAMILIES:
        required += ["serve_trees", "tree_sum"]
    for k in required:
        if not launches[k]:
            raise AssertionError(f"train_wide: {k} never ran")

    # the winner's refit lane against a direct refit on the same mask
    train_idx, holdout_idx = selector.splitter.split(ds.num_rows)
    label_name, vec_name = model.selector_info["labelName"], model.selector_info["vectorName"]
    data = model.score(ds.take(train_idx), keep_intermediate_features=True)
    xt = np.asarray(data[vec_name].values, dtype=np.float32)
    yt = data[label_name].values.astype(np.float32)
    mask = selector.splitter.prepare(yt).astype(np.float32)
    family, grid = next((est, g) for est, g in selector.models
                        if type(est).__name__ == summary["bestModelType"])

    def direct_fit(point, row_mask):
        return family.with_params(**point).fit_arrays_batched_masks(
            xt, yt, [row_mask], [dict(point)])[0][0].get_arrays()

    t0 = time.perf_counter()
    want = direct_fit(summary["bestGrid"], mask)
    direct_s = time.perf_counter() - t0
    best = model.fitted[model.selector_info["estimatorUid"]].best_model
    got = best.get_arrays()
    controls = {}
    if summary["bestModelType"] in GLM_FAMILIES:
        from transmogrifai_tpu_torch.selector.validators import expand_grid

        def weights_diff(other):
            return max(float(np.max(np.abs(np.subtract(got[k], other[k]))))
                       for k in other)

        refit_diff = weights_diff(want)
        if not refit_diff <= LR_LANE_TOL:
            raise AssertionError(f"train_wide: refit lane {refit_diff} from a "
                                 "direct refit")
        # the tolerance must tell the refit lane from a neighbouring grid
        # point's fit and from a fold's
        points = expand_grid(grid)
        i = points.index(summary["bestGrid"])
        fold_mask = selector.validator.split_masks(yt)[0][0].astype(np.float32)
        controls = {
            "neighbour_point": weights_diff(direct_fit(
                points[i + 1 if i + 1 < len(points) else i - 1], mask)),
            "fold_mask": weights_diff(direct_fit(summary["bestGrid"], fold_mask)),
        }
        blind = {k: v for k, v in controls.items() if not v > LR_LANE_TOL}
        if blind:
            raise AssertionError(f"train_wide: LR_LANE_TOL {LR_LANE_TOL} does "
                                 f"not tell these fits from the refit: {blind}")
    else:
        refit_diff = 0.0
        if sorted(got) != sorted(want) or not all(
                np.array_equal(got[k], want[k]) for k in want):
            raise AssertionError("train_wide: the refit lane's trees differ "
                                 "from a direct refit's")
    holdout = ds.take(holdout_idx)
    rt = check_round_trip(model, holdout, pred)
    return {"card": smi, "table": table, "rows": ds.num_rows,
            "vector_columns": int(xt.shape[1]), "train_rows": model.train_rows,
            "holdout_rows": model.holdout_rows, **seconds,
            **busy_share, "launches": launches,
            "winner": summary["bestModelType"], "grid": summary["bestGrid"],
            "candidates": len(summary["validationResults"]),
            "refit_against_direct": "equal" if refit_diff == 0.0
            else f"within {LR_LANE_TOL}",
            "refit_max_diff": refit_diff, "refit_controls_max_diff": controls,
            "direct_refit_s": direct_s, **rt, "_model": model,
            "_trained": (model, pred, seconds, summary)}


#: the all-types phase (``tests/torch_fixtures/all_types.py``): its training
#: rows, the fresh rows it scores (above the host-predict cutoff), and the
#: rows of the small-grid flow trained on the card and on the CPU (cut from
#: 4096: the CPU's train took 18.5 s there)
ALL_TYPES_ROWS = 16384
#: ``train_all_types`` and ``train_dsl`` train their 16384 rows at the CPU
#: tests' small tree grids (cut from the default grids for the whole
#: script's time: the default grids' sweeps run in ``train_flagship``,
#: ``train_wide`` and ``families``)
FEATURE_PHASE_SMALL_GRIDS = True
ALL_TYPES_FRESH_ROWS = 20000
ALL_TYPES_SMALL_ROWS = 1024


def all_types_module():
    sys.path.insert(0, os.path.join(ROOT, "tests", "torch_fixtures"))
    import all_types

    return all_types


def same_vectors(what: str, got, want) -> None:
    import dataclasses

    def metas(col):
        return [dataclasses.asdict(c) for c in col.metadata.columns]

    if not (np.array_equal(np.asarray(got.values), np.asarray(want.values))
            and metas(got) == metas(want)):
        raise AssertionError(f"{what}: the vectors or their metadata differ")


def train_all_types(torch, smi: str, counters, score_function,
                    load_workflow_model) -> dict:
    """Every type of transmogrify's default dispatch on the card:
    ``all_types_table(16384)`` (22 predictors, one per type group, about
    20% of each empty) through ``from_dataset`` -> ``transmogrify`` ->
    ``sanity_check`` (statistics on the card) ->
    ``BinaryClassificationModelSelector`` over the default tree candidates
    at the small grids (``FEATURE_PHASE_SMALL_GRIDS``) ->
    ``Workflow.train()``, then ``score_function`` on 20000 fresh rows
    (the fused planner refuses the plan: the batch scores staged, through
    K1 and the device-route sum). Held EQUAL to the port's CPU runs: the
    vector and keep-set to the feature side fitted on the CPU on the same
    training rows; the scores to the card's model saved, loaded on the CPU
    and scoring the same rows; and, since the default grids' CPU run would
    take about an hour, the flow at the CPU tests' small grids on the
    table's first ``ALL_TYPES_SMALL_ROWS`` rows, trained on the card and on
    the CPU: selector
    summary and fresh scores."""
    import tempfile

    AT = all_types_module()
    t0 = time.perf_counter()
    ds = AT.all_types_table(ALL_TYPES_ROWS, AT.SEED)
    fresh = AT.all_types_table(ALL_TYPES_FRESH_ROWS, AT.SEED + 1)
    rows = fresh.rows([n for n in fresh.columns if n != "label"])
    table_s = time.perf_counter() - t0

    wf, pred, checked, selector = AT.build_flow(
        "port", ds, grids=FEATURE_PHASE_SMALL_GRIDS, device=DEV)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    with UtilizationSampler(period_ms=100) as util, TrainTimer() as timer:
        t1 = time.time()
        p0 = time.perf_counter()
        model = wf.train()
        torch.cuda.synchronize()
        total = time.perf_counter() - p0
        t2 = time.time()
    seconds = timer.split(total)
    launches = {k: fn.launches for k, fn in counters.items()}
    busy = util.between(t1, t2)
    summary = model.summary_json()["modelSelectorSummary"]
    check_lanes("train_all_types", summary)
    for k in ("hist_binloop", "node_order", "split_search"):
        if not launches[k]:
            raise AssertionError(f"train_all_types: {k} never ran in train()")

    # the vector and keep-set: the feature side fitted on the CPU on the
    # same training rows
    train_idx, _ = selector.splitter.split(ds.num_rows)
    train = ds.take(train_idx)
    data = model.score(train, keep_intermediate_features=True)
    p0 = time.perf_counter()
    cdata, cvec, cchecked, _ = AT.feature_side("port", train, device="cpu")
    cpu_feature_s = time.perf_counter() - p0
    vec_name = checked.origin_stage.input_features[-1].name
    if (cvec.name, cchecked.name) != (vec_name, checked.name):
        raise AssertionError("train_all_types: the CPU feature side's names")
    for name, what in ((vec_name, "vector"), (checked.name, "keep-set")):
        same_vectors(f"train_all_types {what} card vs cpu", data[name],
                     cdata[name])

    # the fresh rows above the cutoff on the card, then on the CPU
    fn = score_function(model, device=DEV)
    for c in counters.values():
        c.launches = 0
    p0 = time.perf_counter()
    card = score_matrix(fn.batch(rows))
    torch.cuda.synchronize()
    score_s = time.perf_counter() - p0
    score_launches = {k: c.launches for k, c in counters.items()}
    for c in counters.values():
        c.launches = 0
    md = fused_md(fn)
    if md["active"] or md["fallbackReasons"] != {"unfuseable": 1} \
            or "has no fused kernel" not in (md["reason"] or ""):
        raise AssertionError(f"train_all_types: the fused planner {md}")
    for k in ("serve_trees", "tree_sum_device_route"):
        if not score_launches[k]:
            raise AssertionError(f"train_all_types: scoring launched no {k}")
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        cpu_model = load_workflow_model(tmp, device="cpu")
    p0 = time.perf_counter()
    cpu = score_matrix(score_function(cpu_model, device="cpu").batch(rows))
    cpu_score_s = time.perf_counter() - p0
    same_scores("train_all_types card vs cpu", card, cpu, False)

    # the small-grid flow on the card and on the CPU
    small = ds.take(np.arange(ALL_TYPES_SMALL_ROWS))
    runs = {}
    for dev in dict.fromkeys((DEV, "cpu")):
        p0 = time.perf_counter()
        m, _, _, _ = AT.train_flow("port", small, device=dev)
        runs[dev] = {"train_s": time.perf_counter() - p0,
                     "summary": m.summary_json()["modelSelectorSummary"],
                     "scores": score_matrix(score_function(
                         m, device=dev).batch(rows))}
    card_run = runs[DEV]
    if not same_summary(card_run["summary"], runs["cpu"]["summary"]):
        raise AssertionError("train_all_types: the small grids' selector "
                             "summary differs from the CPU's")
    small_err = same_scores("train_all_types small grids card vs cpu",
                            card_run["scores"], runs["cpu"]["scores"], False)
    return {
        "card": smi, "rows": ALL_TYPES_ROWS, "table_s": table_s,
        "vector_columns": int(np.asarray(data[vec_name].values).shape[1]),
        "keep_set_size": int(np.asarray(data[checked.name].values).shape[1]),
        "vector_and_keep_set_equal_cpu": True,
        "cpu_feature_side_s": cpu_feature_s,
        **seconds, "launches": launches,
        "device_busy_share": sum(busy) / len(busy) / 100.0 if busy
        else "not measured", "busy_samples": len(busy),
        "winner": summary["bestModelType"], "grid": summary["bestGrid"],
        "candidates": len(summary["validationResults"]),
        "fresh_rows": ALL_TYPES_FRESH_ROWS, "score_s": score_s,
        "score_launches": score_launches, "fused_refusal": md["reason"],
        "cpu_score_s": cpu_score_s,
        "card_vs_cpu_scores_max_abs_err": 0.0,
        "small_grids": {
            "rows": ALL_TYPES_SMALL_ROWS,
            "winner": runs["cpu"]["summary"]["bestModelType"],
            "grid": runs["cpu"]["summary"]["bestGrid"],
            "card_train_s": card_run["train_s"],
            "cpu_train_s": runs["cpu"]["train_s"],
            "summary_equal": True, "scores_max_abs_err": small_err},
    }


#: the DSL phase (``tests/torch_fixtures/dsl_flow.py``): F1's training and
#: scoring rows, the fresh rows it scores above the host-predict cutoff,
#: the small-grid flow's rows held to the JAX package's fixture, the rows of
#: its CPU comparison (cut from 4096, then 1024: the port's CPU histograms
#: over F1's ~1460 columns take ~80 s at 4096 rows and 16 s at 1024 on an
#: 8-core host), and F2's
#: fresh rows scored fused
DSL_ROWS = 16384
DSL_FRESH_ROWS = 20000
DSL_SMALL_ROWS = 4096
DSL_CPU_ROWS = 512
DSL_FUSED_ROWS = 65536
DSL_FUSED_SEED = 2031
DSL_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_dsl")


def dsl_flow_module():
    sys.path.insert(0, os.path.join(ROOT, "tests", "torch_fixtures"))
    import dsl_flow

    return dsl_flow


def dsl_filter_on_cpu(D, ds, score_ds) -> tuple:
    """F1's raw feature filter run again on the CPU over the same rows, and
    the blocklist its rewrite makes: (results JSON, blocklist, the rewritten
    flow built for the CPU)."""
    from transmogrifai_tpu_torch.prep.raw_feature_filter import RawFeatureFilter
    from transmogrifai_tpu_torch.workflow.dag import raw_features_of

    flow = D.build_f1("port", ds, score_ds, device="cpu")
    wf = flow["workflow"]
    raw = raw_features_of(wf.result_features)
    rff = RawFeatureFilter()
    score = score_ds.select([f.name for f in raw if not f.is_response])
    blocked = rff.compute_exclusions(ds, raw, score=score, label_name="label")
    wf._apply_blocklist(blocked)
    return rff.results.to_json(), wf.blocklisted_features, flow


def dsl_small_grids(D, score_function) -> dict:
    """F1 at ``all_types``' small grids on ``dsl_table(4096)``, the CPU
    tests' flow, trained on the card: filter results, blocklist, vector
    digests, selector summary and fresh scores EQUAL the JAX package's
    fixture (which the CPU tests hold the port's CPU run to); and the same
    flow on its first ``DSL_CPU_ROWS`` rows on the card and on the CPU,
    EQUAL."""
    import make_dsl_fixtures as MK
    import selector_flows as SF

    with open(os.path.join(DSL_FIXTURE, "flow.json")) as fh:
        want = json.load(fh)["f1"]
    want_scores = np.load(os.path.join(DSL_FIXTURE, "scores.npz"))
    train, score = D.tables("port", DSL_SMALL_ROWS)
    p0 = time.perf_counter()
    flow = D.build_f1("port", train, score, device=DEV)
    model = flow["workflow"].train()
    card_s = time.perf_counter() - p0
    got = MK.flow_record(model, flow, train)
    for key in ("vector_sha256", "vector_metadata_sha256", "checked_sha256",
                "checked_metadata_sha256", "pred_name", "vector_width",
                "checked_width"):
        if got[key] != want[key]:
            raise AssertionError(f"train_dsl small grids: {key} differs from "
                                 f"the JAX package's fixture")
    if not (same_json(model.rff_results, want["rff_results"])
            and model.blocklisted == want["blocklisted"]):
        raise AssertionError("train_dsl small grids: the filter's results")
    SF.assert_same_summary(got["summary"], want["summary"], glm_winner=False)
    fresh = D.fresh_rows(D.dsl_table)
    out = MK.batch_arrays("f1_host", score_function(model, device=DEV).batch(
        fresh), flow["pred"].name)
    for k, v in out.items():
        if not np.array_equal(v, want_scores[k]):
            raise AssertionError(f"train_dsl small grids: {k} differ")
    runs = {}
    cut = np.arange(DSL_CPU_ROWS)
    for dev in dict.fromkeys((DEV, "cpu")):
        p0 = time.perf_counter()
        f = D.build_f1("port", train.take(cut), score.take(cut), device=dev)
        m = f["workflow"].train()
        runs[dev] = {"train_s": time.perf_counter() - p0,
                     "summary": m.summary_json()["modelSelectorSummary"],
                     "rff": m.rff_results, "blocklisted": m.blocklisted,
                     "scores": score_matrix(score_function(
                         m, device=dev).batch(fresh))}
    card, cpu = runs[DEV], runs["cpu"]
    if not (same_summary(card["summary"], cpu["summary"])
            and same_json(card["rff"], cpu["rff"])
            and card["blocklisted"] == cpu["blocklisted"]):
        raise AssertionError("train_dsl: the card's small-grid flow differs "
                             "from the CPU's")
    err = same_scores("train_dsl small grids card vs cpu", card["scores"],
                      cpu["scores"], False)
    return {"rows": DSL_SMALL_ROWS, "card_train_s": card_s,
            "winner": want["summary"]["bestModelType"],
            "grid": want["summary"]["bestGrid"],
            "equal_jax_fixture": True, "cpu_rows": DSL_CPU_ROWS,
            "cpu_comparison_card_train_s": card["train_s"],
            "cpu_comparison_cpu_train_s": cpu["train_s"],
            "cpu_comparison_winner": cpu["summary"]["bestModelType"],
            "summary_equal": True, "scores_max_abs_err": err}


def dsl_fused(torch, ST, TS, D, score_function) -> dict:
    """F2 at the small grids on ``wide_hash_table(16384)``, trained on the
    card; 65536 fresh rows through ``.columns``: fused EQUAL staged, the
    host prefix non-empty and holding the derived stages, one upload, one
    download and one host sync a batch (``fused_transfers``)."""
    p0 = time.perf_counter()
    flow = D.build_f2("port", D.hash_tables("port", DSL_ROWS), device=DEV)
    model = flow["workflow"].train()
    train_s = time.perf_counter() - p0
    p0 = time.perf_counter()
    fresh = D.hash_tables("port", DSL_FUSED_ROWS, DSL_FUSED_SEED)
    table_s = time.perf_counter() - p0
    fn = score_function(model)
    if not fn.prime_fused():
        raise AssertionError(f"train_dsl fused: no program "
                             f"({fused_md(fn)['reason']})")
    prefix = fused_md(fn)["hostPrefixStages"]
    derived = {f.name for f in flow["derived"].values()}
    if not prefix or not derived <= set(prefix):
        raise AssertionError(f"train_dsl fused: host prefix {prefix}")
    name = flow["pred"].name
    counter = FusedLaunches(ST, TS)
    fused = score_matrix(counter.counted(lambda: fn.columns(fresh))[name])
    stg = score_matrix(staged(fn, lambda: fn.columns(fresh))[name])
    err = same_scores("train_dsl fused", fused, stg, False)
    fused_s = host_seconds(
        lambda: counter.counted(lambda: fn.columns(fresh)))
    staged_s = host_seconds(lambda: staged(fn, lambda: fn.columns(fresh)))
    transfers = fused_transfers(torch, TS, counter, fn,
                                lambda: fn.columns(fresh), DSL_FUSED_ROWS)
    md = fused_md(fn)
    if md["fallbacks"]:
        raise AssertionError(f"train_dsl fused: fallbacks {md}")
    return {"train_rows": DSL_ROWS, "train_s": train_s,
            "winner": model.summary_json()["modelSelectorSummary"][
                "bestModelType"],
            "rows": DSL_FUSED_ROWS, "table_s": table_s,
            "host_prefix_stages": prefix,
            "fused_vs_staged_max_abs_err": err,
            "fused_rows_per_s": DSL_FUSED_ROWS / fused_s,
            "staged_rows_per_s": DSL_FUSED_ROWS / staged_s,
            "transfers": transfers, "dispatches": md["dispatches"],
            "launches": dict(counter.total)}


def train_dsl(torch, smi: str, counters, ST, TS, score_function,
              load_workflow_model) -> dict:
    """The DSL's stages and the raw feature filter on the card: F1 (the
    default tree candidates at the small grids,
    ``FEATURE_PHASE_SMALL_GRIDS``) through ``train()`` with the filter against
    drifted scoring rows, then 20000 fresh rows (staged: the planner refuses
    the bucketizer members). Held EQUAL to the port's CPU runs: the filter's
    results and blocklist to the same filter on the CPU; the vector and
    keep-set to the CPU's feature side of the rewritten flow on the same
    training rows; the scores to the saved model, loaded on the CPU. Then
    the small-grid flow (``dsl_small_grids``) and F2 fused
    (``dsl_fused``)."""
    import tempfile

    from transmogrifai_tpu_torch.workflow.fit import fit_and_transform_dag

    D = dsl_flow_module()
    t0 = time.perf_counter()
    ds, score_ds = D.tables("port", DSL_ROWS)
    rows = D.fresh_rows(D.dsl_table, DSL_FRESH_ROWS, D.SEED + 2)
    table_s = time.perf_counter() - t0

    flow = D.build_f1("port", ds, score_ds, grids=FEATURE_PHASE_SMALL_GRIDS,
                      device=DEV)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    with UtilizationSampler(period_ms=100) as util, TrainTimer() as timer:
        t1 = time.time()
        p0 = time.perf_counter()
        model = flow["workflow"].train()
        torch.cuda.synchronize()
        total = time.perf_counter() - p0
        t2 = time.time()
    seconds = timer.split(total)
    launches = {k: fn.launches for k, fn in counters.items()}
    busy = util.between(t1, t2)
    summary = model.summary_json()["modelSelectorSummary"]
    check_lanes("train_dsl", summary)
    for k in ("hist_binloop", "node_order", "split_search"):
        if not launches[k]:
            raise AssertionError(f"train_dsl: {k} never ran in train()")
    blocked = set(D.BLOCKED_RAW) | {flow["derived"]["drift_product"].name}
    if set(model.blocklisted) != blocked:
        raise AssertionError(f"train_dsl: blocklist {model.blocklisted}")

    # the filter and the feature side again on the CPU, same rows
    p0 = time.perf_counter()
    results, blocklist, cflow = dsl_filter_on_cpu(D, ds, score_ds)
    if not (same_json(results, model.rff_results)
            and blocklist == model.blocklisted):
        raise AssertionError("train_dsl: the filter differs from the CPU's")
    train_idx, _ = flow["selector"].splitter.split(ds.num_rows)
    train = ds.take(train_idx).drop(list(D.BLOCKED_RAW))
    data = model.score(train, keep_intermediate_features=True)
    cdata, _ = fit_and_transform_dag(train, [cflow["checked"]])
    cpu_feature_s = time.perf_counter() - p0
    vec_name = flow["checked"].origin_stage.input_features[-1].name
    for name, what in ((vec_name, "vector"),
                       (flow["checked"].name, "keep-set")):
        same_vectors(f"train_dsl {what} card vs cpu", data[name], cdata[name])

    # the fresh rows above the cutoff on the card, then on the CPU
    fn = score_function(model, device=DEV)
    for c in counters.values():
        c.launches = 0
    p0 = time.perf_counter()
    card = score_matrix(fn.batch(rows))
    torch.cuda.synchronize()
    score_s = time.perf_counter() - p0
    score_launches = {k: c.launches for k, c in counters.items()}
    for c in counters.values():
        c.launches = 0
    md = fused_md(fn)
    if md["active"] or md["fallbackReasons"] != {"unfuseable": 1} \
            or "has no fused kernel" not in (md["reason"] or ""):
        raise AssertionError(f"train_dsl: the fused planner {md}")
    for k in ("serve_trees", "tree_sum_device_route"):
        if not score_launches[k]:
            raise AssertionError(f"train_dsl: scoring launched no {k}")
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        cpu_model = load_workflow_model(tmp, device="cpu")
    if not same_json(cpu_model.rff_results, model.rff_results):
        raise AssertionError("train_dsl: rffResults through save and load")
    p0 = time.perf_counter()
    cpu = score_matrix(score_function(cpu_model, device="cpu").batch(rows))
    cpu_score_s = time.perf_counter() - p0
    same_scores("train_dsl card vs cpu", card, cpu, False)

    small = dsl_small_grids(D, score_function)
    fused = dsl_fused(torch, ST, TS, D, score_function)
    ST.serve_trees.launches = TS.tree_sum_device_route.launches = 0
    return {
        "card": smi, "rows": DSL_ROWS, "table_s": table_s,
        "blocklisted": model.blocklisted,
        "exclusion_reasons": model.rff_results["exclusionReasons"],
        "vector_columns": int(np.asarray(data[vec_name].values).shape[1]),
        "keep_set_size": int(np.asarray(
            data[flow["checked"].name].values).shape[1]),
        "filter_and_vectors_equal_cpu": True,
        "cpu_filter_and_feature_side_s": cpu_feature_s,
        **seconds, "launches": launches,
        "device_busy_share": sum(busy) / len(busy) / 100.0 if busy
        else "not measured", "busy_samples": len(busy),
        "winner": summary["bestModelType"], "grid": summary["bestGrid"],
        "candidates": len(summary["validationResults"]),
        "fresh_rows": DSL_FRESH_ROWS, "score_s": score_s,
        "score_launches": score_launches, "fused_refusal": md["reason"],
        "cpu_score_s": cpu_score_s, "card_vs_cpu_scores_max_abs_err": 0.0,
        "small_grids": small, "fused": fused,
    }


#: the multiclass phases (``tests/torch_fixtures/multiclass_flow.py``): the
#: fixture the JAX package made, the full-width table's rows, the holdout
#: tiled to the staged and fused batch sizes, and the fused rows' seed
MULTICLASS_ROWS = 16384
MULTICLASS_STAGED_ROWS = 8192
MULTICLASS_FUSED_ROWS = 65536
#: a logistic candidate's CV weighted F1 and a logistic winner's metrics on
#: the card against the JAX package's stored ones, and a logistic winner's
#: holdout probabilities (stated before the first card run from the CPU's
#: bounds, ``multiclass_flow.LR_METRIC_TOL`` and ``MULTINOMIAL_PROB_TOL``)
CARD_MULTI_METRIC_TOL = 2e-4
CARD_MULTI_PROB_TOL = 1e-5
#: a multinomial winner's refit lane (weights and intercepts) against a
#: direct refit on the same mask, on the card (measured on an H100 before
#: this was stated: 1.62e-5 in each of three runs at the full-width table;
#: the binary lanes' ``LR_LANE_TOL`` is 185x that reading)
MULTI_REFIT_TOL = 1e-4
#: the default RF grid's points per depth group, and the classes of the
#: full-width label: each group's lanes are folds (3) and the refit mask
#: x points x classes
RF_POINTS_PER_DEPTH = 6
MULTICLASS_CLASSES = 4


def multiclass_module():
    sys.path.insert(0, os.path.join(ROOT, "tests", "torch_fixtures"))
    import multiclass_flow

    return multiclass_flow


def multiclass_fixture(torch, smi: str, counters, load_workflow_model,
                       score_function) -> dict:
    """The JAX-recorded multiclass flows at fixture size on the card
    (``tests/fixtures/torch_multiclass``): each flow's indexer labels,
    checked vector, candidates, winner and holdout scores against the
    stored ones (trees EQUAL, logistic within ``CARD_MULTI_*``); the
    one-vs-rest XGBoost, GBT and decision-tree fits, a decision-tree
    regressor and the random forest's multiclass sweep (trees and [K * C,
    N] outputs) EQUAL the stored fits; the JAX-saved model's scores, staged
    and fused (one program over every class stack), EQUAL the stored
    ones. Launches are read around the two trains."""
    from transmogrifai_tpu_torch.models import gbdt as G
    from transmogrifai_tpu_torch.ops.text_stages import OpStringIndexerModel

    MF = multiclass_module()
    schema, columns = MF.multiclass_table()
    out, launches = {}, {k: 0 for k in counters}
    for name, families in MF.FLOWS.items():
        with open(os.path.join(MF.FIXTURE, f"{name}.json")) as fh:
            record = json.load(fh)
        arrays = np.load(os.path.join(MF.FIXTURE, f"{name}.npz"))
        ds = MF.dataset("port", schema, columns)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        model, pred, _, _ = MF.train("port", ds, families, device=DEV)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        for k, fn in counters.items():
            launches[k] += fn.launches
            fn.launches = 0
        summary = model.summary_json()["modelSelectorSummary"]
        check_lanes(f"multiclass_fixture {name}", summary)
        row = check_summary_against(name, summary, record["summary"],
                                    CARD_MULTI_METRIC_TOL,
                                    ("Precision", "Recall", "F1", "Error"))
        labels = next(s.labels for s in model.fitted.values()
                      if isinstance(s, OpStringIndexerModel))
        data = model.score(ds, keep_intermediate_features=True)
        vec = data[model.selector_info["vectorName"]]
        if labels != record["labels"] or vec.metadata.column_names() != \
                record["vector_columns"] or not np.array_equal(
                    np.asarray(vec.values, np.float32), arrays["x"]):
            raise AssertionError(f"multiclass_fixture {name}: labels or the "
                                 "checked vector differ")
        col = model.score(ds.take(np.asarray(record["holdout_idx"])))[pred.name]
        glm = row["winner"] in GLM_FAMILIES
        prob_diff = float(np.abs(col.probability - arrays["probability"]).max())
        if not prob_diff <= (CARD_MULTI_PROB_TOL if glm else 0.0) or (
                not glm and not (np.array_equal(col.prediction,
                                                arrays["prediction"])
                                 and np.array_equal(col.raw, arrays["raw"]))):
            raise AssertionError(f"multiclass_fixture {name}: holdout scores "
                                 f"{prob_diff} from the JAX package's")
        out[name] = {**row, "train_s": train_s,
                     "holdout_prob_max_diff": prob_diff,
                     "prob_tolerance": CARD_MULTI_PROB_TOL if glm else 0.0}

    # the stored fits, refitted on the card
    fits = np.load(os.path.join(MF.FIXTURE, "fits.npz"))
    x, y = np.load(os.path.join(MF.FIXTURE, "multiclass_trees.npz"))["x"], \
        np.load(os.path.join(MF.FIXTURE, "multiclass_trees.npz"))["y"]
    masks = MF.sweep_masks(len(y))

    def equal(t, prefix):
        return all(np.array_equal(np.asarray(a), fits[f"{prefix}{f}"],
                                  equal_nan=True)
                   for f, a in zip(t._fields, t))

    for name, (family, params) in MF.DIRECT_FITS.items():
        model = MF.estimator("port", family, device=DEV, **params).fit_arrays(
            x, y, masks[0])
        stacks = getattr(model, "trees_per_class", None) or model.forests_per_class
        if len(stacks) != 4 or not all(equal(t, f"{name}__c{k}__")
                                       for k, t in enumerate(stacks)):
            raise AssertionError(f"multiclass_fixture: {name} trees differ")
    reg = G.DecisionTreeRegressor(max_depth=5, device=DEV).fit_arrays(x, y, masks[0])
    if not equal(reg.trees, "dt_reg__"):
        raise AssertionError("multiclass_fixture: decision-tree regressor differs")
    sweep = G.RandomForestClassifier(device=DEV).fit_arrays_batched_masks(
        x, y, masks, MF.RF_SWEEP_POINTS)
    stack = sweep[0][0]._sweep_stack
    if not (equal(stack["trees"], "rf_sweep__") and np.array_equal(
            stack["outputs"], fits["rf_sweep__outputs"])):
        raise AssertionError("multiclass_fixture: the forest sweep differs")

    # the JAX-saved model, staged and fused on the card
    want = np.load(os.path.join(MF.FIXTURE, "scores.npz"))
    rows = MF.dataset("port", schema, columns).take(
        np.arange(MF.FUSED_ROWS)).rows()
    model = load_workflow_model(os.path.join(MF.FIXTURE, "model"))
    routes = {}
    for route in ("staged", "fused"):
        if route == "fused":
            os.environ["TPTPU_HOST_PREDICT_MAX"] = str(MF.FUSED_ROWS // 2)
        try:
            fn = score_function(model)
            got = score_matrix(fn.batch(rows))
        finally:
            os.environ.pop("TPTPU_HOST_PREDICT_MAX", None)
        dispatches = fused_md(fn)["dispatches"]
        ref = np.column_stack([want[f"{route}_prediction"],
                               want[f"{route}_probability"], want[f"{route}_raw"]])
        same_scores(f"multiclass_fixture saved model {route}", got, ref, False)
        if dispatches != (route == "fused"):
            raise AssertionError(f"multiclass_fixture: {dispatches} fused "
                                 f"dispatches on the {route} route")
        routes[route] = {"rows": len(rows), "fused_dispatches": dispatches,
                         "equal_jax": True}
    for k in ("hist_binloop", "node_order", "split_search", "serve_trees",
              "tree_sum"):
        if not launches[k]:
            raise AssertionError(f"multiclass_fixture: {k} never ran")
    return {"card": smi, "rows": len(y), "flows": out,
            "fits_equal": sorted(MF.DIRECT_FITS) + ["dt_reg", "rf_sweep"],
            "rf_sweep_lanes": stack["k"], "saved_model": routes,
            "launches": launches}


class ForestLanes:
    """The lanes (K), depth and trees of every batched forest fit made
    while it is on (``trees.fit_forest_batched``, which the estimators
    call through the module)."""

    def __init__(self, TR):
        self.TR, self.real, self.fits = TR, TR.fit_forest_batched, []

    def __enter__(self):
        def hook(binned, target, row_mask, num_trees, max_depth, *a, **kw):
            self.fits.append({"K": int(row_mask.shape[0]),
                              "max_depth": int(max_depth),
                              "num_trees": int(num_trees),
                              "per_lane_targets": np.ndim(target) == 2})
            return self.real(binned, target, row_mask, num_trees, max_depth,
                             *a, **kw)

        self.TR.fit_forest_batched = hook
        return self

    def __exit__(self, *exc):
        self.TR.fit_forest_batched = self.real
        return False


def train_multiclass(torch, smi: str, counters, TS, ST, score_function,
                     load_workflow_model) -> dict:
    """The multiclass flow at full width on the card:
    ``fit_side_tables.wide_hash_multiclass_table()`` (16384 rows, the wide
    table's draws with its label cut at the quartiles of the same score
    into four PickList classes, ``t_sex`` left out so that the fused graph
    can serve the model) -> ``string_indexed`` -> ``transmogrify`` ->
    ``sanity_check`` -> ``MultiClassificationModelSelector()`` (LR 8 points,
    RF 18, 3-fold CV and the refit lane, DataCutter) -> ``train()``:
    seconds split as ``train_wide`` splits them, the card's busy share,
    launches per kernel; no NaN lane; every RF group one batched fit of
    (3 folds + the refit mask) x 6 points x 4 classes lanes; the winner's
    refit equal to a direct refit; save and load; the holdout tiled to
    8192 rows scored staged (against ``model.score`` of the holdout) and to
    65536 rows fused (against the same rows staged): EQUAL for a tree
    winner, within 1e-6 for a logistic one; one upload, one download and
    one sync a fused batch; the predictions mapped back to labels.
    Returns the row and the (x, y) of the checked training vector."""
    import tempfile

    from transmogrifai_tpu_torch.models import trees as TR
    from transmogrifai_tpu_torch.ops.text_stages import (
        OpIndexToString, OpStringIndexerModel,
    )
    from transmogrifai_tpu_torch.types import RealNN
    from transmogrifai_tpu_torch.types.columns import NumericColumn

    MF = multiclass_module()
    from fit_side_tables import WIDE_CLASSES, wide_hash_multiclass_table

    t0 = time.perf_counter()
    schema, columns = wide_hash_multiclass_table(MULTICLASS_ROWS)
    ds = MF.dataset("port", schema, columns)
    table_s = time.perf_counter() - t0
    wf, pred, selector, _ = MF.build("port", ds, None, device=DEV)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    with UtilizationSampler(period_ms=100) as util, TrainTimer() as timer, \
            ForestLanes(TR) as lanes:
        t1 = time.time()
        p0 = time.perf_counter()
        model = wf.train()
        torch.cuda.synchronize()
        total = time.perf_counter() - p0
        t2 = time.time()
    seconds = timer.split(total)
    launches = {k: fn.launches for k, fn in counters.items()}
    for fn in counters.values():
        fn.launches = 0
    busy = util.between(t1, t2)
    summary = model.summary_json()["modelSelectorSummary"]
    check_lanes("train_multiclass", summary)
    glm = summary["bestModelType"] in GLM_FAMILIES
    want_k = (3 + 1) * RF_POINTS_PER_DEPTH * MULTICLASS_CLASSES
    rf_fits = [f for f in lanes.fits if f["per_lane_targets"]]
    if len(rf_fits) != 3 or any(f["K"] != want_k for f in rf_fits):
        raise AssertionError(f"train_multiclass: forest fits {lanes.fits}, "
                             f"expected 3 groups at K = {want_k}")
    required = ["hist_binloop", "node_order", "split_search", "leaf_sum"]
    if not glm:
        required += ["serve_trees", "tree_sum"]
    for k in required:
        if not launches[k]:
            raise AssertionError(f"train_multiclass: {k} never ran")

    # the winner's refit lane against a direct refit on the same mask
    train_idx, holdout_idx = selector.splitter.split(ds.num_rows)
    info = model.selector_info
    data = model.score(ds.take(train_idx), keep_intermediate_features=True)
    xt = np.asarray(data[info["vectorName"]].values, dtype=np.float32)
    yt = data[info["labelName"]].values.astype(np.float32)
    family, grid = next((est, g) for est, g in selector.models
                        if type(est).__name__ == summary["bestModelType"])
    keep = selector.splitter.prepare(yt)
    t0 = time.perf_counter()
    want = family.with_params(**summary["bestGrid"]).fit_arrays_batched_masks(
        xt[keep], yt[keep], [np.ones(int(keep.sum()), np.float32)],
        [dict(summary["bestGrid"])])[0][0].get_arrays()
    direct_s = time.perf_counter() - t0
    got = model.fitted[info["estimatorUid"]].best_model.get_arrays()
    refit_diff = max(float(np.max(np.abs(np.subtract(got[k], want[k]))))
                     for k in want) if glm else 0.0
    if sorted(got) != sorted(want) or (glm and not refit_diff <= MULTI_REFIT_TOL) \
            or (not glm and not all(np.array_equal(got[k], want[k],
                                                   equal_nan=True)
                                    for k in want)):
        raise AssertionError(f"train_multiclass: the refit differs from a "
                             f"direct refit ({refit_diff})")

    # save, load, and the holdout staged and fused
    holdout = ds.take(holdout_idx)
    with tempfile.TemporaryDirectory() as tmp:
        model.save(os.path.join(tmp, "m"))
        loaded = load_workflow_model(os.path.join(tmp, "m"))
    base = holdout.rows()
    raw_features = [f for f in loaded.raw_features if not f.is_response]
    stg_rows = (base * (-(-MULTICLASS_STAGED_ROWS // len(base))))[
        :MULTICLASS_STAGED_ROWS]
    fn = score_function(loaded)
    p0 = time.perf_counter()
    staged_scores = score_matrix(fn.batch(stg_rows))
    staged_s = time.perf_counter() - p0
    # a GLM's float64 core on the card blocks its product by the batch's
    # rows: the reference's 1e-6 across batch sizes, trees EQUAL
    want_scores = score_matrix(model.score(holdout)[pred.name])
    reps = -(-MULTICLASS_STAGED_ROWS // len(base))
    staged_err = same_scores(
        "train_multiclass staged 8192 rows against model.score", staged_scores,
        np.tile(want_scores, (reps, 1))[:MULTICLASS_STAGED_ROWS], glm)
    fused_ds = dataset_of((base * (-(-MULTICLASS_FUSED_ROWS // len(base))))[
        :MULTICLASS_FUSED_ROWS], raw_features)
    if not fn.prime_fused():
        raise AssertionError(f"train_multiclass: no fused program "
                             f"({fused_md(fn)['reason']})")
    counter = FusedLaunches(ST, TS)
    fused = score_matrix(counter.counted(lambda: fn.columns(fused_ds))[pred.name])
    stg = score_matrix(staged(fn, lambda: fn.columns(fused_ds))[pred.name])
    fused_err = same_scores("train_multiclass fused", fused, stg, glm)
    fused_s = host_seconds(
        lambda: counter.counted(lambda: fn.columns(fused_ds)))
    transfers = fused_transfers(torch, TS, counter, fn,
                                lambda: fn.columns(fused_ds),
                                MULTICLASS_FUSED_ROWS)
    md = fused_md(fn)
    if md["fallbacks"]:
        raise AssertionError(f"train_multiclass: fused fallbacks {md}")
    if fused.shape[1] != 1 + 2 * MULTICLASS_CLASSES:
        raise AssertionError(f"train_multiclass: score columns {fused.shape}")
    # the predicted indices back to the labels
    labels = next(s.labels for s in loaded.fitted.values()
                  if isinstance(s, OpStringIndexerModel))
    named = OpIndexToString(labels).transform_columns(NumericColumn(
        RealNN, want_scores[:, 0], np.ones(len(want_scores), bool)),
        num_rows=len(want_scores)).values
    truth = [r["label"] for r in base]
    accuracy = float(np.mean([a == b for a, b in zip(named, truth)]))
    if sorted(labels) != sorted(WIDE_CLASSES) or not set(named) <= set(labels) \
            or not accuracy > 1.0 / MULTICLASS_CLASSES:
        raise AssertionError(f"train_multiclass: labels {labels}, accuracy "
                             f"{accuracy}")
    return {"card": smi, "rows": ds.num_rows, "table_s": table_s,
            "vector_columns": int(xt.shape[1]), "classes": labels,
            "train_rows": model.train_rows, "holdout_rows": model.holdout_rows,
            **seconds,
            "device_busy_share": sum(busy) / len(busy) / 100.0 if busy
            else "not measured", "busy_samples": len(busy),
            "launches": launches, "forest_fits": rf_fits,
            "winner": summary["bestModelType"], "grid": summary["bestGrid"],
            "candidates": len(summary["validationResults"]),
            "refit_against_direct": "equal" if refit_diff == 0.0
            else f"within {MULTI_REFIT_TOL}", "refit_max_diff": refit_diff,
            "direct_refit_s": direct_s,
            "staged_rows": MULTICLASS_STAGED_ROWS, "staged_s": staged_s,
            "staged_vs_score_max_abs_err": staged_err,
            "fused_rows": MULTICLASS_FUSED_ROWS,
            "fused_vs_staged_max_abs_err": fused_err,
            "fused_rows_per_s": MULTICLASS_FUSED_ROWS / fused_s,
            "transfers": transfers, "fused_launches": dict(counter.total),
            "holdout_accuracy": accuracy,
            "_xy": (xt[keep], yt[keep])}


def multiclass_row(summary: dict, k: int) -> dict:
    """A kernel's means at the multiclass sweep's lane count, for the
    kernels line."""
    return {"K": k, **{key: summary[key] for key in
                       ("ms", "plain_ms", "library_ms", "bound_ms",
                        "max_abs_err") if key in summary}}


def multiclass_kernels(torch, H, LS, TR, x, y) -> dict:
    """The training kernels at the multiclass sweep's shapes, on the
    full-width checked vector: the default RF grid's depth-12 group (6
    points, one tree) over the selector's masks, 3 folds and the refit
    mask, x 4 classes, K = 96 as in ``train_multiclass``, captured in the
    grower (K2, the split search, the leaf sums; the row order beside K2)
    and each launch held against its plain version and timed beside its
    bound (every fourth level's launch; K3 every third); then K3 at 256
    bins on a three-class label (the top two classes merged) over the
    depth-6 group and the 3 folds, K = 54."""
    from transmogrifai_tpu_torch.models import gbdt as G
    from transmogrifai_tpu_torch.selector.model_selector import _rf_grid
    from transmogrifai_tpu_torch.selector.validators import (
        CrossValidator, expand_grid,
    )

    folds = [m.astype(np.float32) for m, _ in
             CrossValidator(num_folds=3, seed=42).split_masks(y)]
    # the selector's refit mask rides the sweep as one more lane group
    masks = folds + [np.ones(len(y), np.float32)]
    points = expand_grid(_rf_grid())
    trees_per_fit = points[0]["num_trees"]
    deep = [dict(p, num_trees=1) for p in points if p["max_depth"] == 12]
    mid = [dict(p, num_trees=1, max_bins=256) for p in points
           if p["max_depth"] == 6]
    out = {}
    with KernelCapture(H, TR, "hist_binloop", {"rf": 0}) as cap, \
            SplitCapture(H, TR, {"rf": 0}) as scap, LeafCapture(LS) as lcap:
        cap.start("rf")
        scap.start("rf")
        lcap.path = "multiclass"
        G.RandomForestClassifier(device=DEV).fit_arrays_batched_masks(
            x, y, masks, deep)
    ks = {int(r["args"][1].shape[0]) for r in cap.records}
    if ks != {(3 + 1) * RF_POINTS_PER_DEPTH * MULTICLASS_CLASSES} or \
            len(deep) != RF_POINTS_PER_DEPTH:
        raise AssertionError(f"multiclass_kernels: K2 ran at K = {ks}")
    weights = {"rf": trees_per_fit}
    # every fourth captured launch of the tree's levels (each relaunch is
    # checked and timed in several profiler sessions)
    out["hist_binloop"] = check_main_launches(torch, H, "hist_binloop",
                                              cap.records[::4], weights)
    out["split_search"] = check_split_launches(torch, H, scap.records[::4],
                                               weights)
    out["leaf_sum"] = check_leaf_path(torch, H, LS, lcap.records)
    y3 = np.minimum(y, 2.0).astype(np.float32)
    with KernelCapture(H, TR, "hist_wide", {"rf": 0}) as cap3:
        cap3.start("rf")
        G.RandomForestClassifier(device=DEV).fit_arrays_batched_masks(
            x, y3, folds, mid)
    ks3 = {int(r["args"][1].shape[0]) for r in cap3.records}
    if ks3 != {3 * len(mid) * 3}:
        raise AssertionError(f"multiclass_kernels: K3 ran at K = {ks3}")
    out["hist_wide"] = check_main_launches(torch, H, "hist_wide",
                                           cap3.records[::3], weights,
                                           library_per_tree=True)
    H.build_histogram_binloop.launches = H.build_histogram_wide.launches = 0
    H.node_order.launches = H.split_search.launches = LS.leaf_sum.launches = 0
    return {"K2_K": sorted(ks)[0], "K3_K": sorted(ks3)[0], **out}


#: the fused scoring graph's phase: batches of the twin fixtures' rows
#: tiled to these counts (20000 buckets to 24576, padded; 65536 is a bucket)
FUSED_TILES = (20000, 65536)
#: fresh full-width rows scored by the model trained on wide_hash_table
FUSED_WIDE_ROWS = 65536
FUSED_WIDE_SEED = 2025
#: the training rows of the full-width hash-text model (train_wide's)
WIDE_HASH_TRAIN_ROWS = 16384
FUSED_GLM_ATOL = 1e-6
#: the JAX package's reason for a SmartText member of Pivot and Hash slots
#: (transmogrifai_tpu/compiler/fused.py:891-893)
MIXED_TEXT_REASON = "smart-text member mixes Pivot and Hash slots — not fuseable"


def score_matrix(out) -> np.ndarray:
    """[N, 1 + 2C] prediction, C probabilities, C raw margins of
    ``.batch``'s result dicts or of a prediction column (``.columns``)."""
    if isinstance(out, list):
        preds = [next(iter(r.values())) for r in out]
        c = sum(k.startswith("probability_") for k in preds[0])
        return np.array([[p["prediction"]]
                         + [p[f"probability_{k}"] for k in range(c)]
                         + [p[f"rawPrediction_{k}"] for k in range(c)]
                         for p in preds])
    return np.column_stack([np.asarray(out.prediction),
                            np.asarray(out.probability), np.asarray(out.raw)])


def same_scores(what: str, got: np.ndarray, want: np.ndarray,
                glm: bool) -> float:
    """Trees EQUAL; a GLM's predictions equal, its probabilities within
    ``FUSED_GLM_ATOL`` and its raw margins within that plus 1e-6 of their
    size (float32 core against float64). Returns the largest difference."""
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: bad scores {got.shape}")
    err = float(np.abs(got - want).max())
    if not glm:
        if not np.array_equal(got, want):
            raise AssertionError(f"{what}: tree scores differ ({err})")
        return err
    c = (got.shape[1] - 1) // 2
    prob_err = float(np.abs(got[:, 1:1 + c] - want[:, 1:1 + c]).max())
    raw_ok = np.all(np.abs(got[:, 1 + c:] - want[:, 1 + c:])
                    <= FUSED_GLM_ATOL + 1e-6 * np.abs(want[:, 1 + c:]))
    if not (np.array_equal(got[:, 0], want[:, 0])
            and prob_err <= FUSED_GLM_ATOL and raw_ok):
        raise AssertionError(f"{what}: GLM scores differ (max {err})")
    return err


def dataset_of(rows: list[dict], features):
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.types.columns import column_from_values

    return Dataset.of({f.name: column_from_values(
        f.ftype, [r.get(f.name) for r in rows]) for f in features
        if not f.is_response})


def staged(fn, call):
    """``call`` on the staged loop (``TPTPU_FUSED=0`` is read per batch)."""
    os.environ["TPTPU_FUSED"] = "0"
    try:
        return call()
    finally:
        del os.environ["TPTPU_FUSED"]


def fused_md(fn) -> dict:
    return fn.metadata()["fused"]


def host_seconds(call, reps: int = 1) -> float:
    """The least host-clock seconds of ``reps`` calls of ``call``, each
    after a full garbage collection (a collection that falls inside a call
    costs it tens of milliseconds on the large heaps of this script)."""
    import gc

    best = math.inf
    for _ in range(reps):
        gc.collect()
        t0 = time.perf_counter()
        call()
        best = min(best, time.perf_counter() - t0)
    return best


def expected_launches(TS, prog, b: int) -> tuple[int, int]:
    """(K1, device-route sums) one fused batch of ``b`` rows makes: per
    stack one walk, a second over the leaf windows where they are more than
    one, and one sum; (0, 0) for a GLM."""
    best = prog.predictor.best_model if hasattr(prog.predictor, "best_model") \
        else prog.predictor
    stacks = getattr(best, "device_stacks", [])
    k1 = sum(2 if TS.leaf_windows(b, p.depth) > 1 else 1 for p in stacks)
    return k1, len(stacks)


class FusedLaunches:
    """K1's and the device-route sum's launches made inside fused batches
    (``counted(call)``), apart from the staged batches the phase compares
    them with."""

    def __init__(self, ST, TS):
        self.ST, self.TS = ST, TS
        self.total = {"serve_trees": 0, "tree_sum_device_route": 0}

    def read(self) -> tuple[int, int]:
        return (self.ST.serve_trees.launches,
                self.TS.tree_sum_device_route.launches)

    def counted(self, call):
        before = self.read()
        out = call()
        after = self.read()
        for k, b, a in zip(self.total, before, after):
            self.total[k] += a - b
        return out


def dispatched_copies(torch, call) -> dict:
    """The copies between host and card that PyTorch's dispatcher runs in
    ``call``, by direction: every ``copy_`` and ``_to_copy`` of a non-empty
    tensor whose source and destination lie on different device types,
    seen through a
    ``TorchDispatchMode`` (what the program asks the runtime to copy; the
    profiler's memcpy activities are what the card recorded)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counts = {"h2d": 0, "d2h": 0}
    aten = torch.ops.aten

    class Copies(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            packet = func.overloadpacket
            if packet in (aten.copy_, aten._to_copy):
                src, dst = ((args[1], args[0]) if packet is aten.copy_
                            else (args[0], out))
                kinds = (src.device.type, dst.device.type) if src.numel() \
                    else None
                if kinds == ("cpu", "cuda"):
                    counts["h2d"] += 1
                elif kinds == ("cuda", "cpu"):
                    counts["d2h"] += 1
            return out

    with Copies():
        call()
    return counts


def fused_transfers(torch, TS, counter, fn, call, b: int) -> dict:
    """One fused batch after the first: its copies between host and card,
    its host synchronizations (``count_syncs``), and the kernels it
    launched against the expected counts. Fails unless it made exactly one
    upload, one download and one sync.

    The copies are read twice. The dispatcher's (``dispatched_copies``)
    must be one upload and one download. ``torch.profiler``'s are the
    runtime's memcpy calls (``cudaMemcpyAsync``, both directions) and the
    card's memcpy activities by direction. On the card a session sometimes
    records the call of the pinned upload but drops its device activity,
    so the uploads are the memcpy calls less the downloads the card
    recorded; where a session recorded device activity, that must be one
    upload and one download too. Late in a long run every session can come
    back without device activity (once a machine's profiler stops
    recording it, as ``device_ms``' CUDA-event fallbacks show): after
    ``PROFILE_TRIES`` such sessions the count is the dispatcher's alone,
    said so in ``copies_source`` and counted in
    ``fused_transfers.profiler_empty``, never read as zero copies."""
    from torch.profiler import ProfilerActivity, profile

    counter.counted(call)  # the program's first batch uploads its params
    prog = fn.fused_state["program"]
    before = counter.read()
    _, syncs, msgs = count_syncs(torch, lambda: counter.counted(call))
    launches = tuple(a - b for a, b in zip(counter.read(), before))
    want = expected_launches(TS, prog, b)
    dispatched = dispatched_copies(torch, lambda: counter.counted(call))
    # a session that misses an activity is taken again (the profiler
    # sometimes drops a few on the card, ``device_ms``)
    sessions = []
    for attempt in range(PROFILE_TRIES):
        time.sleep(0.25 * attempt)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            counter.counted(call)
            torch.cuda.synchronize()
        counts = {"memcpy_calls": 0, "h2d": 0, "d2h": 0, "kernels": 0}
        for evt in prof.key_averages():
            key = evt.key.lower()
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                if key.startswith("cudamemcpy"):
                    counts["memcpy_calls"] += evt.count
                continue
            kind = ("h2d" if "memcpy htod" in key else "d2h"
                    if "memcpy dtoh" in key else "kernels")
            counts[kind] += evt.count
        sessions.append(counts)
        if counts["kernels"] and counts["memcpy_calls"] and counts["d2h"]:
            break
    copies = dict(sessions[-1])
    recorded = bool(copies["kernels"] and copies["d2h"])
    if recorded:
        copies["uploads"] = copies["memcpy_calls"] - copies["d2h"]
        source = "profiler and dispatcher"
    else:
        fused_transfers.profiler_empty += 1
        copies["uploads"], copies["d2h"] = dispatched["h2d"], dispatched["d2h"]
        source = (f"dispatcher (the profiler's {len(sessions)} sessions "
                  "recorded no device activity)")
    if ((dispatched["h2d"], dispatched["d2h"]) != (1, 1)
            or (copies["uploads"], copies["d2h"], copies["h2d"] <= 1, syncs)
            != (1, 1, True, 1)):
        raise AssertionError(
            f"fused_serving: {copies} copies ({dispatched} dispatched) and "
            f"{syncs} host syncs in one batch ({msgs}; sessions {sessions})")
    if launches != want:
        raise AssertionError(f"fused_serving: launched K1 and the route sum "
                             f"{launches} times, expected {want}")
    return {"uploads": copies["uploads"], "downloads": copies["d2h"],
            "host_syncs": syncs, "copies_source": source,
            "dispatched_copies": dispatched,
            "kernels_profiled": copies["kernels"],
            "profiler_sessions": sessions,
            "serve_trees_launches": launches[0],
            "tree_sum_device_route_launches": launches[1]}


#: batches whose profiler sessions all came back without device activity
fused_transfers.profiler_empty = 0


def fused_span(torch, TR, counter, fn, call) -> dict:
    """One fused batch under ``torch.profiler``: device ms by group
    (members, gathers, ``bin_data``, K1, the tree sum, the copies, the
    rest), the host ingest seconds of its members, the bytes up and down,
    and its host-clock seconds unprofiled."""
    from torch.profiler import ProfilerActivity, profile, record_function

    prog = fn.fused_state["program"]
    seen = {}
    real = {"assemble": prog.assemble, "gather": prog.gather,
            "run": prog.run, "bin_data": TR.bin_data}

    def ranged(name, f):
        def inner(*a, **kw):
            with record_function(f"fused.{name}"):
                return f(*a, **kw)
        return inner

    def run(cols, b, n):
        t0 = time.perf_counter()
        for m in prog.members:
            m.ingest([cols[nm] for nm in m.stage.input_names])
        seen["ingest_s"] = time.perf_counter() - t0
        core, info = real["run"](cols, b, n)
        seen.update(info)
        return core, info

    counter.counted(call)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counter.counted(call)
    host_s = time.perf_counter() - t0
    prog.assemble = ranged("members", real["assemble"])
    prog.gather = ranged("gather", real["gather"])
    prog.run = run
    TR.bin_data = ranged("bin_data", real["bin_data"])
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            counter.counted(call)
            torch.cuda.synchronize()
    finally:
        for k in ("assemble", "gather", "run"):
            setattr(prog, k, real[k])
        TR.bin_data = real["bin_data"]
    ms = {"upload": 0.0, "download": 0.0, "K1 serve_trees": 0.0,
          "tree_sum": 0.0}
    total = 0.0
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", 0.0)
        # the ranges' card-side annotations span their kernels and the
        # gaps between them: not device work of their own
        if not t or evt.device_type != torch.autograd.DeviceType.CUDA \
                or evt.key.startswith("fused."):
            continue
        total += t / 1e3
        name = evt.key.lower()
        key = ("upload" if "htod" in name else "download" if "dtoh" in name
               else "K1 serve_trees" if "serve_trees" in name
               else "tree_sum" if "tree_sum" in name or "route_pairs" in name
               else None)
        if key:
            ms[key] += t / 1e3
    for group in ("members", "gather", "bin_data"):
        # the kernels under the host-side range (its card-side annotation
        # spans the launch gaps as well)
        ms[group] = sum(e.device_time_total for e in prof.events()
                        if e.name == f"fused.{group}" and e.device_type
                        == torch.autograd.DeviceType.CPU) / 1e3
    if not total:
        return {"device_ms": "not measured", "host_s": host_s}
    ms["rest"] = total - sum(ms.values())
    return {"device_ms": ms, "device_total_ms": total,
            "bin_data_share": ms["bin_data"] / total, "host_s": host_s,
            "ingest_s": seen.get("ingest_s"), "up_bytes": seen.get("upBytes"),
            "down_bytes": seen.get("downBytes")}


def jax_fused_scores() -> dict:
    """The JAX package's scores above the cutoff, recorded by
    ``tests/torch_fixtures/make_fused_fixtures.py`` (``score_matrix``
    columns; the twins' 256 rows, which their tiles repeat)."""
    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_fused",
                              "jax_scores.npz")) as z:
        return {k: z[k] for k in z.files}


def fused_text_xgb(counter, load_workflow_model, score_function) -> dict:
    """The hash-text fixture ``text_xgb`` (20 boosted trees of depth 4,
    whose device-route sum runs in 8 lanes, ROADMAP.md C4) with
    ``TPTPU_HOST_PREDICT_MAX=0``: fused and staged on the card EQUAL the
    JAX package's fused path."""
    path = os.path.join(ROOT, "tests", "fixtures", "torch_fused", "text_xgb")
    with open(os.path.join(path, "rows.json")) as fh:
        rows = json.load(fh)
    want = jax_fused_scores()["text_xgb"]
    os.environ["TPTPU_HOST_PREDICT_MAX"] = "0"
    try:
        fn = score_function(load_workflow_model(path))
        fused = score_matrix(counter.counted(lambda: fn.batch(rows)))
        stg = score_matrix(staged(fn, lambda: fn.batch(rows)))
    finally:
        del os.environ["TPTPU_HOST_PREDICT_MAX"]
    md = fused_md(fn)
    if md["dispatches"] != 1 or md["fallbacks"]:
        raise AssertionError(f"text_xgb: not fused {md}")
    return {"rows": len(rows),
            "fused_vs_jax": same_scores("text_xgb fused", fused, want, False),
            "staged_vs_jax": same_scores("text_xgb staged", stg, want, False)}


def fused_twins(torch, TS, TR, counter, load_workflow_model,
                score_function):
    """The twin fixtures' rows tiled to ``FUSED_TILES`` through ``.batch``
    and ``.columns`` at the default cutoff: fused against staged on the
    card and against the port's fused path on the CPU, rows/s of both
    paths, transfers and the device span of a 65536-row batch."""
    out, rates, transfers, spans = {}, {}, {}, {}
    jax = jax_fused_scores()
    for name in ("xgb", "rf", "lr"):
        path, rows, _ = load_fixture(name)
        glm = name == "lr"
        model = load_workflow_model(path)
        fn = score_function(model)
        cpu = score_function(load_workflow_model(path, device="cpu"),
                             device="cpu")
        if not fn.prime_fused():
            raise AssertionError(f"{name}: no fused program "
                                 f"({fused_md(fn)['reason']})")
        errs, rates[name] = {}, {}
        for n in FUSED_TILES:
            big = (rows * -(-n // len(rows)))[:n]
            ds = dataset_of(big, model.raw_features)
            before = fused_md(fn)["dispatches"]
            fused = score_matrix(counter.counted(lambda: fn.batch(big)))
            cols = score_matrix(next(iter(
                counter.counted(lambda: fn.columns(ds)).values())))
            if fused_md(fn)["dispatches"] != before + 2:
                raise AssertionError(f"{name} {n}: not every batch fused")
            stg = score_matrix(staged(fn, lambda: fn.batch(big)))
            errs[n] = {
                "fused_vs_staged": same_scores(f"{name} {n}", fused, stg, glm),
                "columns_vs_batch": same_scores(f"{name} {n} columns", cols,
                                                fused, False),
            }
            if not glm:
                errs[n]["card_vs_cpu_fused"] = same_scores(
                    f"{name} {n} cpu", fused, score_matrix(cpu.batch(big)),
                    False)
                errs[n]["card_vs_jax_fused"] = same_scores(
                    f"{name} {n} jax", fused,
                    np.resize(jax[name], fused.shape), False)
            rates[name][n] = {
                "fused_rows_per_s": n / host_seconds(
                    lambda: counter.counted(lambda: fn.batch(big))),
                "staged_rows_per_s": n / host_seconds(
                    lambda: staged(fn, lambda: fn.batch(big)))}
        n = FUSED_TILES[-1]
        big = (rows * -(-n // len(rows)))[:n]
        transfers[name] = fused_transfers(torch, TS, counter, fn,
                                          lambda: fn.batch(big), n)
        spans[name] = fused_span(torch, TR, counter, fn,
                                 lambda: fn.batch(big))
        md = fused_md(fn)
        if md["fallbacks"] or not md["active"]:
            raise AssertionError(f"{name}: fused fallbacks {md}")
        out[name] = {"max_abs_err": errs, "dispatches": md["dispatches"],
                     "fallbacks": md["fallbacks"],
                     "fingerprint": md["fingerprint"]}
    return out, rates, transfers, spans


def wide_hash_dataset(n: int, seed: int):
    sys.path.insert(0, os.path.join(ROOT, "tests", "torch_fixtures"))
    from fit_side_tables import wide_hash_table

    from transmogrifai_tpu_torch import types as PT
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.types.columns import column_from_values

    schema, columns = wide_hash_table(n, seed)
    return Dataset.of({k: column_from_values(
        PT.feature_type_by_name(schema[k]), v) for k, v in columns.items()})


def fused_full_width(torch, TS, TR, counter, trained, score_function) -> dict:
    """65536 fresh rows of ``wide_hash_table`` through ``.columns`` of the
    model ``train_wide trees`` trained: fused EQUAL staged,
    ``quantized=True`` EQUAL the float32 plane, with the program's
    ``describe()``, transfers and device span."""
    model, pred, seconds, summary = trained
    t0 = time.perf_counter()
    fresh = wide_hash_dataset(FUSED_WIDE_ROWS, FUSED_WIDE_SEED)
    table_s = time.perf_counter() - t0
    fn = score_function(model)
    quant = score_function(model, quantized=True)
    if not (fn.prime_fused() and quant.prime_fused()):
        raise AssertionError(f"wide_hash: no fused program "
                             f"({fused_md(fn)['reason']})")
    prog = fn.fused_state["program"]
    fused = score_matrix(counter.counted(lambda: fn.columns(fresh))[pred.name])
    stg = score_matrix(staged(fn, lambda: fn.columns(fresh))[pred.name])
    fused_s = host_seconds(lambda: counter.counted(
        lambda: fn.columns(fresh)))
    staged_s = host_seconds(lambda: staged(fn, lambda: fn.columns(fresh)))
    err = same_scores("wide_hash fused", fused, stg, False)
    qerr = same_scores("wide_hash quantized", score_matrix(counter.counted(
        lambda: quant.columns(fresh))[pred.name]), fused, False)
    transfers = fused_transfers(torch, TS, counter, fn,
                                lambda: fn.columns(fresh), FUSED_WIDE_ROWS)
    span = fused_span(torch, TR, counter, fn, lambda: fn.columns(fresh))
    md = fused_md(fn)
    if md["fallbacks"] or fused_md(quant)["fallbacks"]:
        raise AssertionError(f"wide_hash: fused fallbacks {md}")
    return {
        "train_rows": WIDE_HASH_TRAIN_ROWS, "train_split": seconds,
        "winner": summary["bestModelType"], "grid": summary["bestGrid"],
        "rows": FUSED_WIDE_ROWS, "table_s": table_s,
        "vector_columns": prog.plane_width, "predictor_width": prog.width,
        "fused_vs_staged_max_abs_err": err, "quantized_vs_float32": qerr,
        "fused_rows_per_s": FUSED_WIDE_ROWS / fused_s,
        "staged_rows_per_s": FUSED_WIDE_ROWS / staged_s,
        "transfers": transfers, "span": span,
        "quantized_up_bytes_per_row":
            quant.fused_state["program"].up_bytes_per_row,
        "dispatches": md["dispatches"], "fallbacks": md["fallbacks"],
        "describe": {k: v for k, v in prog.describe().items()
                     if k not in ("coveredStages", "quantPlans")},
    }


def fused_refusals(torch, wide_model, load_workflow_model,
                   score_function) -> dict:
    """The full-width model of ``train_wide`` and the CSV twin's model
    (SmartText members of Pivot and Hash slots) build no program, with the
    JAX package's reason, and their batches above the cutoff score staged,
    counted as unfuseable."""
    out = {}
    csv_path = os.path.join(FIT_SIDE, "csv_model")
    with open(os.path.join(csv_path, "rows.json")) as fh:
        csv_rows = json.load(fh)
    sys.path.insert(0, os.path.join(ROOT, "tests", "torch_fixtures"))
    from fit_side_tables import wide_table

    schema, columns = wide_table(FUSED_TILES[0], FUSED_WIDE_SEED)
    wide_rows = [{k: columns[k][i] for k in schema if k != "label"}
                 for i in range(FUSED_TILES[0])]
    for name, model, rows in (
            ("train_wide", wide_model, wide_rows),
            ("csv_twin", load_workflow_model(csv_path), csv_rows)):
        fn = score_function(model)
        if fn.prime_fused():
            raise AssertionError(f"{name}: a fused program was built")
        reason = fused_md(fn)["reason"]
        if reason != MIXED_TEXT_REASON:
            raise AssertionError(f"{name}: reason {reason!r}")
        big = (rows * -(-FUSED_TILES[0] // len(rows)))[:FUSED_TILES[0]]
        got = fn.batch(big)
        md = fused_md(fn)
        if (md["dispatches"], md["fallbacks"], md["fallbackReasons"]) != (
                0, 0, {"unfuseable": 1}) or len(got) != len(big):
            raise AssertionError(f"{name}: {md}")
        out[name] = {"reason": reason, "rows": len(big),
                     "fallbackReasons": md["fallbackReasons"]}
    return out


def fused_serving(torch, smi: str, ST, TS, TR, wide_model, trained,
                  load_workflow_model, score_function) -> dict:
    """The fused scoring graph on the card (``compiler/fused.py``): the
    twin fixtures and a full-width hash-text model fused, the refused
    models staged; K1's and the device-route sum's launches counted from 0
    over the fused batches (``FusedLaunches``; the staged batches they are
    compared with are not counted)."""
    t0 = time.perf_counter()
    ST.serve_trees.launches = TS.tree_sum_device_route.launches = 0
    counter = FusedLaunches(ST, TS)
    twins, rates, transfers, spans = fused_twins(
        torch, TS, TR, counter, load_workflow_model, score_function)
    phase("fused_serving twins", card=smi, twins=twins, rows_per_s=rates,
          transfers_per_batch=transfers, span=spans,
          seconds=time.perf_counter() - t0)
    text_xgb = fused_text_xgb(counter, load_workflow_model, score_function)
    phase("fused_serving text_xgb", card=smi, **text_xgb)
    wide = fused_full_width(torch, TS, TR, counter, trained, score_function)
    phase("fused_serving wide_hash", card=smi, **wide,
          seconds=time.perf_counter() - t0)
    launches = dict(counter.total)
    ST.serve_trees.launches = TS.tree_sum_device_route.launches = 0
    if not all(launches.values()):
        raise AssertionError(f"fused_serving: launches {launches}")
    refusals = fused_refusals(torch, wide_model, load_workflow_model,
                              score_function)
    return {"card": smi, "twins": twins, "text_xgb": text_xgb,
            "rows_per_s": rates,
            "transfers_per_batch": transfers,
            f"span_{FUSED_TILES[-1]}": spans,
            "wide_hash": wide, "refused": refusals,
            "launches": launches, "seconds": time.perf_counter() - t0}


# ---------------------------------------------------- the featurize plane
#: the JAX package's native build (``native/Makefile``), which the port
#: never loads or rewrites; absent from a checkout that holds only the
#: files git tracks
NATIVE_SO = os.path.join(ROOT, "native", "libtptpu.so")
FEATURIZE_ROWS = 65536
FEATURIZE_BATCH = 8192


def file_sha256(path: str) -> str | None:
    import hashlib

    if not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@contextlib.contextmanager
def plain_routes():
    """The featurize plane's plain routes: every native kernel's Python
    route (``TPTPU_DISABLE_NATIVE``, read per call) and one thread."""
    saved = {k: os.environ.get(k)
             for k in ("TPTPU_DISABLE_NATIVE", "TPTPU_FEATURIZE_THREADS")}
    os.environ.update(TPTPU_DISABLE_NATIVE="1", TPTPU_FEATURIZE_THREADS="1")
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def plane_transmogrify(torch, ds) -> dict:
    """``transmogrify`` fit and transform over ``ds`` (host seconds of
    each, the featurizeStats delta), then the SanityChecker's fit of the
    vector on the card: the vector column and the keep-set."""
    from transmogrifai_tpu_torch.features import from_dataset
    from transmogrifai_tpu_torch.featurize import stats as fstats
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.stages.base import Estimator
    from transmogrifai_tpu_torch.utils import uid
    from transmogrifai_tpu_torch.workflow.dag import compute_dag

    uid.reset()  # the same stage names on both routes
    resp, preds = from_dataset(ds, response="label")
    vec = transmogrify(preds)
    checked = resp.sanity_check(vec, remove_bad_features=True)
    before = fstats.snapshot()
    fit_s = transform_s = 0.0
    data = ds
    for layer in compute_dag([vec]):
        t0 = time.perf_counter()
        models = [s.fit(data) if isinstance(s, Estimator) else s for s in layer]
        fit_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        for m in models:
            data = m.transform(data)
        transform_s += time.perf_counter() - t0
    stats = fstats.delta(before)
    checker = checked.origin_stage.fit(data)
    torch.cuda.synchronize()
    summary = checker.metadata["sanityCheckerSummary"]
    return {"vector": data[vec.name], "keep": keep_and_reasons(summary),
            "fit_s": fit_s, "transform_s": transform_s, "featurize": stats}


def plane_staged_scoring(fn, ds, pred_name: str) -> tuple:
    """``ds`` scored in 8192-row batches through ``fn.columns`` (below the
    host-predict cutoff: staged): (score matrix, seconds, fusedAssemblies
    of each batch)."""
    from transmogrifai_tpu_torch.featurize import stats as fstats

    parts, fused, seconds = [], [], 0.0
    for a in range(0, len(ds), FEATURIZE_BATCH):
        batch = ds.take(np.arange(a, min(a + FEATURIZE_BATCH, len(ds))))
        before = fstats.snapshot()
        t0 = time.perf_counter()
        out = fn.columns(batch)[pred_name]
        seconds += time.perf_counter() - t0
        fused.append(fstats.delta(before)["fusedAssemblies"])
        parts.append(score_matrix(out))
    return np.concatenate(parts), seconds, fused


def featurize_plane(torch, smi: str, ST, TS, trained, score_function,
                    native_so_before) -> dict:
    """The featurize plane (``featurize/``, ``native.py``) on the card's
    machine against its plain routes on ``wide_hash_table(65536)``, then
    the model ``fused_serving`` trained on ``wide_hash_table(16384)``
    scoring those 65536 rows staged in 8192-row batches (fused block
    assembly from the second batch on; EQUAL a closure on the plain
    routes) and all at once fused (the fusion planner's widths
    cross-checked, one upload, one download, one sync)."""
    sys.path.insert(0, os.path.join(ROOT, "tests", "torch_fixtures"))
    from fit_side_tables import WIDE_SEED

    from transmogrifai_tpu_torch import native

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    ds = wide_hash_dataset(FEATURIZE_ROWS, WIDE_SEED)
    table_s = time.perf_counter() - t0
    plane = plane_transmogrify(torch, ds)
    with plain_routes():
        plain = plane_transmogrify(torch, ds)
    pv, qv = plane["vector"], plain["vector"]
    if not (pv.is_sparse and not qv.is_sparse):
        raise AssertionError("featurize_plane: the plane's vector is not "
                             "sparse, or the plain routes' is")
    if not np.array_equal(np.asarray(pv.values), qv.values):
        raise AssertionError("featurize_plane: the plane's vector differs "
                             "from the plain routes'")
    if pv.metadata != qv.metadata:
        raise AssertionError("featurize_plane: metadata differ")
    if plane["keep"] != plain["keep"]:
        raise AssertionError("featurize_plane: keep-sets differ")
    routes = {name: {k: run[k] for k in ("fit_s", "transform_s", "featurize")}
              for name, run in (("plane", plane), ("plain", plain))}
    shape = list(pv.values.shape)
    nnz = pv.values.nnz
    del plane, plain, pv, qv

    model, pred, _, _ = trained
    on = score_function(model)
    got, on_s, fused_per_batch = plane_staged_scoring(on, ds, pred.name)
    with plain_routes():
        off = score_function(model)
        want, off_s, off_fused = plane_staged_scoring(off, ds, pred.name)
    if fused_per_batch != [0] + [1] * (len(fused_per_batch) - 1):
        raise AssertionError(f"featurize_plane: fusedAssemblies per batch "
                             f"{fused_per_batch}")
    same_scores("featurize_plane staged", got, want, False)

    counter = FusedLaunches(ST, TS)
    fn = score_function(model)
    if not fn.prime_fused() or not fn.fusion.ready():
        raise AssertionError(f"featurize_plane: no fused program or no "
                             f"learned widths ({fused_md(fn)['reason']})")
    fused = score_matrix(counter.counted(lambda: fn.columns(ds))[pred.name])
    # the same batch staged: above the cutoff both sum the trees in the
    # device route's order (the 8192-row batches took the host order)
    same_scores("featurize_plane fused", fused,
                score_matrix(staged(fn, lambda: fn.columns(ds))[pred.name]),
                False)
    transfers = fused_transfers(torch, TS, counter, fn,
                                lambda: fn.columns(ds), FEATURIZE_ROWS)
    native_so_after = file_sha256(NATIVE_SO)
    if native_so_after != native_so_before:
        raise AssertionError("featurize_plane: native/libtptpu.so changed")
    return {
        "card": smi,
        "native": {**native.build_info, "compiler": native.COMPILER,
                   "flags": list(native.CXX_FLAGS)},
        "native_libtptpu_so_sha256": {"before": native_so_before,
                                      "after": native_so_after},
        "nproc": len(os.sched_getaffinity(0)), "cpu_count": os.cpu_count(),
        "rows": FEATURIZE_ROWS, "table_s": table_s,
        "vector_shape": shape, "vector_nnz": nnz,
        "vectors_metadata_keep_equal": True, "routes": routes,
        "staged": {"batch_rows": FEATURIZE_BATCH,
                   "fused_assemblies_per_batch": fused_per_batch,
                   "fused_assemblies_per_batch_plain": off_fused,
                   "rows_per_s_plane": FEATURIZE_ROWS / on_s,
                   "rows_per_s_plain": FEATURIZE_ROWS / off_s,
                   "scores_equal_plain": True},
        "fused": {"rows": FEATURIZE_ROWS, "planner_widths": len(fn.fusion.widths),
                  "plane_width": fn.fusion.plane_width(),
                  "scores_equal_staged": True, "transfers": transfers,
                  "launches": dict(counter.total),
                  "featurizeStats": fn.metadata()["featurizeStats"]},
        "seconds": time.perf_counter() - t_phase,
    }


# ------------------------------------------------ the hardened closure
def hardening_module():
    """``tests/torch_fixtures/hardening.py``: the hardening scenarios, the
    card's constants and the JAX package's stored results."""
    sys.path.insert(0, os.path.join(ROOT, "tests", "torch_fixtures"))
    import hardening

    return hardening


def launch_counts(ST, TS) -> tuple[int, int, int]:
    """(K1, tree sum, device-route sum) launches so far."""
    return (ST.serve_trees.launches, TS.tree_sum.launches,
            TS.tree_sum_device_route.launches)


def counted_launches(ST, TS, record: dict, label: str, call):
    """``call()``, recording the K1 / tree-sum / route-sum launches it made
    under ``label``."""
    before = launch_counts(ST, TS)
    out = call()
    record[label] = [a - b for a, b in zip(launch_counts(ST, TS), before)]
    return out


def clean_counters(name: str, fn) -> dict:
    """The default closure's health after clean traffic: no guarded or
    quarantined row and no breaker transition, or the phase fails (a
    kernel that returned NaN would otherwise pass as a default)."""
    md = fn.metadata()
    moved = {nm: b["transitions"] for nm, b in md["breakers"].items()
             if b["transitions"] or b["consecutiveFailures"]}
    got = {"guardedRows": md["scoreGuard"]["guardedRows"],
           "quarantinedRows": md["quarantine"]["quarantinedRows"],
           "breakersMoved": moved,
           "fusedFallbacks": md["fused"]["fallbacks"]}
    if got != {"guardedRows": 0, "quarantinedRows": 0, "breakersMoved": {},
               "fusedFallbacks": 0}:
        raise AssertionError(f"serving_hardening {name}: clean traffic "
                             f"moved the counters {got}")
    return got


def hardening_clean(torch, ST, TS, H, P, name, fn, off, tiles, want,
                    stored) -> dict:
    """(a): the default closure EQUAL the all-off closure and the JAX
    package's scores, staged and fused, through ``.batch`` and
    ``.columns``; its counters clean; the same launches as the all-off
    closure; a fused batch one upload, one download, one sync."""
    glm = name == "lr"
    launches: dict = {}
    errs = {}
    for kind, (rows, ds) in tiles.items():
        got = {}
        for label, f in (("default", fn), ("all_off", off)):
            out = counted_launches(ST, TS, launches, f"{label} {kind} batch",
                                   lambda: f.batch(rows))
            cols = counted_launches(
                ST, TS, launches, f"{label} {kind} columns",
                lambda: next(iter(f.columns(ds).values())))
            got[label] = (out, score_matrix(out), score_matrix(cols))
        d_out, d_b, d_c = got["default"]
        _, o_b, o_c = got["all_off"]
        errs[kind] = {
            "default_vs_all_off": same_scores(f"{name} {kind}", d_b, o_b,
                                              False),
            "columns_default_vs_all_off": same_scores(
                f"{name} {kind} columns", d_c, o_c, False),
            "columns_vs_batch": same_scores(f"{name} {kind} columns", d_c,
                                            d_b, False),
        }
        if kind == "staged":
            errs[kind]["vs_jax"] = check_scores(name, d_out, want)
        else:
            errs[kind]["vs_jax"] = same_scores(
                f"{name} fused vs jax", d_b, jax_reference(name, len(d_b)),
                glm)
        for call in ("batch", "columns"):
            if (launches[f"default {kind} {call}"]
                    != launches[f"all_off {kind} {call}"]):
                raise AssertionError(
                    f"serving_hardening {name}: launches {launches}")
    prog = fn.fused_state["program"]
    k1, route = expected_launches(TS, prog, H.FUSED_ROWS)
    if launches["default fused batch"] != [k1, 0, route]:
        raise AssertionError(f"serving_hardening {name}: fused launches "
                             f"{launches['default fused batch']}, expected "
                             f"{[k1, 0, route]}")
    transfers = fused_transfers(
        torch, TS, FusedLaunches(ST, TS), fn,
        lambda: fn.batch(tiles["fused"][0]), H.FUSED_ROWS)
    counters = clean_counters(name, fn)
    fresh = H.scenario_card_clean(P, name)
    H.same(fresh, stored["clean"], 0.0, f"{name} (a) counters")
    return {"max_abs_err": errs, "launches": launches,
            "fused_transfers": transfers, "counters": counters,
            "counters_equal_jax": True}


def jax_reference(name: str, n: int) -> np.ndarray:
    """The JAX package's scores of the fixture's rows tiled to ``n``
    (``score_matrix`` columns): its fused scores for the trees
    (``jax_fused_scores``), its staged ones for the GLM (``expected.npz``),
    which ``same_scores`` holds the port's fused GLM to within
    ``FUSED_GLM_ATOL``."""
    if name != "lr":
        want = jax_fused_scores()[name]
    else:
        _, _, stored = load_fixture(name)
        want = np.column_stack([stored["prediction"], stored["probability"],
                                stored["raw"]])
    return np.resize(want, (n, want.shape[1]))


def hardening_quarantine(H, P, name, clean_scores, stored) -> dict:
    """(b): ``age`` malformed on ``MALFORMED_ROWS`` of 8192: exactly those
    rows quarantined, records and counters EQUAL the JAX package's (the
    defaults' scores within the model's tolerance), every other row EQUAL
    (a)."""
    q = H.scenario_card_quarantine(P, name)
    H.same(H.public(q), stored["quarantine"], H.tolerance(name),
           f"{name} (b)")
    got = score_matrix(q["_out"])
    keep = np.setdiff1d(np.arange(H.STAGED_ROWS), H.MALFORMED_ROWS)
    same_scores(f"{name} (b) other rows", got[keep], clean_scores[keep],
                False)
    return {"records": q["records"],
            "quarantinedRows": q["counters"]["quarantine"]["quarantinedRows"]}


def hardening_breaker(H, P, name, stored) -> dict:
    """(c): the covered stage of ``age`` fails twice and its breaker opens;
    with the plan gone, a 65536-row batch goes staged and defaulted, the
    probe after the cooldown runs staged and closes the breaker, and the
    next batch fuses. Breaker states, counters and the default EQUAL the
    JAX package's; the probe's and the fused batch's scores EQUAL its
    scores (trees' fused EQUAL; lr within 1e-6 of its staged ones)."""
    c = H.scenario_card_breaker(P, name, H.FUSED_ROWS)
    if c["fused"] != [0, 0, 1]:
        raise AssertionError(f"serving_hardening {name}: fused {c['fused']}")
    H.same(H.public(c), stored["breaker"], H.tolerance(name),
           f"{name} (c)")
    batches = c["_batches"]
    default = c["default"]
    if any(H.plain(r) != default for r in batches[0]["scores"]):
        raise AssertionError(f"serving_hardening {name}: an open breaker "
                             "left a row undefaulted")
    errs = {}
    for label, b in (("probe_staged", batches[1]), ("fused", batches[2])):
        m = score_matrix(b["scores"])
        errs[label] = same_scores(f"{name} (c) {label}", m,
                                  jax_reference(name, len(m)), name == "lr")
    return {"stage": c["stage"], "fused": c["fused"],
            "states": [s["state"] for s in c["states"]],
            "max_abs_err_vs_jax_fused": errs}


def hardening_kernel_fault(ST, fn, tiles) -> dict:
    """(e): a ``KernelLaunchError`` injected into K1's launch (``_walk``)
    comes out of ``.batch`` and ``.columns``, staged and fused; no row is
    quarantined, no breaker records a failure, no fallback is counted."""
    from transmogrifai_tpu_torch.utils.cuda_build import KernelLaunchError

    def fault(*a, **kw):
        raise KernelLaunchError("serve_trees kernel launch failed: injected")

    before = fn.metadata()
    real = ST._walk
    ST._walk = fault
    raised = []
    try:
        for kind, (rows, ds) in tiles.items():
            for call, run in (("batch", lambda: fn.batch(rows)),
                              ("columns", lambda: fn.columns(ds))):
                try:
                    run()
                except KernelLaunchError:
                    raised.append(f"{kind} {call}")
                    continue
                raise AssertionError(f"serving_hardening: a kernel fault in "
                                     f"a {kind} {call} was absorbed")
    finally:
        ST._walk = real
    md = fn.metadata()
    moved = {nm: b for nm, b in md["breakers"].items()
             if b["consecutiveFailures"] or b["transitions"]}
    if (md["quarantine"]["quarantinedRows"], moved, md["fused"]["fallbacks"],
            md["fused"]["dispatches"]) != (0, {}, 0,
                                          before["fused"]["dispatches"]):
        raise AssertionError(f"serving_hardening: a kernel fault moved the "
                             f"counters {md['quarantine']} {moved} "
                             f"{md['fused']}")
    return {"raised": raised, "quarantinedRows": 0, "breakerFailures": 0,
            "fusedFallbacks": 0}


def hardening_cost(fn, off, tiles, reps: int) -> dict:
    """(f): host rows/s of ``.batch`` and ``.columns``, staged and fused,
    for the default and the all-off closure, and the seconds per family
    (``record_serve_batch``'s ``stagesMs``) of the last timed call of
    each."""
    from transmogrifai_tpu_torch.telemetry import spans as tspans

    rates, families = {}, {}
    for label, f in (("default", fn), ("all_off", off)):
        for kind, (rows, ds) in tiles.items():
            for call, run in (("batch", lambda: f.batch(rows)),
                              ("columns", lambda: f.columns(ds))):
                key = f"{label} {kind} {call}"
                rates[key] = len(rows) / host_seconds(run, reps=reps)
                trace = tspans.recent_serve_traces()[-1]
                families[key] = {k: v / 1e3
                                 for k, v in trace["stagesMs"].items()}
                families[key]["total"] = trace["durMs"] / 1e3
    return {"rows_per_s": rates, "family_seconds": families}


def serving_hardening(torch, smi: str, ST, TS, load_workflow_model,
                      score_function) -> dict:
    """The hardened scoring closure on the card over the three JAX-saved
    serving fixtures (profiles included), at ``fused_serving``'s tiles
    (8192 rows staged, 65536 fused): (a) clean, (b) quarantine, (c) a
    covered breaker against the fused gate, (d) drift, (e) a kernel fault,
    (f) the cost of the hardening. K1's and both tree sums' launches are
    counted from 0 over the phase."""
    from transmogrifai_tpu_torch.resilience import ScoreGuard

    H = hardening_module()
    P = H.package("port", DEV)
    stored = H.load_results()["card"]
    t0 = time.perf_counter()
    for wrapper in (ST.serve_trees, TS.tree_sum, TS.tree_sum_device_route):
        wrapper.launches = 0
    out: dict = {"card": smi}
    for name in ("xgb", "rf", "lr"):
        t_model = time.perf_counter()
        path, rows, want = load_fixture(name)
        model = load_workflow_model(path)
        if not model.serving_profiles:
            raise AssertionError(f"serving_hardening {name}: no profiles")
        fn = score_function(model)
        off = score_function(model, sentinel=False, breaker=False,
                             drift=False, guard=ScoreGuard(fallback="off"))
        for f in (fn, off):
            if not f.prime_fused():
                raise AssertionError(f"serving_hardening {name}: no fused "
                                     "program")
        tiles = {}
        for kind, n in (("staged", H.STAGED_ROWS), ("fused", H.FUSED_ROWS)):
            big = H.tiled(rows, n)
            tiles[kind] = (big, dataset_of(big, model.raw_features))
        rec = {"a_clean": hardening_clean(torch, ST, TS, H, P, name, fn, off,
                                          tiles, want, stored[name])}
        phase(f"serving_hardening {name} (a) clean", card=smi,
              **rec["a_clean"])
        clean = score_matrix(off.batch(tiles["staged"][0]))
        rec["b_quarantine"] = hardening_quarantine(H, P, name, clean,
                                                   stored[name])
        phase(f"serving_hardening {name} (b) quarantine",
              **rec["b_quarantine"])
        rec["c_breaker"] = hardening_breaker(H, P, name, stored[name])
        phase(f"serving_hardening {name} (c) breaker", **rec["c_breaker"])
        drift = H.scenario_card_drift(P, name)
        H.same(drift, stored[name]["drift"], 0.0, f"{name} (d)")
        rec["d_drift"] = {"alerts": drift["batch"]["alerts"],
                          "columns_alerts": drift["columns"]["alerts"],
                          "report_equals_jax": True}
        phase(f"serving_hardening {name} (d) drift", **rec["d_drift"])
        if name != "lr":
            rec["e_kernel_fault"] = hardening_kernel_fault(ST, fn, tiles)
            phase(f"serving_hardening {name} (e) kernel fault",
                  **rec["e_kernel_fault"])
        rec["f_cost"] = hardening_cost(fn, off, tiles, HARDENING_REPS)
        phase(f"serving_hardening {name} (f) cost", card=smi,
              **rec["f_cost"])
        rec["seconds"] = time.perf_counter() - t_model
        out[name] = rec
    out["launches"] = dict(zip(("serve_trees", "tree_sum",
                                "tree_sum_device_route"),
                               launch_counts(ST, TS)))
    for wrapper in (ST.serve_trees, TS.tree_sum, TS.tree_sum_device_route):
        wrapper.launches = 0
    if not all(out["launches"].values()):
        raise AssertionError(f"serving_hardening: launches {out['launches']}")
    out["seconds"] = time.perf_counter() - t0
    return out


#: the timed calls of ``serving_hardening``'s cost sub-phase, each the
#: least of this many
HARDENING_REPS = 1


def serving_plane_module():
    """``tests/torch_fixtures/serving_plane.py``: the serving plane's
    scenarios, the canary's constants and the JAX package's stored
    decision."""
    sys.path.insert(0, os.path.join(ROOT, "tests", "torch_fixtures"))
    import serving_plane

    return serving_plane


#: (a): single-row requests, their client threads and the service's
#: workers; (b): the offered rates (requests/s), the virtual seconds of
#: arrivals (cut from 2.0 for the whole script's time) and the deadline;
#: (c): the fleet's rate, its virtual seconds of arrivals and the kill; the
#: direct calls timed beside them (medians of this many)
PLANE_REQUESTS = 4096
PLANE_CLIENTS = 4
PLANE_WORKERS = 2
PLANE_RATES = {"light": 1000.0, "overload": 50000.0}
PLANE_SECONDS = 1.0
PLANE_FLEET_SECONDS = 2.0
PLANE_DEADLINE = 0.05
PLANE_FLEET_RATE = 5000.0
PLANE_FLEET_KILL_AT = 1.0
PLANE_DIRECT_REPS = 50
#: the virtual seconds of the light run from an empty latency history
PLANE_COLD_SECONDS = 0.5


def family_totals(P) -> dict:
    """{stage family: (batches, seconds)} of ``record_serve_batch``'s
    histograms so far."""
    return {h.labels.get("stage", "total"): (h.count, h.sum)
            for h in P.metrics.REGISTRY.histograms_named("tptpu_serve_seconds")}


def family_seconds(before: dict, after: dict) -> dict:
    """Seconds, batches and mean ms a batch per stage family between two
    ``family_totals``."""
    out = {}
    for stage, (n, secs) in after.items():
        n0, s0 = before.get(stage, (0, 0.0))
        out[stage] = {"seconds": secs - s0, "batches": n - n0,
                      "mean_ms": (secs - s0) / max(n - n0, 1) * 1e3}
    return out


class GcPauses:
    """Host pauses of Python's garbage collector over a block
    (``gc.callbacks``): collections by generation, the longest pause and
    their sum, in host seconds."""

    def __enter__(self):
        import gc

        self.by_gen = [0, 0, 0]
        self.total_s = 0.0
        self.max_s = 0.0
        self._t0 = None

        def cb(stage, info):
            if stage == "start":
                self._t0 = time.perf_counter()
            elif self._t0 is not None:
                dt = time.perf_counter() - self._t0
                self.by_gen[info["generation"]] += 1
                self.total_s += dt
                self.max_s = max(self.max_s, dt)
                self._t0 = None

        self._cb = cb
        gc.callbacks.append(cb)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._cb)
        return False

    def report(self) -> dict:
        return {"collections_by_generation": self.by_gen,
                "max_ms": self.max_s * 1e3, "total_s": self.total_s}


def plane_worker_mode(SP, P, ST, TS, name, fn, rows, want) -> dict:
    """(a): ``PLANE_REQUESTS`` single-row requests from ``PLANE_CLIENTS``
    threads through a worker-mode service: every result EQUAL ``fn.batch``
    of its row called directly (the logistic model's within its fixture
    tolerance, with its largest difference printed) and, trees and
    logistic alike, the JAX package's stored scores within the fixture's
    tolerance; reconciled, no service thread left, no row quarantined or
    guarded; a tree batch launches K1 once and the tree sum once per
    stack, and no batch fuses."""
    md0 = fn.metadata()
    before = launch_counts(ST, TS)
    res = SP.worker_mode(P, fn, rows, PLANE_REQUESTS, PLANE_CLIENTS,
                         seed=17, workers=PLANE_WORKERS)
    launches = [a - b for a, b in zip(launch_counts(ST, TS), before)]
    got, idx = res.pop("_results"), res.pop("_idx")
    md = fn.metadata()
    stacks = 0 if name == "lr" else 1
    want_launches = [res["batches"] * stacks, res["batches"] * stacks, 0]
    if res["errors"] or res["outcomes"] != ["completed"]:
        raise AssertionError(f"serving_plane {name} (a): outcomes "
                             f"{res['outcomes']} errors {res['errors']}")
    direct = SP.direct_mismatches(fn, rows, got, idx, PROB_ATOL[name])
    vs_jax = check_scores(name, got, {k: v[idx] for k, v in want.items()})
    moved = {
        "quarantinedRows": md["quarantine"]["quarantinedRows"]
        - md0["quarantine"]["quarantinedRows"],
        "guardedRows": md["scoreGuard"]["guardedRows"]
        - md0["scoreGuard"]["guardedRows"],
        "fusedDispatches": md["fused"]["dispatches"]
        - md0["fused"]["dispatches"]}
    problems = []
    if not res["reconciled"] or res["threads"]:
        problems.append(f"reconciled {res['reconciled']} threads "
                        f"{res['threads']}")
    if direct["mismatched"]:
        problems.append(f"{direct['mismatched']} results differ from the "
                        "direct closure's")
    if name != "lr" and direct["max_abs_err"] != 0.0:
        problems.append(f"tree results differ: {direct['max_abs_err']}")
    if any(moved.values()):
        problems.append(f"counters moved {moved}")
    if launches != want_launches:
        problems.append(f"launches {launches}, expected {want_launches}")
    if problems:
        raise AssertionError(f"serving_plane {name} (a): {problems}")
    return {**res, "launches": launches, "direct": direct,
            "max_abs_err_vs_jax": vs_jax, "counters_moved": moved}


def plane_bench(SP, P, name, fn, rows) -> dict:
    """(b): the bench-mode load test (the measured batch time advances the
    virtual clock) at each of ``PLANE_RATES`` for ``PLANE_SECONDS`` with a
    ``PLANE_DEADLINE`` deadline; per rate the report's goodput, latency
    percentiles, shed rate and batches, the rows a batch, the seconds per
    family from ``record_serve_batch`` and the garbage collector's pauses.
    Each run must reconcile, and the light one complete 90% of its
    requests. The runs follow ``plane_direct`` on a reset
    registry and do not reset it: the deadline gate admits against the
    pipeline's p95 of the serve-latency histograms, which then hold the
    direct calls' 102 batches of 1 and 256 rows, the history of a warm
    standing service (an empty one makes a single slow first batch the
    p95, and the gate then refuses every request: ``ROADMAP.md`` "Found
    in the reference")."""
    out = {}
    for label, rate in PLANE_RATES.items():
        fam0 = family_totals(P)
        snap0 = P.export.serving_snapshot()
        t0 = time.perf_counter()
        with GcPauses() as gc_pauses:
            rep = P.serving.run_loadtest(
                fn, rows, rate=rate, duration=PLANE_SECONDS, seed=23,
                deadline=PLANE_DEADLINE)
        wall = time.perf_counter() - t0
        snap = P.export.serving_snapshot()
        rows_run = snap["serveRows"] - snap0["serveRows"]
        batches_run = snap["serveBatches"] - snap0["serveBatches"]
        if not rep["reconciled"]:
            raise AssertionError(f"serving_plane {name} (b) {label}: not "
                                 f"reconciled {rep}")
        if label == "light" and rep["completed"] < 0.9 * rep["offered"]:
            raise AssertionError(f"serving_plane {name} (b) light: a light "
                                 f"load was refused or shed {rep}")
        out[label] = {
            "offered_per_s": rate, "goodput_rows_per_s":
                rep["goodput_rows_per_s"],
            "latency_ms": rep["latency_ms"], "shed_rate": rep["shed_rate"],
            "shed": rep["shed"], "rejected": rep["rejected"],
            "completed": rep["completed"], "batches": rep["batches"],
            "rows_per_batch": rows_run / max(batches_run, 1),
            "max_queue_depth_rows": rep["max_queue_depth_rows"],
            "virtual_end_s": rep["virtual_end_s"],
            "family_seconds": family_seconds(fam0, family_totals(P)),
            "gc_pauses": gc_pauses.report(),
            "reconciled": rep["reconciled"], "wall_s": wall}
    return out


def plane_cold_gate(SP, P, name, fn, rows) -> dict:
    """(b) from an empty history: the light run for ``PLANE_COLD_SECONDS``
    on a reset registry, where the deadline gate's p95 holds only this
    run's own batches. Either the gate admits on (the p95 ends within the
    deadline and 90% of the requests complete) or it refuses as the
    reference does (the p95 ends above the deadline and deadline requests
    are refused at admission): a run that fits neither fails."""
    SP.reset(P)
    rep = P.serving.run_loadtest(
        fn, rows, rate=PLANE_RATES["light"], duration=PLANE_COLD_SECONDS,
        seed=31, deadline=PLANE_DEADLINE)
    p95 = P.deadline.pipeline_p95()
    out = {"offered": rep["offered"], "completed": rep["completed"],
           "rejected": rep["rejected"], "shed_rate": rep["shed_rate"],
           "batches": rep["batches"], "latency_ms": rep["latency_ms"],
           "pipeline_p95_ms": p95 * 1e3,
           "refuses": p95 > PLANE_DEADLINE}
    admits = rep["completed"] >= 0.9 * rep["offered"]
    refuses = out["refuses"] and rep["rejected"].get("deadline", 0) > 0
    if not rep["reconciled"] or not (refuses or (admits and not out["refuses"])):
        raise AssertionError(f"serving_plane {name} (b) empty history: {out}")
    return out


def plane_direct(fn, rows) -> dict:
    """Host seconds of ``fn.batch`` of 1 row and of 256 rows called
    directly (medians of ``PLANE_DIRECT_REPS``, after one warm call); the
    calls also give the serve-latency histograms their history."""
    out = {}
    for n in (1, 256):
        batch = (rows * -(-n // len(rows)))[:n]
        fn.batch(batch)
        secs = []
        for _ in range(PLANE_DIRECT_REPS):
            t0 = time.perf_counter()
            fn.batch(batch)
            secs.append(time.perf_counter() - t0)
        out[f"batch_{n}_ms"] = statistics.median(secs) * 1e3
    out["rows_per_s_at_256"] = 256 / (out["batch_256_ms"] / 1e3)
    return out


def plane_fleet(SP, P, fn, rows) -> dict:
    """(c): ``run_fleet_loadtest`` in bench mode, 2 replicas of the xgb
    closure, ``PLANE_FLEET_RATE`` requests/s for ``PLANE_FLEET_SECONDS`` with
    ``kill_replica(1, at=PLANE_FLEET_KILL_AT)``: 0 dropped, reconciled at
    every instant, replica 1 lost, every completed result EQUAL the
    direct closure's; beside it one replica at the same rate."""
    submitted: list = []

    def on_fleet(fleet):
        submit = fleet.submit

        def recording(rows_, *a, **kw):
            h = submit(rows_, *a, **kw)
            submitted.append((rows_, h))
            return h

        fleet.submit = recording
        return None

    out = {}
    for replicas in (2, 1):
        SP.reset(P)
        for row in rows[:PLANE_DIRECT_REPS]:  # the deadline gate's history
            fn.batch([dict(row)])
        submitted.clear()
        plan = P.faults.FaultPlan(seed=3)
        if replicas == 2:
            plan.kill_replica(1, at=PLANE_FLEET_KILL_AT)
        t0 = time.perf_counter()
        with P.faults.installed(plan), GcPauses() as gc_pauses:
            rep = P.serving.run_fleet_loadtest(
                fn, rows, rate=PLANE_FLEET_RATE, duration=PLANE_FLEET_SECONDS,
                replicas=replicas, seed=29, deadline=PLANE_DEADLINE,
                plan=plan, on_fleet=on_fleet)
        wall = time.perf_counter() - t0
        done = [(r, h) for r, h in submitted
                if h.outcome in ("completed", "quarantined")]
        direct = fn.batch([dict(r) for r, _ in done]) if done else []
        differ = sum(h.results[0] != d for (_, h), d in zip(done, direct))
        out[f"replicas_{replicas}"] = {
            k: rep[k] for k in (
                "offered", "admitted", "completed", "shed", "rejected",
                "shed_rate", "latency_ms", "goodput_rows_per_s", "dropped",
                "reconciled", "reconciled_every_instant", "replicas_lost",
                "lost_replicas", "orphans_adopted", "hedges_fired",
                "router_dispatched", "virtual_end_s")}
        out[f"replicas_{replicas}"].update(
            wall_s=wall, results_checked=len(done), results_differ=differ,
            gc_pauses=gc_pauses.report(),
            fired=sorted({k for k, _ in plan.fired}))
    two = out["replicas_2"]
    if (two["dropped"], two["reconciled_every_instant"],
            two["lost_replicas"], two["results_differ"]) != (0, True, [1], 0):
        raise AssertionError(f"serving_plane (c): {two}")
    if not two["results_checked"] or not out["replicas_1"]["reconciled"]:
        raise AssertionError(f"serving_plane (c): {out}")
    SP.reset(P)
    return out


def plane_kernel_fault(SP, P, ST, fn, rows) -> dict:
    """(e): a ``KernelLaunchError`` injected into K1's launch (``_walk``)
    inside a worker-mode service and a two-replica fleet: the fault
    reaches the caller (``submit``, ``stop``; the fleet's ``pump_all``,
    ``tick``, ``submit``, ``stop``), every request settles ``error`` with
    it, nothing is hedged, adopted or retried, the ledgers reconcile.
    Then in the registry's mirror scoring, as the shadow and as the
    canary's control: the fault fails the fleet and voids the window (its
    reports, ``evaluate_canary`` and ``promote`` re-raise it), and nothing
    is promoted or rolled back."""
    inject = SP.k1_fault(ST, "_walk")
    SP.reset(P)
    fault = ["KernelLaunchError", None]
    svc = SP.kernel_fault_service(P, fn, rows, inject, workers=PLANE_WORKERS)
    if (svc["handles"] != [{"outcome": "error", "error": fault}] * 5
            or svc["submit"] != fault or svc["stop"] != fault
            or not svc["reconciled"] or svc["threads"]
            or svc["stats"]["errors"] != 5):
        raise AssertionError(f"serving_plane (e) service: {svc}")
    SP.reset(P)
    fleet = SP.kernel_fault_fleet(P, fn, rows, inject)
    if ((fleet["pump_all"], fleet["tick"], fleet["submit"], fleet["stop"])
            != (fault,) * 4
            or fleet["handles"] != [{"outcome": "error", "error": fault}] * 4
            or (fleet["hedges"], fleet["adopted"], fleet["lost"]) != (0, 0, [])
            or not fleet["reconciled"] or fleet["outstanding"]):
        raise AssertionError(f"serving_plane (e) fleet: {fleet}")
    mirror = {}
    for mode in ("shadow", "canary"):
        SP.reset(P)
        got = mirror[mode] = SP.mirror_kernel_fault(P, fn, rows, inject, mode)
        raised = [got[k] for k in ("pump_all", "report", "submit", "tick",
                                   "stop", "fleet_fault")]
        raised += ([got["stop_shadow"]] if mode == "shadow"
                   else [got["evaluate"], got["promote"]])
        if (raised != [fault] * len(raised)
                or got["handles"] != ["completed"] * 2
                or got["mirror_errors"] or got["promotions"]
                or got["rollbacks"] or not all(got.get("unchanged", [True]))
                or got["replica_faults"] != [None, None]
                or got["hedges"] or got["lost"] or not got["reconciled"]):
            raise AssertionError(f"serving_plane (e) {mode} mirror: {got}")
    SP.reset(P)
    md = fn.metadata()
    return {"service": {k: svc[k] for k in ("submit", "stop", "handles",
                                             "reconciled", "stats")},
            "mirror": {mode: {k: v for k, v in got.items()
                              if k in ("pump_all", "evaluate", "promote",
                                       "mirror_errors", "promotions",
                                       "rollbacks")}
                       for mode, got in mirror.items()},
            "fleet": {k: fleet[k] for k in ("pump_all", "tick", "submit",
                                             "stop", "hedges", "adopted",
                                             "lost", "errors",
                                             "reconciled")},
            "quarantinedRows": md["quarantine"]["quarantinedRows"]}


def serving_plane(torch, smi: str, ST, TS) -> dict:
    """The serving plane on the card (``serving/``) over the three
    JAX-saved serving fixtures with the default hardened closure: (a)
    worker mode, (b) the bench-mode load test at two rates with the direct
    calls beside it and a short light run from an empty latency history
    before them, (c) a two-replica fleet losing replica 1, (d) the canary
    gate against the JAX package's decision, (e) a kernel fault in a
    service, in a fleet and in the registry's mirror scoring. K1's and both tree sums' launches are
    counted from 0 over (a)-(d); (e)'s injected faults launch nothing."""
    SP = serving_plane_module()
    P = SP.package("port", DEV)
    stored = SP.load_results()
    t0 = time.perf_counter()
    for wrapper in (ST.serve_trees, TS.tree_sum, TS.tree_sum_device_route):
        wrapper.launches = 0
    out: dict = {"card": smi}
    fns = {}
    for name in ("xgb", "rf", "lr"):
        t_model = time.perf_counter()
        path, rows, want = load_fixture(name)
        fn = fns[name] = P.score(P.load(path))
        SP.reset(P)
        rec = {"a_worker_mode": plane_worker_mode(SP, P, ST, TS, name, fn,
                                                  rows, want)}
        phase(f"serving_plane {name} (a) worker mode", card=smi,
              **rec["a_worker_mode"])
        rec["b_empty_history"] = plane_cold_gate(SP, P, name, fn, rows)
        phase(f"serving_plane {name} (b) empty history", card=smi,
              **rec["b_empty_history"])
        SP.reset(P)
        rec["b_direct"] = plane_direct(fn, rows)
        rec["b_loadtest"] = plane_bench(SP, P, name, fn, rows)
        phase(f"serving_plane {name} (b) loadtest", card=smi,
              **rec["b_loadtest"], direct=rec["b_direct"])
        rec["seconds"] = time.perf_counter() - t_model
        out[name] = rec
    _, rows, _ = load_fixture("xgb")
    out["c_fleet"] = plane_fleet(SP, P, fns["xgb"], rows)
    phase("serving_plane (c) fleet", card=smi, **out["c_fleet"])
    SP.reset(P)
    canary = SP.canary(P)
    SP.same(canary, stored["canary"], 0.0, "serving_plane (d)")
    out["d_canary"] = {k: canary["decision"][k] for k in (
        "decision", "codes", "compared", "agreement", "canaryServed",
        "controlServed")}
    out["d_canary"]["equals_jax"] = True
    phase("serving_plane (d) canary", **out["d_canary"])
    out["launches"] = dict(zip(("serve_trees", "tree_sum",
                                "tree_sum_device_route"),
                               launch_counts(ST, TS)))
    out["e_kernel_fault"] = plane_kernel_fault(SP, P, ST, fns["xgb"], rows)
    phase("serving_plane (e) kernel fault", **out["e_kernel_fault"])
    for wrapper in (ST.serve_trees, TS.tree_sum, TS.tree_sum_device_route):
        wrapper.launches = 0
    if not (out["launches"]["serve_trees"] and out["launches"]["tree_sum"]):
        raise AssertionError(f"serving_plane: launches {out['launches']}")
    out["seconds"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------
# the other families, the combiner and the insights plane (A9, A10)
# --------------------------------------------------------------------------
#: the families phase's rows (``wide_hash_table``'s width: 1419 vector
#: columns), the rows of its card-against-CPU fits, and the trees' rounds
#: in those fits (the CPU's plain histograms are the time there); cut from
#: 16384 rows and 10 rounds so the whole script keeps inside its time limit
#: with the text phase
FAMILIES_ROWS = 8192
FAMILIES_CPU_ROWS = 2048
FAMILIES_CPU_TREES = 3
#: card against CPU: Naive Bayes' pi and theta (relative), the SVC's
#: weights (relative to the largest |w|) and the GLR's fitted means
#: (relative to the largest), the MLP's probabilities; the logistic and
#: linear lanes keep ``GLM_LOGISTIC_TOL`` and ``GLM_LINEAR_TOL``; trees EQUAL
FAMILY_NB_RTOL = 1e-6
FAMILY_LINEAR_RTOL = 1e-4
#: the MLP card against CPU: Adam carries the products' last-ulp
#: differences (cuBLAS against the CPU's BLAS) over its 100 steps; at 2048 x
#: 1409 the card read 1.1e-5 (binary) and 7.6e-4 (4 classes, PERF.md), so
#: the bound is 5x the larger, and the losses' gap per step is printed
FAMILY_MLP_ATOL = 4e-3
#: the tree families' grids in the families phase (cut from the default
#: grids, which ``train_wide``, ``train_regression`` and ``train_multiclass``
#: run: the phase's new code is the other families, at their default
#: grids, and the selector over the whole catalog)
FAMILY_TREE_GRIDS = {
    "RandomForestClassifier": {"max_depth": [3, 6], "num_trees": [5],
                               "min_instances_per_node": [10, 100]},
    "XGBoostClassifier": {"num_round": [10], "eta": [0.3], "max_depth": [6],
                          "min_child_weight": [1.0, 10.0]},
    "GBTClassifier": {"max_depth": [3, 6], "max_iter": [3]},
    "DecisionTreeClassifier": {"max_depth": [3, 6, 12],
                               "min_instances_per_node": [10, 100]},
}
FAMILY_TREE_GRIDS.update({k.replace("Classifier", "Regressor"): v
                          for k, v in FAMILY_TREE_GRIDS.items()})
#: the multiclass selector's XGBoost grid, cut to 5 rounds for the whole
#: script's time (one-vs-rest over 4 classes: its sweep set the 21.7 s of
#: that train()'s validation at 20 rounds, 22.3 s at 10 on a slower machine)
FAMILY_MULTI_TREE_GRIDS = {**FAMILY_TREE_GRIDS, "XGBoostClassifier": {
    **FAMILY_TREE_GRIDS["XGBoostClassifier"], "num_round": [5]}}
#: the combiner's two binary selectors
COMBINER_SELECTORS = (["OpLogisticRegression", "OpLinearSVC",
                       "OpMultilayerPerceptronClassifier"],
                      ["OpDecisionTreeClassifier"])


def families_dataset(kind: str):
    """``wide_hash_table(FAMILIES_ROWS)``'s predictors with a label of the
    kind: its binary label; the quartiles of its linear score as classes
    0-3 (``wide_hash_multiclass_table``'s classes, as RealNN); or a
    positive continuous target, exp(0.3 x score) (the GLR's gamma and
    poisson families need y > 0)."""
    sys.path.insert(0, os.path.join(ROOT, "tests", "torch_fixtures"))
    from fit_side_tables import WIDE_SEED, _wide_draws

    from transmogrifai_tpu_torch import types as PT
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.types.columns import column_from_values

    schema, columns, score = _wide_draws(FAMILIES_ROWS, WIDE_SEED)
    del schema["t_sex"], columns["t_sex"]
    if kind == "BinaryClassification":
        label = (score > 0).astype(float)
    elif kind == "MultiClassification":
        edges = np.quantile(score, [0.25, 0.5, 0.75])
        label = np.searchsorted(edges, score, side="right").astype(float)
    else:
        label = np.exp(0.3 * score)
    schema["label"], columns["label"] = "RealNN", label.tolist()
    return Dataset.of({k: column_from_values(
        PT.feature_type_by_name(schema[k]), v) for k, v in columns.items()})


def family_selector(kind: str, names, combine: str | None = None):
    """The kind's selector over ``names`` on the card, at their default
    grids but the tree families' (``FAMILY_TREE_GRIDS``, the multiclass
    selector's ``FAMILY_MULTI_TREE_GRIDS``); with ``combine``
    a ``SelectedModelCombiner`` of two binary selectors over
    ``COMBINER_SELECTORS`` in that strategy."""
    from transmogrifai_tpu_torch.selector import combiner as C
    from transmogrifai_tpu_torch.selector import model_selector as MS

    grids = (FAMILY_MULTI_TREE_GRIDS if kind == "MultiClassification"
             else FAMILY_TREE_GRIDS)

    def candidates(names):
        return [(e, grids.get(type(e).__name__, g))
                for e, g in MS.make_candidates(kind, names)]

    if combine is not None:
        s1, s2 = (MS.BinaryClassificationModelSelector(models=candidates(n))
                  for n in COMBINER_SELECTORS)
        return C.SelectedModelCombiner(
            s1, s2, getattr(C.CombinationStrategy, combine))
    factory = {"BinaryClassification": MS.BinaryClassificationModelSelector,
               "MultiClassification": MS.MultiClassificationModelSelector,
               "Regression": MS.RegressionModelSelector}[kind]
    return factory(models=candidates(names))


def family_train(torch, kind: str, names, counters, combine=None):
    """``Workflow.train()`` of the selector on the card, with its seconds
    split (each family's sweep among them), the attribution baseline's
    seconds inside it, and the kernels' launches around exactly it."""
    from transmogrifai_tpu_torch.features import from_dataset
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.utils import uid
    from transmogrifai_tpu_torch.workflow.workflow import Workflow

    ds = families_dataset(kind)
    uid.reset()
    label, predictors = from_dataset(ds, response="label")
    checked = label.sanity_check(transmogrify(list(predictors)),
                                 remove_bad_features=True)
    selector = family_selector(kind, names, combine)
    pred = selector.set_input(label, checked).get_output()
    wf = Workflow().set_result_features(pred).set_input_dataset(ds)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    with TrainTimer() as timer:
        t0 = time.perf_counter()
        model = wf.train()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    for fn in counters.values():
        fn.launches = 0
    return model, pred, ds, timer.split(total), launches


def family_estimators(summary: dict, kind: str, names) -> dict:
    """Each family's best grid point of a selection: class name ->
    (estimator on the card, grid)."""
    from transmogrifai_tpu_torch.selector import model_selector as MS

    larger = kind != "Regression"
    best: dict = {}
    for r in summary["validationResults"]:
        cur = best.get(r["modelName"])
        better = cur is None or (r["metricMean"] > cur["metricMean"]
                                 if larger else r["metricMean"] < cur["metricMean"])
        if better and np.isfinite(r["metricMean"]):
            best[r["modelName"]] = r
    ests = {type(e).__name__: e for e, _ in MS.make_candidates(kind, names)}
    return {name: (ests[name], r["grid"]) for name, r in best.items()}


#: each tree family's rounds knob
TREE_ROUNDS = {"XGBoostClassifier": "num_round", "XGBoostRegressor": "num_round",
               "RandomForestClassifier": "num_trees",
               "RandomForestRegressor": "num_trees",
               "GBTClassifier": "max_iter", "GBTRegressor": "max_iter"}


def cpu_point(grid: dict, est) -> dict:
    """The grid point with a tree family's rounds cut to
    ``FAMILIES_CPU_TREES`` (the CPU's plain histograms are the time of
    these fits)."""
    out = dict(grid)
    knob = TREE_ROUNDS.get(type(est).__name__)
    if knob is not None:
        out[knob] = min(int(out.get(knob, getattr(est, knob))),
                        FAMILIES_CPU_TREES)
    return out


def same_family_fit(name: str, card, cpu, x) -> float:
    """Card against CPU for one family's fit: trees EQUAL; the other
    families within their bounds. Returns the largest difference."""
    a, b = card.get_arrays(), cpu.get_arrays()
    if sorted(a) != sorted(b):
        raise AssertionError(f"families {name}: arrays {sorted(a)} {sorted(b)}")
    if name == "NaiveBayes":
        err = max(float(np.max(np.abs(a[k] - b[k]) / np.abs(b[k])))
                  for k in ("pi", "theta"))
        tol = FAMILY_NB_RTOL
    elif name == "MLPClassifier":
        err = float(np.max(np.abs(card.predict_arrays(x)[1]
                                  - cpu.predict_arrays(x)[1])))
        tol = FAMILY_MLP_ATOL
    elif name == "LinearSVC":
        scale = float(np.max(np.abs(b["weights"]))) or 1.0
        err = max(float(np.max(np.abs(a[k] - b[k]))) for k in
                  ("weights", "intercept")) / scale
        tol = FAMILY_LINEAR_RTOL
    elif name == "GeneralizedLinearRegression":
        # at full width the IRLS normal equations ([1410, 1410] over 2048
        # rows, many sparse hashed columns) are ill-conditioned: the float32
        # solves on the card and the CPU have landed 2.9e-3 of the largest
        # weight apart (PERF.md); the fitted means are held instead
        got, want = card.predict_arrays(x)[0], cpu.predict_arrays(x)[0]
        err = float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) or 1.0))
        tol = FAMILY_LINEAR_RTOL
    elif name in ("LogisticRegression", "LinearRegression"):
        err = max(float(np.max(np.abs(a[k] - b[k]))) for k in a)
        tol = (GLM_LOGISTIC_TOL if name == "LogisticRegression"
               else GLM_LINEAR_TOL[0] * 10)
    else:
        err = max((float(np.max(np.abs(np.asarray(a[k], np.float64)
                                       - np.asarray(b[k], np.float64))))
                   if np.size(a[k]) else 0.0) for k in a)
        if not all(np.array_equal(a[k], b[k], equal_nan=True) for k in a):
            raise AssertionError(f"families {name}: trees differ ({err})")
        tol = 0.0
    if not err <= tol:
        raise AssertionError(f"families {name}: card against cpu {err} > {tol}")
    return err


def mlp_loss_gaps(card_est, cpu_est, x, y, mask) -> dict:
    """The MLP's losses on the card against the CPU's, step by step: the
    relative gap at steps 1, 10, 50 and the last, and its largest."""
    from transmogrifai_tpu_torch.models import mlp

    losses = []
    for est in (card_est, cpu_est):
        k = int(max(y.max() + 1, 2))
        sizes = (x.shape[1], *est.hidden_layers, k)
        _, loss = mlp.train_mlp(x, np.eye(k, dtype=np.float32)[y.astype(int)],
                                mask, sizes, int(est.max_iter),
                                float(est.step_size), int(est.seed),
                                compute_dtype=est.compute_dtype,
                                device=est.device)
        losses.append(np.asarray(loss, np.float64))
    gap = np.abs(losses[0] - losses[1]) / np.abs(losses[1])
    steps = [s for s in (1, 10, 50, len(gap)) if s <= len(gap)]
    return {"steps": {str(s): float(gap[s - 1]) for s in steps},
            "max": float(gap.max())}


def family_holds(torch, model, pred, ds, kind: str, names, summary) -> dict:
    """Each family's best point refit on the card at full rows (its
    seconds), then fitted on the card and on the CPU over
    ``FAMILIES_CPU_ROWS`` rows (trees at ``FAMILIES_CPU_TREES`` rounds) and
    held to each other. Naive Bayes fits a non-negative plane (|x|)
    there, whatever the selection did with it."""
    info = model.selector_info
    full = model.score(ds, keep_intermediate_features=True)
    x = np.asarray(full[info["vectorName"]].values, dtype=np.float32)
    y = np.asarray(full[info["labelName"]].values, dtype=np.float32)
    ests = family_estimators(summary, kind, names)
    if "NaiveBayes" not in ests and "OpNaiveBayes" in names:
        from transmogrifai_tpu_torch.models.naive_bayes import NaiveBayes

        ests["NaiveBayes"] = (NaiveBayes(), {"smoothing": 1.0})
    out = {"_vector_columns": int(x.shape[1])}
    xs, ys = x[:FAMILIES_CPU_ROWS], y[:FAMILIES_CPU_ROWS]
    for name, (est, grid) in sorted(ests.items()):
        xf = np.abs(x) if name == "NaiveBayes" else x
        card_est = est.with_params(**grid)
        card_est.device = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_est.fit_arrays(xf, y, np.ones(len(y), np.float32))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        point = cpu_point(grid, est)
        xh = np.abs(xs) if name == "NaiveBayes" else xs
        mask = np.ones(len(ys), np.float32)
        a = est.with_params(**point)
        a.device = None
        b = est.with_params(**point)
        b.device = "cpu"
        card_fit = a.fit_arrays(xh, ys, mask)
        cpu_fit = b.fit_arrays(xh, ys, mask)
        err = same_family_fit(name, card_fit, cpu_fit, xh)
        out[name] = {"grid": grid, "full_fit_s": fit_s,
                     "cpu_point": point, "card_vs_cpu": err}
        if name == "GeneralizedLinearRegression":
            w_a, w_b = card_fit.weights, cpu_fit.weights
            out[name]["weights_gap_rel"] = float(
                np.max(np.abs(w_a - w_b)) / (np.max(np.abs(w_b)) or 1.0))
        if name == "MLPClassifier":
            out[name]["loss_gap_per_step"] = mlp_loss_gaps(a, b, xh, ys, mask)
    return out


def families(torch, smi: str, counters) -> dict:
    """The rest of the selector's catalog on the card at full width
    (``wide_hash_table(16384)``, 1419 vector columns): a binary selector
    over every binary candidate, a multiclass one over the multiclass
    names, a regression selector whose candidates include the GLR (the
    regression ``train()`` on the card), and a ``SelectedModelCombiner``
    of two binary selectors in both strategies. Per train(): seconds, each
    family's sweep seconds, the attribution baseline's seconds and the
    kernels' launches; no family excluded but Naive Bayes on a plane with
    negative values, which is excluded as the reference's validator
    excludes it; each family's best point held to the CPU route."""
    from transmogrifai_tpu_torch.selector import model_selector as MS

    out: dict = {"card": smi}
    runs: dict = {}
    for kind, key in (("BinaryClassification", "binary"),
                      ("MultiClassification", "multiclass"),
                      ("Regression", "regression")):
        names = list(getattr(MS, {
            "BinaryClassification": "BINARY_CLASSIFICATION_MODELS",
            "MultiClassification": "MULTI_CLASSIFICATION_MODELS",
            "Regression": "REGRESSION_MODELS"}[kind]))
        model, pred, ds, seconds, launches = family_train(
            torch, kind, names, counters)
        summary = model.summary_json()["modelSelectorSummary"]
        excluded = {a["modelName"]: a.get("error") for a in
                    summary["candidateAttempts"] if a["excluded"]}
        negatives = bool(np.any(np.asarray(model.score(
            ds.take(np.arange(256)), keep_intermediate_features=True)[
                model.selector_info["vectorName"]].values) < 0))
        allowed = {"NaiveBayes"} if negatives else set()
        if set(excluded) - allowed or any(
                "non-negative" not in str(e) for e in excluded.values()):
            raise AssertionError(f"families {key}: excluded {excluded}")
        results = summary["validationResults"]
        if not all(np.isfinite(r["metricMean"]) for r in results):
            raise AssertionError(f"families {key}: a NaN candidate")
        holds = family_holds(torch, model, pred, ds, kind, names, summary)
        width = holds.pop("_vector_columns")
        run = {"train": seconds, "launches": launches, "vector_columns": width,
               "attribution_baseline_s": model.attribution_seconds,
               "attribution_groups": len(
                   (model.attribution_profiles or {}).get("groups", {})),
               "winner": summary["bestModelType"], "grid": summary["bestGrid"],
               "candidates": len(results), "excluded": excluded,
               "families": holds}
        phase(f"families {key}", card=smi, **run)
        runs[f"families {key}"] = run
        if key == "binary":
            out["_wide"] = (model, pred)
        del model
    for strategy in ("BEST", "WEIGHTED"):
        model, pred, ds, seconds, launches = family_train(
            torch, "BinaryClassification", None, counters, combine=strategy)
        summary = model.summary_json()["modelSelectorSummary"]
        rt = check_round_trip(model, ds.take(np.arange(min(2048, ds.num_rows))),
                              pred)
        run = {"train": seconds, "launches": launches,
               "strategy": summary.get("combinationStrategy"),
               "winner": summary["bestModelType"],
               "weights": summary.get("weights"),
               "validation_results": len(summary["validationResults"]),
               "attribution_baseline_s": model.attribution_seconds, **rt}
        if summary.get("combinationStrategy") != strategy.capitalize():
            raise AssertionError(f"families combiner {strategy}: {summary}")
        phase(f"families combiner {strategy.lower()}", card=smi, **run)
        runs[f"families combiner {strategy.lower()}"] = run
        del model
    out["train_runs"] = runs
    return out


#: the insights phase: the lane batches' rows, the rows timed for explain
#: rows/s against the plain batch, and the repetitions
INSIGHTS_REPS = 1
INSIGHTS_WIDE_ROWS = 4096
INSIGHTS_WIDE_EXPLAIN_ROWS = 64
INSIGHTS_WIDE_BUDGET = 1 << 27


def insights_module():
    """``tests/torch_fixtures/insights_flow.py``: the insights scenarios,
    the card's shapes and the JAX package's stored attributions."""
    sys.path.insert(0, os.path.join(ROOT, "tests", "torch_fixtures"))
    import insights_flow

    return insights_flow


class LaneFault:
    """A context manager under which K1's launch on the card (``ST._walk``)
    raises ``KernelLaunchError`` for a plane of more than ``rows`` rows
    only (the lanes, not the batch's base), or, with ``rows=None``, for
    every plane while ``arm()`` is on."""

    def __init__(self, ST, rows: int | None):
        self.ST, self.rows, self.armed, self.raised = ST, rows, False, 0

    def arm(self, call):
        def armed(*a, **kw):
            self.armed = True
            try:
                return call(*a, **kw)
            finally:
                self.armed = False
        return armed

    def __enter__(self):
        from transmogrifai_tpu_torch.utils.cuda_build import KernelLaunchError

        real = self.real = self.ST._walk

        def walk(*a, **kw):
            n = a[0].shape[0] if a and hasattr(a[0], "shape") else 0
            if (self.rows is not None and n > self.rows) or (
                    self.rows is None and self.armed):
                self.raised += 1
                raise KernelLaunchError("serve_trees launch failed: injected")
            return real(*a, **kw)

        self.ST._walk = walk
        return self

    def __exit__(self, *exc):
        self.ST._walk = self.real
        return False


def insights_fault_checks(torch, I, P, ST, fused_fn, rows_fused) -> dict:
    """A ``KernelLaunchError`` in K1 on the card reaches the caller from the
    staged lanes (``.batch``, ``.columns``), from the fused explain core
    (the lane plane's launch; the base's succeeds), from a service and
    from ``train()``'s attribution baseline; no row is quarantined and no
    fallback counted."""
    from transmogrifai_tpu_torch.insights import drift, loco
    from transmogrifai_tpu_torch.utils.cuda_build import KernelLaunchError

    out = {}
    fn = P.score(P.load(I.model_path("xgb")))
    rows = I.fixture_rows("xgb", 64)
    real = loco.explain_batch
    with LaneFault(ST, None) as lf:
        loco.explain_batch = lf.arm(real)
        try:
            for label, call in (("batch", lambda: fn.batch(rows, explain=3)),
                                ("columns", lambda: fn.columns(
                                    dataset_of(rows, P.load(I.model_path(
                                        "xgb")).raw_features), explain=3))):
                try:
                    call()
                    raise AssertionError(f"insights fault {label}: no raise")
                except KernelLaunchError:
                    out[f"staged_{label}"] = "KernelLaunchError"
        finally:
            loco.explain_batch = real
    out["staged_quarantined"] = fn.metadata()["quarantine"]["quarantinedRows"]
    b = bucket_rows(len(rows_fused))
    with LaneFault(ST, b) as lf:
        try:
            fused_fn.batch(rows_fused, explain=3)
            raise AssertionError("insights fault fused: no raise")
        except KernelLaunchError:
            out["fused_core"] = "KernelLaunchError"
    out["fused_fallbacks"] = fused_fn.metadata()["fused"]["fallbacks"]
    svc = P.serving.ScoringService(fn, P.serving.ServiceConfig(workers=0))
    svc.start()
    with LaneFault(ST, None) as lf:
        loco.explain_batch = lf.arm(real)
        try:
            h = svc.submit(rows[0], explain=2)
            try:
                svc.pump()
                raise AssertionError("insights fault service: no raise")
            except KernelLaunchError:
                out["service_pump"] = "KernelLaunchError"
            out["service_handle"] = h.outcome
            try:
                svc.stop()
            except KernelLaunchError:
                out["service_stop"] = "KernelLaunchError"
        finally:
            loco.explain_batch = real
    real_profile = drift.explain_batch
    with LaneFault(ST, None) as lf:
        drift.explain_batch = lf.arm(real_profile)
        try:
            try:
                I.train_trees(P)
                raise AssertionError("insights fault train: no raise")
            except KernelLaunchError:
                out["train_baseline"] = "KernelLaunchError"
        finally:
            drift.explain_batch = real_profile
    if (out["staged_quarantined"] or out["fused_fallbacks"]
            or out.get("service_handle") != "error"
            or "service_stop" not in out):
        raise AssertionError(f"insights faults: {out}")
    return out


def bucket_rows(n: int) -> int:
    from transmogrifai_tpu_torch.local.scoring import bucket

    return bucket(n)


def lane_batch(ST, TS, call) -> tuple:
    """(call(), K1's, the tree sum's and the route sum's launches in it)."""
    before = launch_counts(ST, TS)
    out = call()
    return out, tuple(a - b for a, b in zip(launch_counts(ST, TS), before))


def insights_wide(P, I, counter, model, pred) -> dict:
    """``.columns(explain=3)`` on the full-width model the families phase
    trained (its ~900 column groups): at ``INSIGHTS_WIDE_ROWS`` rows one
    fused run cannot hold the lanes under the default lane budget, so the
    attributions are skipped and counted and the scores kept; at
    ``INSIGHTS_WIDE_EXPLAIN_ROWS`` rows under ``INSIGHTS_WIDE_BUDGET`` the
    fused lanes agree with the staged sweep within the reference's 1e-5
    between its routes, and a group the staged sweep finds exactly 0 (no
    weight) is exactly 0 fused. Explain rows/s against the plain batch, and
    the attribution drift report's alerts (64 rows repeated against the
    256-row baseline)."""
    fn = P.score(model)
    big = wide_hash_dataset(INSIGHTS_WIDE_ROWS, FUSED_WIDE_SEED)
    small = big.take(np.arange(INSIGHTS_WIDE_EXPLAIN_ROWS))
    before = P.ledger.snapshot()["explainBudgetSkips"]
    with scoped_env({"TPTPU_HOST_PREDICT_MAX": "32"}):
        skipped = fn.columns(big, explain=3)
        if skipped["attributions"] is not None or pred.name not in skipped:
            raise AssertionError("insights wide: the budget skip")
        skips = P.ledger.snapshot()["explainBudgetSkips"] - before
        with scoped_env({"TPTPU_EXPLAIN_LANE_BUDGET": str(INSIGHTS_WIDE_BUDGET)}):
            sweeps = []
            observe = fn.attribution_drift.observe
            fn.attribution_drift.observe = lambda names, diffs: (
                sweeps.append(diffs.copy()), observe(names, diffs))
            fused_attrs = counter.counted(
                lambda: fn.columns(small, explain=3))["attributions"]
            staged_attrs = staged(fn, lambda: fn.columns(
                small, explain=3))["attributions"]
            fn.attribution_drift.observe = observe
            I.same_attributions(fused_attrs, staged_attrs, 1e-5)
            fused_d, staged_d = sweeps
            zero = ~staged_d.any(axis=0)
            if fused_d[:, zero].any() or not np.allclose(
                    fused_d, staged_d, rtol=0, atol=1e-5):
                raise AssertionError(
                    "insights wide: the fused sweep's diffs differ from the "
                    f"staged one's ({int(zero.sum())} groups exactly 0 "
                    "staged)")
            plain_s = host_seconds(lambda: fn.columns(small), INSIGHTS_REPS)
            explain_s = host_seconds(lambda: fn.columns(small, explain=3),
                                     INSIGHTS_REPS)
    md = fused_md(fn)
    if md["fallbacks"] or skips != 1:
        raise AssertionError(f"insights wide: {md}, {skips} budget skips")
    best = getattr(model.fitted[model.selector_info["estimatorUid"]],
                   "best_model", None)
    drift = fn.metadata()["attributions"]["drift"]
    return {"winner": type(best).__name__,
            "groups": len(fn.metadata()["attributions"]["groups"] or []),
            "groups_exactly_0": int(zero.sum()),
            "fused_vs_staged_diffs_max": float(np.abs(fused_d - staged_d).max()),
            "drift_rows": drift["rowsObserved"],
            "drift_alerts": len(drift["alerts"]),
            "budget_skip_rows": INSIGHTS_WIDE_ROWS, "budget_skips": skips,
            "rows": INSIGHTS_WIDE_EXPLAIN_ROWS,
            "lane_budget": INSIGHTS_WIDE_BUDGET,
            "dispatches": md["dispatches"], "fallbacks": md["fallbacks"],
            "fused_vs_staged_within": 1e-5,
            "plain_rows_per_s": INSIGHTS_WIDE_EXPLAIN_ROWS / plain_s,
            "explain_rows_per_s": INSIGHTS_WIDE_EXPLAIN_ROWS / explain_s}


def insights(torch, smi: str, ST, TS, counter, wide) -> dict:
    """``explain=3`` on the card: (a) the serving fixtures staged (600 rows:
    16 lanes of 1024 rows) and fused (100 rows, the cutoff at 64: 16 lanes
    of 128 rows through the device route), each held to the JAX package's
    stored attributions (trees EQUAL, lr within 1e-6), with K1's and the
    tree sums' launches per explained batch; the fused batch's transfers
    (one upload, one download, one sync); explain rows/s against the plain
    batch; the synthetic depth-6 stacks' lanes above the cutoff (8 x 2500
    rows) EQUAL the port's CPU route; (b) ``.columns`` on the full-width model the families phase
    trained (``insights_wide``); (c) through ``ScoringService``: each request's attributions
    EQUAL a direct batch's; (d) a kernel fault in the staged lanes, the
    fused explain core, a service and ``train()``'s baseline reaches the
    caller."""
    I = insights_module()
    P = I.package("port", DEV)
    stored = I.load_results()
    out: dict = {"card": smi}
    t0 = time.perf_counter()
    for wrapper in (ST.serve_trees, TS.tree_sum, TS.tree_sum_device_route):
        wrapper.launches = 0
    for name in ("xgb", "rf", "lr"):
        atol = 0.0 if name in I.TREES else I.GLM_ATOL
        rec = {}
        for route, n in (("staged", I.CHIP_ROWS),
                         ("fused", I.CHIP_FUSED_ROWS)):
            want = I.from_json(stored["models"][name][route])
            (attrs, fn), launches = lane_batch(
                ST, TS, lambda: I.explain_fixture(P, name, n, route))
            I.same_attributions(attrs, want, atol)
            err = max((abs(g[k] - w[k]) for g, w in zip(attrs, want)
                       for k in w), default=0.0)
            rows = I.fixture_rows(name, n)
            env = ({"TPTPU_FUSED": "0"} if route == "staged" else
                   {"TPTPU_HOST_PREDICT_MAX": str(I.CHIP_FUSED_CUTOFF)})
            with scoped_env(env):
                plain_s = host_seconds(lambda: fn.batch(rows), INSIGHTS_REPS)
                explain_s = host_seconds(lambda: fn.batch(rows, explain=3),
                                         INSIGHTS_REPS)
                _, again = lane_batch(ST, TS, lambda: fn.batch(rows, explain=3))
                if route == "fused":
                    _, syncs, msgs = count_syncs(
                        torch, lambda: fn.batch(rows, explain=3))
                    copies = dispatched_copies(
                        torch, lambda: fn.batch(rows, explain=3))
                    if (copies["h2d"], copies["d2h"], syncs) != (1, 1, 1):
                        raise AssertionError(
                            f"insights {name} fused: {copies} copies, "
                            f"{syncs} syncs ({msgs})")
                    rec["fused_transfers"] = {
                        "uploads": copies["h2d"], "downloads": copies["d2h"],
                        "host_syncs": syncs}
            rec[route] = {
                "rows": n, "equals_jax": atol == 0.0,
                "max_abs_err_vs_jax": err,
                "launches_first_batch": dict(zip(
                    ("serve_trees", "tree_sum", "tree_sum_device_route"),
                    launches)),
                "launches_per_explained_batch": dict(zip(
                    ("serve_trees", "tree_sum", "tree_sum_device_route"),
                    again)),
                "plain_rows_per_s": n / plain_s,
                "explain_rows_per_s": n / explain_s,
                "groups": len(fn.metadata()["attributions"]["groups"])}
        phase(f"insights {name}", card=smi, **rec)
        out[name] = rec
    # the lanes above the host-predict cutoff at a row count that is not a
    # power of two (8 lanes x 2500 rows), depth 6, 2 and 4 tree windows:
    # EQUAL the port's CPU route, which equals the JAX package's there
    # (tests/test_torch_insights.py)
    CPU = I.package("port", "cpu")
    depth6 = {}
    for trees in (40, 100):
        x, card_models = I.depth6_models(P, trees)
        _, cpu_models = I.depth6_models(CPU, trees)
        groups = P.loco.column_groups(None, x.shape[1], count_fallback=False)
        for kind, cm, hm in zip(("boosted", "forest"), card_models,
                                cpu_models):
            (got, info), launches = lane_batch(
                ST, TS, lambda: P.loco.explain_batch(cm, x, groups))
            want, _ = CPU.loco.explain_batch(hm, x, groups)
            if not np.array_equal(got, want):
                raise AssertionError(f"insights depth6 {trees} {kind}: "
                                     "the card's diffs differ from the CPU's")
            depth6[f"{kind}_{trees}"] = {
                "lane_rows": info["lanes"] * x.shape[0], "equal_cpu": True,
                "launches": dict(zip(("serve_trees", "tree_sum",
                                      "tree_sum_device_route"), launches))}
    out["depth6"] = depth6
    phase("insights depth6", card=smi, **depth6)
    if wide is not None:
        out["wide"] = insights_wide(P, I, counter, *wide)
        phase("insights wide", card=smi, **out["wide"])
    # (c) the service
    fn = P.score(P.load(I.model_path("xgb")))
    rows = I.fixture_rows("xgb", 48)
    svc = P.serving.ScoringService(fn, P.serving.ServiceConfig(
        workers=0, max_batch_rows=16))
    svc.start()
    hs = [svc.submit(r, explain=3) for r in rows]
    while svc.pump():
        pass
    svc.stop()
    direct = I.attributions(fn.batch(rows, explain=3))
    I.same_attributions([h.result(1)[0]["attributions"] for h in hs], direct,
                        0.0)
    out["service"] = {"requests": len(rows), "equal_direct": True,
                      "completed": svc.stats()["completed"]}
    phase("insights service", card=smi, **out["service"])
    out["launches"] = dict(zip(("serve_trees", "tree_sum",
                                "tree_sum_device_route"),
                               launch_counts(ST, TS)))
    for wrapper in (ST.serve_trees, TS.tree_sum, TS.tree_sum_device_route):
        wrapper.launches = 0
    # (d) kernel faults (launch nothing that is counted)
    with scoped_env({"TPTPU_HOST_PREDICT_MAX": str(I.CHIP_FUSED_CUTOFF)}):
        fused_fn = P.score(P.load(I.model_path("xgb")))
        rows_fused = I.fixture_rows("xgb", I.CHIP_FUSED_ROWS)
        fused_fn.batch(rows_fused)
        out["faults"] = insights_fault_checks(torch, I, P, ST, fused_fn,
                                              rows_fused)
    phase("insights kernel faults", **out["faults"])
    for wrapper in (ST.serve_trees, TS.tree_sum, TS.tree_sum_device_route):
        wrapper.launches = 0
    if not (out["launches"]["serve_trees"] and out["launches"]["tree_sum"]
            and out["launches"]["tree_sum_device_route"]):
        raise AssertionError(f"insights: launches {out['launches']}")
    out["seconds"] = time.perf_counter() - t0
    return out


#: the text phase: the JAX package's embeddings configuration
#: (baseline_cpu.make_topic_corpus at its defaults, bench.py embeddings:
#: 5000 documents x 40 tokens, V = 2000, 10 topics); the SGD steps and the
#: documents of the card-against-CPU comparisons; the documents the text
#: train() scores
TEXT_CORPUS = dict(n_docs=5000, n_topics=10, words_per_topic=200, doc_len=40)
TEXT_CPU_STEPS = 50
TEXT_PROFILE_STEPS = 50
TEXT_LDA_CPU_DOCS = 500
TEXT_SCORE_DOCS = 1000
#: the card against the port's CPU route: SGNS vectors after
#: TEXT_CPU_STEPS steps relative to the largest |w| (the one-hot GEMM
#: against index_add_; measured 4.2e-8 on an H100); LDA topic_word relative
#: to its largest entry and theta absolute (CUDA's digamma and reductions
#: against the CPU's, compounded over 20 x 11 iterations; measured 2.1e-5
#: and 1.5e-5 over the first 500 documents, 10 topics; over the first 300
#: they read 1.3e-3 and 8.0e-4, argmax topics EQUAL: fewer documents pin
#: the topics less and the EM carries the last ulps further); a logistic
#: winner's
#: probabilities
TEXT_SGNS_RTOL = 2e-6
TEXT_LDA_RTOL = 1e-4
TEXT_LDA_THETA_ATOL = 1e-4
TEXT_LR_ATOL = 1e-6
#: the reference's quality floors (tests/test_dsl_transformers.py)
TEXT_P10_FLOOR = 0.8
TEXT_LDA_FLOOR = 0.7


#: the text train()'s stage settings (``text.FULL_STAGES`` where None)
TEXT_STAGES = None


def text_module():
    sys.path.insert(0, os.path.join(ROOT, "tests", "torch_fixtures"))
    import text as TX

    return TX


def profiled_kernels(torch, fn) -> tuple:
    """(fn(), the CUDA kernels it launched and their device seconds, from
    ``torch.profiler``; "not measured" where the profiler saw none)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith(("Memcpy", "Memset"))]
    launches = sum(e.count for e in events)
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if not launches:
        return out, "not measured", "not measured"
    return out, launches, busy


def text_word2vec(torch, BC, PE) -> dict:
    """(a) OpWord2Vec on the card at the reference's configuration: the
    fit's seconds, the SGD loop's launches and device seconds (a second fit
    under the profiler, bit-equal to the first), precision@10, the
    vocabulary against an independent count, and the card against the CPU
    route over the same pre-sampled batches."""
    from transmogrifai_tpu_torch import types as PT
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.types.columns import ListColumn

    vocab, ids, _ = BC.make_topic_corpus(**TEXT_CORPUS)
    docs = np.empty(len(ids), dtype=object)
    for d, row in enumerate(ids):
        docs[d] = [vocab[i] for i in row]
    ds = Dataset.of({"text": ListColumn(PT.TextList, docs)})
    feat = FeatureBuilder.TextList("text").as_predictor()

    def fit():
        est = PE.OpWord2Vec(vector_size=100, window_size=5, min_count=1,
                            max_vocab=len(vocab))
        est.set_input(feat)
        return est, est.fit(ds)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est, model = fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    steps = est.metadata["trainSteps"]
    _, pairs = est.vocabulary_and_pairs(ds["text"])
    # the SGD loop again, its inputs already on the card: the second fit of
    # the vectors over the same pre-sampled steps, timed alone
    centers, contexts, neg, lr_sched = (
        torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
        for a in PE.sgns_batches(pairs, len(model.vocab), steps))
    w0 = torch.from_numpy(PE.sgns_start(len(model.vocab), 100, 42)).to(DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = PE.sgns_steps(w0, centers, contexts, neg, lr_sched)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    if not np.array_equal(again.cpu().numpy(), model.vectors):
        raise AssertionError("text word2vec: two card fits differ")
    window = [a[:TEXT_PROFILE_STEPS] for a in (centers, contexts, neg, lr_sched)]
    _, syncs, sync_kinds = count_syncs(
        torch, lambda: PE.sgns_steps(w0, *window))
    # launches and device time a step, from the profiler over a window (a
    # session over every step slows late in a long run)
    _, window_launches, window_busy = profiled_kernels(
        torch, lambda: PE.sgns_steps(w0, *window))
    del centers, contexts, neg, lr_sched, window, again
    per_step = (window_launches / TEXT_PROFILE_STEPS
                if isinstance(window_launches, int) else window_launches)
    counts = np.bincount(ids.ravel(), minlength=len(vocab))
    want_vocab = [vocab[i] for i in sorted(
        range(len(vocab)), key=lambda i: (-counts[i], vocab[i]))]
    if model.vocab != want_vocab:
        raise AssertionError("text word2vec: the vocabulary differs from the "
                             "counted order")
    order = [model.vocab.index(t) for t in vocab]
    p10 = BC.w2v_neighbor_precision(vocab, model.vectors[order],
                                    TEXT_CORPUS["words_per_topic"])
    if not p10 >= TEXT_P10_FLOOR:
        raise AssertionError(f"text word2vec: precision@10 {p10}")
    card = PE.sgns_train(pairs, len(model.vocab), 100, steps=TEXT_CPU_STEPS)
    cpu = PE.sgns_train(pairs, len(model.vocab), 100, steps=TEXT_CPU_STEPS,
                        device="cpu")
    err = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    if not err <= TEXT_SGNS_RTOL:
        raise AssertionError(f"text word2vec: card against cpu {err}")
    return {"vocab": len(model.vocab), "pairs": int(len(pairs)),
            "steps": steps, "fit_s": fit_s, "sgd_loop_s": loop_s,
            "sgd_step_ms": loop_s / steps * 1e3,
            "launches": int(round(per_step * steps))
            if isinstance(per_step, float) else per_step,
            "launches_per_step": per_step,
            "launches_source": f"torch.profiler over {TEXT_PROFILE_STEPS} "
                               "steps, times the steps",
            "device_busy_ms_per_step": window_busy / TEXT_PROFILE_STEPS * 1e3
            if isinstance(window_busy, float) else window_busy,
            "host_syncs_in_50_steps": syncs,
            "sync_kinds": sync_kinds, "precision_at_10": p10,
            "two_fits": "bit-equal", "vocab_equals_counted_order": True,
            "card_vs_cpu_rel_err": err, "card_vs_cpu_steps": TEXT_CPU_STEPS,
            "card_vs_cpu_tolerance": TEXT_SGNS_RTOL}


def text_lda(torch, BC, PE) -> dict:
    """(b) OpLDA on the card at k = 10, 20 EM iterations over the corpus's
    [5000, 2000] counts: seconds and peak memory of the fit, the transform
    on the card, topic purity and document accuracy, and the card against
    the CPU route on the first TEXT_LDA_CPU_DOCS documents."""
    from transmogrifai_tpu_torch import types as PT
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.stages.metadata import VectorMetadata
    from transmogrifai_tpu_torch.types.columns import VectorColumn

    vocab, ids, doc_topics = BC.make_topic_corpus(**TEXT_CORPUS)
    k = TEXT_CORPUS["n_topics"]
    counts = np.zeros((len(ids), len(vocab)), dtype=np.float32)
    np.add.at(counts, (np.repeat(np.arange(len(ids)), ids.shape[1]),
                       ids.ravel()), 1.0)
    ds = Dataset.of({"counts": VectorColumn(
        PT.OPVector, counts, VectorMetadata("counts", ()))})
    feat = FeatureBuilder.OPVector("counts").as_predictor()
    est = PE.OpLDA(k=k, max_iter=20)
    est.set_input(feat)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = est.fit(ds)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    theta = model.transform_columns(ds["counts"], num_rows=len(ids)).values
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    purity, acc = BC.lda_quality(model.topic_word, theta, doc_topics,
                                 TEXT_CORPUS["words_per_topic"])
    if not (purity >= TEXT_LDA_FLOOR and acc >= TEXT_LDA_FLOOR):
        raise AssertionError(f"text lda: purity {purity}, accuracy {acc}")
    (_, _), launches, busy = profiled_kernels(
        torch, lambda: PE.lda_fit(counts, k, iters=20, seed=42))
    sub = counts[:TEXT_LDA_CPU_DOCS]
    lam_c, theta_c = PE.lda_fit(sub, k, iters=20, seed=42)
    t0 = time.perf_counter()
    lam_p, theta_p = PE.lda_fit(sub, k, iters=20, seed=42, device="cpu")
    cpu_s = time.perf_counter() - t0
    lam_err = float(np.abs(lam_c - lam_p).max() / np.abs(lam_p).max())
    theta_err = float(np.abs(theta_c - theta_p).max())
    tr_c = PE.lda_transform(sub, lam_c)
    tr_err = float(np.abs(tr_c - PE.lda_transform(sub, lam_c, device="cpu")
                          ).max())
    if not (lam_err <= TEXT_LDA_RTOL and theta_err <= TEXT_LDA_THETA_ATOL
            and tr_err <= TEXT_LDA_THETA_ATOL
            and np.array_equal(theta_c.argmax(1), theta_p.argmax(1))):
        raise AssertionError(f"text lda: card against cpu topic_word "
                             f"{lam_err}, theta {theta_err}, transform "
                             f"{tr_err}")
    return {"docs": len(ids), "vocab": len(vocab), "k": k, "em_iters": 20,
            "fit_s": fit_s, "transform_s": transform_s,
            "peak_memory_bytes": peak, "launches": launches,
            "device_busy_s": busy, "topic_purity": purity,
            "doc_accuracy": acc, "card_vs_cpu_docs": TEXT_LDA_CPU_DOCS,
            "cpu_fit_s": cpu_s, "topic_word_rel_err": lam_err,
            "theta_abs_err": theta_err, "transform_abs_err": tr_err,
            "argmax_topics": "equal",
            "tolerances": {"topic_word_rel": TEXT_LDA_RTOL,
                           "theta_abs": TEXT_LDA_THETA_ATOL}}


def text_train(torch, smi: str, counters, TX, ds, rows, candidates: str,
               prefit=None) -> dict:
    """(c) The text flow through train() on the card: word2vec, count
    vectors into LDA, TF-IDF and language detection of the documents
    (authors in front), sanity checked, a binary selector over
    ``candidates`` (``text.build_flow``'s), with sensitive-feature
    detection; ``prefit`` (a model) lends its fitted stages but the
    selector's. Then ``score_function(model)`` on ``rows`` (fresh
    documents), staged
    after the fused attempt is refused as the reference refuses it, held to
    the same model scored on the CPU route: trees EQUAL, a logistic winner
    within TEXT_LR_ATOL. Launches are read around the train() and around
    the scoring."""
    import json as _json
    import tempfile
    import types as _types

    from transmogrifai_tpu_torch import load_workflow_model, score_function

    flow = TX.build_flow("port", ds, candidates, stages=TEXT_STAGES)
    if prefit is not None:
        flow["workflow"].with_model_stages(_types.SimpleNamespace(fitted={
            k: v for k, v in prefit.fitted.items()
            if k != prefit.selector_info["estimatorUid"]}))
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    with UtilizationSampler(period_ms=100) as util, TrainTimer() as timer:
        t0 = time.time()
        model = flow["workflow"].train()
        torch.cuda.synchronize()
        t1 = time.time()
    train_s = t1 - t0
    train_launches = {k: fn.launches for k, fn in counters.items()}
    for fn in counters.values():
        fn.launches = 0
    busy = util.between(t0, t1)
    summary = model.summary_json()
    sel = summary["modelSelectorSummary"]
    check_lanes(f"text {candidates}", sel)
    for k in ("hist_binloop", "split_search"):
        if not train_launches[k]:
            raise AssertionError(f"text {candidates}: {k} never ran")
    sensitive = summary["sensitiveFeatures"]
    if [(r["name"], r["kind"]) for r in sensitive or []] != [("text", "Name")]:
        raise AssertionError(f"text {candidates}: sensitive features "
                             f"{sensitive}")
    with open(os.path.join(ROOT, "tests", "fixtures", "torch_text",
                           "jax_results.json")) as fh:
        want_reason = _json.load(fh)["trees"]["fused"]["reason"]
    fn = score_function(model)
    with scoped_env({"TPTPU_HOST_PREDICT_MAX": "0"}):
        fn.batch(rows[:64])  # the fused attempt, refused
    fused = TX.fused_state(fn)
    if fused["active"] or fused["reason"] != want_reason:
        raise AssertionError(f"text {candidates}: fused state {fused}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn.batch(rows)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    score_launches = {k: fn_.launches for k, fn_ in counters.items()}
    for fn_ in counters.values():
        fn_.launches = 0
    name = flow["pred"].name
    got = TX.probabilities(out, name)
    if not np.isfinite(got).all():
        raise AssertionError(f"text {candidates}: a non-finite score")
    with tempfile.TemporaryDirectory() as tmp:
        model.save(os.path.join(tmp, "model"))
        cpu_model = load_workflow_model(os.path.join(tmp, "model"),
                                        device="cpu")
    want = TX.probabilities(score_function(cpu_model, device="cpu").batch(rows),
                            name)
    winner = sel["bestModelType"]
    diff = float(np.abs(got - want).max())
    if winner in GLM_FAMILIES:
        if not diff <= TEXT_LR_ATOL:
            raise AssertionError(f"text {candidates}: card against cpu {diff}")
    else:
        if not np.array_equal(got, want):
            raise AssertionError(f"text {candidates}: the card's tree scores "
                                 "differ from the CPU route's")
        for k in ("serve_trees", "tree_sum"):
            if not score_launches[k]:
                raise AssertionError(f"text {candidates}: a tree winner's "
                                     f"scoring never ran {k}")
    return {"card": smi, "candidates": candidates,
            "rows": ds.num_rows, "train_rows": model.train_rows,
            "holdout_rows": model.holdout_rows,
            "prefitted_stages": 0 if prefit is None else len(prefit.fitted) - 1,
            "vector_columns": int(np.asarray(model.score(
                ds.take(np.arange(8)), keep_intermediate_features=True)[
                    model.selector_info["vectorName"]].values).shape[1]),
            **timer.split(train_s),
            "device_busy_share": sum(busy) / len(busy) / 100.0 if busy
            else "not measured", "busy_samples": len(busy),
            "winner": winner, "grid": sel["bestGrid"],
            "holdout_metrics": {k: v for k, v in (
                sel.get("holdoutEvaluation") or {}).items()
                if not isinstance(v, list)},
            "sensitive_features": sensitive, "fused": fused,
            "score_rows": len(rows), "score_s": score_s,
            "card_vs_cpu_scores": "equal" if diff == 0.0
            else f"{diff} (within {TEXT_LR_ATOL})",
            "launches": train_launches, "score_launches": score_launches,
            "_model": model}


def text_phase(torch, smi: str, counters) -> dict:
    """The text phase: (a) word2vec, (b) LDA, (c) the text train() at the
    default selector, then with the tree candidates at small grids over
    the first model's fitted text stages, so that a tree winner's scoring
    runs K1 and the tree sum whichever family the default selector picks."""
    from transmogrifai_tpu_torch.ops import embeddings as PE

    TX = text_module()
    BC = TX.BC
    t0 = time.perf_counter()
    w2v = text_word2vec(torch, BC, PE)
    w2v["part_s"] = time.perf_counter() - t0
    phase("text word2vec", card=smi, **w2v)
    t1 = time.perf_counter()
    lda = text_lda(torch, BC, PE)
    lda["part_s"] = time.perf_counter() - t1
    phase("text lda", card=smi, **lda)
    ds = TX.text_table("port", **TEXT_CORPUS)
    rows = TX.score_rows(TX.text_table(
        "port", **dict(TEXT_CORPUS, n_docs=TEXT_SCORE_DOCS, seed=TX.FRESH_SEED)))
    runs = {}
    prefit = None
    for candidates, label in (("default", "text train"),
                              ("trees", "text train trees")):
        t1 = time.perf_counter()
        run = text_train(torch, smi, counters, TX, ds, rows, candidates, prefit)
        run["part_s"] = time.perf_counter() - t1
        prefit = run.pop("_model")
        runs[f"{label} scoring"] = {"launches": run.pop("score_launches")}
        runs[label] = run
        phase(label, **run, score_launches=runs[f"{label} scoring"]["launches"])
    del prefit
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in counters}
    for k in ("hist_binloop", "split_search", "serve_trees", "tree_sum"):
        if not launches[k]:
            raise AssertionError(f"text: {k} never ran in the phase")
    return {"seconds": time.perf_counter() - t0, "word2vec": w2v, "lda": lda,
            "launches": launches, "train_runs": runs}


#: (a)'s table: ``fit_side_tables.wide_hash_table`` (the families
#: phase's 1419-column table) written as this many CSV chunk files
RESILIENCE_ROWS = 8192
RESILIENCE_CHUNKS = 8


def resilience_module():
    sys.path.insert(0, os.path.join(ROOT, "tests", "torch_fixtures"))
    import resilience_flow

    return resilience_flow


def write_csv_chunks(directory: str, schema: dict, columns: dict,
                     chunks: int) -> list:
    """The table as ``chunks`` CSV files of equal rows (a header each, an
    empty cell for a missing value, floats by ``repr``, which reads back
    to the same double)."""
    import csv

    names = list(schema)
    n = len(columns[names[0]])
    size = -(-n // chunks)
    paths = []
    for c in range(chunks):
        path = os.path.join(directory, f"part-{c:03d}.csv")
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(names)
            for i in range(c * size, min(n, (c + 1) * size)):
                w.writerow(["" if columns[k][i] is None else
                            repr(columns[k][i]) if isinstance(columns[k][i], float)
                            else str(columns[k][i]) for k in names])
        paths.append(path)
    return paths


def csv_features(schema: dict):
    """A raw feature per column, typed by the schema, each parsing its CSV
    cell (the label the response)."""
    from transmogrifai_tpu_torch.features import FeatureBuilder as FB

    parse = {"Real": float, "RealNN": float, "Integral": int,
             "Binary": lambda v: v == "True"}
    feats = []
    for name, kind in schema.items():
        conv = parse.get(kind, str)
        fn = (lambda r, k=name, c=conv: None if r[k] is None else c(r[k]))
        f = getattr(FB, kind)(name).extract(fn)
        feats.append(f.as_response() if name == "label" else f.as_predictor())
    return feats


def resilience_selector():
    """The default binary selector with the tree grids cut as the families
    phase cuts them (``FAMILY_TREE_GRIDS``)."""
    from transmogrifai_tpu_torch.selector import model_selector as MS

    default = MS.BinaryClassificationModelSelector()
    return MS.BinaryClassificationModelSelector(models=[
        (e, FAMILY_TREE_GRIDS.get(type(e).__name__, g))
        for e, g in default.models])


def resilience_flow_of(schema: dict, reader):
    from transmogrifai_tpu_torch.ops.transmogrify import transmogrify
    from transmogrifai_tpu_torch.utils import uid
    from transmogrifai_tpu_torch.workflow.workflow import Workflow

    uid.reset()
    feats = csv_features(schema)
    label = next(f for f in feats if f.is_response)
    checked = label.sanity_check(
        transmogrify([f for f in feats if not f.is_response]),
        remove_bad_features=True)
    pred = resilience_selector().set_input(label, checked).get_output()
    return Workflow().set_result_features(pred).set_reader(reader), pred, feats


class PollSyncs:
    """Counts the host syncs made inside the run recorder's device-memory
    polls: CUDA's sync debug mode is on only while a poll runs."""

    def __init__(self, torch, runlog):
        self.torch, self.runlog = torch, runlog
        self.polls = self.syncs = 0

    def __enter__(self):
        import warnings

        real = self.real = self.runlog.poll_device_memory

        def poll():
            self.torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    out = real()
            finally:
                self.torch.cuda.set_sync_debug_mode(0)
            self.polls += 1
            self.syncs += sum("synchronizing CUDA operation" in str(w.message)
                              for w in caught)
            return out

        self.runlog.poll_device_memory = poll
        return self

    def __exit__(self, *exc):
        self.runlog.poll_device_memory = self.real


def resilience_stream(torch, smi: str, counters, F, tmp: str) -> dict:
    """(a) ``train(stream=True, checkpoint_dir=, run_dir=)`` over the CSV
    chunks of the full-width table, then the same flow materialized: the
    streamed statistics bit-equal to a one-shot pass, the trees EQUAL, the
    RUN report valid with the card's allocator in it, no sync in a poll."""
    sys.path.insert(0, os.path.join(ROOT, "tests", "torch_fixtures"))
    from fit_side_tables import wide_hash_table

    from transmogrifai_tpu_torch.readers import FileStreamingReader, SimpleReader
    from transmogrifai_tpu_torch.telemetry import runlog
    from transmogrifai_tpu_torch.workflow import stream as WS

    schema, columns = wide_hash_table(RESILIENCE_ROWS)
    data = os.path.join(tmp, "chunks")
    os.makedirs(data)
    t0 = time.perf_counter()
    write_csv_chunks(data, schema, columns, RESILIENCE_CHUNKS)
    write_s = time.perf_counter() - t0
    captured = {}
    real_ingest = WS.stream_ingest

    def ingest(*a, **kw):
        captured["out"] = real_ingest(*a, **kw)
        return captured["out"]

    runs = {}
    reader = FileStreamingReader(data, pattern="*.csv")
    wf, pred, feats = resilience_flow_of(schema, reader)
    box = capture_refit_lanes(pred)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    WS.stream_ingest = ingest
    try:
        with UtilizationSampler(period_ms=100) as util, \
                PollSyncs(torch, runlog) as polls:
            t0 = time.time()
            model = wf.train(stream=True,
                             checkpoint_dir=os.path.join(tmp, "ck_stream"),
                             run_dir=os.path.join(tmp, "runs"))
            torch.cuda.synchronize()
            t1 = time.time()
    finally:
        WS.stream_ingest = real_ingest
    runs["resilience stream"] = {"launches": {k: fn.launches
                                              for k, fn in counters.items()}}
    busy = util.between(t0, t1)
    train_raw, summary = captured["out"]
    report = model.run_report
    problems = runlog.validate_run_report(report)
    if problems:
        raise AssertionError(f"resilience (a): RUN report {problems}")
    run = report["run"]
    mem = run["deviceMemory"]
    if mem["backend"] != "cuda" or not mem["devicePeakBytes"] > 0:
        raise AssertionError(f"resilience (a): device memory {mem}")
    if polls.syncs or not polls.polls:
        raise AssertionError(f"resilience (a): {polls.syncs} syncs in "
                             f"{polls.polls} recorder polls")
    # the one-shot pass over the same rows
    records = [r for b in FileStreamingReader(data, pattern="*.csv")
               .stream_batches() for r in b]
    whole = SimpleReader(records).generate_dataset(feats)
    one = WS.ChunkStatsReducer()
    one.fold_dataset(whole)
    if summary["fitStats"] != one.finalize():
        raise AssertionError("resilience (a): streamed column stats differ "
                             "from the one-shot pass")
    if summary["rowsSeen"] != RESILIENCE_ROWS or summary["quarantinedTotal"]:
        raise AssertionError(f"resilience (a): ingest {summary}")
    # the same flow over the same records, materialized
    wf2, pred2, _ = resilience_flow_of(schema, SimpleReader(records))
    box2 = capture_refit_lanes(pred2)
    for fn in counters.values():
        fn.launches = 0
    t2 = time.perf_counter()
    model2 = wf2.train(stream=False)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t2
    runs["resilience materialized"] = {"launches": {
        k: fn.launches for k, fn in counters.items()}}
    for fn in counters.values():
        fn.launches = 0
    a, b = F.fitted_arrays(model), F.fitted_arrays(model2)
    if not same_arrays(a, b):
        raise AssertionError("resilience (a): the streamed model differs from "
                             "the materialized one")
    sel = model.summary_json()["modelSelectorSummary"]
    # every candidate's fold metrics (the tree families' fits among them)
    # EQUAL the materialized run's
    got_v = [(r["modelName"], r["grid"], r["metricValues"])
             for r in sel["validationResults"]]
    want_v = [(r["modelName"], r["grid"], r["metricValues"]) for r in
              model2.summary_json()["modelSelectorSummary"]["validationResults"]]
    if got_v != want_v:
        raise AssertionError("resilience (a): the streamed sweep's metrics "
                             "differ from the materialized one's")
    # and every family's refit lanes, the tree families' trees among them
    lanes, lanes2 = refit_lane_arrays(box), refit_lane_arrays(box2)
    if not any(":split_feat" in k or "split_feat" in k for k in lanes):
        raise AssertionError("resilience (a): no tree family's refit lane")
    if not same_arrays(lanes, lanes2):
        bad = sorted(k for k in set(lanes) | set(lanes2)
                     if not same_arrays({k: lanes.get(k)}, {k: lanes2.get(k)}))
        raise AssertionError("resilience (a): the streamed refit lanes differ "
                             f"from the materialized ones: {bad[:8]}")
    launches = runs["resilience stream"]["launches"]
    for k in ("hist_binloop", "split_search", "node_order"):
        if not launches[k]:
            raise AssertionError(f"resilience (a): {k} never ran")
    chunk_series = mem.get("chunkSeries", [])
    return {"card": smi, "rows": RESILIENCE_ROWS,
            "chunk_files": RESILIENCE_CHUNKS, "csv_write_s": write_s,
            "ingest_s": run["phases"]["ingest"]["seconds"],
            "chunks": summary["chunksDone"], "rows_seen": summary["rowsSeen"],
            "quarantined": summary["quarantinedTotal"],
            "rows_buffered": summary["rowsBuffered"],
            "host_rss_per_chunk": [c["hostRssBytes"] for c in chunk_series],
            "device_bytes_per_chunk": [c["deviceBytesInUse"]
                                       for c in chunk_series],
            "device_peak_bytes": mem["devicePeakBytes"],
            "train_s": t1 - t0,
            "phases_s": {k: v["seconds"] for k, v in run["phases"].items()},
            "layers_s": [l["seconds"] for l in run["layers"]],
            "candidates": [[c["model"], c["seconds"]] for c in run["candidates"]],
            "device_busy_share": sum(busy) / len(busy) / 100.0 if busy
            else "not measured", "busy_samples": len(busy),
            "recorder_polls": polls.polls, "recorder_poll_syncs": polls.syncs,
            "winner": sel["bestModelType"],
            "materialized_train_s": plain_s,
            "streamed_stats": "equal to the one-shot pass",
            "streamed_model": "EQUAL the materialized one, every "
                              "candidate's fold metrics and every family's "
                              "refit lanes too",
            "refit_lane_arrays": len(lanes),
            "run_file": run.get("file"), "launches": launches,
            "_runs": runs, "_model": model}


def same_arrays(a: dict, b: dict) -> bool:
    """The same names and EQUAL arrays (NaN where the other has NaN)."""
    return sorted(a) == sorted(b) and all(
        a[k] is not None and b[k] is not None
        and np.array_equal(a[k], b[k], equal_nan=True) for k in a)


def capture_refit_lanes(pred) -> dict:
    """A box that receives the selector's refit lanes when its validator
    returns (``Validator.last_extra_models``, which the selector clears
    once it took the winner's)."""
    validator = pred.origin_stage.validator
    real, box = validator.validate, {}

    def validate(*a, **kw):
        out = real(*a, **kw)
        box["lanes"] = dict(validator.last_extra_models)
        return out

    validator.validate = validate
    return box


def refit_lane_arrays(box) -> dict:
    """The arrays of every family's refit lanes of the selector's sweep
    (each tree family's trees, each GLM's weights), keyed by family, mask,
    grid point and name."""
    out = {}
    for uid, (_, models) in box["lanes"].items():
        for mi, row in enumerate(models):
            for pi, m in enumerate(row):
                for k, v in m.get_arrays().items():
                    out[f"{uid}:{mi}:{pi}:{k}"] = np.asarray(v)
    return out


def stage_devices(torch, model) -> dict:
    """The device of every tensor a fitted stage holds (a selected model's
    winner, its placed thresholds and packed stacks among them)."""
    out = {}

    def visit(prefix, obj, depth=0):
        if isinstance(obj, torch.Tensor):
            out[prefix] = obj.device.type
        elif depth < 5 and isinstance(obj, (list, tuple)):
            for i, o in enumerate(obj):
                visit(f"{prefix}[{i}]", o, depth + 1)
        elif depth < 5 and hasattr(obj, "__dict__") and not isinstance(
                obj, type):
            for k, v in vars(obj).items():
                visit(f"{prefix}.{k}", v, depth + 1)

    for uid, stage in model.fitted.items():
        visit(type(stage).__name__, stage)
    return out


def resilience_resume(torch, counters, F, P, H, tmp: str) -> dict:
    """(b) Crash and resume on the serving twin at small grids: after the
    selector's layer (every stage restored, each tensor on the card), with
    the selector's layer checkpoint lost (its candidates from their
    checkpoints), after a stream chunk (< 1 chunk of rework), and a kernel
    fault injected mid-train (it propagates; the resume then completes)."""
    from transmogrifai_tpu_torch.utils.cuda_build import KernelLaunchError

    ds = F.twin_ds(P)
    wf, _ = F.tree_flow(P, ds, "xgb")
    for fn in counters.values():
        fn.launches = 0
    reference = wf.train()
    out = {}
    for at in ("after_selector", "selector"):
        r = F.crash_resume(P, os.path.join(tmp, f"ck_{at}"), "xgb", at,
                           ds=ds, reference=reference)
        a, b = F.fitted_arrays(r["resumed"]), F.fitted_arrays(reference)
        if not same_arrays(a, b):
            raise AssertionError(f"resilience (b) {at}: the resumed model "
                                 "differs from the uninterrupted one")
        devices = stage_devices(torch, r["resumed"])
        off = {k: v for k, v in devices.items() if v != "cuda"}
        if not devices or off:
            raise AssertionError(f"resilience (b) {at}: restored tensors off "
                                 f"the card {off or devices}")
        if at == "selector" and not r["hits"] > 0:
            raise AssertionError(f"resilience (b): no candidate checkpoint hit "
                                 f"{r['attempts']}")
        out[at] = {"fired": r["fired"], "layers": r["layers"],
                   "candidate_hits": r["hits"],
                   "restored_tensors_on_cuda": len(devices),
                   "model": "EQUAL the uninterrupted one"}
    s = F.stream_case(P, n=800, chunk=100, crash_after=3,
                      ckpt_dir=os.path.join(tmp, "ck_chunk"))
    sm = s["summary"]
    rework = sm["chunksDone"] - sm["chunksSkippedOnResume"] - (
        sm["chunksFolded"])
    if not (s["crashed"] and sm["resumed"]
            and sm["chunksSkippedOnResume"] == 4 and rework < 1):
        raise AssertionError(f"resilience (b): stream resume {sm}")
    out["after_chunk"] = {"chunks": sm["chunksDone"],
                          "skipped_on_resume": sm["chunksSkippedOnResume"],
                          "refolded": sm["chunksFolded"], "rework_chunks": rework}
    # a kernel fault in the selector's sweep: the split search's wrapper
    # raises at its 5th call
    ck = os.path.join(tmp, "ck_fault")
    wf3, _ = F.tree_flow(P, ds, "xgb")
    real = H.split_search
    calls = {"n": 0}

    def faulty(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 5:
            raise KernelLaunchError("injected: CUDA error: an illegal memory "
                                    "access was encountered")
        return real(*a, **kw)

    faulty.launches = 0  # the wrapper counts on the module's attribute
    H.split_search = faulty
    try:
        wf3.train(checkpoint_dir=ck)
        raise AssertionError("resilience (b): the injected kernel fault did "
                             "not propagate")
    except KernelLaunchError:
        pass
    finally:
        H.split_search = real
    layers = sorted(os.listdir(os.path.join(ck, "layers")))
    partial = [n for n in layers if ".tmp-" in n or ".old-" in n]
    if partial or not layers:
        raise AssertionError(f"resilience (b): checkpoints after the fault "
                             f"{layers}")
    resumed = wf3.train(checkpoint_dir=ck, resume=True)
    a, b = F.fitted_arrays(resumed), F.fitted_arrays(reference)
    if not same_arrays(a, b):
        raise AssertionError("resilience (b): the model resumed after the "
                             "kernel fault differs")
    out["kernel_fault"] = {"propagated": True, "layers_kept": layers,
                           "resumed": "EQUAL the uninterrupted one"}
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    for fn in counters.values():
        fn.launches = 0
    return out


def resilience_retrain(torch, counters, F, P, tmp: str) -> dict:
    """(c) The retrain loop over a two-replica fleet of the serving fixture
    ``xgb`` in virtual time: the state sequence, history, ledger and events
    EQUAL the JAX package's stored run; promoted with no request dropped;
    K1's launches from the canary's start; then a kernel fault in the
    trainer propagates out of ``tick``."""
    from transmogrifai_tpu_torch.utils.cuda_build import KernelLaunchError

    with open(F.RESULTS) as fh:
        want = json.load(fh)["retrain_loop"]
    marks = {}
    k1 = counters["serve_trees"]

    def on_canary(fleet):
        marks["k1"] = k1.launches

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    got = F.retrain_loop(P, os.path.join(tmp, "ck_retrain"),
                         on_canary=on_canary)
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    for fn in counters.values():
        fn.launches = 0
    k1_canary = launches["serve_trees"] - marks.get("k1", 0)
    strip = lambda d: {k: v for k, v in d.items()  # noqa: E731
                       if k != "deviceMemoryHighWater"}
    if strip(got) != strip(want):
        raise AssertionError(f"resilience (c): the loop differs from the JAX "
                             f"package's: {strip(got)} against {strip(want)}")
    if got["history"][-1]["outcome"] != "promoted" or got["dropped"]:
        raise AssertionError(f"resilience (c): {got['history']}")
    if not k1_canary:
        raise AssertionError("resilience (c): K1 never ran during the canary")

    def trainer(chunks, ctx):
        raise KernelLaunchError("injected: CUDA error: an illegal memory "
                                "access was encountered")

    try:
        F.retrain_loop(P, os.path.join(tmp, "ck_fault_rt"), trainer=trainer)
        raise AssertionError("resilience (c): the trainer's kernel fault did "
                             "not propagate out of tick")
    except KernelLaunchError:
        pass
    return {"states": got["states"], "history": got["history"],
            "ledger": got["ledger"],
            "device_memory_high_water": got["deviceMemoryHighWater"],
            "events": got["events"], "dropped": got["dropped"],
            "k1_launches_canary": k1_canary, "seconds": seconds,
            "equal_to_jax": True, "trainer_kernel_fault": "propagated",
            "launches": launches}


def resilience_telemetry(tmp: str) -> dict:
    """(d) The export surfaces over (a)'s run."""
    from transmogrifai_tpu_torch.telemetry import export

    trace = export.export_chrome_trace(os.path.join(tmp, "trace.json"))
    breakdown = export.phase_breakdown()
    line = export.summary_line()
    text = export.render_prometheus()
    sources = {k: f"tptpu_{k}_" in text for k in ("run", "retrain")}
    if not (trace["traceEvents"] and any(breakdown.values()) and line
            and all(sources.values())):
        raise AssertionError(f"resilience (d): {len(trace['traceEvents'])} "
                             f"trace events, {breakdown}, {line}, {sources}")
    return {"trace_events": len(trace["traceEvents"]),
            "phase_breakdown_s": breakdown, "summary_line": line,
            "exposition_sources": sources}


def resilience_phase(torch, smi: str, counters, H) -> dict:
    import tempfile

    F = resilience_module()
    P = F.package("port", DEV)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        a = resilience_stream(torch, smi, counters, F, tmp)
        runs = a.pop("_runs")
        model = a.pop("_model")
        a["part_s"] = time.perf_counter() - t0
        phase("resilience stream", **a)
        tel = resilience_telemetry(tmp)
        phase("resilience telemetry", **tel)
        del model
        t1 = time.perf_counter()
        b = resilience_resume(torch, counters, F, P, H, tmp)
        b["part_s"] = time.perf_counter() - t1
        phase("resilience resume", **b)
        runs["resilience resume"] = {"launches": b["launches"]}
        t2 = time.perf_counter()
        c = resilience_retrain(torch, counters, F, P, tmp)
        c["part_s"] = time.perf_counter() - t2
        phase("resilience retrain", **c)
        runs["resilience retrain"] = {"launches": c["launches"]}
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in counters}
    for k in ("hist_binloop", "split_search", "node_order", "serve_trees",
              "tree_sum"):
        if not launches[k]:
            raise AssertionError(f"resilience: {k} never ran in the phase")
    return {"seconds": time.perf_counter() - t0, "launches": launches,
            "k1_launches_canary": c["k1_launches_canary"],
            "train_runs": runs}


@contextlib.contextmanager
def scoped_env(env: dict):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def start_on_card(torch, sources: list[str]) -> str:
    """Print the environment and the card's name and power limit, and
    build the kernels of ``sources`` (one nvcc each, all started together),
    printing ptxas's report. Returns the name and power limit line."""
    from transmogrifai_tpu_torch.utils import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    phase(
        "environment", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        package=os.path.dirname(os.path.dirname(cuda_build.__file__)),
    )
    print(smi, flush=True)
    from transmogrifai_tpu_torch import native

    t0 = time.perf_counter()
    built = cuda_build.build(sources)
    native.library()  # the host kernels, with g++, before any phase times
    phase("build", seconds=time.perf_counter() - t0, per_source=built,
          native=native.build_info)
    for name, log in cuda_build.build_logs.items():
        print(f"nvcc {name}:\n{log.strip()}", flush=True)
    return smi


#: every kernel source the script builds
SOURCES = ["serve_trees", "tree_sum", "node_order", "hist_binloop", "hist_wide",
           "best_split", "split_search", "leaf_sum"]


def run_fit_side(torch, smi, M) -> dict:
    """The fit side of the flagship flow: the twins against the JAX
    package's stored results, the full-width table, and the checked vector
    into a tree fit with its kernels' counts read around it."""
    flagship, x, y = fit_side_flagship(torch, smi)
    phase("fit_side flagship", **flagship)
    phase("fit_side wide", **fit_side_wide(torch, smi))
    to_train = fit_side_to_train(torch, M.G, M.H, M.ST, M.TS, x, y, smi)
    phase("fit_side to_train", **to_train)
    return {"launches": to_train["launches"]}


def run_train_flagship(torch, smi, M) -> dict:
    """train(): the five-line flow at the default selector, the flagship
    twin held to the JAX package's selector fixture; each with the
    kernels' counts read around exactly its train()."""
    runs = {}
    for name, label in (("selector", "train_flagship"),
                        ("workflow_cv", "train_flagship workflow_cv"),
                        ("selector_trees", "train_flagship trees")):
        runs[label] = train_flagship(torch, smi, name, M.counters)
        phase(label, **runs[label])
    return {"train_runs": runs}


def run_train_wide(torch, smi, M) -> dict:
    """train() at full width; the first model is kept for
    ``fused_serving``."""
    runs = {}
    for trees_only, label in ((False, "train_wide"), (True, "train_wide trees")):
        runs[label] = train_wide(torch, smi, M.counters, trees_only)
        model = runs[label].pop("_model")
        trained = runs[label].pop("_trained")
        if trees_only:
            M.shared["wide_hash_trained"] = trained
        else:
            M.shared["wide_model"] = model
        del model, trained
        phase(label, **runs[label])
    return {"train_runs": runs}


def run_fused_serving(torch, smi, M) -> dict:
    """The fused scoring graph: one upload and one download a batch above
    the host-predict cutoff, K1 and the device-route sum inside; its
    hashed twin is kept for ``featurize_plane``."""
    fused = fused_serving(torch, smi, M.ST, M.TS, M.TR,
                          M.shared.pop("wide_model"),
                          M.shared["wide_hash_trained"],
                          M.load_workflow_model, M.score_function)
    phase("fused_serving", **fused)
    return fused


def run_train_all_types(torch, smi, M) -> dict:
    """Every type of transmogrify's default dispatch through train() and
    scoring above the cutoff, with the kernels' counts read around them."""
    run = train_all_types(torch, smi, M.counters, M.score_function,
                          M.load_workflow_model)
    phase("train_all_types", **run)
    return {"train_runs": {"train_all_types": run}}


def run_train_dsl(torch, smi, M) -> dict:
    """The DSL's stages and the raw feature filter through train(),
    scoring staged and fused with a host prefix."""
    t0 = time.perf_counter()
    run = train_dsl(torch, smi, M.counters, M.ST, M.TS, M.score_function,
                    M.load_workflow_model)
    run["seconds"] = time.perf_counter() - t0
    phase("train_dsl", **run)
    return {"train_runs": {"train_dsl": run}}


def run_multiclass(torch, smi, M) -> dict:
    """The multiclass path: the JAX-recorded flows at fixture size, the
    full-width flow through the default multiclass selector, then the
    training kernels at its sweep's lane counts."""
    t0 = time.perf_counter()
    fixture = multiclass_fixture(torch, smi, M.counters, M.load_workflow_model,
                                 M.score_function)
    phase("multiclass_fixture", **fixture)
    run = train_multiclass(torch, smi, M.counters, M.TS, M.ST,
                           M.score_function, M.load_workflow_model)
    xy = run.pop("_xy")
    phase("train_multiclass", **run)
    kernels = multiclass_kernels(torch, M.H, M.LS, M.TR, *xy)
    del xy
    phase("multiclass_kernels", **kernels)
    phase("multiclass", seconds=time.perf_counter() - t0)
    for fn in M.counters.values():
        fn.launches = 0
    return {"train_runs": {"multiclass_fixture": fixture,
                           "train_multiclass": run},
            "kernels": kernels}


def run_featurize_plane(torch, smi, M) -> dict:
    """The featurize plane against the plain routes, its scoring staged and
    fused; K1's and the route sum's launches of its fused batches
    counted."""
    plane = featurize_plane(torch, smi, M.ST, M.TS,
                            M.shared.pop("wide_hash_trained"),
                            M.score_function, M.native_so_before)
    phase("featurize_plane", **plane)
    return plane


def run_serving_hardening(torch, smi, M) -> dict:
    """The hardened scoring closure: sentinel, quarantine, breakers against
    the fused gate, drift, a kernel fault, and the hardening's cost."""
    run = serving_hardening(torch, smi, M.ST, M.TS, M.load_workflow_model,
                            M.score_function)
    phase("serving_hardening", launches=run["launches"],
          seconds=run["seconds"])
    return run


def run_serving_plane(torch, smi, M) -> dict:
    """The serving plane: worker mode, the bench-mode load test, a fleet
    losing a replica, the canary gate and a kernel fault, over the
    hardened closure."""
    run = serving_plane(torch, smi, M.ST, M.TS)
    phase("serving_plane", launches=run["launches"], seconds=run["seconds"])
    return run


def run_families(torch, smi, M) -> dict:
    """The rest of the selector's catalog at full width, the regression
    selector (GLR among its candidates) and the combiner; the binary
    model is kept for ``insights``."""
    t0 = time.perf_counter()
    run = families(torch, smi, M.counters)
    M.shared["families_wide"] = run.pop("_wide")
    phase("families", seconds=time.perf_counter() - t0)
    return run


def run_text(torch, smi, M) -> dict:
    """The text stages on the card: word2vec and LDA at the reference's
    embeddings configuration, then a text flow through train() (K2, the
    split search, K1 and the tree sum) and its scoring."""
    run = text_phase(torch, smi, M.counters)
    phase("text", seconds=run["seconds"], launches=run["launches"])
    return run


def run_resilience(torch, smi, M) -> dict:
    """The run recorder, checkpoints with resume, the streamed train() and
    the retrain loop on the card (K2, the split search, the row order, the
    leaf sums, K1 and the tree sums inside them)."""
    run = resilience_phase(torch, smi, M.counters, M.H)
    phase("resilience", seconds=run["seconds"], launches=run["launches"])
    return run


def run_insights(torch, smi, M) -> dict:
    """``explain=3`` staged, fused and through the service, held to the JAX
    package's stored attributions, with the kernel-fault checks."""
    run = insights(torch, smi, M.ST, M.TS, FusedLaunches(M.ST, M.TS),
                   M.shared.pop("families_wide"))
    phase("insights", launches=run["launches"], seconds=run["seconds"])
    return run


#: the phases after the kernels' checks and the main path, in the order a
#: whole run takes them; each prints its lines and returns its record. A
#: partial run (``--phases a,b``) takes the named ones in the order named.
PHASES = {
    "fit_side": run_fit_side,
    "train_flagship": run_train_flagship,
    "train_wide": run_train_wide,
    "fused_serving": run_fused_serving,
    "train_all_types": run_train_all_types,
    "train_dsl": run_train_dsl,
    "multiclass": run_multiclass,
    "featurize_plane": run_featurize_plane,
    "serving_hardening": run_serving_hardening,
    "serving_plane": run_serving_plane,
    "families": run_families,
    "insights": run_insights,
    "text": run_text,
    "resilience": run_resilience,
}

#: a phase that takes over what another left, and that phase
NEEDS = {"fused_serving": "train_wide", "featurize_plane": "fused_serving",
         "insights": "families"}


def parse_phases(argv: list[str]) -> list[str] | None:
    """The phases ``--phases a,b`` names, or None for the whole run."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Smoke run of the PyTorch port on one CUDA card.")
    ap.add_argument(
        "--phases", default=None,
        help="a run of only these comma-separated phases (of "
        f"{', '.join(PHASES)}), after the build and K1's and the tree "
        "sum's checks; prints no kernels line")
    args = ap.parse_args(argv)
    if args.phases is None:
        return None
    names = [p.strip() for p in args.phases.split(",") if p.strip()]
    unknown = [n for n in names if n not in PHASES]
    if unknown or not names:
        ap.error(f"unknown phases {unknown or names}; choose from "
                 f"{', '.join(PHASES)}")
    for i, name in enumerate(names):
        if name in NEEDS and NEEDS[name] not in names[:i]:
            ap.error(f"phase {name} needs {NEEDS[name]} named before it")
    return names


def check_kernels_untimed(torch, ST, TS) -> None:
    """A partial run's checks: K1 and the tree sum held bit for bit against
    their plain versions at their synthetic shapes, untimed."""
    for label, (binned, sf, sb, lv, _) in k1_inputs().items():
        phase(f"serve_trees {label}", **check_traversal(
            torch, ST, label, binned, sf, sb, lv, timed=False))
    rng = np.random.default_rng(7)
    for label, (n, t, boosted) in TREE_SUM_SHAPES.items():
        per_tree = torch.from_numpy(rng.normal(size=(n, t)).astype(
            np.float32)).to(DEV)
        phase(f"tree_sum {label}", **check_tree_sum(
            torch, TS, label, per_tree, boosted, 0.02, 0.37, timed=False))


def print_device(torch) -> None:
    """The last line: the platform, the card's name and the card count."""
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


def main(argv: list[str] | None = None) -> int:
    names = parse_phases(sys.argv[1:] if argv is None else argv)
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    native_so_before = file_sha256(NATIVE_SO)
    import types

    from transmogrifai_tpu_torch import load_workflow_model, score_function
    from transmogrifai_tpu_torch.models import gbdt as G
    from transmogrifai_tpu_torch.models import hist as H
    from transmogrifai_tpu_torch.models import leaf_sum as LS
    from transmogrifai_tpu_torch.models import serve_trees as ST
    from transmogrifai_tpu_torch.models import tree_sum as TS
    from transmogrifai_tpu_torch.models import trees as TR

    smi = start_on_card(torch, SOURCES)
    M = types.SimpleNamespace(
        G=G, H=H, LS=LS, ST=ST, TS=TS, TR=TR,
        load_workflow_model=load_workflow_model, score_function=score_function,
        counters=path_counters(H, LS, ST, TS),
        native_so_before=native_so_before, shared={})
    if names is not None:
        check_kernels_untimed(torch, ST, TS)
        for fn in M.counters.values():
            fn.launches = 0
        for name in names:
            PHASES[name](torch, smi, M)
        phase("phases", names=names, seconds=time.perf_counter() - t_start)
        print_device(torch)
        return 0

    # the tree-sum kernel at its shapes (launches here are not counted)
    rng = np.random.default_rng(7)
    ts_paired = {}
    for label, (n, t, boosted) in TREE_SUM_SHAPES.items():
        per_tree = torch.from_numpy(
            (rng.normal(size=(n, t)) * 10.0 ** rng.integers(-3, 2, (n, t)))
            .astype(np.float32)).to(DEV)
        row = check_tree_sum(torch, TS, label, per_tree, boosted, 0.02, 0.37,
                             timed=not label.startswith(("c", "d")),
                             pairs=MUST_PAIRS)
        phase(f"tree_sum {label}", **row)
        if "paired" in row:
            ts_paired[label] = row["paired"]
    # its device-route mode at its shapes (launches here are not counted)
    route_rows = {}
    for label, (n, t, h, depth, boosted) in ROUTE_SHAPES.items():
        per_tree = torch.from_numpy(
            (rng.normal(size=(n, t)) * 10.0 ** rng.integers(-3, 2, (n, t)))
            .astype(np.float32)).to(DEV)
        win = (torch.from_numpy(rng.integers(0, h, (n, t)).astype(np.float32))
               .to(DEV) if h > 1 else None)
        route_rows[label] = check_tree_sum_route(
            torch, TS, label, per_tree, win, h, depth, boosted, 0.02, 0.37,
            timed=label.startswith(ROUTE_TIMED),
            pairs=MUST_PAIRS if label.startswith(("a", "b")) else 2)
        phase(f"tree_sum_device_route {label}", **route_rows[label])
        del per_tree, win
    # the split-search kernel at its shapes (launches here are not counted)
    split_rows = {}
    for i, (label, (k, m, f, b, empty)) in enumerate(SPLIT_SHAPES.items()):
        split_rows[label] = check_split(
            torch, H, label, split_inputs(torch, k, m, f, b, empty, seed=40 + i),
            timed=label < "e")
        phase(f"split_search {label}", **split_rows[label])
    # the leaf-sum kernel at its shapes (launches here are not counted)
    leaf_rows = {}
    for i, (label, (k, n, size, crowded)) in enumerate(LEAF_SHAPES.items()):
        leaf_rows[label] = check_leaf_sum(
            torch, H, LS, label, leaf_inputs(torch, k, n, size, crowded,
                                             seed=50 + i), size,
            timed=label < "c")
        phase(f"leaf_sum {label}", **leaf_rows[label])
    # kernel K4 at the reference's fused-route shapes: on no path, so its
    # launches are counted in these phases alone (early in the run, where
    # the profiler still sees every activity)
    H.build_best_split.launches = 0
    k4 = {}
    for i, (label, (n, f, b, k, m)) in enumerate(K4_SHAPES.items()):
        k4[label] = check_best_split(torch, H, label, n, f, b, k, m,
                                     seed=3 if label.startswith("c") else 20 + i)
        phase(f"best_split {label}", **k4[label])
    k4_launches = H.build_best_split.launches
    H.build_best_split.launches = 0

    k1_shapes = k1_inputs()
    k1_timed = {}
    for label, (binned, sf, sb, lv, timed) in k1_shapes.items():
        if label != "main_path":
            row = check_traversal(torch, ST, label, binned, sf, sb, lv,
                                  timed=timed)
            phase(f"serve_trees {label}", **row)
            if timed:
                k1_timed[label] = row

    # the main path: fixtures scored on the card through the port's entry
    # points, with the launch counts read around exactly this run; the tree
    # models' scores must equal the JAX package's, the logistic model's
    # lie within 1e-6 (its float64 core in another summation order)
    TS.tree_sum.launches = 0
    ST.serve_trees.launches = 0
    models, rates, score_err = {}, {}, {}
    ts_cap = TreeSumCapture(ST)
    with ts_cap:
        ts_cap.path = "serving"
        for name in ("xgb", "rf", "lr"):
            path, rows, want = load_fixture(name)
            model = load_workflow_model(path)
            fn = score_function(model)
            errs = [check_scores(name, [fn(rows[0])],
                                 {k: v[:1] for k, v in want.items()}),
                    check_scores(name, fn.batch(rows), want)]
            big = (rows * (-(-BUCKET_ROWS // len(rows))))[:BUCKET_ROWS]
            errs.append(check_scores(name, fn.batch(big), want))
            secs = []
            for _ in range(3):
                s = time.perf_counter()
                fn.batch(big)
                secs.append(time.perf_counter() - s)
            rates[name] = BUCKET_ROWS / statistics.median(secs)
            score_err[name] = max(errs)
            models[name] = model
    launches = ST.serve_trees.launches
    ts_launches = TS.tree_sum.launches
    ST.serve_trees.launches = 0
    TS.tree_sum.launches = 0
    if launches == 0:
        raise AssertionError("the main path never launched serve_trees")
    if ts_launches == 0:
        raise AssertionError("the main path never launched tree_sum")
    lr_best = next(s for s in models["lr"].fitted.values()
                   if hasattr(s, "best_model")).best_model
    if lr_best.device is None or lr_best.device.type != torch.device(DEV).type:
        raise AssertionError("the lr fixture's model did not predict on the card")
    phase("end_to_end", launches=launches, tree_sum_launches=ts_launches,
          batch_rows=BUCKET_ROWS, rows_per_s=rates,
          score_max_abs_err_vs_jax=score_err,
          score_tolerance=PROB_ATOL)
    # the tree-sum kernel at the serving path's own calls (relaunches are
    # not counted)
    ts_sums = {"serving": check_tree_sum_path(torch, TS, ts_cap.records,
                                              "serving", pairs=MUST_PAIRS)}
    TS.tree_sum.launches = 0
    phase("tree_sum main_path serving", **ts_sums["serving"])
    ts_paired["serving"] = ts_sums["serving"]["paired"]
    phase("tree_sum against torch.sum", pairs=MUST_PAIRS,
          sign_level=SIGN_LEVEL, **{label: {
              k: v for k, v in p.items()
              if k in ("pairs_used", "kernel_wins", "p_kernel_faster",
                       "p_kernel_slower", "verdict")}
              for label, p in ts_paired.items()})
    # the serving path above 16384 rows: the reference's device-route order,
    # its counts read around exactly this run
    route = device_route_path(torch, G, ST, TS, TR, load_workflow_model)
    route_records = route.pop("_records")
    phase("serving_device_route", **route)
    route_main = check_route_path(torch, TS, route_records, pairs=MUST_PAIRS)
    del route_records
    TS.tree_sum_device_route.launches = 0
    ST.serve_trees.launches = 0
    phase("tree_sum_device_route main_path", **route_main)
    for name, model in models.items():
        _, rows, _ = load_fixture(name)
        big = (rows * (-(-BUCKET_ROWS // len(rows))))[:BUCKET_ROWS]
        stage_seconds(torch, model, big)  # warm
        phase(f"where_time_goes {name}", batch_rows=BUCKET_ROWS,
              seconds=stage_seconds(torch, model, big))

    # the kernel at the main path's own shape: the xgb winner's trees over
    # a [8192, F] plane of its width (launches here are not counted)
    main = check_traversal(torch, ST, "main_path", *k1_shapes["main_path"][:4],
                           timed=True)
    phase("serve_trees main_path", **main)
    k1_timed["main_path"] = main
    ST.serve_trees.launches = 0
    phase("serve_trees packing", basis=(
        "host_pack_s: a model's packing of its stacks at placement "
        "(pack_trees, on the host, then the copy to the card); "
        "pack_device_ms: the per-call packing of serve_trees on the card"),
          **{label: {"host_pack_s": row["host_pack_s"],
                     "pack_device_ms": row["pack_device_ms"]}
             for label, row in k1_timed.items()})

    # kernel K2 at its shapes (launches here are not counted)
    for i, (label, (n, f, b, k, m)) in enumerate(K2_SHAPES.items()):
        phase(f"hist_binloop {label}", **check_hist(
            torch, H, "hist_binloop", label, n, f, b, k, m,
            timed=not label.startswith("c"), seed=i, root=label.endswith("root")))
    phase("small_fits", **check_small_fits(torch))
    # kernel K3 at its shapes (launches here are not counted)
    for i, (label, (n, f, b, k, m)) in enumerate(K3_SHAPES.items()):
        phase(f"hist_wide {label}", **check_hist(
            torch, H, "hist_wide", label, n, f, b, k, m, timed=True,
            seed=10 + i, root=label.endswith("root")))
    # the row-order kernel at its shapes (launches here are not counted)
    for i, (label, (n, k, m, slots)) in enumerate(ORDER_SHAPES.items()):
        phase(f"node_order {label}", **check_order_shape(
            torch, H, n, k, m, slots, seed=30 + i))
    H.build_histogram_wide.launches = 0
    H.build_histogram_binloop.launches = 0
    H.node_order.launches = 0

    # the training path, with the counts read around exactly this run
    x, y, target, masks = train_table(TRAIN_ROWS)
    TS.tree_sum.launches = 0
    leaf_cap = LeafCapture(LS)
    with ts_cap, leaf_cap:
        ts_cap.path = leaf_cap.path = "training"
        train = train_path(torch, x, y, masks)
    ts_train = TS.tree_sum.launches
    records = train.pop("_records")
    k1_records = train.pop("_k1_records")
    split_records = train.pop("_split_records")
    phase("train", **train)
    # the split search at the training path's own calls (relaunches are not
    # counted)
    split_weights = {"xgb": XGB_GRID[0]["num_round"],
                     "rf": RF_GRID[0]["num_trees"]}
    split_train = check_split_launches(torch, H, split_records, split_weights,
                                       timed_every=MAIN_TIMED_EVERY)
    del split_records
    H.split_search.launches = 0
    phase("split_search main_path", **split_train)
    ts_sums["training"] = check_tree_sum_path(torch, TS, ts_cap.records,
                                              "training")
    TS.tree_sum.launches = 0
    phase("tree_sum main_path training", **ts_sums["training"])
    # K2 at the training path's own launches (relaunches are not counted)
    k2 = check_main_launches(torch, H, "hist_binloop", records, weights={
        "xgb": XGB_GRID[0]["num_round"], "rf": RF_GRID[0]["num_trees"]},
        timed_every=MAIN_TIMED_EVERY)
    del records
    phase("hist_binloop main_path", **k2)

    # the regression path at a 256-bin sketch, its counts read around it
    TS.tree_sum.launches = 0
    with ts_cap, leaf_cap:
        ts_cap.path = leaf_cap.path = "regression training"
        reg = train_regression_path(torch, x, target, masks)
    ts_reg = TS.tree_sum.launches
    TS.tree_sum.launches = 0
    if not (ts_train and ts_reg):
        raise AssertionError(f"scoring the fitted lanes launched tree_sum "
                             f"{ts_train} and {ts_reg} times")
    split_records = reg.pop("_split_records")
    reg_weights = {"gbt": GBT_GRID[0]["max_iter"],
                   "rfr": RFR_GRID[0]["num_trees"]}
    split_reg = check_split_launches(torch, H, split_records, reg_weights,
                                     timed_every=MAIN_TIMED_EVERY)
    del split_records
    H.split_search.launches = 0
    phase("split_search main_path regression", **split_reg)
    # the leaf sums at both training paths' own calls
    leaf_main = check_leaf_path(torch, H, LS, leaf_cap.records)
    LS.leaf_sum.launches = 0
    phase("leaf_sum main_path", **leaf_main)
    records = reg.pop("_records")
    records_k2 = reg.pop("_records_k2")
    k1_records_reg = reg.pop("_k1_records")
    phase("train_regression", **reg)
    ts_sums["regression training"] = check_tree_sum_path(
        torch, TS, ts_cap.records, "regression training")
    TS.tree_sum.launches = 0
    phase("tree_sum main_path regression training",
          **ts_sums["regression training"])
    # K1 at both training paths' own launches (relaunches are not counted)
    k1_train = check_k1_launches(torch, ST, k1_records)
    phase("serve_trees main_path training", **k1_train)
    k1_reg = check_k1_launches(torch, ST, k1_records_reg)
    phase("serve_trees main_path regression training", **k1_reg)
    del k1_records, k1_records_reg
    ST.serve_trees.launches = 0
    # K3 and K2 at the regression path's own launches (relaunches are not
    # counted); K2's 2-bin launches there are held against the CPU's plain
    # version at the classifiers' launches and through the fixtures
    k3 = check_main_launches(torch, H, "hist_wide", records, reg_weights,
                             library_per_tree=True,
                             timed_every=MAIN_TIMED_EVERY)
    del records
    phase("hist_wide main_path", **k3)
    k2r = check_main_launches(torch, H, "hist_binloop", records_k2,
                              reg_weights, library_per_tree=True,
                              cpu_check=False, timed_every=MAIN_TIMED_EVERY)
    del records_k2
    phase("hist_binloop main_path regression", **k2r)
    k2_weights = {"training": k2["estimated_path_launches"],
                  "regression training": k2r["estimated_path_launches"]}
    k2_paths = combine_paths({"training": k2, "regression training": k2r},
                             k2_weights)
    phase("hist_binloop main_path both", **k2_paths)
    phase("train_fixture", **check_train_fixture(torch))
    phase("gbt_depth12 against the cpu",
          **check_gbt_depth12_cpu(torch, x, target, masks))
    LS.leaf_sum.launches = 0
    # the tree sum over the three paths, weighted by their launches
    ts_counts = {"serving": ts_launches, "training": ts_train,
                 "regression training": ts_reg}
    ts_all = combine_paths(ts_sums, ts_counts,
                           keys=("ms", "device_ms", "plain_ms", "library_ms",
                                 "bound_ms"))
    phase("tree_sum main_path", **{k: v for k, v in ts_all.items()},
          launches_by_path=ts_counts)
    # the GLM slice: both families' sweeps on the card
    phase("glm_train", **glm_train_path(torch, x, y, target, masks))
    phase("where_time_goes train", **where_time_goes_train(
        torch, "XGBoost grid 10 rounds + RF depth-12 group 5 trees", [
            (G.XGBoostClassifier, x, y, masks,
             [dict(p, num_round=10) for p in XGB_GRID]),
            (G.RandomForestClassifier, x, y, masks,
             [dict(p, num_trees=5) for p in RF_GRID if p["max_depth"] == 12]),
        ]))
    phase("where_time_goes train_regression", **where_time_goes_train(
        torch, "GBT depth-12 group 5 rounds + RF depth-12 group 5 trees, "
        f"{REG_BINS} bins", [
            (G.GBTRegressor, x, target, masks,
             [dict(p, max_iter=5) for p in GBT_GRID if p["max_depth"] == 12]),
            (G.RandomForestRegressor, x, target, masks,
             [dict(p, num_trees=5) for p in RFR_GRID if p["max_depth"] == 12]),
        ]))
    H.build_histogram_binloop.launches = 0
    H.build_histogram_wide.launches = 0
    H.split_search.launches = 0
    LS.leaf_sum.launches = 0
    ST.serve_trees.launches = 0

    records = {name: run(torch, smi, M) for name, run in PHASES.items()}
    fit_launches = records["fit_side"]["launches"]
    train_runs = {label: run for rec in records.values()
                  for label, run in rec.get("train_runs", {}).items()}
    train_launches = {k: {path: run["launches"][k] for path, run in train_runs.items()}
                      for k in M.counters}
    fused = records["fused_serving"]
    all_types_scoring = train_runs["train_all_types"]["score_launches"]
    dsl_scoring = train_runs["train_dsl"]["score_launches"]
    dsl_fused_launches = train_runs["train_dsl"]["fused"]["launches"]
    mc_fused = train_runs["train_multiclass"]["fused_launches"]
    mc_kernels = records["multiclass"]["kernels"]
    plane = records["featurize_plane"]
    hardening = records["serving_hardening"]
    plane_run = records["serving_plane"]
    insights_run = records["insights"]

    phase("wall", seconds=time.perf_counter() - t_start,
          profiler_missed_activities=device_ms.missed_activities,
          profiler_sessions_retaken=device_ms.empty_sessions,
          device_ms_event_fallbacks=device_ms.event_fallbacks,
          fused_transfers_without_profiler=fused_transfers.profiler_empty)

    k1_weights = {"serving": launches, "training": k1_train["launches"],
                  "regression training": k1_reg["launches"]}
    k1_paths = combine_paths(
        {"serving": main, "training": k1_train, "regression training": k1_reg},
        k1_weights, keys=("packed_ms", "packed_device_ms", "kernel_ms",
                          "plain_ms", "bound_ms"), ms_key="packed_ms")

    orders = combine_paths(
        {"training": k2["node_order"], "regression training": k2r["node_order"]},
        k2_weights, keys=("ms", "plain_ms", "library_ms", "bound_ms"))
    split_paths = combine_paths(
        {"training": split_train, "regression training": split_reg},
        {"training": train["split_search_launches"],
         "regression training": reg["split_search_launches"]},
        keys=("ms", "plain_ms", "bound_ms"))
    print(json.dumps({"kernels": [{
        "name": "tree_sum",
        "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/tree_sum.cu",
        "replaces": None,
        "path": "the per-row tree-order sum after K1; it replaces no TPU "
                "kernel (the reference adds the trees on the host, "
                "native/tptpu_native.cpp tp_tree_predict_sum, and on its "
                "device route in XLA); times over the captured calls of "
                "serving and both training paths' lane scoring, weighted by "
                "launches; ms on CUDA-event groups, device_ms the "
                "profiler's; library = one torch.sum(dim=1)",
        "launches": ts_launches,
        "launches_by_path": {**ts_counts,
                             "fit_side to_train": fit_launches["tree_sum"],
                             **train_launches["tree_sum"],
                             "serving_hardening":
                                 hardening["launches"]["tree_sum"],
                             "serving_plane":
                                 plane_run["launches"]["tree_sum"],
                             "insights": insights_run["launches"]["tree_sum"]},
        "max_abs_err": ts_all["max_abs_err"],
        "ms": ts_all["ms"],
        "ms_by_path": ts_all["ms_by_path"],
        "device_ms": ts_all["device_ms"],
        "plain_ms": ts_all["plain_ms"],
        "bound_ms": ts_all["bound_ms"],
        "bound_by": ts_all["bound_by"],
        "library_ms": ts_all["library_ms"],
        "device_ms_sources": {
            k: sum(p["device_ms_sources"][k] for p in ts_sums.values())
            for k in ("profiler", "cuda_events")},
        "against_library": {label: p["verdict"]
                            for label, p in ts_paired.items()},
    }, {
        "name": "tree_sum_device_route",
        "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/tree_sum.cu",
        "replaces": None,
        "path": "the tree sum's second mode, the reference's device-route "
                "order for batches above 16384 rows (XLA's windowed "
                "reduction of its one-hot leaf select, "
                "transmogrifai_tpu/models/trees.py predict_boosted_raw / "
                "predict_forest_raw); it replaces no TPU kernel; times over "
                "the captured calls of the device-route serving phase, "
                "weighted by launches; ms on CUDA-event groups, device_ms "
                "the profiler's; library = one torch.sum(dim=1), the same "
                "function in another order",
        "launches": route["route_launches"],
        "launches_by_path": {
            "serving_device_route": route["route_launches"],
            "fused_serving": fused["launches"]["tree_sum_device_route"],
            "train_all_types scoring": all_types_scoring[
                "tree_sum_device_route"],
            "train_dsl scoring": dsl_scoring["tree_sum_device_route"],
            "train_dsl fused": dsl_fused_launches["tree_sum_device_route"],
            "train_multiclass fused": mc_fused["tree_sum_device_route"],
            "featurize_plane fused": plane["fused"]["launches"][
                "tree_sum_device_route"],
            "serving_hardening": hardening["launches"][
                "tree_sum_device_route"],
            "serving_plane": plane_run["launches"][
                "tree_sum_device_route"],
            "insights": insights_run["launches"]["tree_sum_device_route"],
            **{f"{path}": launches for path, launches in
               train_launches["tree_sum_device_route"].items()
               if path.startswith(("families", "text"))}},
        "max_abs_err": max(route_main["max_abs_err"],
                           max(r["max_abs_err"] for r in route_rows.values())),
        "ms": route_main["ms"],
        "device_ms": route_main["device_ms"],
        "device_ms_sources": route_main["device_ms_sources"],
        "plain_ms": route_main["plain_ms"],
        "bound_ms": route_main["bound_ms"],
        "bound_by": route_main["bound_by"],
        "library_ms": route_main["library_ms"],
        "library_device_ms": route_main["library_device_ms"],
        "device_ms_over_bound": route_main["device_ms_over_bound"],
        "against_library": {
            "main": route_main["paired"]["verdict"],
            **{label: r["paired"]["verdict"] for label, r in route_rows.items()
               if "paired" in r}},
        "shapes": {label: {k: r[k] for k in ("order", "ms", "device_ms",
                                             "plain_ms", "library_ms",
                                             "library_device_ms", "bound_ms",
                                             "device_ms_over_bound")}
                   for label, r in route_rows.items() if "ms" in r},
    }, {
        "name": "split_search",
        "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/split_search.cu",
        "replaces": "transmogrifai_tpu/models/hist_pallas.py:711",
        "path": "the split stage of K4 (hist_pallas.py _split_kernel, "
                "pallas_call at :711) over the histogram K2 or K3 wrote, on "
                "both training paths (the reference's two-phase split "
                "arithmetic, transmogrifai_tpu/models/trees.py:469-490); "
                "times over the calls captured on both paths' chosen trees, "
                "weighted by how often each tree recurs, device time from "
                "the profiler; library: none (no single PyTorch call)",
        "launches": train["split_search_launches"] + reg["split_search_launches"],
        "launches_by_path": {"training": train["split_search_launches"],
                             "regression training": reg["split_search_launches"],
                             "fit_side to_train": fit_launches["split_search"],
                             **train_launches["split_search"]},
        "launches_per_call": max(split_train["launches_per_call"],
                                 split_reg["launches_per_call"]),
        "max_abs_err": 0.0,
        "ms": split_paths["ms"],
        "ms_by_path": split_paths["ms_by_path"],
        "plain_ms": split_paths["plain_ms"],
        "bound_ms": split_paths["bound_ms"],
        "bound_by": split_paths["bound_by"],
        "ms_over_bound": split_paths["ms"] / split_paths["bound_ms"],
        "library_ms": None,
        "shapes": {label: {k: r[k] for k in ("ms", "plain_ms", "bound_ms")}
                   for label, r in split_rows.items() if "ms" in r},
        "multiclass_k96": multiclass_row(mc_kernels["split_search"],
                                         mc_kernels["K2_K"]),
    }, {
        "name": "leaf_sum",
        "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/leaf_sum.cu",
        "replaces": None,
        "path": "the grower's leaf sums past the reference's one-hot budget "
                "(transmogrifai_tpu/models/trees.py _segment_sum_small's "
                "scatter-add form, which XLA applies in row order); it "
                "replaces no TPU kernel; ms with the row order made in the "
                "call, over the captured calls of both training paths, "
                "weighted by calls; library = one index_put_(accumulate="
                "True) of both arrays",
        "launches": train["leaf_sum_launches"] + reg["leaf_sum_launches"],
        "launches_by_path": {"training": train["leaf_sum_launches"],
                             "regression training": reg["leaf_sum_launches"],
                             **train_launches["leaf_sum"]},
        "max_abs_err": 0.0,
        "ms": leaf_main["ms"],
        "kernel_only_ms": leaf_main["kernel_only_ms"],
        "plain_ms": leaf_main["plain_ms"],
        "bound_ms": leaf_main["bound_ms"],
        "bound_by": leaf_main["bound_by"],
        "library_ms": leaf_main["library_ms"],
        "shapes": {label: {k: r[k] for k in ("ms", "kernel_only_ms",
                                             "plain_ms", "library_ms",
                                             "bound_ms")}
                   for label, r in leaf_rows.items() if "ms" in r},
        "multiclass_k96": multiclass_row(mc_kernels["leaf_sum"],
                                         mc_kernels["K2_K"]),
    }, {
        "name": "serve_trees",
        "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/serve_trees.cu",
        "replaces": "transmogrifai_tpu/models/serve_pallas.py:146",
        "path": "times over the models' packed stacks (serve_trees_packed), "
                "weighted by launches over serving and both training paths' "
                "lane scoring; ms on CUDA-event groups, device_ms the "
                "profiler's",
        "launches": launches,
        "launches_by_path": {**k1_weights,
                             "fit_side to_train": fit_launches["serve_trees"],
                             **train_launches["serve_trees"],
                             "fused_serving": fused["launches"]["serve_trees"],
                             "train_all_types scoring":
                                 all_types_scoring["serve_trees"],
                             "train_dsl scoring": dsl_scoring["serve_trees"],
                             "train_dsl fused":
                                 dsl_fused_launches["serve_trees"],
                             "train_multiclass fused": mc_fused["serve_trees"],
                             "featurize_plane fused":
                                 plane["fused"]["launches"]["serve_trees"],
                             "serving_hardening":
                                 hardening["launches"]["serve_trees"],
                             "serving_plane":
                                 plane_run["launches"]["serve_trees"],
                             "insights":
                                 insights_run["launches"]["serve_trees"]},
        "max_abs_err": max(main["max_abs_err"], k1_train["max_abs_err"],
                           k1_reg["max_abs_err"]),
        "ms": k1_paths["packed_ms"],
        "ms_by_path": k1_paths["ms_by_path"],
        "device_ms": k1_paths["packed_device_ms"],
        "per_call_ms": k1_paths["kernel_ms"],
        "plain_ms": k1_paths["plain_ms"],
        "bound_ms": k1_paths["bound_ms"],
        "bound_by": k1_paths["bound_by"],
        "library_ms": None,
    }, {
        "name": "hist_binloop",
        "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/hist_binloop.cu",
        "replaces": "transmogrifai_tpu/models/hist_pallas.py:427",
        "launches": train["hist_binloop_launches"] + reg["hist_binloop_launches"],
        "launches_by_path": {"training": train["hist_binloop_launches"],
                             "regression training": reg["hist_binloop_launches"],
                             "fit_side to_train": fit_launches["hist_binloop"],
                             **train_launches["hist_binloop"]},
        "max_abs_err": k2_paths["max_abs_err"],
        "ms": k2_paths["ms"],
        "ms_by_path": k2_paths["ms_by_path"],
        "order_ms": k2_paths["order_ms"],
        "kernel_only_ms": k2_paths["kernel_only_ms"],
        "plain_ms": k2_paths["plain_ms"],
        "bound_ms": k2_paths["bound_ms"],
        "bound_by": k2_paths["bound_by"],
        "library_ms": k2_paths["library_ms"],
        "multiclass_k96": multiclass_row(mc_kernels["hist_binloop"],
                                         mc_kernels["K2_K"]),
    }, {
        "name": "hist_wide",
        "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/hist_wide.cu",
        "replaces": "transmogrifai_tpu/models/hist_pallas.py:244",
        "launches": reg["hist_wide_launches"],
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"],
        "order_ms": k3["order_ms"],
        "kernel_only_ms": k3["kernel_only_ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],
        "launches_by_path": {"regression training": reg["hist_wide_launches"],
                             **train_launches["hist_wide"]},
        "multiclass_k54": multiclass_row(mc_kernels["hist_wide"],
                                         mc_kernels["K3_K"]),
    }, {
        "name": "node_order",
        "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/node_order.cu",
        "replaces": None,
        "path": "the row order of K2 and K3; it replaces no TPU kernel (the "
                "reference's hist_pallas.py:427 and :244 one-hot every row "
                "instead); times at K2's captured launches of both paths, "
                "library = one stable torch.sort of the slots",
        "launches": train["node_order_launches"] + reg["node_order_launches"],
        "launches_by_path": {"training": train["node_order_launches"],
                             "regression training": reg["node_order_launches"],
                             "fit_side to_train": fit_launches["node_order"],
                             **train_launches["node_order"]},
        "max_abs_err": orders["max_abs_err"],
        "ms": orders["ms"],
        "ms_sources": {
            k: k2["node_order"]["ms_sources"][k] + k2r["node_order"]["ms_sources"][k]
            for k in ("profiler", "cuda_events")},
        "plain_ms": orders["plain_ms"],
        "bound_ms": orders["bound_ms"],
        "bound_by": "bytes",
        "library_ms": orders["library_ms"],
        "multiclass_k96": multiclass_row(mc_kernels["hist_binloop"]["node_order"],
                                         mc_kernels["K2_K"]),
    }, {
        "name": "best_split",
        "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/best_split.cu",
        "replaces": "transmogrifai_tpu/models/hist_pallas.py:711",
        "path": "the fused form is on no path of the reference "
                "(models/trees.py:333, :355-361): launches and times are its "
                "own phases', times at (a) with its row order; its split "
                "stage (split_stage.cuh) runs on both training paths as the "
                "split_search kernel (split_stage_launches); two_phase_ms: "
                "the row order, K2 or K3 and the split-search kernel on the "
                "same inputs",
        "launches": k4_launches,
        "split_stage_launches": train["split_search_launches"]
        + reg["split_search_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in k4.values()),
        "ms": k4["a_narrow"]["ms"],
        "two_phase_ms": k4["a_narrow"]["two_phase_ms"],
        "plain_ms": k4["a_narrow"]["plain_ms"],
        "bound_ms": k4["a_narrow"]["bound_ms"],
        "bound_by": k4["a_narrow"]["bound_by"],
        "library_ms": None,
        "shapes": {label: {k: r[k] for k in ("ms", "two_phase_ms",
                                             "plain_ms", "bound_ms")}
                   for label, r in k4.items()},
    }]}), flush=True)
    print_device(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
