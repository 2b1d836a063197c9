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

Kernel K4, the fused split search, is on no path of the reference (its
policy never takes it); it is held against the two-phase split search it
fuses at the reference's fused-route shapes.

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
#: leaf values and outputs against the JAX package's stored fit: f32 sums
#: in the same order, held to a few ulps of values of order 1
FIXTURE_TOL = 1e-5


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


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
PROFILE_TRIES = 3


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
    growing pause. After ``PROFILE_TRIES`` such sessions the reading is
    taken with CUDA events (``time_ms``, which holds any host gaps) and
    reported in a ``device_ms fallback`` phase of its own: a dropped
    capture is never returned as a reading."""
    from torch.profiler import ProfilerActivity, profile

    fn(*arg_sets[0])
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
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
            return per_call / 1e3
        device_ms.empty_sessions += 1
    ms = time_ms(torch, fn, arg_sets, reps=calls, rounds=3)
    device_ms.event_fallbacks += 1
    device_ms.last_source = "cuda_events"
    phase("device_ms fallback", fn=getattr(fn, "__name__", str(fn)),
          empty_sessions=PROFILE_TRIES, event_ms=ms)
    return ms


#: activities the sessions of ``device_ms`` missed (of the launches their
#: calls made), sessions it took again, and readings it took with CUDA
#: events after ``PROFILE_TRIES`` of them
device_ms.missed_activities = 0
device_ms.empty_sessions = 0
device_ms.event_fallbacks = 0
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
MUST_PAIRS = 16
#: one-sided sign-test level at which a side is called faster
SIGN_LEVEL = 0.05


class ClockSampler:
    """The card's SM clock, sampled every ``period_ms`` by ``nvidia-smi``
    (a process of its own, stopped when the block ends) while a comparison
    runs; ``between`` gives the samples taken inside a span of wall time.
    Samples are diagnostics: where ``nvidia-smi`` gives none, readings
    carry no clock."""

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
                ["nvidia-smi", "--query-gpu=timestamp,clocks.sm",
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
ROUTE_SHAPES = {
    "a_depth6": (20000, 200, 2, True),
    "b_depth10": (65536, 200, 32, True),
    "c_ragged_one_window": (16385, 7, 1, False),
    "d_ragged": (16385, 7, 2, True),
    "e_many_trees": (1001, 1100, 4, False),
    "f_depth12": (4099, 50, 128, True),
}
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


def check_tree_sum_route(torch, TS, name, per_tree, win, h, boosted, eta,
                         base, timed: bool) -> dict:
    """The device-route mode against its plain version on the same card
    tensors and on CPU copies, bit for bit; with ``timed``, its times as
    ``check_tree_sum`` takes them (the library call: one
    ``torch.sum(dim=1)``, the same function in another order)."""
    got = TS.tree_sum_device_route(per_tree, win, h, boosted, eta, base)
    want = TS.tree_sum_device_route_plain(per_tree, win, h, boosted, eta, base)
    cpu = TS.tree_sum_device_route_plain(
        per_tree.cpu(), None if win is None else win.cpu(), h, boosted, eta,
        base)
    torch.cuda.synchronize()
    if not (same_values(torch, got, want) and same_values(torch, got.cpu(), cpu)):
        bad = int((got != want).sum().item())
        raise AssertionError(f"tree_sum_device_route {name}: kernel != plain "
                             f"version ({bad} rows)")
    n, t = per_tree.shape
    out = {"shape": {"N": n, "T": t, "H": h}, "boosted": bool(boosted),
           "max_abs_err": float((got - want).nan_to_num().abs().max().item())
           if n else 0.0, "bit_identical": True}
    if timed:
        bound, by = route_bound_ms(n, t, h)
        args = [per_tree] if win is None else [per_tree, win]
        cold = l2_cold_copies(args, sum(a.numel() for a in args) * 4)

        def kernel(pt, w=None):
            return TS.tree_sum_device_route(pt, w, h, boosted, eta, base)

        def plain(pt, w=None):
            return TS.tree_sum_device_route_plain(pt, w, h, boosted, eta, base)

        def library(pt, w=None):
            return torch.sum(pt, dim=1)

        out.update(compare_device_ms(torch, kernel, library, cold))
        out.update({
            "plain_ms": time_ms(torch, plain, cold, reps=2, rounds=3),
            "bound_ms": bound, "bound_by": by, "arg_copies": len(cold),
        })
        del cold
    return out


class RouteCapture:
    """Records the first device-route tree sum of every (N, T, H, boosted)
    group that the predictors make (through ``serve_trees``'s name for
    it), with how many calls each group makes. It adds no launch."""

    def __init__(self, ST):
        self.ST = ST
        self.real = ST.tree_sum_device_route
        self.records: dict[tuple, dict] = {}

    def __enter__(self):
        def hook(per_tree, leaf_window, num_windows, boosted, eta=0.0,
                 base_score=0.0):
            key = (per_tree.shape[0], per_tree.shape[1], num_windows,
                   bool(boosted))
            rec = self.records.get(key)
            if rec is None:
                self.records[key] = {
                    "per_tree": per_tree.clone(),
                    "win": None if leaf_window is None else leaf_window.clone(),
                    "eta": eta, "base": base_score, "count": 1}
            else:
                rec["count"] += 1
            return self.real(per_tree, leaf_window, num_windows, boosted, eta,
                             base_score)

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


def check_route_path(torch, TS, records: dict) -> dict:
    """Each device-route sum captured on the serving path relaunched
    against the plain version and timed; the means weighted by each
    group's calls."""
    rows = []
    for (n, t, h, boosted), rec in records.items():
        rows.append({"weight": rec["count"], **check_tree_sum_route(
            torch, TS, f"serving N={n} T={t} H={h}", rec["per_tree"],
            rec["win"], h, boosted, rec["eta"], rec["base"], timed=True)})
    if not rows:
        raise AssertionError("no device-route sum of the serving path was "
                             "captured")
    total = sum(r["weight"] for r in rows)
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
            "bound_ms")
    return {
        "basis": "mean per launch, each captured call weighted by the calls "
                 "of its (N, T, H, boosted) group",
        "launches": total,
        "device_ms_sources": source_counts(rows),
        **{k: sum(r["weight"] * r[k] for r in rows) / total for k in keys},
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
        if not t or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        total += t / 1e3
        name = evt.key.lower()
        key = ("upload" if "htod" in name else "download" if "dtoh" in name
               else "K1 serve_trees" if "serve_trees" in name
               else "tree_sum" if "tree_sum" in name else None)
        if key:
            ms[key] += t / 1e3
    ms["bin_data"] = sum(e.device_time_total for e in prof.events()
                         if e.name == "predictor.bin_data") / 1e3
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


def check_node_order(torch, H, node, g, h, m) -> dict:
    """The row-order kernel (``node_order``) on card tensors against its
    plain version on the same tensors and on the CPU: order, start and count
    equal element for element, and a relaunch equal too; then timed with
    the inputs out of L2 against the plain version, one stable
    ``torch.sort`` of the slots (the library call: it gives the order, not
    the runs) and the bound."""
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


def check_main_launches(torch, H, kernel, records, weights: dict,
                        library_per_tree: bool = False,
                        cpu_check: bool = True) -> dict:
    """Each captured main-path launch of a histogram kernel held against
    its plain version (``hist_accuracy``: the relaunch must equal the main
    path's own histogram bit for bit; the first launch of each tree also
    against the CPU's plain version) and timed (``hist_times``). The
    summary weighs each launch by how often its tree recurs on the path
    (``weights``: rounds for boosting, trees per group for a forest), which
    estimates the mean launch of the whole path. With ``library_per_tree``
    the GEMM pair is timed at the first launch of each tree only, and the
    library mean is taken over those; without ``cpu_check`` no launch is
    held against the CPU's plain version."""
    rows, seen = [], set()
    for rec in records:
        args, m, b = rec["args"], rec["m"], rec["b"]
        binned, node, g, h = args
        counts = H.node_order(node, m, g, h)[2]
        name = f"{rec['tree']} level {rec['level']} B={b}"
        first = rec["tree"] not in seen
        row = {
            "tree": rec["tree"], "level": rec["level"],
            "N": binned.shape[0], "F": binned.shape[1], "B": b,
            "K": node.shape[0], "M": m,
            "slotted_rows": int(((node >= 0) & (node < m)).sum()),
            "live_rows": int(counts.sum()),
            "longest_slot_run": int(counts.max()),
            **hist_accuracy(torch, H, kernel, name, args, m, b, rec["out"],
                            cpu_check=first and cpu_check),
            **hist_times(torch, H, kernel, args, m, b, reps=3,
                         library=first or not library_per_tree),
            "node_order": check_node_order(torch, H, node, g, h, m),
        }
        seen.add(rec["tree"])
        row["weight"] = weights[rec["family"]]
        rows.append(row)
        rec["out"] = None
    if not rows:
        raise AssertionError(f"no {kernel} launch of the training path was "
                             "captured")

    def mean(key, subset=rows):
        return (sum(r["weight"] * r[key] for r in subset)
                / sum(r["weight"] for r in subset))

    by_bytes, by_ops = (
        sum(r["weight"] * r["bound_ms"] for r in rows if r["bound_by"] == by)
        for by in ("bytes", "operations")
    )
    return {
        "basis": "mean per launch, each launch weighted by how often its "
                 "tree recurs on the path",
        "weights": weights, "captured_launches": len(rows),
        "estimated_path_launches": sum(r["weight"] for r in rows),
        "ms": mean("kernel_ms"), "wrapper_ms": mean("wrapper_ms"),
        "kernel_only_ms": mean("kernel_only_ms"), "order_ms": mean("order_ms"),
        "plain_ms": mean("plain_ms"),
        "library_ms": mean("library_ms", [r for r in rows
                                          if r["library_ms"] is not None]),
        "library_basis": ("first launch of each tree" if library_per_tree
                          else "every captured launch"),
        "bound_ms": mean("bound_ms"),
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_err_over_tol": max(r["max_err_over_tol"] for r in rows),
        "node_order": {
            **{key: mean(key, [r["node_order"] | {"weight": r["weight"]}
                               for r in rows])
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
            "max_abs_err": max(r["node_order"]["max_abs_err"] for r in rows),
            "ms_sources": source_counts([r["node_order"] for r in rows]),
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
    the card: identical split arrays, leaves and outputs within
    ``FIXTURE_TOL``."""
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
        leaf_err = float(np.nanmax(np.abs(trees.leaf_value - want["leaf_value"])))
        out_err = float(np.abs(stack["outputs"] - want["outputs"]).max())
        if not same:
            bad = int(((trees.split_feat != want["split_feat"])
                       | (trees.split_bin != want["split_bin"])).sum())
            raise AssertionError(f"train_fixture {name}: {bad} split entries "
                                 "differ from the JAX package's")
        nan_ok = np.array_equal(np.isnan(trees.leaf_value),
                                np.isnan(want["leaf_value"]))
        if not (nan_ok and leaf_err <= FIXTURE_TOL and out_err <= FIXTURE_TOL):
            raise AssertionError(
                f"train_fixture {name}: leaf err {leaf_err}, output err "
                f"{out_err} > {FIXTURE_TOL}"
            )
        out[name] = {"splits_identical": True, "leaf_max_abs_err": leaf_err,
                     "output_max_abs_err": out_err,
                     "max_bins": points[name]["max_bins"],
                     "hist_wide_launches": k3}
    return out


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
    label, masks, grid): run once unprofiled for its wall time and once
    under ``torch.profiler`` for device time by kernel group (the
    profiler's own host tracing stretches that run's wall clock, so the
    busy share is taken against the unprofiled wall), with its host syncs,
    its histogram kernels' launches and the host seconds spent drawing
    bagging masks."""
    from torch.profiler import ProfilerActivity, profile

    from transmogrifai_tpu_torch.models import hist as H
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
                "node_order": H.node_order.launches}

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
                OrderAudit(H) as audit:
            window()
        wall = time.perf_counter() - s
        syncs = TR.host_syncs - syncs
        launches = {k: v - launches[k] for k, v in counts().items()}
    finally:
        TR._bag_masks = real_bag
    groups = {"K2 hist_binloop": ("hist_binloop",),
              "K3 hist_wide": ("hist_wide",),
              "row order for K2/K3 (node_order)": ("node_order",),
              "GEMM": ("gemm", "matmul", "cutlass"),
              "leaf sums / compaction (index_put, gather)": ("index", "gather", "scatter")}
    # the kernels a row order made of torch calls (a sort, a scatter_add
    # of counts, a cumsum) would be found by, by name; the keys also catch
    # every other sort, scan or scatter_add of the window
    name_keys = ("node_order", "sort", "radix", "scan", "scatter_add")
    name_keys_ms = 0.0
    dev_ms = {g: 0.0 for g in groups}
    dev_ms["elementwise and reductions (split search, routing)"] = 0.0
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
            dev_ms["elementwise and reductions (split search, routing)"] += t
    out = {
        "window": title,
        "wall_s": plain_wall, "wall_s_profiled": wall,
        "device_ms": dev_ms if total else "not measured",
        "device_busy_share": (total / 1e3 / plain_wall) if total else "not measured",
        "row_order_by_name_keys_ms": name_keys_ms if total else "not measured",
        "host_syncs": syncs, "bagging_draw_s": bag_s[0],
    }
    if audit.faults or audit.orders != launches["node_order"]:
        raise AssertionError(f"{title}: row order not shared per chunk: "
                             f"{sorted(set(audit.faults))}")
    out["node_order_launches"] = launches["node_order"]
    out["histograms_per_node_order"] = audit.hists / max(audit.orders, 1)
    for kernel, group in (("hist_binloop", "K2 hist_binloop"),
                          ("hist_wide", "K3 hist_wide")):
        out[f"{kernel}_launches"] = launches[kernel]
        out[f"{kernel}_ms_per_launch"] = (
            dev_ms[group] / launches[kernel]
            if total and launches[kernel] else "not measured")
    return out


def train_path(torch, x, y, masks) -> dict:
    """The training main path, with K2's and K1's counts read around it and
    K2's launches on some of its trees captured (``KernelCapture``)."""
    from transmogrifai_tpu_torch.models import gbdt as G
    from transmogrifai_tpu_torch.models import hist as H
    from transmogrifai_tpu_torch.models import serve_trees as ST
    from transmogrifai_tpu_torch.models import trees as TR

    H.build_histogram_binloop.launches = 0
    H.node_order.launches = 0
    ST.serve_trees.launches = 0
    with KernelCapture(H, TR, "hist_binloop",
                       {"xgb": XGB_GRID[0]["num_round"] // 2, "rf": 0}) as cap:
        cap.start("xgb")
        xgb, xgb_s, xgb_syncs = fit_family(
            torch, G.XGBoostClassifier(device=DEV), x, y, masks, XGB_GRID)
        k2_xgb = H.build_histogram_binloop.launches
        cap.start("rf")
        rf, rf_s, rf_syncs = fit_family(
            torch, G.RandomForestClassifier(device=DEV), x, y, masks, RF_GRID)
    orders = H.node_order.launches
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
        "serve_trees_launches_scoring": k1,
        "refit_bit_identical": True,
        "_records": cap.records, "_k1_records": k1cap.records,
    }


class OrderAudit:
    """Follows the grower's calls of ``node_order`` and of the histogram
    wrappers in order: every histogram must be given the row order of the
    last ``node_order`` call, made over the same slot tensor, and every
    ``node_order`` call must serve at least one histogram. It adds no
    launch (each hook calls its wrapper once and keeps its count)."""

    NAMES = ("node_order", *HIST_WRAPPERS.values())

    def __init__(self, H):
        self.H = H
        self.real = {name: getattr(H, name) for name in self.NAMES}
        self.orders = self.hists = 0
        self.faults: list[str] = []
        self._last = None  # (slot tensor, histograms served)

    def _order_hook(self):
        def hook(node, m, g, h):
            self._close()
            self.orders += 1
            out = self.real["node_order"](node, m, g, h)
            self._last = [node, out, 0]
            return out
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
        return self

    def __exit__(self, *exc):
        self._close()
        for name, real in self.real.items():
            real.launches = getattr(self.H, name).launches
            setattr(self.H, name, real)
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
    K3's and K2's launches on the middle GBT round and the first forest
    tree of each depth group captured (``KernelCapture``)."""
    from transmogrifai_tpu_torch.models import gbdt as G
    from transmogrifai_tpu_torch.models import hist as H
    from transmogrifai_tpu_torch.models import serve_trees as ST
    from transmogrifai_tpu_torch.models import trees as TR

    H.build_histogram_wide.launches = 0
    H.build_histogram_binloop.launches = 0
    H.node_order.launches = 0
    ST.serve_trees.launches = 0
    out, fitted = {}, {}
    trees = {"gbt": GBT_GRID[0]["max_iter"] // 2, "rfr": 0}
    with KernelCapture(H, TR, "hist_wide", trees) as cap, \
            KernelCapture(H, TR, "hist_binloop", trees) as cap2:
        for family, cls, grid in (("gbt", G.GBTRegressor, GBT_GRID),
                                  ("rfr", G.RandomForestRegressor, RFR_GRID)):
            cap.start(family)
            cap2.start(family)
            k3 = H.build_histogram_wide.launches
            k2 = H.build_histogram_binloop.launches
            models, secs, syncs = fit_family(torch, cls(device=DEV), x, target,
                                             masks, grid)
            k3 = H.build_histogram_wide.launches - k3
            k2 = H.build_histogram_binloop.launches - k2
            if k3 == 0 or k2 == 0:
                raise AssertionError(
                    f"{family}: the wide group took {k3} hist_wide launches, "
                    f"the indicators {k2} hist_binloop launches; both must run")
            fitted[family] = models
            out[family] = {"lanes": len(grid) * len(masks),
                           "groups": len(stacks_of(models)), "seconds": secs,
                           "host_syncs": syncs, "hist_wide_launches": k3,
                           "hist_binloop_launches": k2}
    k3 = H.build_histogram_wide.launches
    k2 = H.build_histogram_binloop.launches
    orders = H.node_order.launches
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
        "node_order_launches": orders,
        "serve_trees_launches_scoring": k1, "refit_bit_identical": True,
        "_records": cap.records, "_records_k2": cap2.records,
        "_k1_records": k1cap.records,
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
    the same inputs: the same (feature, bin) everywhere, the gains bit for
    bit (or, where not, within 1e-6 relative and reported), and a relaunch
    bit-identical; timed against the card's two-phase route (the histogram
    the policy picks for N rows, then ``split_search``)."""
    cpu = best_split_inputs(n, f, b, k, m, seed)
    args = [a.to(DEV) for a in cpu]
    got = H.build_best_split(*args, m, b)
    again = H.build_best_split(*args, m, b)
    want = H.best_split_plain(*cpu, m, b)
    torch.cuda.synchronize()
    label = f"best_split {name}"
    if not all(torch.equal(p, q) for p, q in zip(got, again)):
        raise AssertionError(f"{label}: two launches differ")
    gain, feat, bin_ = (a.cpu() for a in got)
    if not (torch.equal(feat, want[1]) and torch.equal(bin_, want[2])):
        bad = int(((feat != want[1]) | (bin_ != want[2])).sum())
        raise AssertionError(f"{label}: {bad} (feature, bin) choices differ "
                             "from the plain version's")
    bits = torch.equal(gain, want[0])
    fin = torch.isfinite(want[0])
    err = (gain[fin].double() - want[0][fin].double()).abs()
    max_err = err.max().item() if err.numel() else 0.0
    if not bits and not (
        torch.equal(torch.isfinite(gain), fin)
        and bool((err <= 1e-6 * (want[0][fin].double().abs() + 1.0)).all())
    ):
        raise AssertionError(f"{label}: gains differ by {max_err}")
    binned, node, g, h, fmask, lam, gam, mcw = args
    route = H.histogram_route(binned.device, b)

    def fused(*a):
        return H.build_best_split(*a, m, b)

    def two_phase(binned, node, g, h, fmask, lam, gam, mcw):
        hist = hist_kernel(H, f"hist_{route}")(binned, node, g, h, m, b)
        return H.split_search(hist, fmask, lam, gam, mcw)

    bound, by = best_split_bound(torch, binned, node, g, h, m, b)
    return {
        "shape": {"N": n, "F": f, "B": b, "K": k, "M": m},
        "gain_bit_identical_to_cpu_plain": bits, "max_abs_err": max_err,
        "same_feat_bin_as_cpu_plain": True, "bit_identical_relaunch": True,
        "no_valid_split_slots": int((feat == -1).sum()),
        "kernel_ms": device_ms(torch, fused, [args]),
        "plain_ms": device_ms(torch, two_phase, [args], calls=4),
        "plain_route": f"{route} histogram + split_search",
        "bound_ms": bound, "bound_by": by, "library_ms": None,
    }


def start_on_card(torch, sources: list[str]) -> None:
    """Print the environment and the card's name and power limit, and
    build the kernels of ``sources`` (one nvcc each, all started together),
    printing ptxas's report."""
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
    t0 = time.perf_counter()
    built = cuda_build.build(sources)
    phase("build", seconds=time.perf_counter() - t0, per_source=built)
    for name, log in cuda_build.build_logs.items():
        print(f"nvcc {name}:\n{log.strip()}", flush=True)


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from transmogrifai_tpu_torch import load_workflow_model, score_function
    from transmogrifai_tpu_torch.models import gbdt as G
    from transmogrifai_tpu_torch.models import hist as H
    from transmogrifai_tpu_torch.models import serve_trees as ST
    from transmogrifai_tpu_torch.models import tree_sum as TS
    from transmogrifai_tpu_torch.models import trees as TR

    start_on_card(torch, ["serve_trees", "tree_sum", "node_order",
                          "hist_binloop", "hist_wide", "best_split"])

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
    for label, (n, t, h, boosted) in ROUTE_SHAPES.items():
        per_tree = torch.from_numpy(
            (rng.normal(size=(n, t)) * 10.0 ** rng.integers(-3, 2, (n, t)))
            .astype(np.float32)).to(DEV)
        win = (torch.from_numpy(rng.integers(0, h, (n, t)).astype(np.float32))
               .to(DEV) if h > 1 else None)
        route_rows[label] = check_tree_sum_route(
            torch, TS, label, per_tree, win, h, boosted, 0.02, 0.37,
            timed=label.startswith(("a", "b")))
        phase(f"tree_sum_device_route {label}", **route_rows[label])
        del per_tree, win

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
    route_main = check_route_path(torch, TS, route_records)
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
    with ts_cap:
        ts_cap.path = "training"
        train = train_path(torch, x, y, masks)
    ts_train = TS.tree_sum.launches
    records = train.pop("_records")
    k1_records = train.pop("_k1_records")
    phase("train", **train)
    ts_sums["training"] = check_tree_sum_path(torch, TS, ts_cap.records,
                                              "training")
    TS.tree_sum.launches = 0
    phase("tree_sum main_path training", **ts_sums["training"])
    # K2 at the training path's own launches (relaunches are not counted)
    k2 = check_main_launches(torch, H, "hist_binloop", records, weights={
        "xgb": XGB_GRID[0]["num_round"], "rf": RF_GRID[0]["num_trees"]})
    del records
    phase("hist_binloop main_path", **k2)

    # the regression path at a 256-bin sketch, its counts read around it
    TS.tree_sum.launches = 0
    with ts_cap:
        ts_cap.path = "regression training"
        reg = train_regression_path(torch, x, target, masks)
    ts_reg = TS.tree_sum.launches
    TS.tree_sum.launches = 0
    if not (ts_train and ts_reg):
        raise AssertionError(f"scoring the fitted lanes launched tree_sum "
                             f"{ts_train} and {ts_reg} times")
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
    reg_weights = {"gbt": GBT_GRID[0]["max_iter"],
                   "rfr": RFR_GRID[0]["num_trees"]}
    k3 = check_main_launches(torch, H, "hist_wide", records, reg_weights,
                             library_per_tree=True)
    del records
    phase("hist_wide main_path", **k3)
    k2r = check_main_launches(torch, H, "hist_binloop", records_k2,
                              reg_weights, library_per_tree=True,
                              cpu_check=False)
    del records_k2
    phase("hist_binloop main_path regression", **k2r)
    k2_weights = {"training": k2["estimated_path_launches"],
                  "regression training": k2r["estimated_path_launches"]}
    k2_paths = combine_paths({"training": k2, "regression training": k2r},
                             k2_weights)
    phase("hist_binloop main_path both", **k2_paths)
    phase("train_fixture", **check_train_fixture(torch))
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
    ST.serve_trees.launches = 0

    # kernel K4 at the reference's fused-route shapes: on no path, so its
    # launches are counted in these phases alone
    H.build_best_split.launches = 0
    k4 = {}
    for i, (label, (n, f, b, k, m)) in enumerate(K4_SHAPES.items()):
        k4[label] = check_best_split(torch, H, label, n, f, b, k, m,
                                     seed=3 if label.startswith("c") else 20 + i)
        phase(f"best_split {label}", **k4[label])
    k4_launches = H.build_best_split.launches
    H.build_best_split.launches = 0
    phase("wall", seconds=time.perf_counter() - t_start,
          profiler_missed_activities=device_ms.missed_activities,
          profiler_sessions_retaken=device_ms.empty_sessions,
          device_ms_event_fallbacks=device_ms.event_fallbacks)

    k1_weights = {"serving": launches, "training": k1_train["launches"],
                  "regression training": k1_reg["launches"]}
    k1_paths = combine_paths(
        {"serving": main, "training": k1_train, "regression training": k1_reg},
        k1_weights, keys=("packed_ms", "packed_device_ms", "kernel_ms",
                          "plain_ms", "bound_ms"), ms_key="packed_ms")

    orders = combine_paths(
        {"training": k2["node_order"], "regression training": k2r["node_order"]},
        k2_weights, keys=("ms", "plain_ms", "library_ms", "bound_ms"))
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
        "launches_by_path": ts_counts,
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
        "max_abs_err": max(route_main["max_abs_err"],
                           max(r["max_abs_err"] for r in route_rows.values())),
        "ms": route_main["ms"],
        "device_ms": route_main["device_ms"],
        "device_ms_sources": route_main["device_ms_sources"],
        "plain_ms": route_main["plain_ms"],
        "bound_ms": route_main["bound_ms"],
        "bound_by": route_main["bound_by"],
        "library_ms": route_main["library_ms"],
        "shapes": {label: {k: r[k] for k in ("ms", "device_ms", "plain_ms",
                                             "library_ms", "bound_ms")}
                   for label, r in route_rows.items() if "ms" in r},
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
        "launches_by_path": k1_weights,
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
                             "regression training": reg["hist_binloop_launches"]},
        "max_abs_err": k2_paths["max_abs_err"],
        "ms": k2_paths["ms"],
        "ms_by_path": k2_paths["ms_by_path"],
        "order_ms": k2_paths["order_ms"],
        "kernel_only_ms": k2_paths["kernel_only_ms"],
        "plain_ms": k2_paths["plain_ms"],
        "bound_ms": k2_paths["bound_ms"],
        "bound_by": k2_paths["bound_by"],
        "library_ms": k2_paths["library_ms"],
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
                             "regression training": reg["node_order_launches"]},
        "max_abs_err": orders["max_abs_err"],
        "ms": orders["ms"],
        "ms_sources": {
            k: k2["node_order"]["ms_sources"][k] + k2r["node_order"]["ms_sources"][k]
            for k in ("profiler", "cuda_events")},
        "plain_ms": orders["plain_ms"],
        "bound_ms": orders["bound_ms"],
        "bound_by": "bytes",
        "library_ms": orders["library_ms"],
    }, {
        "name": "best_split",
        "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/best_split.cu",
        "replaces": "transmogrifai_tpu/models/hist_pallas.py:711",
        "path": "on no path of the reference (models/trees.py:333, :355-361); "
                "launches and times are its own phases', times at (a)",
        "launches": k4_launches,
        "max_abs_err": max(r["max_abs_err"] for r in k4.values()),
        "ms": k4["a_narrow"]["kernel_ms"],
        "plain_ms": k4["a_narrow"]["plain_ms"],
        "bound_ms": k4["a_narrow"]["bound_ms"],
        "bound_by": k4["a_narrow"]["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
