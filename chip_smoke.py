#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Run from the repository root. It builds the port's CUDA kernels from
``transmogrifai_tpu_torch/csrc/`` into ``transmogrifai_tpu_torch/_build/``
(one ``nvcc`` per source, all started together), checks each kernel
against its plain PyTorch version on the card, then drives the port's two
paths:

* serving: the committed fixture models
  (``tests/fixtures/torch_serving/{xgb,rf}``, trained and saved by the JAX
  package) are loaded with ``load_workflow_model`` and answer requests
  through ``score_function`` on ``cuda``; their scores are held to the ones
  the JAX package stored. Kernel K1 (the traversal) walks the stacks the
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
  K2 and through the one-hot GEMM pair over the same launches.

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

import json
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
#: probability tolerance against the JAX package's stored scores: f32 sums
#: of up to 200 per-tree values taken in another order (see
#: tests/test_torch_scoring.py)
PROB_ATOL = 1e-5
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
            return per_call / 1e3
        device_ms.empty_sessions += 1
    ms = time_ms(torch, fn, arg_sets, reps=calls, rounds=3)
    device_ms.event_fallbacks += 1
    phase("device_ms fallback", fn=getattr(fn, "__name__", str(fn)),
          empty_sessions=PROFILE_TRIES, event_ms=ms)
    return ms


#: activities the sessions of ``device_ms`` missed (of the launches their
#: calls made), sessions it took again, and readings it took with CUDA
#: events after ``PROFILE_TRIES`` of them
device_ms.missed_activities = 0
device_ms.empty_sessions = 0
device_ms.event_fallbacks = 0


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


def load_fixture(name: str):
    path = os.path.join(FIXTURES, name)
    with open(os.path.join(path, "rows.json")) as fh:
        rows = json.load(fh)
    with np.load(os.path.join(path, "expected.npz")) as z:
        want = {k: z[k] for k in z.files}
    return path, rows, want


def check_scores(name: str, out: list[dict], want: dict) -> None:
    preds = [next(iter(r.values())) for r in out]
    prob = np.array([[p["probability_0"], p["probability_1"]] for p in preds])
    pred = np.array([p["prediction"] for p in preds])
    reps = -(-len(preds) // len(want["prediction"]))
    w_prob = np.tile(want["probability"], (reps, 1))[: len(preds)]
    w_pred = np.tile(want["prediction"], reps)[: len(preds)]
    if prob.shape != w_prob.shape or not np.isfinite(prob).all():
        raise AssertionError(f"{name}: bad probability block {prob.shape}")
    err = float(np.abs(prob - w_prob).max())
    if err > PROB_ATOL or not np.array_equal(pred, w_pred):
        raise AssertionError(
            f"{name}: scores differ from the JAX package's (max prob err {err})"
        )


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
    ms = {"upload": 0.0, "download": 0.0, "K1 serve_trees": 0.0}
    total = 0.0
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", 0.0)
        if not t or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        total += t / 1e3
        name = evt.key.lower()
        key = ("upload" if "htod" in name else "download" if "dtoh" in name
               else "K1 serve_trees" if "serve_trees" in name else None)
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
    out = {
        "bit_identical_to_plain": True, "max_abs_err": err,
        "ms": device_ms(torch, lambda a, b, c: H.node_order(a, m, b, c), cold),
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

    start_on_card(torch, ["serve_trees", "node_order", "hist_binloop",
                          "hist_wide", "best_split"])

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
    # points, with the launch count read around exactly this run
    ST.serve_trees.launches = 0
    models, rates = {}, {}
    for name in ("xgb", "rf"):
        path, rows, want = load_fixture(name)
        model = load_workflow_model(path)
        fn = score_function(model)
        check_scores(name, [fn(rows[0])], {k: v[:1] for k, v in want.items()})
        check_scores(name, fn.batch(rows), want)
        big = (rows * (-(-BUCKET_ROWS // len(rows))))[:BUCKET_ROWS]
        check_scores(name, fn.batch(big), want)
        secs = []
        for _ in range(3):
            s = time.perf_counter()
            fn.batch(big)
            secs.append(time.perf_counter() - s)
        rates[name] = BUCKET_ROWS / statistics.median(secs)
        models[name] = model
    launches = ST.serve_trees.launches
    ST.serve_trees.launches = 0
    if launches == 0:
        raise AssertionError("the main path never launched serve_trees")
    phase("end_to_end", launches=launches, batch_rows=BUCKET_ROWS,
          rows_per_s=rates)
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
    train = train_path(torch, x, y, masks)
    records = train.pop("_records")
    k1_records = train.pop("_k1_records")
    phase("train", **train)
    # K2 at the training path's own launches (relaunches are not counted)
    k2 = check_main_launches(torch, H, "hist_binloop", records, weights={
        "xgb": XGB_GRID[0]["num_round"], "rf": RF_GRID[0]["num_trees"]})
    del records
    phase("hist_binloop main_path", **k2)

    # the regression path at a 256-bin sketch, its counts read around it
    reg = train_regression_path(torch, x, target, masks)
    records = reg.pop("_records")
    records_k2 = reg.pop("_records_k2")
    k1_records_reg = reg.pop("_k1_records")
    phase("train_regression", **reg)
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
