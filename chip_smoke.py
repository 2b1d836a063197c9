#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Run from the repository root. It builds the port's CUDA kernels from
``transmogrifai_tpu_torch/csrc/`` into ``transmogrifai_tpu_torch/_build/``,
checks each kernel against its plain PyTorch version on the card, then
drives the main path: the committed fixture models
(``tests/fixtures/torch_serving/{xgb,rf}``, trained and saved by the JAX
package) are loaded with ``load_workflow_model`` and answer requests through
``score_function`` on ``cuda``; their scores are held to the ones the JAX
package stored. Every phase that fails raises, and the script exits non-zero
with no result line; it never falls back to the CPU.

The line before the last is ``{"kernels": [...]}`` with each kernel's
launches on the main path, its error against the plain version, and its
time, the plain version's time and the card's lower bound at the main
path's shape. The last line is ``{"ok": true, "device": {...}}``.
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


def l2_cold_copies(args, touched_bytes: int) -> list:
    """``args`` and enough clones of it that one pass over them touches at
    least four times the L2, so that a timed call reads from HBM."""
    k = min(64, max(2, -(-4 * L2_BYTES // max(touched_bytes, 1))))
    return [args] + [[a.clone() for a in args] for _ in range(k - 1)]


def random_stack(rng, t, depth, f, bins):
    """Random [T, depth, 2^depth] split arrays (-1 anywhere) and leaves."""
    w = 1 << depth
    return (
        rng.integers(-1, f, size=(t, depth, w)).astype(np.int32),
        rng.integers(0, bins, size=(t, depth, w)).astype(np.int32),
        rng.normal(size=(t, w)).astype(np.float32),
    )


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


def check_traversal(torch, ST, name, binned, sf, sb, lv, timed: bool) -> dict:
    """Kernel against the plain walk on the same card tensors: bit-identical
    or raise; with ``timed``, the kernel's and the plain walk's times with
    the inputs out of L2 (and the kernel's with them L2-resident too)."""
    args = [torch.from_numpy(a).cuda() for a in (binned, sf, sb, lv)]
    got = ST.serve_trees(*args)
    want = ST.serve_trees_reference(*args)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        bad = (got != want).sum().item() if got.shape == want.shape else "shape"
        raise AssertionError(f"serve_trees {name}: kernel != plain walk ({bad})")
    n, f = binned.shape
    t, depth, _ = sf.shape
    out = {
        "shape": {"N": n, "F": f, "T": t, "depth": depth},
        "max_abs_err": (got - want).abs().max().item() if got.numel() else 0.0,
    }
    if timed:
        nbytes = traversal_touched_bytes(torch, *args[:3])
        bound, by = traversal_bound_ms(nbytes, n, t, depth)
        cold = l2_cold_copies(args, nbytes)
        out.update(
            kernel_ms=time_ms(torch, ST.serve_trees, cold),
            kernel_ms_l2_warm=time_ms(torch, ST.serve_trees, [args]),
            plain_ms=time_ms(
                torch, ST.serve_trees_reference, cold, reps=3, rounds=5
            ),
            touched_bytes=nbytes, arg_copies=len(cold),
            bound_ms=bound, bound_by=by,
        )
        del cold
    return out


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
    s = time.perf_counter()
    for f in model.result_features:
        cols[f.name].to_list()
    out["render"] = time.perf_counter() - s
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from transmogrifai_tpu_torch import load_workflow_model, score_function
    from transmogrifai_tpu_torch.models import serve_trees as ST
    from transmogrifai_tpu_torch.utils import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    phase(
        "environment", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
    )
    print(smi, flush=True)

    t0 = time.perf_counter()
    built = cuda_build.build(["serve_trees"])
    phase("build", seconds=time.perf_counter() - t0, per_source=built)
    for name, log in cuda_build.build_logs.items():
        print(f"nvcc {name}:\n{log.strip()}", flush=True)

    rng = np.random.default_rng(0)
    shapes = {
        "a_xgb_flagship": (BUCKET_ROWS, 928, 200, 10, 32),
        "b_rf": (BUCKET_ROWS, 928, 50, 12, 32),
        "c_ragged": (133, 7, 5, 3, 8),
    }
    for label, (n, f, t, depth, bins) in shapes.items():
        sf, sb, lv = random_stack(rng, t, depth, f, bins)
        if label == "c_ragged":
            sf[[1, 3]] = -1  # leaf-only trees
        binned = rng.integers(0, bins, size=(n, f)).astype(np.int32)
        res = check_traversal(
            torch, ST, label, binned, sf, sb, lv, timed=label != "c_ragged"
        )
        phase(f"serve_trees {label}", **res)

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
    best = models["xgb"].stage_plan()[-1].best_model
    trees = best.device_stacks[0]
    num_f = best.thresholds.shape[0]
    binned = rng.integers(0, best.thresholds.shape[1] + 1,
                          size=(BUCKET_ROWS, num_f)).astype(np.int32)
    main = check_traversal(
        torch, ST, "main_path", binned,
        *(a.cpu().numpy() for a in trees), timed=True,
    )
    phase("serve_trees main_path", **main)
    ST.serve_trees.launches = 0

    print(json.dumps({"kernels": [{
        "name": "serve_trees",
        "route": "cuda",
        "source": "transmogrifai_tpu_torch/csrc/serve_trees.cu",
        "replaces": "transmogrifai_tpu/models/serve_pallas.py:146",
        "launches": launches,
        "max_abs_err": main["max_abs_err"],
        "ms": main["kernel_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
