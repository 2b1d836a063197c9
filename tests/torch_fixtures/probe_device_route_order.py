"""Probe where the port's device-route tree sum departs from the JAX
package's (``ROADMAP.md`` C4).

Run from the repository root, on the CPU:

    JAX_PLATFORMS=cpu python tests/torch_fixtures/probe_device_route_order.py \
        [--depths 1,3,5,6] [--trees 4,8,20,33,50] [--rows 256,300,32768]
    JAX_PLATFORMS=cpu python tests/torch_fixtures/probe_device_route_order.py \
        --fixture tests/fixtures/torch_fused/text_xgb

The first form draws a seeded random stack per (depth, trees, rows) and
prints, for the boosted and the forest sum, how many rows of the port's
``tree_sum_device_route_plain`` differ from the reference's
``predict_boosted_raw`` / ``predict_forest_raw`` on the same leaves, and
which of two candidate orders the reference followed where they differ:
``lanes8`` (tree t in lane t % 8 over the first multiple of 8, the lanes
folded by halves, the rest added in order; one window of trees and
leaves) or ``fold_w`` (the [W, 2] grid of partials summed per tree window,
those folded by halves; two leaf windows). The second form scores a saved
model's rows with both packages above the host-predict cutoff and prints
the rows whose scores differ.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
F, ETA, BASE = 8, 0.02, 0.37


def _stack(t: int, depth: int, n: int, seed: int = 0):
    rng = np.random.default_rng(seed + 1000 * t + depth)
    w = 1 << depth
    sf = rng.integers(-1, F, (t, depth, w)).astype(np.int32)
    sb = rng.integers(0, 30, (t, depth, w)).astype(np.int32)
    lv = (rng.normal(size=(t, w)) * 10.0 ** rng.integers(-3, 2, (t, w))).astype(np.float32)
    x = rng.normal(size=(n, F)).astype(np.float32)
    thr = np.sort(rng.normal(size=(F, 31)), axis=1).astype(np.float32)
    return sf, sb, lv, x, thr


def _reference(sf, sb, lv, x, thr):
    """(boosted, forest) outputs and each (row, tree)'s leaf, from the JAX
    package's device route."""
    import jax
    import jax.numpy as jnp

    from transmogrifai_tpu.models import trees as JTR

    tree = JTR.Tree(jnp.asarray(sf), jnp.asarray(sb), jnp.asarray(lv))
    xj, tj = jnp.asarray(x), jnp.asarray(thr)
    boosted = np.asarray(JTR.predict_boosted_raw(xj, tj, tree, jnp.float32(ETA),
                                                 jnp.float32(BASE)))
    forest = np.asarray(JTR.predict_forest_raw(xj, tj, tree))
    ids = np.tile(np.arange(lv.shape[1], dtype=np.float32), (lv.shape[0], 1))
    binned = JTR.bin_data(xj, tj)
    leaf = np.asarray(jax.vmap(lambda t: JTR.predict_tree(binned, t))(
        JTR.Tree(jnp.asarray(sf), jnp.asarray(sb), jnp.asarray(ids)))).T
    return boosted, forest, leaf.astype(np.int64)


def _epilogue(total, boosted: bool, t: int) -> np.ndarray:
    import torch

    from transmogrifai_tpu_torch.models import tree_sum as TS

    total = torch.from_numpy(np.asarray(total, np.float32))
    if boosted:
        return TS._fma32(ETA, total, BASE).numpy()
    return (total * torch.tensor(TS._reciprocal(t), dtype=torch.float32)).numpy()


def _halve(v: np.ndarray) -> np.ndarray:
    while v.shape[1] > 1:
        h = v.shape[1] // 2
        v = v[:, :h] + v[:, h:]
    return v[:, 0]


def _lanes8(vals: np.ndarray) -> np.ndarray:
    n, t = vals.shape
    main = t // 8 * 8
    acc = np.zeros((n, 8), np.float32)
    for j in range(0, main, 8):
        acc = acc + vals[:, j:j + 8]
    s = _halve(acc) if main else np.zeros(n, np.float32)
    for j in range(main, t):
        s = s + vals[:, j]
    return s


def _fold_w(vals: np.ndarray, leaf: np.ndarray) -> np.ndarray:
    n, t = vals.shape
    w = -(-t // 32)
    lo = (w * 32 - t) // 2
    grid = np.zeros((n, w, 2), np.float32)
    for j in range(t):
        cell = (j + lo) // 32
        h = leaf[:, j] // 32
        for k in (0, 1):
            grid[:, cell, k] += np.where(h == k, vals[:, j], np.float32(0))
    return _halve(grid[:, :, 0] + grid[:, :, 1])


def probe_shape(depth: int, t: int, n: int) -> dict:
    import torch

    from transmogrifai_tpu_torch.models import tree_sum as TS

    sf, sb, lv, x, thr = _stack(t, depth, n)
    want_b, want_f, leaf = _reference(sf, sb, lv, x, thr)
    vals = np.take_along_axis(lv, leaf.T, 1).T.astype(np.float32)
    h = TS.leaf_windows(n, depth)
    win = torch.from_numpy((leaf // 32).astype(np.float32)) if h > 1 else None
    out = {}
    for boosted, want in ((True, want_b), (False, want_f)):
        got = TS.tree_sum_device_route_plain(
            torch.from_numpy(vals), win, h, boosted, ETA, BASE).numpy()
        row = {"differ": int(np.count_nonzero(got != want))}
        if row["differ"]:
            for name, total in (("lanes8", _lanes8(vals)),
                                ("fold_w", _fold_w(vals, leaf) if h == 2 else None)):
                if total is not None and np.array_equal(
                        _epilogue(total, boosted, t), want):
                    row["reference_order"] = name
        out["boosted" if boosted else "forest"] = row
    return out


def probe_fixture(path: str) -> dict:
    os.environ["TPTPU_HOST_PREDICT_MAX"] = "0"
    from transmogrifai_tpu.local.scoring import score_function as jax_score
    from transmogrifai_tpu.workflow.persistence import load_workflow_model as jax_load
    from transmogrifai_tpu_torch.local.scoring import score_function
    from transmogrifai_tpu_torch.workflow.persistence import load_workflow_model

    with open(os.path.join(path, "rows.json")) as fh:
        rows = json.load(fh)

    def raw(out):
        return np.array([next(iter(r.values()))["rawPrediction_1"] for r in out])

    port = raw(score_function(load_workflow_model(path, device="cpu"),
                              device="cpu").batch(rows))
    ref = raw(jax_score(jax_load(path)).batch(rows))
    return {"rows": len(rows), "differ": int(np.count_nonzero(port != ref)),
            "max_abs": float(np.abs(port - ref).max())}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", default="1,3,5,6,7")
    ap.add_argument("--trees", default="4,7,8,15,20,32,33,50,65,100,200")
    ap.add_argument("--rows", default="256,300")
    ap.add_argument("--fixture")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.fixture:
        print(json.dumps(probe_fixture(args.fixture)))
        return
    for n in map(int, args.rows.split(",")):
        for depth in map(int, args.depths.split(",")):
            for t in map(int, args.trees.split(",")):
                print(json.dumps({"rows": n, "depth": depth, "trees": t,
                                  **probe_shape(depth, t, n)}), flush=True)


if __name__ == "__main__":
    main()
