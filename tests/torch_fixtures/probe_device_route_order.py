"""Measure which order the JAX package's device-route tree sum takes, for
every ensemble shape (``ROADMAP.md`` C4), and check the port against it.

Run from the repository root, on the CPU, with one JAX device:

    JAX_PLATFORMS=cpu python tests/torch_fixtures/probe_device_route_order.py \
        [--depths 1-6] [--trees 1-128] [--rows 64,160,...] [--jobs 6]
    JAX_PLATFORMS=cpu python tests/torch_fixtures/probe_device_route_order.py \
        --fixture tests/fixtures/torch_fused/text_xgb

With ``--stacks C`` (C > 1) each case instead draws C stacks, as a
one-vs-rest model holds them, and scores them with the JAX package's fused
core of a ``BoostedMultiModel`` and a ``ForestClassifierModel`` (every
class stack inside one XLA program, ``jnp.stack(outs, axis=1)``); each JSON
line says whether that program equals each stack's own program (the
single-stack orders above) and the port's ``device_core`` on its device
route (``"single"`` / ``"port"``, boosted and forest apart).

The first form draws a seeded random stack per (depth, trees, rows), scores
it with the reference's ``predict_boosted_raw`` and ``predict_forest_raw``,
and sums the same leaf values in each candidate order:

* ``inorder``: trees 0..T-1 into one float32 accumulator;
* ``lanes4`` / ``lanes8``: tree t in lane t % L over the first multiple of
  L, the lanes folded by halves, the rest added in order;
* ``fold_w``: two leaf windows; per window of 32 trees (padding centred)
  the partials of each leaf window in tree order, their [W, 2] grid summed
  as p[w, 0] + p[w, 1] per tree window, those folded by halves;
* ``grid``: the row-major windowed grid (``tree_sum._grid_sum`` over the
  [W, H] partials, the order the port took before C4's repair);
* ``port``: the port's ``tree_sum_device_route_plain`` as it stands.

Each JSON line names every candidate that equals the reference on all
rows, boosted and forest apart (``"none"`` where none does: such a case is
printed, never guessed). The last line summarises, per (depth, trees),
the orders matched at each row count; ``port_differs`` counts the cases
where the port is not the reference's. The second form scores a saved
model's rows with both packages above the host-predict cutoff and prints
the rows whose scores differ.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import multiprocessing as mp
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
F, ETA, BASE = 8, 0.02, 0.37
ROWS = "64,160,256,300,1000,2048,16385,20000,24576,32768"


def _stack(t: int, depth: int, n: int, seed: int = 0):
    rng = np.random.default_rng(seed + 1000 * t + depth)
    w = 1 << depth
    sf = rng.integers(-1, F, (t, depth, w)).astype(np.int32)
    sb = rng.integers(0, 30, (t, depth, w)).astype(np.int32)
    lv = (rng.normal(size=(t, w)) * 10.0 ** rng.integers(-3, 2, (t, w))).astype(np.float32)
    x = rng.normal(size=(n, F)).astype(np.float32)
    thr = np.sort(rng.normal(size=(F, 31)), axis=1).astype(np.float32)
    return sf, sb, lv, x, thr


def _leaves(binned: np.ndarray, sf: np.ndarray, sb: np.ndarray) -> np.ndarray:
    """[N, T] leaf index of every (row, tree): the reference's traversal
    (``trees.predict_tree``) in numpy."""
    t, depth, _ = sf.shape
    n = binned.shape[0]
    node = np.zeros((t, n), np.int64)
    rows = np.arange(n)
    for d in range(depth):
        feat = np.take_along_axis(sf[:, d], node, 1)
        thr = np.take_along_axis(sb[:, d], node, 1)
        code = binned[rows[None, :], np.maximum(feat, 0)]
        node = node * 2 + ((feat >= 0) & (code > thr))
    return node.T


def _reference(sf, sb, lv, x, thr):
    """(boosted, forest) outputs of the JAX package's device route, and
    each (row, tree)'s leaf."""
    import jax.numpy as jnp

    from transmogrifai_tpu.models import trees as JTR

    tree = JTR.Tree(jnp.asarray(sf), jnp.asarray(sb), jnp.asarray(lv))
    xj, tj = jnp.asarray(x), jnp.asarray(thr)
    boosted = np.asarray(JTR.predict_boosted_raw(xj, tj, tree, jnp.float32(ETA),
                                                 jnp.float32(BASE)))
    forest = np.asarray(JTR.predict_forest_raw(xj, tj, tree))
    binned = np.asarray(JTR.bin_data(xj, tj))
    return boosted, forest, _leaves(binned, sf, sb)


def _epilogue(total, boosted: bool, t: int) -> np.ndarray:
    import torch

    from transmogrifai_tpu_torch.models import tree_sum as TS

    total = torch.from_numpy(np.asarray(total, np.float32))
    if boosted:
        return TS._fma32(ETA, total, BASE).numpy()
    return (total * torch.tensor(TS._reciprocal(t), dtype=torch.float32)).numpy()


def _halve(v: np.ndarray) -> np.ndarray | None:
    if v.shape[1] & (v.shape[1] - 1):
        return None
    while v.shape[1] > 1:
        h = v.shape[1] // 2
        v = v[:, :h] + v[:, h:]
    return v[:, 0]


def _inorder(vals: np.ndarray) -> np.ndarray:
    s = np.zeros(vals.shape[0], np.float32)
    for j in range(vals.shape[1]):
        s = s + vals[:, j]
    return s


def _lanes(vals: np.ndarray, lanes: int) -> np.ndarray:
    n, t = vals.shape
    main = t // lanes * lanes
    acc = np.zeros((n, lanes), np.float32)
    for j in range(0, main, lanes):
        acc = acc + vals[:, j:j + lanes]
    s = _halve(acc) if main else np.zeros(n, np.float32)
    for j in range(main, t):
        s = s + vals[:, j]
    return s


def _partials(vals: np.ndarray, leaf: np.ndarray, h: int) -> np.ndarray:
    """[N, W, H] level-1 partials: per tree window (padding centred) and
    leaf window, the tree-order sum."""
    n, t = vals.shape
    w = -(-t // 32) if t > 32 else 1
    lo = (w * 32 - t) // 2 if t > 32 else 0
    grid = np.zeros((n, w, h), np.float32)
    for j in range(t):
        cell = (j + lo) // 32
        hw = leaf[:, j] // 32 if h > 1 else np.zeros(n, np.int64)
        for k in range(h):
            grid[:, cell, k] += np.where(hw == k, vals[:, j], np.float32(0))
    return grid


def _fold_w(vals: np.ndarray, leaf: np.ndarray, h: int) -> np.ndarray | None:
    if h != 2:
        return None
    grid = _partials(vals, leaf, 2)
    return _halve(grid[:, :, 0] + grid[:, :, 1])


def _grid(vals: np.ndarray, leaf: np.ndarray, h: int) -> np.ndarray:
    import torch

    from transmogrifai_tpu_torch.models import tree_sum as TS

    grid = torch.from_numpy(np.ascontiguousarray(
        _partials(vals, leaf, h).transpose(1, 2, 0)))
    return TS._grid_sum(grid).numpy()


def probe_shape(depth: int, t: int, n: int) -> dict:
    import torch

    from transmogrifai_tpu_torch.models import tree_sum as TS

    sf, sb, lv, x, thr = _stack(t, depth, n)
    want_b, want_f, leaf = _reference(sf, sb, lv, x, thr)
    vals = np.take_along_axis(lv, leaf.T, 1).T.astype(np.float32)
    h = TS.leaf_windows(n, depth)
    totals = {"inorder": _inorder(vals), "lanes4": _lanes(vals, 4),
              "lanes8": _lanes(vals, 8), "fold_w": _fold_w(vals, leaf, h),
              "grid": _grid(vals, leaf, h)}
    win = torch.from_numpy((leaf // 32).astype(np.float32)) if h > 1 else None
    out = {}
    for boosted, want in ((True, want_b), (False, want_f)):
        match = [name for name, total in totals.items() if total is not None
                 and np.array_equal(_epilogue(total, boosted, t), want)]
        port = TS.tree_sum_device_route_plain(
            torch.from_numpy(vals), win, h, depth, boosted, ETA, BASE).numpy()
        if np.array_equal(port, want):
            match.append("port")
        out["boosted" if boosted else "forest"] = match or ["none"]
    return out


def probe_stacks(depth: int, t: int, n: int, c: int) -> dict:
    """C class stacks in one fused program against their own programs and
    the port's device route (see the module docstring)."""
    import jax
    import jax.numpy as jnp
    import torch

    from transmogrifai_tpu.models import gbdt as JG
    from transmogrifai_tpu.models import trees as JTR
    from transmogrifai_tpu_torch.models import gbdt as PG

    arrays, stacks = {}, []
    for k in range(c):
        sf, sb, lv, x, thr = _stack(t, depth, n, seed=17 * k + 1)
        stacks.append(JTR.Tree(jnp.asarray(sf), jnp.asarray(sb), jnp.asarray(lv)))
        for name, a in (("split_feat", sf), ("split_bin", sb), ("leaf_value", lv)):
            arrays[f"c{k}__{name}"] = a
    arrays["thresholds"] = thr
    xj, tj = jnp.asarray(x), jnp.asarray(thr)
    out = {}
    for boosted in (True, False):
        cls = "BoostedMultiModel" if boosted else "ForestClassifierModel"
        params = {"eta": ETA, "base_score": BASE} if boosted else {}
        spec = getattr(JG, cls).from_params(params, arrays).fused_predict_spec()
        fused = np.asarray(jax.jit(lambda plane: spec.core(plane, spec.params))(xj))
        if boosted:
            single = [JTR.predict_boosted_raw(xj, tj, st, jnp.float32(ETA),
                                              jnp.float32(BASE)) for st in stacks]
        else:
            single = [JTR.predict_forest_raw(xj, tj, st) for st in stacks]
        port = getattr(PG, cls).from_params(params, arrays).to("cpu").device_core(
            torch.from_numpy(x), device_route=True).numpy()
        match = [name for name, got in (
            ("single", np.stack([np.asarray(s) for s in single], 1)), ("port", port))
            if np.array_equal(got, fused)]
        out["boosted" if boosted else "forest"] = match or ["none"]
    return out


def _run(job: tuple) -> list[dict]:
    n, depth, trees, c = job
    sys.path.insert(0, ROOT)
    import jax
    import torch

    torch.set_num_threads(1)
    out = [{"rows": n, "depth": depth, "trees": t, "stacks": c,
            **(probe_stacks(depth, t, n, c) if c > 1 else probe_shape(depth, t, n))}
           for t in trees]
    jax.clear_caches()  # one program per shape: keep a worker's memory flat
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


def _ints(spec: str) -> list[int]:
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def _summary(lines: list[dict]) -> dict:
    """Per depth and tree count: each order's set of row counts where it
    matched (boosted and forest both; with ``--stacks``, "single" and
    "port"), and the cases the port missed."""
    table: dict = {}
    port_differs = []
    for r in lines:
        both = set(r["boosted"]) & set(r["forest"])
        key = f"d{r['depth']}t{r['trees']}"
        cell = table.setdefault(key, {})
        for name in both or {"none"}:
            cell.setdefault(name, []).append(r["rows"])
        if "port" not in both:
            port_differs.append([r["depth"], r["trees"], r["rows"]])
    return {"summary": table, "port_differs": port_differs}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", default="1-6")
    ap.add_argument("--trees", default="1-128")
    ap.add_argument("--rows", default=ROWS)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--fixture")
    ap.add_argument("--stacks", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.fixture:
        print(json.dumps(probe_fixture(args.fixture)))
        return
    trees = _ints(args.trees)
    jobs = [(n, d, trees[i:i + 16], args.stacks) for n in _ints(args.rows)
            for d in _ints(args.depths) for i in range(0, len(trees), 16)]
    lines = []
    if args.jobs > 1:
        with cf.ProcessPoolExecutor(args.jobs, mp_context=mp.get_context("spawn")) as ex:
            results = ex.map(_run, jobs)
            for part in results:
                for line in part:
                    print(json.dumps(line), flush=True)
                lines.extend(part)
    else:
        for job in jobs:
            for line in _run(job):
                print(json.dumps(line), flush=True)
                lines.append(line)
    print(json.dumps(_summary(lines)))


if __name__ == "__main__":
    main()
