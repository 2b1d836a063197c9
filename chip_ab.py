#!/usr/bin/env python3
"""A/B timing of two checkouts of the PyTorch port on one CUDA card.

    python3 chip_ab.py save DIR
    python3 chip_ab.py time DIR [--root CHECKOUT] [--reps N] [--parts P,...]

``save`` writes to DIR the inputs of K1 and of the row-order kernel: the
K1 shapes ``chip_smoke.py`` times ((a), (b) and the main path) and the K1
launches that scoring the fitted lanes of both training paths makes, and
the row orders that K2's launches on chosen trees of both training paths
ask for (captured as ``chip_smoke.py`` captures them: the middle boosting
round and the first forest tree of each depth group), each with how many
launches it stands for. It needs this checkout's package (the captures
read its packed stacks).

``time`` imports ``transmogrifai_tpu_torch`` from CHECKOUT (default: this
one), builds its kernels from that checkout's sources, and times, with
``chip_smoke.py``'s yardsticks (CUDA-event groups and the profiler's device
time, inputs out of L2), the parts named by ``--parts``:

* ``k1``: its traversal on DIR's inputs, per call (``serve_trees``, which
  every version of the port has) and, where the package has it, over the
  stack packed once (``serve_trees_packed``), each checked against the
  plain walk bit for bit; then the means over each training path's
  launches, weighted;
* ``order``: its row order (``node_order``) on DIR's captured inputs, each
  checked against the plain version, and the means per path and over both,
  weighted by the launches each input stands for;
* ``tree_sum``: its tree sum at ``chip_smoke.py``'s shapes and at the
  serving path's (1, 256 and 8192 rows of the xgb and rf fixtures' 200 and
  50 trees), beside one ``torch.sum(dim=1)``;
* ``sweep``: the GBT regressor's sweep (``chip_smoke.py``'s grid and table)
  once untimed and N times on the host clock;
* ``split``: its split search (``hist.split_search``, given the slots'
  counts where it takes them) at ``chip_smoke.py``'s timed split shapes;
* ``k4``: its fused split search (``hist.build_best_split``, its row
  order and its kernel) at ``chip_smoke.py``'s K4 shapes;
* ``route``: its tree sum's device-route mode at ``chip_smoke.py``'s timed
  device-route shapes and at its serving phase's device-route calls;
* ``k4ring``: K4 as it ships (``hist.build_best_split``) against its ring
  design (``csrc/best_split_ring.cu``: the row order walked through
  ``hist_ring.cuh``'s ring, the split stage run by the ring's consumers) at
  ``chip_smoke.py``'s K4 shapes, both making their row order, each checked
  bit for bit against ``best_split_plain``, timed in the order ring, K4,
  K4, ring;
* ``families``: the default binary selector's candidate families
  (``Validator.validate``) on the inputs its validator gets in ``train()``
  of the flagship twin and of ``fit_side_tables.wide_table()``: all three
  on the selector's thread pool, then each family alone, N times in turn
  after one untimed ``train()``, each with its wall seconds, each family's
  sweep seconds and the host process's CPU seconds over the same window
  (more CPU than wall seconds means that threads ran on the host at once).

Compare two checkouts in one call on one card, in the order A, B, B, A.
Each run prints one JSON phase per line, like ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _smoke():
    """``chip_smoke.py`` of this checkout, loaded by path so that it does
    not put this checkout's package ahead of ``--root``'s."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def save(cs, path: str) -> None:
    import torch

    from transmogrifai_tpu_torch.models import gbdt as G
    from transmogrifai_tpu_torch.models import hist as H
    from transmogrifai_tpu_torch.models import serve_trees as ST
    from transmogrifai_tpu_torch.models import trees as TR

    cs.start_on_card(torch, ["serve_trees", "node_order", "hist_binloop",
                             "hist_wide"])
    os.makedirs(path, exist_ok=True)
    inputs = cs.k1_inputs()
    for label in cs.K1_TIMED:
        binned, sf, sb, lv, _ = inputs[label]
        np.savez(os.path.join(path, f"k1_shape_{label}.npz"), binned=binned,
                 split_feat=sf, split_bin=sb, leaf_value=lv, weight=1,
                 path="shapes")
    x, y, target, masks = cs.train_table(cs.TRAIN_ROWS)
    i = j = 0
    # K2's captured trees and the launches each stands for, as chip_smoke.py
    trees = {"xgb": cs.XGB_GRID[0]["num_round"] // 2, "rf": 0,
             "gbt": cs.GBT_GRID[0]["max_iter"] // 2, "rfr": 0}
    weights = {"xgb": cs.XGB_GRID[0]["num_round"],
               "rf": cs.RF_GRID[0]["num_trees"],
               "gbt": cs.GBT_GRID[0]["max_iter"],
               "rfr": cs.RFR_GRID[0]["num_trees"]}
    for path_name, label, fits in (
        ("training", y, (("xgb", G.XGBoostClassifier, cs.XGB_GRID, True),
                         ("rf", G.RandomForestClassifier, cs.RF_GRID, False))),
        ("regression training", target,
         (("gbt", G.GBTRegressor, cs.GBT_GRID, True),
          ("rfr", G.RandomForestRegressor, cs.RFR_GRID, False))),
    ):
        for family, cls, grid, boosted in fits:
            with cs.KernelCapture(H, TR, "hist_binloop", trees) as kcap:
                kcap.start(family)
                models, _, _ = cs.fit_family(torch, cls(device=cs.DEV), x,
                                             label, masks, grid)
            for rec in kcap.records:
                _, node, g, h = rec["args"]
                np.savez(os.path.join(path, f"order_{j:03d}_{family}.npz"),
                         node=node.cpu().numpy(), grad=g.cpu().numpy(),
                         hess=h.cpu().numpy(), m=rec["m"],
                         weight=weights[family], path=path_name)
                j += 1
            cs.phase("order inputs saved", path=path_name, family=family,
                     launches=len(kcap.records))
            del kcap
            with cs.K1Capture(ST) as cap:
                cap.family = family
                cs.check_lanes_score(x, models, boosted=boosted,
                                     regression=path_name != "training")
            for (fam, depth, t), rec in cap.records.items():
                sf, sb, lv = (a.cpu().numpy()
                              for a in ST.unpack_trees(rec["packed"]))
                binned = rec["binned"].cpu().numpy()
                if binned.min() >= 0 and binned.max() < 256:
                    binned = binned.astype(np.uint8)  # widened when read
                np.savez(os.path.join(path,
                                      f"k1_train_{i:02d}_{fam}_d{depth}.npz"),
                         binned=binned, split_feat=sf, split_bin=sb,
                         leaf_value=lv, weight=rec["count"], path=path_name)
                cs.phase("k1 input saved", path=path_name, family=fam,
                         depth=depth, T=t, weight=rec["count"])
                i += 1
            del models, cap


def time_k1(cs, torch, path: str) -> None:
    from transmogrifai_tpu_torch.models import serve_trees as ST

    packs = hasattr(ST, "serve_trees_packed")
    rows = []
    for fname in sorted(f for f in os.listdir(path) if f.startswith("k1_")):
        with np.load(os.path.join(path, fname)) as z:
            host = [torch.from_numpy(z[k].astype(np.float32 if k == "leaf_value"
                                                 else np.int32))
                    for k in ("binned", "split_feat", "split_bin", "leaf_value")]
            weight, path_name = int(z["weight"]), str(z["path"])
        args = [a.to(cs.DEV) for a in host]
        want = ST.serve_trees_reference(*args)
        got = ST.serve_trees(*args)
        torch.cuda.synchronize()
        if not cs.same_values(torch, got, want):
            raise AssertionError(f"{fname}: kernel != plain walk")
        n, f = host[0].shape
        t, depth, _ = host[1].shape
        nbytes = cs.traversal_touched_bytes(torch, *args[:3])
        bound, by = cs.traversal_bound_ms(nbytes, n, t, depth)
        cold = cs.l2_cold_copies(args, nbytes)
        row = {"input": fname, "path": path_name, "weight": weight,
               "shape": {"N": n, "F": f, "T": t, "depth": depth},
               "kernel_ms": cs.time_ms(torch, ST.serve_trees, cold),
               "kernel_device_ms": cs.device_ms(torch, ST.serve_trees, cold),
               "bound_ms": bound, "bound_by": by}
        if packs:
            packed = ST.pack_trees(*host[1:], num_features=f).to(cs.DEV)
            if not cs.same_values(torch, ST.serve_trees_packed(args[0], packed),
                                  want):
                raise AssertionError(f"{fname}: packed kernel != plain walk")
            cold_packed = [[c[0], packed if i == 0 else cs.packed_clone(packed)]
                           for i, c in enumerate(cold)]
            row["packed_ms"] = cs.time_ms(torch, ST.serve_trees_packed,
                                          cold_packed)
            row["packed_device_ms"] = cs.device_ms(
                torch, ST.serve_trees_packed, cold_packed)
            del cold_packed
        del cold
        cs.phase(f"k1 {fname}", **row)
        rows.append(row)
    keys = [k for k in ("kernel_ms", "kernel_device_ms", "packed_ms",
                        "packed_device_ms", "bound_ms") if k in rows[0]]
    summary = {}
    for name in sorted({r["path"] for r in rows} - {"shapes"}):
        sel = [r for r in rows if r["path"] == name]
        total = sum(r["weight"] for r in sel)
        summary[name] = {"launches": total, **{
            k: sum(r["weight"] * r[k] for r in sel) / total for k in keys}}
    cs.phase("k1 summary", packed_route=packs, by_path=summary)


def time_order(cs, torch, path: str) -> None:
    from transmogrifai_tpu_torch.models import hist as H

    rows = []
    for fname in sorted(f for f in os.listdir(path) if f.startswith("order_")):
        with np.load(os.path.join(path, fname)) as z:
            node, g, h = (torch.from_numpy(z[k]).to(cs.DEV)
                          for k in ("node", "grad", "hess"))
            m, weight, path_name = int(z["m"]), int(z["weight"]), str(z["path"])
        k, n = node.shape
        row = {"input": fname, "path": path_name, "weight": weight,
               "shape": {"N": n, "K": k, "M": m},
               **cs.check_node_order(torch, H, node, g, h, m)}
        cs.phase(f"order {fname}", **row)
        rows.append(row)
    summary = {}
    for name in sorted({r["path"] for r in rows}) + ["both"]:
        sel = [r for r in rows if name in (r["path"], "both")]
        total = sum(r["weight"] for r in sel)
        summary[name] = {"launches_weight": total, "inputs": len(sel), **{
            key: sum(r["weight"] * r[key] for r in sel) / total
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
            "ms_sources": cs.source_counts(sel)}
    cs.phase("order summary", by_path=summary)


#: the serving path's tree sums: the xgb and rf fixtures' 200 and 50 trees
#: at a single row, their 256 rows and the scoring bucket cap
SERVING_SUMS = [(n, t, t == 200) for t in (200, 50) for n in (1, 256, 8192)]


def time_tree_sum(cs, torch) -> None:
    from transmogrifai_tpu_torch.models import tree_sum as TS

    rng = np.random.default_rng(7)
    shapes = {label: v for label, v in cs.TREE_SUM_SHAPES.items()
              if not label.startswith(("c", "d"))}
    shapes.update({f"serving N={n} T={t}": (n, t, b)
                   for n, t, b in SERVING_SUMS})
    for label, (n, t, boosted) in shapes.items():
        per_tree = torch.from_numpy(
            (rng.normal(size=(n, t)) * 10.0 ** rng.integers(-3, 2, (n, t)))
            .astype(np.float32)).to(cs.DEV)
        cs.phase(f"tree_sum {label}", **cs.check_tree_sum(
            torch, TS, label, per_tree, boosted, 0.02, 0.37, timed=True,
            pairs=cs.MUST_PAIRS))


def time_sweep(cs, torch, reps: int) -> None:
    from transmogrifai_tpu_torch.models import gbdt as G

    x, _, target, masks = cs.train_table(cs.TRAIN_ROWS)
    secs = []
    for i in range(reps + 1):
        _, s, _ = cs.fit_family(torch, G.GBTRegressor(device=cs.DEV), x,
                                target, masks, cs.GBT_GRID)
        if i:
            secs.append(s)
    cs.phase("gbt sweep", lanes=len(cs.GBT_GRID) * len(masks), seconds=secs,
             untimed_first=True)


def _family_inputs(cs, torch, table: str):
    """(validator, candidates, x, y, evaluator, extra masks) as the default
    binary selector's validator gets them in ``train()`` of ``table``
    (``twin`` or ``wide``), taken from one untimed train."""
    from transmogrifai_tpu_torch import types as PT
    from transmogrifai_tpu_torch.dataset import Dataset
    from transmogrifai_tpu_torch.selector import validators as V
    from transmogrifai_tpu_torch.types.columns import column_from_values

    if table == "twin":
        import json

        with open(os.path.join(cs.FIT_SIDE, "flagship_table.json")) as fh:
            t = json.load(fh)
        schema, columns = t["schema"], t["columns"]
    else:
        sys.path.insert(0, os.path.join(HERE, "tests", "torch_fixtures"))
        from fit_side_tables import wide_table

        schema, columns = wide_table()
    ds = Dataset.of({
        k: column_from_values(PT.feature_type_by_name(schema[k]), v)
        for k, v in columns.items()})
    seen = []
    real = V.Validator.validate

    def record(self, candidates, x, y, evaluator, extra_masks=()):
        seen.append((self, list(candidates), x, y, evaluator, list(extra_masks)))
        return real(self, candidates, x, y, evaluator, extra_masks=extra_masks)

    V.Validator.validate = record
    try:
        cs.train_flow(torch, ds, "label", False)
    finally:
        V.Validator.validate = real
    return seen[0]


def time_families(cs, torch, reps: int) -> None:
    for table in ("twin", "wide"):
        validator, cands, x, y, ev, masks = _family_inputs(cs, torch, table)
        names = [type(est).__name__ for est, _ in cands]
        runs = {"pool": []} | {n: [] for n in names}
        for _ in range(reps):
            for label, subset in [("pool", cands)] + [
                    (n, [c]) for n, c in zip(names, cands)]:
                torch.cuda.synchronize()
                with cs.TrainTimer() as timer:
                    t0, c0 = time.perf_counter(), time.process_time()
                    validator.validate(subset, x, y, ev, extra_masks=masks)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    cpu = time.process_time() - c0
                runs[label].append({
                    "wall_s": wall, "process_cpu_s": cpu,
                    "family_sweep_s": timer.split(wall)["family_sweep_s"]})
        cs.phase(f"families {table}", rows=int(x.shape[0]),
                 vector_columns=int(x.shape[1]), reps=reps,
                 untimed_first_train=True, runs=runs)


def _takes(fn, name: str) -> bool:
    import inspect

    return name in inspect.signature(fn).parameters


def time_split(cs, torch) -> None:
    from transmogrifai_tpu_torch.models import hist as H

    counted = _takes(H.split_search, "count")
    for i, (label, (k, m, f, b, empty)) in enumerate(cs.SPLIT_SHAPES.items()):
        if label >= "e":
            continue
        args = cs.split_inputs(torch, k, m, f, b, empty, seed=40 + i)
        cold = cs.l2_cold_copies(args, args[0].numel() * 4)

        def run(*a):
            if counted:
                return H.split_search(*a[:5], count=a[5])
            return H.split_search(*a[:5])

        cs.phase(f"split_search {label}", count_passed=counted,
                 ms=cs.device_ms(torch, run, cold),
                 wrapper_ms=cs.time_ms(torch, run, cold, reps=5, rounds=5))
        del cold


def time_k4(cs, torch) -> None:
    from transmogrifai_tpu_torch.models import hist as H

    for i, (label, (n, f, b, k, m)) in enumerate(cs.K4_SHAPES.items()):
        cpu = cs.best_split_inputs(n, f, b, k, m,
                                   seed=3 if label.startswith("c") else 20 + i)
        args = [a.to(cs.DEV) for a in cpu]
        cold = cs.l2_cold_copies(args, args[0].numel() * 4 + 12 * args[1].numel())

        def fused(*a):
            return H.build_best_split(*a, m, b)

        cs.phase(f"best_split {label}", ms=cs.device_ms(torch, fused, cold))
        del cold


def _ring_k4(torch):
    """K4's ring design as a function of ``build_best_split``'s
    arguments: the row order, then one launch of ``best_split_ring.cu``."""
    import ctypes

    from transmogrifai_tpu_torch.models import hist as H
    from transmogrifai_tpu_torch.utils import cuda_build

    lib = cuda_build.load_library("best_split_ring")
    lib.tp_best_split_ring.argtypes = ([ctypes.c_void_p] * 16
                                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.tp_best_split_ring.restype = ctypes.c_int
    lib.tp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tp_cuda_error_string.restype = ctypes.c_char_p

    def run(binned, node, g, h, fmask, lam, gam, mcw, m, b):
        k, n = node.shape
        f = binned.shape[1]
        dev = binned.device
        knobs = [H._per_fit(v, k, dev, name) for v, name in (
            (lam, "reg_lambda"), (gam, "gamma"), (mcw, "min_child_weight"))]
        rows, start, count = H.node_order(node, m, g, h)
        gain = torch.empty((k, m), dtype=torch.float32, device=dev)
        feat = torch.empty((k, m), dtype=torch.int32, device=dev)
        bin_ = torch.empty_like(feat)
        tile_gain = torch.empty((f, k, m), dtype=torch.float32, device=dev)
        tile_idx = torch.empty((f, k, m), dtype=torch.int32, device=dev)
        arrivals = torch.zeros((k, m), dtype=torch.int32, device=dev)
        rc = lib.tp_best_split_ring(
            binned.data_ptr(), rows.data_ptr(), start.data_ptr(),
            count.data_ptr(), g.data_ptr(), h.data_ptr(), fmask.data_ptr(),
            *(v.data_ptr() for v in knobs), gain.data_ptr(), feat.data_ptr(),
            bin_.data_ptr(), tile_gain.data_ptr(), tile_idx.data_ptr(),
            arrivals.data_ptr(), n, f, binned.stride(0), k, m, b,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError("best_split_ring launch failed: "
                               + lib.tp_cuda_error_string(rc).decode())
        return gain, feat, bin_

    return run


def time_k4ring(cs, torch) -> None:
    from transmogrifai_tpu_torch.models import hist as H

    ring = _ring_k4(torch)
    for i, (label, (n, f, b, k, m)) in enumerate(cs.K4_SHAPES.items()):
        cpu = cs.best_split_inputs(n, f, b, k, m,
                                   seed=3 if label.startswith("c") else 20 + i)
        args = [a.to(cs.DEV) for a in cpu]
        want = H.best_split_plain(*cpu, m, b)
        for name, fn in (("ring", ring), ("k4", H.build_best_split)):
            got = fn(*args, m, b)
            torch.cuda.synchronize()
            if not all(cs.same_values(torch, x.cpu(), y)
                       for x, y in zip(got, want)):
                raise AssertionError(f"{name} {label}: differs from "
                                     "best_split_plain")
        cold = cs.l2_cold_copies(args, args[0].numel() * 4 + 12 * args[1].numel())

        def run_ring(*a):
            return ring(*a, m, b)

        def run_k4(*a):
            return H.build_best_split(*a, m, b)

        readings = {"ring": [], "k4": []}
        for name in ("ring", "k4", "k4", "ring"):
            readings[name].append(cs.device_ms(
                torch, run_ring if name == "ring" else run_k4, cold))
        cs.phase(f"best_split ring against k4 {label}",
                 shape={"N": n, "F": f, "B": b, "K": k, "M": m},
                 bit_identical_to_cpu_plain=True, ring_ms=readings["ring"],
                 k4_ms=readings["k4"])
        del cold


#: the device-route calls of ``chip_smoke.py``'s serving phase: the xgb
#: fixture and its twin (200 boosted trees of depth 10: 32 leaf windows),
#: the rf fixture (50 trees of depth 12: 128) and its depth-10 twin
SERVING_ROUTES = {"serving T=200 H=32": (20000, 200, 32, 10, True),
                  "serving T=50 H=128": (20000, 50, 128, 12, False),
                  "serving T=50 H=32": (20000, 50, 32, 10, False)}


def time_route(cs, torch) -> None:
    from transmogrifai_tpu_torch.models import tree_sum as TS

    rng = np.random.default_rng(7)
    shapes = {label: v for label, v in cs.ROUTE_SHAPES.items()
              if label.startswith(("a", "b"))}
    shapes.update(SERVING_ROUTES)
    for label, (n, t, h, depth, boosted) in shapes.items():
        per_tree = torch.from_numpy(
            (rng.normal(size=(n, t)) * 10.0 ** rng.integers(-3, 2, (n, t)))
            .astype(np.float32)).to(cs.DEV)
        win = torch.from_numpy(rng.integers(0, h, (n, t)).astype(np.float32)
                               ).to(cs.DEV)
        cold = cs.l2_cold_copies([per_tree, win], 8 * n * t)

        def run(pt, w):
            return TS.tree_sum_device_route(pt, w, h, depth, boosted, 0.02,
                                            0.37)

        bound, _ = cs.route_bound_ms(n, t, h)
        ms = cs.device_ms(torch, run, cold)
        cs.phase(f"tree_sum_device_route {label}", device_ms=ms,
                 time_ms=cs.time_ms(torch, run, cold), bound_ms=bound,
                 device_ms_over_bound=ms / bound)
        del cold


def time_side(cs, path: str, reps: int, parts: list[str]) -> None:
    import torch

    from transmogrifai_tpu_torch.utils import cuda_build

    names = ["serve_trees", "tree_sum", "node_order", "hist_binloop",
             "hist_wide", "best_split", "split_search", "leaf_sum"]
    if "k4ring" in parts:
        names.append("best_split_ring")
    cs.start_on_card(torch, [n for n in names if os.path.exists(
        os.path.join(cuda_build.CSRC_DIR, f"{n}.cu"))])
    if "k1" in parts:
        time_k1(cs, torch, path)
    if "order" in parts:
        time_order(cs, torch, path)
    if "tree_sum" in parts:
        time_tree_sum(cs, torch)
    if "sweep" in parts:
        time_sweep(cs, torch, reps)
    if "split" in parts:
        time_split(cs, torch)
    if "k4" in parts:
        time_k4(cs, torch)
    if "route" in parts:
        time_route(cs, torch)
    if "k4ring" in parts:
        time_k4ring(cs, torch)
    if "families" in parts:
        time_families(cs, torch, reps)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["save", "time"])
    ap.add_argument("dir", help="where the inputs are written or read")
    ap.add_argument("--root", default=HERE,
                    help="time: the checkout whose package is timed")
    ap.add_argument("--reps", type=int, default=3,
                    help="time: timed GBT sweeps after the untimed one, "
                         "or turns of the families' sweeps")
    ap.add_argument("--parts", default="k1,order,tree_sum,sweep",
                    help="time: what to time, of k1, order, tree_sum, sweep, "
                         "split, k4, route, k4ring, families")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root if args.mode == "time" else HERE))
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device is available", file=sys.stderr)
        return 2
    cs = _smoke()
    t0 = time.perf_counter()
    if args.mode == "save":
        save(cs, args.dir)
    else:
        time_side(cs, args.dir, args.reps, args.parts.split(","))
    cs.phase("wall", seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
