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
  once untimed and N times on the host clock.

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


def time_side(cs, path: str, reps: int, parts: list[str]) -> None:
    import torch

    cs.start_on_card(torch, ["serve_trees", "tree_sum", "node_order",
                             "hist_binloop", "hist_wide"])
    if "k1" in parts:
        time_k1(cs, torch, path)
    if "order" in parts:
        time_order(cs, torch, path)
    if "tree_sum" in parts:
        time_tree_sum(cs, torch)
    if "sweep" in parts:
        time_sweep(cs, torch, reps)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["save", "time"])
    ap.add_argument("dir", help="where the inputs are written or read")
    ap.add_argument("--root", default=HERE,
                    help="time: the checkout whose package is timed")
    ap.add_argument("--reps", type=int, default=3,
                    help="time: timed GBT sweeps after the untimed one")
    ap.add_argument("--parts", default="k1,order,tree_sum,sweep",
                    help="time: what to time, of k1, order, tree_sum, sweep")
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
