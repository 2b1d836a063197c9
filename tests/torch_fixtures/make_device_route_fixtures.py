"""Record the JAX package's device-route tree scores over the ensemble shapes
of ``ROADMAP.md`` C4, for ``tests/test_torch_device_route.py``.

Run from the repository root, on the CPU, with one JAX device:

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_device_route_fixtures.py

For every depth in ``DEPTHS``, tree count in ``TREES`` (one from each
measured regime of ``models/tree_sum.py``'s order table) and row count in
``ROWS`` it draws ``route_stack(depth, trees, rows)`` and writes the
reference's ``predict_boosted_raw`` (eta ``ETA``, base ``BASE``) and
``predict_forest_raw`` outputs, float32, to
``tests/fixtures/torch_device_route/orders.npz`` under
``d<depth>_t<trees>_n<rows>_boosted`` / ``..._forest``, with the JAX
version in ``config.json``. (720 compiled programs: about 4 minutes.)
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT_DIR = os.path.join(ROOT, "tests", "fixtures", "torch_device_route")

DEPTHS = (1, 2, 3, 4, 5, 6)
TREES = (1, 4, 7, 8, 12, 16, 20, 24, 28, 32, 33, 50, 64, 97, 128)
ROWS = (64, 256, 300, 2048)
ETA, BASE = 0.02, 0.37
FEATURES, BINS = 8, 32


def route_stack(depth: int, trees: int, rows: int):
    """(x [rows, F], thresholds [F, BINS - 1], split_feat, split_bin
    [trees, depth, 2^depth], leaf_value [trees, 2^depth]): a seeded stack
    whose leaf values span five decades, so that sums in another order
    round differently."""
    rng = np.random.default_rng(97 * depth + 1009 * trees + rows)
    w = 1 << depth
    sf = rng.integers(-1, FEATURES, (trees, depth, w)).astype(np.int32)
    sb = rng.integers(0, BINS - 1, (trees, depth, w)).astype(np.int32)
    lv = (rng.normal(size=(trees, w))
          * 10.0 ** rng.integers(-3, 2, (trees, w))).astype(np.float32)
    x = rng.normal(size=(rows, FEATURES)).astype(np.float32)
    thr = np.sort(rng.normal(size=(FEATURES, BINS - 1)), axis=1) \
        .astype(np.float32)
    return x, thr, sf, sb, lv


def key(depth: int, trees: int, rows: int, boosted: bool) -> str:
    return f"d{depth}_t{trees}_n{rows}_{'boosted' if boosted else 'forest'}"


def reference(depth: int, trees: int, rows: int) -> dict:
    import jax.numpy as jnp

    from transmogrifai_tpu.models import trees as JTR

    x, thr, sf, sb, lv = route_stack(depth, trees, rows)
    tree = JTR.Tree(jnp.asarray(sf), jnp.asarray(sb), jnp.asarray(lv))
    xj, tj = jnp.asarray(x), jnp.asarray(thr)
    return {
        key(depth, trees, rows, True): np.asarray(JTR.predict_boosted_raw(
            xj, tj, tree, jnp.float32(ETA), jnp.float32(BASE))),
        key(depth, trees, rows, False): np.asarray(
            JTR.predict_forest_raw(xj, tj, tree)),
    }


def main() -> None:
    import jax

    sys.path.insert(0, ROOT)
    if jax.device_count() != 1:
        raise SystemExit("run with one JAX device (see the docstring)")
    out = {}
    for depth in DEPTHS:
        for trees in TREES:
            for rows in ROWS:
                out.update(reference(depth, trees, rows))
        jax.clear_caches()
        print("depth", depth, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    np.savez_compressed(os.path.join(OUT_DIR, "orders.npz"), **out)
    with open(os.path.join(OUT_DIR, "config.json"), "w") as fh:
        json.dump({"jax": jax.__version__, "jax_devices": jax.device_count()},
                  fh, indent=1)


if __name__ == "__main__":
    main()
