"""Store the JAX package's ``explain=k`` attributions of the serving
fixtures at the card's shapes, which ``chip_smoke.py``'s ``insights``
phase holds the port's on the card to.

Run from the repository root, on the CPU (~1 min):

    TPTPU_COMPILE_CACHE=/tmp/cache JAX_PLATFORMS=cpu \\
        python tests/torch_fixtures/make_insights_fixtures.py

It writes ``tests/fixtures/torch_insights/jax_results.json``: for each of
``xgb``, ``rf`` and ``lr`` (``tests/fixtures/torch_serving/``) and each
route, ``insights_flow.explain_fixture``'s top-3 maps: ``staged`` over
``CHIP_ROWS`` = 600 rows (the fused graph opted out; they bucket to 1024,
so the 16 lanes score 16384 rows) and ``fused`` over ``CHIP_FUSED_ROWS`` =
100 rows (``TPTPU_HOST_PREDICT_MAX=64``: one fused run with the lanes
inside, 16 x 128 lane rows through the device route). Peak memory ~3 GB.
"""
from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import insights_flow as I  # noqa: E402


def main() -> None:
    P = I.package("jax")
    out = {"rows": I.CHIP_ROWS, "fusedRows": I.CHIP_FUSED_ROWS,
           "k": I.CHIP_K, "fusedCutoff": I.CHIP_FUSED_CUTOFF, "models": {}}
    for name in ("xgb", "rf", "lr"):
        out["models"][name] = {}
        for route in ("staged", "fused"):
            t0 = time.perf_counter()
            rows = I.CHIP_ROWS if route == "staged" else I.CHIP_FUSED_ROWS
            attrs, _ = I.explain_fixture(P, name, rows, route)
            if any(a is None for a in attrs):
                raise SystemExit(f"{name} {route}: the JAX package's explain "
                                 "degraded (see its warning)")
            out["models"][name][route] = I.to_json(attrs)
            print(name, route, f"{time.perf_counter() - t0:.1f}s", flush=True)
    os.makedirs(I.FIXTURE, exist_ok=True)
    with open(I.RESULTS, "w") as fh:
        json.dump(out, fh)
    print("wrote", I.RESULTS)


if __name__ == "__main__":
    main()
