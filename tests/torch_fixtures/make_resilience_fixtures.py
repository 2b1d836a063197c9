"""Write ``tests/fixtures/torch_resilience/jax_results.json``: the JAX
package's results of the resilience slice's scenarios that the card holds
the port to (``chip_smoke.py``'s ``resilience`` phase) and the CPU tests
read beside the live JAX runs (``tests/test_torch_resilience_flow.py``):

* ``retrain_loop``: ``resilience_flow.retrain_loop`` (the fleet over the
  serving fixture ``xgb``, the drift quorum, one ``crash_retrain``): the
  controller's states, history, ledger and events;
* ``report_shape`` / ``pulse_order``: the key sets of the RUN report of
  ``resilience_flow.recorded_train`` and its progress pulses' order;
* ``stream``: ``resilience_flow.stream_case`` with torn, corrupt and
  memory-pressured chunks and a crash after chunk 3, resumed.

Run: ``JAX_PLATFORMS=cpu python tests/torch_fixtures/make_resilience_fixtures.py``
(~15 s).
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import resilience_flow as F  # noqa: E402

#: the stream scenario the fixture stores
STREAM = {"n": 300, "chunk": 40, "cap": 100,
          "faults": [["tear_stream_chunk", 2], ["corrupt_chunk", 4],
                     ["oom_chunk", 1]],
          "crash_after": 5}


def main() -> None:
    J = F.package("jax")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["retrain_loop"] = F.retrain_loop(J, os.path.join(tmp, "rt"))
        model, pulses = F.recorded_train(J, os.path.join(tmp, "runs"))
        out["report_shape"] = F.report_shape(model.run_report)
        out["pulse_order"] = F.pulse_order(pulses)
        kw = dict(STREAM, faults=tuple(tuple(f) for f in STREAM["faults"]))
        out["stream"] = F.stream_case(J, ckpt_dir=os.path.join(tmp, "s"),
                                      **kw)
    os.makedirs(F.FIXTURE, exist_ok=True)
    with open(F.RESULTS, "w") as fh:
        json.dump(out, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(F.RESULTS)


if __name__ == "__main__":
    main()
