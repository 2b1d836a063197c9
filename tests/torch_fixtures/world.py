"""Spawn a ``torch.distributed`` world of N ranks on the CPU (``gloo``)
and bring each rank's results back to the caller.

``run_world(n, "module:function", args, tmp_path)`` starts N processes of
this file. Each joins a ``gloo`` group (``backend="nccl"``: an NCCL group,
rank r on card r) through a ``file://`` store under
``tmp_path`` (so parallel test workers never share a port), sets one
thread, turns collective tracing on, calls ``function(*args)`` (imported
from ``tests/torch_fixtures``) and writes ``(result, tapes)`` to a pickle.
The group's timeout is 60 s, and the parent joins with a deadline and
kills every rank past it: a hung collective fails one test and never
stalls the suite. Keep spawns few: run several cases per world and
return their results together.

Run as ``python world.py JOB RANK``.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
GLOO_TIMEOUT_S = 60
DEADLINE_S = 240


def run_world(n: int, target: str, args: tuple, tmp_path,
              deadline: float = DEADLINE_S, backend: str = "gloo") -> list:
    """[(result, tapes)] of ranks 0..n-1; raises with every failing rank's
    traceback, or when the deadline passes (every rank killed). With
    ``backend="nccl"`` rank r drives card r (``LOCAL_RANK``)."""
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    job = os.path.join(tmp, f"world_job_{os.getpid()}_{time.time_ns()}.pkl")
    with open(job, "wb") as fh:
        pickle.dump({"n": n, "target": target, "args": args,
                     "backend": backend,
                     "store": os.path.join(job + ".store")}, fh)
    child_env = dict(os.environ)
    child_env.update({"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"})
    child_env.pop("LOCAL_RANK", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(r)],
        env=dict(child_env, **({"LOCAL_RANK": str(r)}
                               if backend == "nccl" else {})),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(n)]
    end = time.monotonic() + deadline
    outs = [b""] * n
    try:
        for r, p in enumerate(procs):
            left = max(1.0, end - time.monotonic())
            outs[r], _ = p.communicate(timeout=left)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"world of {n} ranks passed its {deadline} s "
                             "deadline; every rank killed")
    failed = [r for r, p in enumerate(procs)
              if p.returncode != 0 or not os.path.exists(f"{job}.rank{r}")]
    if failed:
        raise AssertionError("\n".join(
            f"rank {r} of {n} failed (exit {procs[r].returncode}):\n"
            + outs[r].decode(errors="replace")[-4000:] for r in failed))
    results = []
    for r in range(n):
        with open(f"{job}.rank{r}", "rb") as fh:
            results.append(pickle.load(fh))
    return results


def _main(job_path: str, rank: int) -> int:
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(job_path, "rb") as fh:
        job = pickle.load(fh)
    sys.path[:0] = [HERE, ROOT]
    from transmogrifai_tpu_torch.parallel import guarded

    if job["backend"] == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        job["backend"], init_method=f"file://{job['store']}",
        world_size=job["n"], rank=rank,
        timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
    guarded.set_tracing(True)
    guarded.reset_tapes()
    try:
        mod_name, fn_name = job["target"].split(":")
        fn = getattr(__import__(mod_name), fn_name)
        result = fn(*job["args"])
        tapes = guarded.collective_tapes()
        with open(f"{job_path}.rank{rank}", "wb") as fh:
            pickle.dump((result, tapes), fh)
    except BaseException:
        traceback.print_exc()
        return 1
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1], int(sys.argv[2])))
