"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``_build/`` (keyed by a
hash of the source and the flags) at first use, and loaded with ctypes.
Nothing is built when a module is imported. ``nvcc`` is looked for on
``PATH``, then in ``$CUDA_HOME/bin``, then in ``/usr/local/cuda/bin``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
DEFAULT_CUDA_ROOT = "/usr/local/cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: per kernel source: nvcc's output from the build this process ran
#: (ptxas registers / shared memory / spills), for the smoke report
build_logs: dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """A kernel library could not be built or loaded."""


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append(os.path.join(DEFAULT_CUDA_ROOT, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or in "
        f"{DEFAULT_CUDA_ROOT}/bin: the CUDA kernels cannot be built"
    )


def library_path(name: str) -> str:
    """``_build/lib<name>-<hash>.so`` for ``csrc/<name>.cu``; the hash
    covers the source, the headers beside it and the flags."""
    h = hashlib.sha256()
    headers = sorted(p for p in os.listdir(CSRC_DIR) if p.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: list[str]) -> dict[str, float]:
    """Compile every missing library among ``names``, one ``nvcc`` process
    per source, all started together. Returns seconds per built source."""
    pending = {n: library_path(n) for n in names}
    pending = {n: p for n, p in pending.items() if not os.path.exists(p)}
    if not pending:
        return {}
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, path in pending.items():
        tmp = f"{path}.tmp-{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (tmp, path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    seconds, failed = {}, []
    for name, (tmp, path, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
    if failed:
        raise KernelBuildError("\n".join(failed))
    return seconds


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            try:
                lib = ctypes.CDLL(library_path(name))
            except OSError as e:
                raise KernelBuildError(f"cannot load {name}: {e}") from e
            _libs[name] = lib
        return lib
