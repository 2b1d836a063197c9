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


class KernelError(RuntimeError):
    """A fault of the program's kernels, never of a model candidate: the
    model selector lets it propagate instead of excluding a family."""


class KernelBuildError(KernelError):
    """A kernel library could not be built or loaded."""


class KernelLaunchError(KernelError):
    """A kernel's launch was refused (its wrapper's return-code check)."""


def _device_errors() -> tuple[type, ...]:
    import torch

    found = [torch.OutOfMemoryError]
    if hasattr(torch, "AcceleratorError"):
        found.append(torch.AcceleratorError)
    return tuple(found)


def is_kernel_fault(e: BaseException) -> bool:
    """Whether ``e`` is a fault of the kernels or the card: a kernel that
    did not build, load or launch, the card's memory running out, or an
    error the device runtime reported (an asynchronous kernel fault
    surfaces at the next sync as one)."""
    return isinstance(e, (KernelError, *_device_errors())) or (
        isinstance(e, RuntimeError) and "CUDA error" in str(e)
    )


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``; exact when several threads launch
    at once (the model selector sweeps its families on a thread pool)."""
    with _count_lock:
        wrapper.launches += 1


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
