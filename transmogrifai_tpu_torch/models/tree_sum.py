"""The per-row reduction of a served tree ensemble, in tree order.

``tree_sum(per_tree, boosted, eta, base_score)`` turns the traversal's
[N, T] float32 leaf values (kernel K1) into the ensemble's [N] float32
output: the trees added in order t = 0..T-1 into one float32 accumulator
per row, starting from 0, then

* boosted: ``base + eta * sum``, the product and the sum rounded apart;
* forest: ``sum / T``, a true division.

That is the JAX package's serving arithmetic for batches of up to 16384
rows (its native loop ``tp_tree_predict_sum`` and the epilogues of
``predict_boosted_host`` / ``predict_forest_host``), so served scores
equal the reference's bit for bit. The port takes this order at every
batch size. Above 16384 rows the reference takes its device route, whose
order differs from this one in the last ulp.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/tree_sum.cu``) or raises; on a CPU tensor it runs the plain
version (``tree_sum_plain``: a Python loop of T adds). Both give the same
bits: the kernel's adds are ``__fadd_rn`` in the same order, and its
epilogue uses the ``_rn`` intrinsics, which are never contracted into a
fused multiply-add.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import cuda_build

_KERNEL = "tree_sum"


def _check(per_tree: torch.Tensor) -> None:
    if not isinstance(per_tree, torch.Tensor):
        raise TypeError("tree_sum: per_tree must be a tensor")
    if per_tree.dtype != torch.float32:
        raise TypeError(f"tree_sum: per_tree must be float32, got {per_tree.dtype}")
    if per_tree.dim() != 2:
        raise ValueError(
            f"tree_sum: per_tree must be [N, T], got {tuple(per_tree.shape)}")
    if not per_tree.is_contiguous():
        raise ValueError("tree_sum: per_tree must be contiguous")
    if per_tree.device.type not in ("cuda", "cpu"):
        raise ValueError(f"tree_sum: unsupported device {per_tree.device}")


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim float32 tensor on ``like``'s device, filled there: no host
    copy, and a division by it is a true division on the card (a Python
    divisor would be taken as a reciprocal multiply there)."""
    return torch.full((), float(np.float32(v)), dtype=torch.float32,
                      device=like.device)


def tree_sum_plain(per_tree: torch.Tensor, boosted: bool, eta: float = 0.0,
                   base_score: float = 0.0) -> torch.Tensor:
    """The kernel's contract in plain PyTorch, on the tensor's device."""
    n, t = per_tree.shape
    acc = torch.zeros(n, dtype=torch.float32, device=per_tree.device)
    for j in range(t):
        acc = acc + per_tree[:, j]
    if boosted:
        return _scalar(base_score, acc) + _scalar(eta, acc) * acc
    return acc / _scalar(t, acc)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library(_KERNEL)
    fn = lib.tp_tree_sum
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _on_cuda(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def tree_sum(per_tree: torch.Tensor, boosted: bool, eta: float = 0.0,
             base_score: float = 0.0) -> torch.Tensor:
    """[N, T] float32 leaf values -> [N] float32: the boosted margin
    ``base_score + eta * sum`` or the forest mean ``sum / T``, the trees
    summed in order. ``eta`` and ``base_score`` are rounded to float32."""
    _check(per_tree)
    if not _on_cuda(per_tree):
        return tree_sum_plain(per_tree, boosted, eta, base_score)
    lib = _library()
    n, t = per_tree.shape
    out = torch.empty(n, dtype=torch.float32, device=per_tree.device)
    rc = lib.tp_tree_sum(
        per_tree.data_ptr(), out.data_ptr(), n, t, int(bool(boosted)),
        float(base_score), float(eta),  # c_float rounds to nearest
        torch._C._cuda_getCurrentRawStream(per_tree.device.index),
    )
    if rc != 0:
        msg = lib.tp_cuda_error_string(rc).decode()
        raise RuntimeError(f"tree_sum kernel launch failed: {msg} ({rc})")
    if n:
        tree_sum.launches += 1
    return out


#: kernel launches since the last reset (the plain version is not counted)
tree_sum.launches = 0
