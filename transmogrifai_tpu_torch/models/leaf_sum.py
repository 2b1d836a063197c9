"""A grown tree's leaf sums past the reference's one-hot budget.

``leaf_sum(g, h, idx, size)`` -> (out_g, out_h) [K, size] float32:
``out_g[k, m]`` is the float32 sum, in ascending row order from +0, of
``g[k, r]`` over the rows r with ``idx[k, r] == m`` (``out_h`` the same
over ``h``; with ``h`` None only ``g`` is summed, and ``out_h`` is None). That is the order of the JAX package's scatter-add form of
``trees._segment_sum_small`` (a vmapped ``.at[].add``, which XLA's CPU
backend applies in row order), the form it takes for more than 512 slots
once (index count x slots) passes 2^28.

On a CUDA tensor the wrapper orders the rows by slot (``hist.node_order``,
a stable sort) and launches the hand-written kernel (``csrc/leaf_sum.cu``),
which adds each slot's run in that order, so its sums equal the plain
version's bit for bit; on a CPU tensor it runs the plain version
(``leaf_sum_plain``: an ``index_add_`` per fit and array, which the CPU
applies in row order). An accumulating ``index_put_`` adds a slot's many
rows in another order on the card, and on the CPU too with more than one
thread.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build
from . import hist as H

_KERNEL = "leaf_sum"


def _check(g, h, idx, size: int) -> None:
    arrays = (("g", g, torch.float32), ("h", h, torch.float32),
              ("idx", idx, torch.int32))
    for name, x, want in (a for a in arrays if a[1] is not None):
        if not isinstance(x, torch.Tensor) or x.dtype != want:
            raise TypeError(f"leaf_sum: {name} must be a {want} tensor, got "
                            f"{getattr(x, 'dtype', type(x).__name__)}")
        if x.dim() != 2 or tuple(x.shape) != tuple(idx.shape):
            raise ValueError(f"leaf_sum: {name} must be [K, N] = "
                             f"{list(idx.shape)}, got {list(x.shape)}")
        if x.device != idx.device:
            raise ValueError(f"leaf_sum: {name} is on {x.device}, idx on "
                             f"{idx.device}")
    if size < 1:
        raise ValueError(f"leaf_sum: size {size} must be >= 1")


def leaf_sum_plain(g: torch.Tensor, h: torch.Tensor, idx: torch.Tensor,
                   size: int):
    """The plain version: per fit and array one ``index_add_`` into zeros,
    on the tensors' device. On the CPU a one-dimensional ``index_add_``
    adds its entries one after another in row order, with any number of
    threads (an accumulating ``index_put_`` there adds float32 entries in
    parallel, with atomics, once it has more than one thread and 32768
    entries)."""
    k_fits = idx.shape[0]
    slots = idx.long()
    outs = []
    for v in (g, h):
        if v is None:
            outs.append(None)
            continue
        out = torch.zeros((k_fits, size), dtype=v.dtype, device=v.device)
        for k in range(k_fits):
            out[k].index_add_(0, slots[k], v[k])
        outs.append(out)
    return tuple(outs)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library(_KERNEL)
    lib.tp_leaf_sum.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.tp_leaf_sum.restype = ctypes.c_int
    lib.tp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def leaf_sum(g: torch.Tensor, h: torch.Tensor | None, idx: torch.Tensor,
             size: int):
    """(out_g, out_h) [K, size] float32, idx [K, N] int32 in [0, size):
    the module docstring's sums, in ascending row order per slot (``out_h``
    None where ``h`` is)."""
    _check(g, h, idx, size)
    if H._plain_on_cpu(idx):
        return leaf_sum_plain(g, h, idx, size)
    k_fits, n = idx.shape
    dev = idx.device
    g, idx = g.contiguous(), idx.contiguous()
    h = None if h is None else h.contiguous()
    lib = _library()  # build or load before any work is queued
    order, start, count = H.node_order(idx, size, g, g if h is None else h)
    out_g = torch.empty((k_fits, size), dtype=torch.float32, device=dev)
    out_h = None if h is None else torch.empty_like(out_g)
    rc = lib.tp_leaf_sum(
        order.data_ptr(), start.data_ptr(), count.data_ptr(), g.data_ptr(),
        None if h is None else h.data_ptr(), out_g.data_ptr(),
        None if out_h is None else out_h.data_ptr(), n, k_fits, size,
        torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        msg = lib.tp_cuda_error_string(rc).decode()
        raise cuda_build.KernelLaunchError(f"leaf_sum kernel launch failed: {msg} ({rc})")
    if k_fits:
        cuda_build.count_launch(leaf_sum)
    return out_g, out_h


#: kernel launches since the last reset (the plain version is not counted)
leaf_sum.launches = 0
