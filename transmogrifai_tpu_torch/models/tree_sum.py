"""The per-row reduction of a served tree ensemble, in the JAX package's
two orders.

``tree_sum(per_tree, boosted, eta, base_score)`` turns the traversal's
[N, T] float32 leaf values (kernel K1) into the ensemble's [N] float32
output: the trees added in order t = 0..T-1 into one float32 accumulator
per row, starting from 0, then

* boosted: ``base + eta * sum``, the product and the sum rounded apart;
* forest: ``sum / T``, a true division.

That is the JAX package's serving arithmetic for batches of up to 16384
rows (its native loop ``tp_tree_predict_sum`` and the epilogues of
``predict_boosted_host`` / ``predict_forest_host``).

``tree_sum_device_route(per_tree, leaf_window, num_windows, ...)`` is the
order of its device route, which serves larger batches (XLA's CPU
reduction of ``predict_boosted_raw`` / ``predict_forest_raw``). There each
tree's leaf is picked by a one-hot select over the 2^depth leaves, and the
select is reduced over trees and leaves together, in windows of 32 x 32:

* level 1: the trees are cut into windows of 32 (the zero padding split,
  half before tree 0); ``partial[w, h]`` is the sequential float32 sum, in
  tree order, of the trees of window w whose leaf lies in leaf window
  ``h = leaf // 32`` (``leaf_window``, exact small integers in float32);
* the [W, H] grid of partials is reduced the same way while an axis is
  longer than 32: windows of 32 with the padding centred, each summed in
  row-major order (an axis of 32 or fewer is one window);
* a grid of at most 32 x 32 is summed sequentially in row-major order;
* boosted: ``fma(eta, total, base)``, rounded once; forest:
  ``total * f32(1 / T)``.

Where the reference reads the leaf table by a gather instead of the select
(``leaf_windows`` says where), the leaves form one window.

On a CUDA tensor each wrapper launches the hand-written kernel
(``csrc/tree_sum.cu``) or raises; on a CPU tensor it runs the plain
version (``tree_sum_plain``, ``tree_sum_device_route_plain``: Python loops
of float32 adds in the same order). Both give the same bits: the kernel's
adds are ``__fadd_rn`` in the same order, and its epilogues use the
``_rn`` intrinsics, which are never contracted or split.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import cuda_build

_KERNEL = "tree_sum"

#: XLA's reduction window on the CPU
WINDOW = 32
#: the reference's one-hot lookup limits (``trees._use_onehot``): a leaf
#: table at most this wide, or with index count x width within the budget,
#: is read through a one-hot select, whose reduction windows the leaves
ONEHOT_MAX_WIDTH = 512
ONEHOT_OPS_BUDGET = 1 << 28
#: the kernel's device-route mode streams at most three levels of windows:
#: up to 32 * 32 * 32 trees and 2^15 leaves
MAX_ROUTE_TREES = WINDOW ** 3
MAX_ROUTE_WINDOWS = WINDOW ** 2


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


def leaf_windows(n: int, depth: int) -> int:
    """The leaf windows H of the device route for a batch of ``n`` rows
    over trees of ``depth``: 2^depth / 32 (at least 1) where the reference
    reads the leaf table through its one-hot select, 1 where it gathers."""
    width = 1 << depth
    if width > ONEHOT_MAX_WIDTH and n * width > ONEHOT_OPS_BUDGET:
        return 1
    return max(1, width // WINDOW)


def _centred(n: int) -> tuple[int, int, int]:
    """(window, windows, leading zeros) of one axis of length ``n``."""
    if n <= WINDOW:
        return n, 1, 0
    count = -(-n // WINDOW)
    return WINDOW, count, (count * WINDOW - n) // 2


def _grid_sum(grid: torch.Tensor) -> torch.Tensor:
    """[A, B, N] float32 -> [N]: XLA's windowed reduction of the grid's two
    leading axes (windows of 32, padding centred, each in row-major order),
    repeated until both axes are 32 or shorter, then a row-major sum."""
    while grid.shape[0] > WINDOW or grid.shape[1] > WINDOW:
        a, b, n = grid.shape
        wa, na, la = _centred(a)
        wb, nb, lb = _centred(b)
        pad = grid.new_zeros((na * wa, nb * wb, n))
        pad[la:la + a, lb:lb + b] = grid
        cells = pad.reshape(na, wa, nb, wb, n).permute(0, 2, 1, 3, 4) \
            .reshape(na, nb, wa * wb, n)
        grid = torch.zeros((na, nb, n), dtype=torch.float32, device=grid.device)
        for i in range(wa * wb):
            grid = grid + cells[:, :, i]
    flat = grid.reshape(-1, grid.shape[-1])
    acc = torch.zeros(flat.shape[1], dtype=torch.float32, device=flat.device)
    for i in range(flat.shape[0]):
        acc = acc + flat[i]
    return acc


def _fma32(a: float, x: torch.Tensor, c: float) -> torch.Tensor:
    """float32 ``a * x + c`` rounded once (a fused multiply-add), in float64
    ops: the product of two float32 values is exact there, the sum is taken
    exactly as a float64 value and its error (two-sum), rounded to odd, and
    the odd-rounded value then rounds to float32 as the exact one would."""
    a, c = float(np.float32(a)), float(np.float32(c))
    p = x.double() * a
    s = p + c
    back = s - p
    err = (p - (s - back)) + (c - back)
    even = (s.view(torch.int64) & 1) == 0
    fix = (err != 0) & torch.isfinite(err) & even
    toward = torch.where(err > 0, torch.inf, -torch.inf).double()
    return torch.where(fix, torch.nextafter(s, toward), s).float()


def _reciprocal(t: int) -> float:
    """f32(1 / T), the forest mean's factor: one float32 division (inf for
    no trees, whose mean is then NaN, as 0 / 0 is)."""
    with np.errstate(divide="ignore"):
        return float(np.float32(1.0) / np.float32(t))


def tree_sum_device_route_plain(per_tree: torch.Tensor,
                                leaf_window: torch.Tensor | None,
                                num_windows: int, boosted: bool,
                                eta: float = 0.0,
                                base_score: float = 0.0) -> torch.Tensor:
    """``tree_sum_device_route``'s contract in plain PyTorch, on the
    tensor's device: the level-1 partials by one scatter-add a tree (each
    row's cell takes one float32 add), then ``_grid_sum``."""
    n, t = per_tree.shape
    _, tcount, lo = _centred(t)
    grid = torch.zeros((tcount * num_windows, n), dtype=torch.float32,
                       device=per_tree.device)
    for j in range(t):
        w = (j + lo) // WINDOW
        if num_windows == 1:
            grid[w] = grid[w] + per_tree[:, j]
        else:
            cell = w * num_windows + leaf_window[:, j].long()
            grid.scatter_add_(0, cell[None], per_tree[None, :, j])
    total = _grid_sum(grid.reshape(tcount, num_windows, n))
    if boosted:
        return _fma32(eta, total, base_score)
    return total * _scalar(_reciprocal(t), total)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library(_KERNEL)
    lib.tp_tree_sum.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    lib.tp_tree_sum_device_route.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    for fn in (lib.tp_tree_sum, lib.tp_tree_sum_device_route):
        fn.restype = ctypes.c_int
    lib.tp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _on_cuda(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.tp_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


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
    _raise_on(lib, rc, "tree_sum")
    if n:
        tree_sum.launches += 1
    return out


#: kernel launches since the last reset (the plain version is not counted)
tree_sum.launches = 0


def _check_route(per_tree, leaf_window, num_windows: int) -> None:
    _check(per_tree)
    n, t = per_tree.shape
    if num_windows < 1 or num_windows > MAX_ROUTE_WINDOWS:
        raise ValueError(f"tree_sum_device_route: {num_windows} leaf windows "
                         f"(1..{MAX_ROUTE_WINDOWS})")
    if t > MAX_ROUTE_TREES:
        raise ValueError(f"tree_sum_device_route: {t} trees (at most "
                         f"{MAX_ROUTE_TREES})")
    if num_windows == 1:
        if leaf_window is not None:
            raise ValueError("tree_sum_device_route: one leaf window takes "
                             "no leaf_window array")
        return
    _check(leaf_window)
    if leaf_window.shape != per_tree.shape \
            or leaf_window.device != per_tree.device:
        raise ValueError(
            f"tree_sum_device_route: leaf_window {tuple(leaf_window.shape)} "
            f"on {leaf_window.device} != per_tree {tuple(per_tree.shape)} on "
            f"{per_tree.device}")


def tree_sum_device_route(per_tree: torch.Tensor,
                          leaf_window: torch.Tensor | None, num_windows: int,
                          boosted: bool, eta: float = 0.0,
                          base_score: float = 0.0) -> torch.Tensor:
    """[N, T] float32 leaf values -> [N] float32 in the reference's
    device-route order (module docstring): ``fma(eta, total, base_score)``
    or ``total * f32(1 / T)``. ``leaf_window`` [N, T] float32 holds each
    (row, tree)'s leaf // 32, integers in [0, num_windows); with one window
    (``leaf_windows``) it is None and not read."""
    _check_route(per_tree, leaf_window, num_windows)
    if not _on_cuda(per_tree):
        return tree_sum_device_route_plain(per_tree, leaf_window, num_windows,
                                           boosted, eta, base_score)
    lib = _library()
    n, t = per_tree.shape
    out = torch.empty(n, dtype=torch.float32, device=per_tree.device)
    rc = lib.tp_tree_sum_device_route(
        per_tree.data_ptr(),
        None if leaf_window is None else leaf_window.data_ptr(),
        out.data_ptr(), n, t, num_windows, int(bool(boosted)),
        float(base_score), float(eta), _reciprocal(t),
        torch._C._cuda_getCurrentRawStream(per_tree.device.index),
    )
    _raise_on(lib, rc, "tree_sum_device_route")
    if n:
        tree_sum_device_route.launches += 1
    return out


#: kernel launches since the last reset (the plain version is not counted)
tree_sum_device_route.launches = 0
