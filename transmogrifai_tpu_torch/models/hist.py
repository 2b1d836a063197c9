"""Gradient histograms for tree growth: the port of ``models/hist_pallas.py``
(kernel K2) and of the one-hot GEMM histogram in ``models/trees.py``.

Every histogram here computes the same function::

    hist[k, m, f, b] = (sum of grad[k, r], sum of hess[k, r])
                       over rows r with node[k, r] == m and binned[r, f] == b

-> [K, M, F, B, 2] float32, for codes ``binned`` [N, F] int32 in [0, B)
shared by the K fits, node slots ``node`` [K, N] int32 (-1, and any slot
>= M, is dead: it adds nothing) and ``grad``/``hess`` [K, N] float32.

* ``build_histogram_scatter_batched`` is the plain version: one
  ``index_add_`` per fit, which sums every cell in ascending row order.
* ``build_histogram_binloop`` is K2. On a CUDA tensor it launches the
  hand-written kernel ``csrc/hist_binloop.cu`` (built at first use) or
  raises; on a CPU tensor it runs the plain version. The kernel also sums
  every cell in ascending row order, so the two agree bit for bit and the
  result never depends on scheduling (the rows it leaves out, those of
  zero grad and hess, change no sum: see ``node_order``).
* ``build_histogram_gemm`` is the reference's formulation for small row
  counts: a node one-hot [K, N, M] times a prebuilt code one-hot
  [N, F*B], as two matrix products. It runs in float64 (which TF32 never
  touches, whatever the caller's matmul settings) and rounds to float32.

``histogram_route`` is the reference's policy (``trees.py:333``,
``:444-464``), applied by tensor device: the plain version on the CPU; on
the card the GEMM pair up to ``GEMM_MAX_ROWS`` rows, K2 above that for up
to ``BINLOOP_MAX_BINS`` bins, and for more bins the lane-packed kernel K3,
which is not ported yet, so that raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build

_KERNEL = "hist_binloop"
#: the reference builds histograms as one-hot GEMMs up to this many rows
GEMM_MAX_ROWS = 4096
#: the bin-loop kernel's range; wider sketches take the lane-packed K3
BINLOOP_MAX_BINS = 64


def histogram_route(device: torch.device, num_rows: int, num_bins: int) -> str:
    """'scatter', 'gemm' or 'binloop': the implementation the reference's
    policy picks for this device and shape. Raises where that is K3."""
    if device.type == "cpu":
        return "scatter"
    if device.type != "cuda":
        raise ValueError(f"histograms: unsupported device {device}")
    if num_rows <= GEMM_MAX_ROWS:
        return "gemm"
    if num_bins <= BINLOOP_MAX_BINS:
        return "binloop"
    raise NotImplementedError(
        f"histograms with {num_bins} > {BINLOOP_MAX_BINS} bins above "
        f"{GEMM_MAX_ROWS} rows take the lane-packed kernel K3 "
        "(hist_pallas._build_histogram_pallas_batched), which is not ported "
        "yet (ROADMAP.md, section B)"
    )


def _check(binned, node, grad, hess, num_nodes, num_bins) -> None:
    for name, x, want in (
        ("binned", binned, torch.int32), ("node", node, torch.int32),
        ("grad", grad, torch.float32), ("hess", hess, torch.float32),
    ):
        if not isinstance(x, torch.Tensor) or x.dtype != want:
            raise TypeError(
                f"histogram: {name} must be a {want} tensor, got "
                f"{getattr(x, 'dtype', type(x).__name__)}"
            )
        if not x.is_contiguous():
            raise ValueError(f"histogram: {name} must be contiguous")
        if x.device != binned.device:
            raise ValueError(
                f"histogram: {name} is on {x.device}, binned on {binned.device}"
            )
    if binned.dim() != 2 or node.dim() != 2:
        raise ValueError(
            f"histogram: binned [N, F] and node [K, N] expected, got "
            f"{tuple(binned.shape)} and {tuple(node.shape)}"
        )
    if node.shape[1] != binned.shape[0]:
        raise ValueError(
            f"histogram: node has {node.shape[1]} rows, binned {binned.shape[0]}"
        )
    if grad.shape != node.shape or hess.shape != node.shape:
        raise ValueError(
            f"histogram: grad {tuple(grad.shape)} / hess {tuple(hess.shape)} "
            f"!= node {tuple(node.shape)}"
        )
    if num_nodes < 1 or num_bins < 1:
        raise ValueError(
            f"histogram: num_nodes {num_nodes} and num_bins {num_bins} must be >= 1"
        )
    n, f = binned.shape
    k = node.shape[0]
    if max(n * f, k * n, k * num_nodes * f * num_bins * 2) >= 2**31:
        raise ValueError("histogram: more than 2^31 elements in one array")


def build_histogram_scatter_batched(
    binned: torch.Tensor, node: torch.Tensor, grad: torch.Tensor,
    hess: torch.Tensor, num_nodes: int, num_bins: int,
) -> torch.Tensor:
    """The plain version: per fit, one ``index_add_`` over the flattened
    (row, feature) cells, in ascending row order. Runs in the dtype of
    ``grad`` (float64 gives the card's yardstick)."""
    n, f = binned.shape
    k_fits = node.shape[0]
    size = num_nodes * f * num_bins
    cols = torch.arange(f, device=binned.device)
    out = torch.zeros((k_fits, 2, size), dtype=grad.dtype, device=grad.device)
    for k in range(k_fits):
        live = (node[k] >= 0) & (node[k] < num_nodes)
        rows = torch.nonzero(live).flatten()
        flat = (
            (node[k, rows].long()[:, None] * f + cols) * num_bins
            + binned[rows].long()
        ).flatten()
        for v, vals in enumerate((grad[k, rows], hess[k, rows])):
            out[k, v].index_add_(0, flat, vals.repeat_interleave(f))
    return out.reshape(k_fits, 2, num_nodes, f, num_bins).permute(
        0, 2, 3, 4, 1
    ).contiguous()


def codes_one_hot(binned: torch.Tensor, num_bins: int) -> torch.Tensor:
    """The loop-invariant [N, F*B] code one-hot of the GEMM path, float64
    (0/1 is exact in every type, so the reference's bf16 copy under
    ``lowp`` holds the same values)."""
    n, f = binned.shape
    out = torch.zeros((n, f * num_bins), dtype=torch.float64, device=binned.device)
    idx = binned.long() + torch.arange(f, device=binned.device) * num_bins
    out.scatter_(1, idx, 1.0)
    return out


def build_histogram_gemm(
    codes1h: torch.Tensor, node: torch.Tensor, grad: torch.Tensor,
    hess: torch.Tensor, num_nodes: int, num_bins: int, lowp: bool = False,
) -> torch.Tensor:
    """[K, M, F, B, 2] as two one-hot products, ``trees.py:409-430``:
    (node one-hot * g) [K, M, N] @ codes one-hot [N, F*B]. With ``lowp`` the
    weighted one-hots are rounded to bfloat16 first, as the reference feeds
    them to its bf16 product; the sums run in float64 and round to f32."""
    k_fits, n = node.shape
    f = codes1h.shape[1] // num_bins
    live = (node >= 0) & (node < num_nodes)
    node1h = torch.zeros((k_fits, num_nodes, n), dtype=torch.float32,
                         device=node.device)
    node1h.scatter_(
        1, torch.where(live, node, 0).long()[:, None, :],
        live.to(torch.float32)[:, None, :],
    )
    outs = []
    for v in (grad, hess):
        w = node1h * v[:, None, :]
        if lowp:
            w = w.to(torch.bfloat16)
        outs.append(torch.matmul(w.to(torch.float64), codes1h).to(torch.float32))
    return torch.stack(outs, dim=-1).reshape(k_fits, num_nodes, f, num_bins, 2)


def _on_cuda(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library(_KERNEL)
    fn = lib.tp_hist_binloop
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def node_order(node: torch.Tensor, num_nodes: int, grad: torch.Tensor,
               hess: torch.Tensor):
    """(order [K, N] int32, start [K, M] int32, count [K, M] int32): the
    live rows of each fit sorted by node slot, ascending row order within a
    slot (a stable sort), and where each slot's run starts and how long it
    is. Dead rows (-1, or >= M) sort to the end and belong to no run.

    Rows whose grad and hess are both zero (rows a fold or a bootstrap
    draw left out) are dead too: a sequential f32 sum starts at +0.0 and
    never becomes -0.0, and adding +0.0 or -0.0 to it leaves its bits
    unchanged, so dropping them changes no cell."""
    k_fits, _ = node.shape
    live = (node >= 0) & (node < num_nodes) & ((grad != 0) | (hess != 0))
    key = torch.where(live, node, num_nodes).long()
    order = torch.sort(key, dim=1, stable=True).indices.to(torch.int32)
    count = torch.zeros((k_fits, num_nodes + 1), dtype=torch.int64,
                        device=node.device)
    count.scatter_add_(1, key, torch.ones_like(key))
    start = torch.cumsum(count, dim=1) - count
    return (
        order.contiguous(),
        start[:, :num_nodes].to(torch.int32).contiguous(),
        count[:, :num_nodes].to(torch.int32).contiguous(),
    )


def build_histogram_binloop(
    binned: torch.Tensor, node: torch.Tensor, grad: torch.Tensor,
    hess: torch.Tensor, num_nodes: int, num_bins: int,
) -> torch.Tensor:
    """K2: hist [K, num_nodes, F, num_bins, 2] float32, the contract of
    ``hist_pallas.build_histogram_pallas_binloop``. The reference's ``lowp``
    has no counterpart: the kernel sums in float32 directly, with no bf16
    split to skip."""
    _check(binned, node, grad, hess, num_nodes, num_bins)
    if not _on_cuda(binned):
        if binned.device.type != "cpu":
            raise ValueError(f"histogram: unsupported device {binned.device}")
        return build_histogram_scatter_batched(
            binned, node, grad, hess, num_nodes, num_bins
        )
    if num_bins > BINLOOP_MAX_BINS:
        raise ValueError(
            f"hist_binloop: {num_bins} bins > {BINLOOP_MAX_BINS}; see "
            "histogram_route"
        )
    lib = _library()
    n, f = binned.shape
    k_fits = node.shape[0]
    order, start, count = node_order(node, num_nodes, grad, hess)
    out = torch.empty((k_fits, num_nodes, f, num_bins, 2), dtype=torch.float32,
                      device=binned.device)
    stream = torch.cuda.current_stream(binned.device).cuda_stream
    rc = lib.tp_hist_binloop(
        binned.data_ptr(), order.data_ptr(), start.data_ptr(),
        count.data_ptr(), grad.data_ptr(), hess.data_ptr(), out.data_ptr(),
        n, f, k_fits, num_nodes, num_bins, stream,
    )
    if rc != 0:
        msg = lib.tp_cuda_error_string(rc).decode()
        raise RuntimeError(f"hist_binloop kernel launch failed: {msg} ({rc})")
    build_histogram_binloop.launches += 1
    return out


#: kernel launches since the last reset (the plain CPU version is not counted)
build_histogram_binloop.launches = 0
