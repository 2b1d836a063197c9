"""Gradient histograms and split search for tree growth: the port of
``models/hist_pallas.py`` (kernels K2, K3 and K4) and of the one-hot GEMM
histogram and the split search in ``models/trees.py``.

Every histogram here computes the same function::

    hist[k, m, f, b] = (sum of grad[k, r], sum of hess[k, r])
                       over rows r with node[k, r] == m and binned[r, f] == b

-> [K, M, F, B, 2] float32, for codes ``binned`` [N, F] int32 in [0, B)
shared by the K fits, node slots ``node`` [K, N] int32 (-1, and any slot
>= M, is dead: it adds nothing) and ``grad``/``hess`` [K, N] float32.

* ``build_histogram_scatter_batched`` is the plain version: one
  ``index_add_`` per fit, which sums every cell in ascending row order.
* ``build_histogram_binloop`` is K2 (up to ``BINLOOP_MAX_BINS`` bins) and
  ``build_histogram_wide`` is K3 (any bin count up to
  ``HIST_WIDE_MAX_BINS``). On a CUDA tensor each launches its hand-written
  kernel (``csrc/hist_binloop.cu``, ``csrc/hist_wide.cu``, built at first
  use) or raises; on a CPU tensor it runs the plain version. Both kernels
  also sum every cell in ascending row order, so they agree with the plain
  version bit for bit and never depend on scheduling (the rows they leave
  out, those of zero grad and hess, change no sum: see ``node_order``).
  Both walk each slot's rows in the order ``node_order`` gives (a stable
  counting sort by slot, ``csrc/node_order.cu`` on the card); a caller
  that builds several histograms over the same slots passes that order in
  once (``order=``), as the grower does per node chunk.
* ``build_histogram_gemm`` is the reference's formulation for small row
  counts: a node one-hot [K, N, M] times a prebuilt code one-hot
  [N, F*B], as two matrix products, in float64 (which TF32 never touches,
  whatever the caller's matmul settings) rounded to float32. No route
  takes it: it stays as the yardstick that ``chip_smoke.py`` times the
  kernels against.

``split_search`` turns a histogram into each slot's best split, in the
reference's arithmetic order; the grower calls it after every histogram.
On the card it is one launch of the split-search kernel
(``csrc/split_search.cu``: K4's split stage over the histogram K2 or K3
wrote, skipping the slots that hold no row); on the CPU its plain version
(``split_search_plain``). ``build_best_split`` is K4, the reference's
fused histogram and split search (``csrc/best_split.cu`` on the card, the
same split stage over cells it builds in shared memory; on the CPU the
scatter histogram followed by ``split_search_plain``). As in the
reference, the grower never calls it.

``histogram_route`` picks by tensor device: the plain version on the CPU;
on the card K2 up to ``BINLOOP_MAX_BINS`` bins and K3 for more, at every
row count. The reference builds histograms of 4096 rows or fewer as
one-hot GEMMs (``trees.py:333``); the kernels sum every cell in f32 in
ascending row order, as the JAX package's own sums on the CPU do, where a
float64 product rounded to f32 can differ in the last ulp and flip a split
at a near-tie.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build

#: the bin-loop kernel's range; wider sketches take K3
BINLOOP_MAX_BINS = 64
#: K3 keeps one feature's cells in shared memory: its bin-count limit
HIST_WIDE_MAX_BINS = 16384
#: K4's domain: the reference's 128-lane bin packing
FUSED_SPLIT_MAX_BINS = 128

_HIST_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
#: each kernel library's C entry point and argument types
_ENTRY = {
    "node_order": ("tp_node_order", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p]),
    "hist_binloop": ("tp_hist_binloop", _HIST_ARGS),
    "hist_wide": ("tp_hist_wide", _HIST_ARGS),
    "split_search": ("tp_split_search", [ctypes.c_void_p] * 5 + [ctypes.c_int]
                     + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                     + [ctypes.c_void_p]),
    "best_split": (
        "tp_best_split",
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    ),
}


def histogram_route(device: torch.device, num_bins: int) -> str:
    """'scatter', 'binloop' or 'wide': the implementation for this device
    and bin count, the same at every row count."""
    if device.type == "cpu":
        return "scatter"
    if device.type != "cuda":
        raise ValueError(f"histograms: unsupported device {device}")
    return "binloop" if num_bins <= BINLOOP_MAX_BINS else "wide"


def _check(binned, node, grad, hess, num_nodes, num_bins,
           padded_rows: bool = False) -> None:
    """Types, shapes and devices of a histogram's inputs; with
    ``padded_rows`` ``binned`` may be a view of the first F columns of a
    row-major array with longer rows (``pad_codes``)."""
    for name, x, want in (
        ("binned", binned, torch.int32), ("node", node, torch.int32),
        ("grad", grad, torch.float32), ("hess", hess, torch.float32),
    ):
        if not isinstance(x, torch.Tensor) or x.dtype != want:
            raise TypeError(
                f"histogram: {name} must be a {want} tensor, got "
                f"{getattr(x, 'dtype', type(x).__name__)}"
            )
        rows_ok = (name == "binned" and padded_rows and x.dim() == 2
                   and x.stride(1) == 1 and x.stride(0) >= x.shape[1])
        if not (x.is_contiguous() or rows_ok):
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


def pad_codes(binned: torch.Tensor) -> torch.Tensor:
    """``binned`` [N, F] as a view of the first F columns of a zero-padded
    [N, F'] int32 array, F' = F rounded up to a multiple of 4: its rows are
    16-byte aligned, so K2 copies its codes 16 bytes at a time."""
    n, f = binned.shape
    padded = torch.zeros((n, -(-f // 4) * 4), dtype=torch.int32,
                         device=binned.device)
    padded[:, :f] = binned
    return padded[:, :f]


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


# --------------------------------------------------------------------------
# the split search, in the order XLA's CPU backend takes the reference's
# reductions (so that where the histograms agree, the splits agree)
# --------------------------------------------------------------------------
#: XLA's CPU backend reduces a long axis in windows of this many elements
_REDUCE_WINDOW = 32
#: ... and takes ``jnp.cumsum`` in blocks of this many elements
_CUMSUM_BLOCK = 16


def _seq_sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, one element after another from 0."""
    tot = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        tot = tot + x[..., j]
    return tot


def _xla_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in the order XLA's CPU backend takes a reduction:
    an axis longer than 32 is zero-padded to whole windows of 32 (half the
    padding in front), each window summed in order, and the window sums
    reduced the same way, until 32 or fewer remain and are summed in order."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > _REDUCE_WINDOW:
        n = x.shape[-1]
        nb = -(-n // _REDUCE_WINDOW)
        pad = nb * _REDUCE_WINDOW - n
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = _seq_sum_last(x.reshape(*x.shape[:-1], nb, _REDUCE_WINDOW))
    return _seq_sum_last(x)


def _cumsum_bins(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over axis 3 of [K, M, F, B, ...], in the order
    XLA's CPU backend takes ``jnp.cumsum``: sequential within blocks of 16
    bins (zero-padded at the end), each block then offset by the cumsum of
    the block totals before it, itself taken the same way (so sequentially
    up to 16 blocks, 256 bins). Exact f32 adds in a fixed order on every
    device, so an empty bin repeats its neighbour's value exactly, and a
    prefix of the input has the same cumsum as a prefix of the output."""
    b = x.shape[3]
    blk_len = _CUMSUM_BLOCK
    if b <= blk_len:
        w = x.clone()
        for j in range(1, b):
            w[:, :, :, j] += w[:, :, :, j - 1]
        return w
    nb = -(-b // blk_len)
    pad = nb * blk_len - b
    xp = x if pad == 0 else torch.cat(
        [x, x.new_zeros((*x.shape[:3], pad, *x.shape[4:]))], dim=3
    )
    w = xp.reshape(*x.shape[:3], nb, blk_len, *x.shape[4:]).clone()
    for j in range(1, blk_len):
        w[:, :, :, :, j] += w[:, :, :, :, j - 1]
    totals = _cumsum_bins(w[:, :, :, :, blk_len - 1])
    w[:, :, :, 1:] += totals[:, :, :, :-1].unsqueeze(4)
    return w.reshape(*xp.shape)[:, :, :, :b]


def _empty_slot_split(gmask, lam, gam, mcw, len_):
    """(gain [K], flat index [K]) of a slot that holds no row: its
    histogram is all zeros, so every prefix and total is +0 and every
    threshold of an enabled feature has one gain, that of zeros; the first
    enabled feature's threshold 0 wins where that gain beats -inf (or is
    NaN), else index 0 at -inf."""
    zero = torch.zeros_like(lam)
    parent = zero * zero / (zero + lam)
    g = 0.5 * (zero * zero / (zero + lam) + zero * zero / (zero + lam)
               - parent) - gam
    g = torch.where((zero >= mcw) & (zero >= mcw), g,
                    torch.full_like(g, -torch.inf))
    on = gmask > 0
    first = torch.argmax(on.to(torch.int32), dim=1)
    wins = on.any(dim=1) & ((g > -torch.inf) | torch.isnan(g))
    return (torch.where(wins, g, torch.full_like(g, -torch.inf)),
            torch.where(wins, first * len_, 0))


def split_search_plain(hist: torch.Tensor, gmask: torch.Tensor,
                       lam: torch.Tensor, gam: torch.Tensor, mcw: torch.Tensor,
                       count: torch.Tensor | None = None):
    """``split_search``'s plain version (the reference's arithmetic in
    PyTorch ops, on the tensor's device); with ``count`` the slots whose
    count is 0 take ``_empty_slot_split``'s result instead."""
    k_fits, m = hist.shape[:2]
    b = hist.shape[3]
    lam, gam, mcw = (v.reshape(-1).expand(k_fits) for v in (lam, gam, mcw))
    lam4, gam4, mcw4 = (v[:, None, None, None] for v in (lam, gam, mcw))
    # the prefix sums split search reads, bins [0, B-1): the last bin's
    # prefix is the total, and no earlier prefix depends on it
    csum = _cumsum_bins(hist[:, :, :, :-1])
    tot = _xla_sum(hist, 3).unsqueeze(3)
    gl, hl = csum[..., 0], csum[..., 1]
    gt, ht = tot[..., 0], tot[..., 1]
    gr = gt - gl
    hr = ht - hl
    parent = (gt * gt) / (ht + lam4)
    gain = 0.5 * (gl * gl / (hl + lam4) + gr * gr / (hr + lam4) - parent) - gam4
    valid = (hl >= mcw4) & (hr >= mcw4) & (gmask[:, None, :, None] > 0)
    gain = torch.where(valid, gain, torch.full_like(gain, -torch.inf))
    flat = gain.reshape(k_fits, m, -1)
    best = torch.argmax(flat, dim=2)
    best_gain = torch.gather(flat, 2, best[..., None])[..., 0]
    if count is not None:
        eg, ei = _empty_slot_split(gmask, lam, gam, mcw, b - 1)
        empty = count == 0
        best_gain = torch.where(empty, eg[:, None], best_gain)
        best = torch.where(empty, ei[:, None], best)
    return (best_gain, (best // (b - 1)).to(torch.int32),
            (best % (b - 1)).to(torch.int32))


def _knob(v: torch.Tensor, k_fits: int, device, name: str) -> torch.Tensor:
    """A [1] or [K] float32 knob of the split search, as the kernel reads it
    (one value for every fit, or one per fit)."""
    if isinstance(v, torch.Tensor):
        v = v.reshape(-1)
    if (not isinstance(v, torch.Tensor) or v.dtype != torch.float32
            or v.shape[0] not in (1, k_fits) or v.device != device):
        raise ValueError(f"split_search: {name} must be a float32 [1] or "
                         f"[{k_fits}] tensor on {device}")
    return v.contiguous()


def split_search(hist: torch.Tensor, gmask: torch.Tensor, lam: torch.Tensor,
                 gam: torch.Tensor, mcw: torch.Tensor,
                 count: torch.Tensor | None = None):
    """(best_gain [K, M] f32, best_feat, best_bin [K, M] int32) over a
    histogram [K, M, F, B, 2] (2 <= B <= ``HIST_WIDE_MAX_BINS``), the
    reference's two-phase split search (``trees.py:469-493``): prefix sums
    over bins 0..B-2, the bin total, the XGBoost gain
    ``0.5·(GL²/(HL+λ) + GR²/(HR+λ) − G²/(H+λ)) − γ`` with per-fit ``lam``,
    ``gam``, ``mcw`` ([K] or [1] f32), -inf where a child weighs less than
    ``mcw`` or ``gmask`` [K, F] disables the feature, and the first flat
    (feature, bin) index at the maximum (a NaN counts as the maximum, as
    ``argmax`` takes it). Where every gain is -inf the index is 0.
    ``count`` [K, M] (``node_order``'s) marks the slots that hold no row;
    their histogram is all zeros and is not read.

    On a CUDA tensor one launch of the split-search kernel
    (``csrc/split_search.cu``), which computes what ``split_search_plain``
    computes in the same order, bit for bit; on a CPU tensor the plain
    version."""
    if (not isinstance(hist, torch.Tensor) or hist.dtype != torch.float32
            or hist.dim() != 5 or hist.shape[4] != 2
            or not hist.is_contiguous()):
        raise ValueError("split_search: hist must be a contiguous float32 "
                         "[K, M, F, B, 2] tensor")
    k_fits, m, f, b, _ = hist.shape
    dev = hist.device
    if b < 2 or b > HIST_WIDE_MAX_BINS:
        raise ValueError(f"split_search: {b} bins; a split needs 2 to "
                         f"{HIST_WIDE_MAX_BINS} (HIST_WIDE_MAX_BINS)")
    if (not isinstance(gmask, torch.Tensor) or gmask.dtype != torch.float32
            or tuple(gmask.shape) != (k_fits, f) or gmask.device != dev):
        raise ValueError(f"split_search: gmask must be a float32 [{k_fits}, "
                         f"{f}] tensor on {dev}")
    lam, gam, mcw = (_knob(v, k_fits, dev, name) for v, name in
                     ((lam, "lam"), (gam, "gam"), (mcw, "mcw")))
    if count is not None and (
            not isinstance(count, torch.Tensor) or count.dtype != torch.int32
            or tuple(count.shape) != (k_fits, m) or count.device != dev
            or not count.is_contiguous()):
        raise ValueError(f"split_search: count must be a contiguous int32 "
                         f"[{k_fits}, {m}] tensor on {dev}")
    if _plain_on_cpu(hist):
        return split_search_plain(hist, gmask, lam, gam, mcw, count)
    gmask = gmask.contiguous()
    _library("split_search")  # build or load before any work is queued
    gain = torch.empty((k_fits, m), dtype=torch.float32, device=dev)
    feat = torch.empty((k_fits, m), dtype=torch.int32, device=dev)
    bin_ = torch.empty_like(feat)
    # a knob's stride over the fits: 0 for one value shared by all
    strides = sum(int(v.shape[0] > 1) << i for i, v in enumerate((lam, gam, mcw)))
    _launch(
        "split_search", hist.data_ptr(), gmask.data_ptr(), lam.data_ptr(),
        gam.data_ptr(), mcw.data_ptr(), strides,
        None if count is None else count.data_ptr(), gain.data_ptr(),
        feat.data_ptr(), bin_.data_ptr(), k_fits, m, f, b,
        torch._C._cuda_getCurrentRawStream(dev.index),
    )
    cuda_build.count_launch(split_search)
    return gain, feat, bin_


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------
def _on_cuda(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    lib = cuda_build.load_library(name)
    entry, argtypes = _ENTRY[name]
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.tp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, *args) -> None:
    """Launch kernel ``name`` on the current stream, raising on a refused
    launch."""
    lib = _library(name)
    rc = getattr(lib, _ENTRY[name][0])(*args)
    if rc != 0:
        msg = lib.tp_cuda_error_string(rc).decode()
        raise cuda_build.KernelLaunchError(f"{name} kernel launch failed: {msg} ({rc})")


def node_order_plain(node: torch.Tensor, num_nodes: int, grad: torch.Tensor,
                     hess: torch.Tensor):
    """``node_order``'s plain version: a stable ``torch.sort`` of the keys
    (the slot, or M for a dead row), a ``scatter_add_`` of the counts and a
    ``cumsum``."""
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


def _check_rows(node, grad, hess, num_nodes) -> None:
    for name, x, want in (("node", node, torch.int32),
                          ("grad", grad, torch.float32),
                          ("hess", hess, torch.float32)):
        if not isinstance(x, torch.Tensor) or x.dtype != want:
            raise TypeError(
                f"node_order: {name} must be a {want} tensor, got "
                f"{getattr(x, 'dtype', type(x).__name__)}"
            )
        if not x.is_contiguous() or x.dim() != 2:
            raise ValueError(f"node_order: {name} must be a contiguous [K, N] "
                             "tensor")
        if x.device != node.device:
            raise ValueError(f"node_order: {name} is on {x.device}, node on "
                             f"{node.device}")
    if grad.shape != node.shape or hess.shape != node.shape:
        raise ValueError(
            f"node_order: grad {tuple(grad.shape)} / hess {tuple(hess.shape)} "
            f"!= node {tuple(node.shape)}"
        )
    if num_nodes < 1:
        raise ValueError(f"node_order: num_nodes {num_nodes} must be >= 1")


def node_order(node: torch.Tensor, num_nodes: int, grad: torch.Tensor,
               hess: torch.Tensor):
    """(order [K, N] int32, start [K, M] int32, count [K, M] int32): the
    live rows of each fit sorted by node slot, ascending row order within a
    slot (a stable sort), and where each slot's run starts and how long it
    is. Dead rows (-1, or >= M) sort to the end and belong to no run: the
    tail holds them in ascending row order, so all three arrays equal
    ``node_order_plain``'s, on the card (``csrc/node_order.cu``, a stable
    counting sort) as on the CPU.

    Rows whose grad and hess are both zero (rows a fold or a bootstrap
    draw left out) are dead too: a sequential f32 sum starts at +0.0 and
    never becomes -0.0, and adding +0.0 or -0.0 to it leaves its bits
    unchanged, so dropping them changes no cell."""
    _check_rows(node, grad, hess, num_nodes)
    if _plain_on_cpu(node):
        return node_order_plain(node, num_nodes, grad, hess)
    k_fits, n = node.shape
    dev = node.device
    if k_fits * n >= 2**31:
        raise ValueError("node_order: more than 2^31 rows in all")
    _library("node_order")  # build or load before any work is queued
    order = torch.empty((k_fits, n), dtype=torch.int32, device=dev)
    if n == 0 or k_fits == 0:
        zeros = torch.zeros((k_fits, num_nodes), dtype=torch.int32, device=dev)
        return order, zeros, zeros.clone()
    start = torch.empty((k_fits, num_nodes), dtype=torch.int32, device=dev)
    count = torch.empty_like(start)
    _launch(
        "node_order", node.data_ptr(), grad.data_ptr(), hess.data_ptr(),
        order.data_ptr(), start.data_ptr(), count.data_ptr(), n, k_fits,
        num_nodes, torch._C._cuda_getCurrentRawStream(dev.index),
    )
    cuda_build.count_launch(node_order)
    return order, start, count


def _check_order(rows, node, num_nodes) -> None:
    """A precomputed ``node_order`` result must match the slots it sorts."""
    k_fits, n = node.shape
    if len(rows) != 3:
        raise ValueError("histogram: order must be node_order's (order, "
                         "start, count)")
    for name, x, shape in zip(("order", "start", "count"), rows,
                              ((k_fits, n), (k_fits, num_nodes),
                               (k_fits, num_nodes))):
        if (not isinstance(x, torch.Tensor) or x.dtype != torch.int32
                or tuple(x.shape) != shape or not x.is_contiguous()
                or x.device != node.device):
            raise ValueError(
                f"histogram: order's {name} must be a contiguous int32 "
                f"{list(shape)} tensor on {node.device}"
            )


def _sorted_rows_histogram(name, binned, node, grad, hess, num_nodes,
                           num_bins, rows) -> torch.Tensor:
    """Launch histogram kernel ``name`` over ``node_order``'s runs (``rows``,
    or computed here when None)."""
    n, f = binned.shape
    k_fits = node.shape[0]
    _library(name)  # build or load before any work is queued
    if rows is None:
        rows = node_order(node, num_nodes, grad, hess)
    order, start, count = rows
    out = torch.empty((k_fits, num_nodes, f, num_bins, 2), dtype=torch.float32,
                      device=binned.device)
    _launch(
        name, binned.data_ptr(), order.data_ptr(), start.data_ptr(),
        count.data_ptr(), grad.data_ptr(), hess.data_ptr(), out.data_ptr(),
        n, f, binned.stride(0), k_fits, num_nodes, num_bins,
        torch.cuda.current_stream(binned.device).cuda_stream,
    )
    return out


def _plain_on_cpu(x: torch.Tensor) -> bool:
    """True for a CPU tensor (run the plain version), False for a CUDA one
    (launch the kernel); any other device raises."""
    if _on_cuda(x):
        return False
    if x.device.type != "cpu":
        raise ValueError(f"histogram: unsupported device {x.device}")
    return True


def build_histogram_binloop(
    binned: torch.Tensor, node: torch.Tensor, grad: torch.Tensor,
    hess: torch.Tensor, num_nodes: int, num_bins: int, order=None,
) -> torch.Tensor:
    """K2: hist [K, num_nodes, F, num_bins, 2] float32, the contract of
    ``hist_pallas.build_histogram_pallas_binloop``. ``order`` is
    ``node_order(node, num_nodes, grad, hess)``'s result where the caller
    has it (computed here otherwise; the plain version needs none). The
    reference's ``lowp`` has no counterpart: the kernel sums in float32
    directly, with no bf16 split to skip."""
    _check(binned, node, grad, hess, num_nodes, num_bins, padded_rows=True)
    if order is not None:
        _check_order(order, node, num_nodes)
    if _plain_on_cpu(binned):
        return build_histogram_scatter_batched(
            binned, node, grad, hess, num_nodes, num_bins
        )
    if num_bins > BINLOOP_MAX_BINS:
        raise ValueError(
            f"hist_binloop: {num_bins} bins > {BINLOOP_MAX_BINS}; see "
            "histogram_route"
        )
    out = _sorted_rows_histogram("hist_binloop", binned, node, grad, hess,
                                 num_nodes, num_bins, order)
    cuda_build.count_launch(build_histogram_binloop)
    return out


def build_histogram_wide(
    binned: torch.Tensor, node: torch.Tensor, grad: torch.Tensor,
    hess: torch.Tensor, num_nodes: int, num_bins: int, order=None,
) -> torch.Tensor:
    """K3: hist [K, num_nodes, F, num_bins, 2] float32, the contract of
    ``hist_pallas.build_histogram_pallas_batched`` (which the reference
    takes for more than 64 bins), for up to ``HIST_WIDE_MAX_BINS`` bins.
    ``order`` and ``lowp`` as in K2."""
    _check(binned, node, grad, hess, num_nodes, num_bins, padded_rows=True)
    if order is not None:
        _check_order(order, node, num_nodes)
    if _plain_on_cpu(binned):
        return build_histogram_scatter_batched(
            binned, node, grad, hess, num_nodes, num_bins
        )
    if num_bins > HIST_WIDE_MAX_BINS:
        raise ValueError(
            f"hist_wide: {num_bins} bins > {HIST_WIDE_MAX_BINS}, the most "
            "one feature's cells in shared memory can hold"
        )
    out = _sorted_rows_histogram("hist_wide", binned, node, grad, hess,
                                 num_nodes, num_bins, order)
    cuda_build.count_launch(build_histogram_wide)
    return out


def _per_fit(v, k_fits: int, device, name: str) -> torch.Tensor:
    """A scalar, [1] or [K] knob -> contiguous float32 [K] on ``device``."""
    t = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
    if t.shape[0] == 1:
        t = t.expand(k_fits)
    if t.shape[0] != k_fits:
        raise ValueError(f"best_split: {name} has {t.shape[0]} values, not K={k_fits}")
    return t.contiguous()


def best_split_plain(binned, node, grad, hess, feat_mask, reg_lambda, gamma,
                     min_child_weight, num_nodes, num_bins):
    """K4's plain version: the scatter histogram, then ``split_search``;
    ``best_feat`` is -1 (and ``best_bin`` 0) where no gain beats -inf,
    i.e. where no threshold is valid, as in the reference's kernel."""
    k_fits = node.shape[0]
    knobs = (_per_fit(v, k_fits, binned.device, name) for v, name in (
        (reg_lambda, "reg_lambda"), (gamma, "gamma"),
        (min_child_weight, "min_child_weight")))
    hist = build_histogram_scatter_batched(binned, node, grad, hess,
                                           num_nodes, num_bins)
    gain, feat, bin_ = split_search_plain(hist, feat_mask, *knobs)
    none = gain == -torch.inf
    return gain, torch.where(none, -1, feat), torch.where(none, 0, bin_)


def build_best_split(binned, node, grad, hess, feat_mask, reg_lambda, gamma,
                     min_child_weight, num_nodes, num_bins):
    """K4: (best_gain [K, M] f32, best_feat [K, M] i32, best_bin [K, M] i32),
    the contract of ``hist_pallas.build_best_split_pallas``: each slot's
    best split over the features ``feat_mask`` [K, F] (> 0) enables, with
    per-fit ``reg_lambda``, ``gamma`` and ``min_child_weight`` (scalars or
    [K]), the lowest (feature, bin) on equal gain, and ``best_feat = -1``
    where no threshold is valid. Any row count; 2 to
    ``FUSED_SPLIT_MAX_BINS`` bins. The kernel computes what
    ``best_split_plain`` computes, in the same order, bit for bit, over
    ``node_order``'s rows, which it makes first."""
    _check(binned, node, grad, hess, num_nodes, num_bins, padded_rows=True)
    k_fits = node.shape[0]
    n, f = binned.shape
    if (not isinstance(feat_mask, torch.Tensor)
            or feat_mask.dtype != torch.float32
            or tuple(feat_mask.shape) != (k_fits, f)
            or feat_mask.device != binned.device
            or not feat_mask.is_contiguous()):
        raise ValueError(
            f"best_split: feat_mask must be a contiguous float32 [K, F] = "
            f"[{k_fits}, {f}] tensor on {binned.device}"
        )
    if num_bins < 2:
        raise ValueError(f"best_split: a split needs >= 2 bins, got {num_bins}")
    if _plain_on_cpu(binned):
        return best_split_plain(binned, node, grad, hess, feat_mask, reg_lambda,
                                gamma, min_child_weight, num_nodes, num_bins)
    if num_bins > FUSED_SPLIT_MAX_BINS:
        raise ValueError(
            f"best_split: {num_bins} bins > {FUSED_SPLIT_MAX_BINS}, the "
            "kernel's domain (the reference's 128-lane bin packing)"
        )
    dev = binned.device
    lam, gam, mcw = (_per_fit(v, k_fits, dev, name) for v, name in (
        (reg_lambda, "reg_lambda"), (gamma, "gamma"),
        (min_child_weight, "min_child_weight")))
    _library("best_split")  # build or load before any work is queued
    rows, start, count = node_order(node, num_nodes, grad, hess)
    gain = torch.empty((k_fits, num_nodes), dtype=torch.float32, device=dev)
    feat = torch.empty_like(gain, dtype=torch.int32)
    bin_ = torch.empty_like(feat)
    _launch(
        "best_split", binned.data_ptr(), rows.data_ptr(), start.data_ptr(),
        count.data_ptr(), grad.data_ptr(), hess.data_ptr(),
        feat_mask.data_ptr(), lam.data_ptr(), gam.data_ptr(), mcw.data_ptr(),
        gain.data_ptr(), feat.data_ptr(), bin_.data_ptr(), n, f,
        binned.stride(0), k_fits,
        num_nodes, num_bins, torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.count_launch(build_best_split)
    return gain, feat, bin_


#: kernel launches since the last reset (the plain CPU versions are not
#: counted)
node_order.launches = 0
split_search.launches = 0
build_histogram_binloop.launches = 0
build_histogram_wide.launches = 0
build_best_split.launches = 0
