"""Sharded monoid reductions: the map-reduce plane of the statistics (the
port of the JAX package's ``parallel/reductions.py``).

The reference writes every statistic as a commutative-monoid map-reduce
(Statistics.colStats, reduceByKey in SanityChecker.scala:252-348). Here
every rank holds the same global array, takes its block of the rows (the
padded row space split over the mesh's data axis), computes its partial
in float32 on the mesh's device, and the partials are all-reduced in rank
order (``Mesh.all_reduce``), so every rank returns the same bits. The
inputs are arrays or tensors; a tensor on the card stays there.

Padding rows are neutral: zeros for the sums; min and max mask them by
count through a row-validity column, as the reference does. Every
all-reduce runs through the guarded seam, taped under the reduction's
name (``pcolumn_stats.sums``, ...).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.stats import full_f32_matmul
from .mesh import DATA_AXIS, Mesh


def _local(mesh: Mesh, x, dtype=torch.float32):
    """(this rank's rows of ``x`` [rows, D] on the mesh's device in
    ``dtype``, their validity [rows, 1]: 1 on real rows, 0 on padding),
    so that padding drops out of counts, minimum and maximum."""
    x = torch.as_tensor(x)
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    lo, hi, _ = mesh.row_block(n)
    xs = mesh.local_rows(x).to(device=mesh.device, dtype=dtype)
    rows = torch.arange(lo, hi, device=mesh.device)
    return xs, (rows < n).to(dtype)[:, None]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def pcolumn_stats(x, mesh: Mesh) -> dict[str, np.ndarray]:
    """Per-column count/mean/centered-M2/min/max over row-sharded ``x``,
    two passes: sums first, then centred squared deviations (float32
    raw-moment variance cancels for columns with |mean| >> std). Three
    all-reduces: the sums, the range (min and negated max in one), M2."""
    data, v = _local(mesh, x)
    big = torch.finfo(torch.float32).max
    cnt_s = mesh.all_reduce("pcolumn_stats.sums", torch.cat(
        [v.sum().reshape(1), (data * v).sum(dim=0)]))
    lo_hi = mesh.all_reduce("pcolumn_stats.range", torch.cat([
        torch.where(v > 0, data, big).amin(dim=0),
        -torch.where(v > 0, data, -big).amax(dim=0)]), op="min")
    d = data.shape[1]
    cnt = _host(cnt_s[0])
    mean = _host(cnt_s[1:]).astype(np.float64) / max(float(cnt), 1.0)
    c = (data - torch.from_numpy(mean.astype(np.float32)).to(data.device)) * v
    m2 = mesh.all_reduce("pcolumn_stats.m2", (c * c).sum(dim=0))
    return {"count": cnt, "mean": mean,
            "m2": _host(m2).astype(np.float64),
            "min": _host(lo_hi[:d]), "max": _host(-lo_hi[d:])}


def pcentered_gram(x, mesh: Mesh) -> tuple[np.ndarray, np.ndarray, float]:
    """(centred XᵀX, column means, n) over row-sharded ``x``: the
    covariance and correlation building block, centred before the float32
    product (full float32 precision)."""
    xs, v = _local(mesh, x)
    n = int(torch.as_tensor(x).shape[0])
    s = _host(mesh.all_reduce("pcentered_gram.sums",
                              (xs * v).sum(dim=0))).astype(np.float64)
    mean = s / max(n, 1)
    c = (xs - torch.from_numpy(mean.astype(np.float32)).to(xs.device)) * v
    with full_f32_matmul():
        g = mesh.all_reduce("pcentered_gram.gram", c.T @ c)
    return _host(g).astype(np.float64), mean, float(n)


def pxtx(x, mesh: Mesh) -> np.ndarray:
    """XᵀX over row-sharded ``x``: a float32 product per rank, then the
    all-reduce. Zero padding rows are neutral."""
    xs, _ = _local(mesh, x)
    with full_f32_matmul():
        return _host(mesh.all_reduce("pxtx", xs.T @ xs)).astype(np.float64)


def phistogram(codes, num_bins: int, mesh: Mesh, weights=None) -> np.ndarray:
    """Per-column histograms [F, B] of int codes in [0, num_bins); rows
    with code < 0 are skipped (which also masks the padding)."""
    codes = torch.as_tensor(codes).to(torch.int64)
    if codes.ndim == 1:
        codes = codes[:, None]
    cs = _local(mesh, codes + 1, torch.int64)[0] - 1  # padding rows: -1
    if weights is None:
        weights = torch.ones(codes.shape[0], dtype=torch.float32)
    ws = _local(mesh, weights)[0][:, 0]
    f = cs.shape[1]
    valid = (cs >= 0).to(torch.float32) * ws[:, None]
    # one slot per (column, bin) plus a drop slot for skipped rows; the
    # scatter-add is exact for whole-number weights (counts below 2^24)
    idx = torch.where(cs >= 0, cs + torch.arange(f, device=cs.device) * num_bins,
                      f * num_bins)
    hist = torch.zeros(f * num_bins + 1, dtype=torch.float32, device=cs.device)
    hist.scatter_add_(0, idx.reshape(-1), valid.reshape(-1))
    return _host(mesh.all_reduce("phistogram",
                                 hist[:-1].reshape(f, num_bins)))


#: rows per rank and round for pcontingency: float32 cell counts stay exact
#: within a round (below 2^24); rounds add in float64 on the host
_CONTINGENCY_CHUNK_ROWS = 1 << 23


def pcontingency(group_onehot, label_onehot, mesh: Mesh) -> np.ndarray:
    """Contingency tables group x label as a product per rank and an
    all-reduce per round of rows (SanityChecker's Cramér's V tables)."""
    total = np.zeros((group_onehot.shape[1], label_onehot.shape[1]),
                     dtype=np.float64)
    step = _CONTINGENCY_CHUNK_ROWS * mesh.shape[DATA_AXIS]
    n = group_onehot.shape[0]
    for i in range(0, max(n, 1), step):
        gs, _ = _local(mesh, group_onehot[i:i + step])
        ls, _ = _local(mesh, label_onehot[i:i + step])
        with full_f32_matmul():
            total += _host(mesh.all_reduce("pcontingency",
                                           gs.T @ ls)).astype(np.float64)
    return total
