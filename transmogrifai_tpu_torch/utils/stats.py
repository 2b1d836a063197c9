"""Statistics plane on the card: column stats, correlation, contingency
tables, Cramér's V (OpStatistics.scala; the reference is
``transmogrifai_tpu/utils/stats.py``).

Column stats and the correlation matrix of [X | y] (a centred XᵀX product)
run on the card. They follow the reference's single-device routing at
``_DEVICE_THRESHOLD`` elements: below it in float64 (its numpy route), at
or above it in float32 (its ``_colstats_kernel`` / ``_corr_kernel``), with
the float32 products taken at full float32 precision (no TF32) whatever
the process-wide setting. Contingency tables are one matmul Gᵀ·Y on the
card, routed the same way, every group of a vector in one product per
dtype. The statistics of a finished [K, C] table
(chi-squared, Cramér's V, PMI, rule confidence) are a few host float64
operations on K x C cells, as in the reference. Under an execution mesh
of more than one data rank (the one ``Workflow.train`` installs around
its fit), inputs at or above ``_DEVICE_THRESHOLD`` elements take the
reference's mesh route (``_stats_mesh``): column stats, the centred gram
and the contingency tables through ``parallel/reductions.py``, each rank
reducing its block of the rows. Without one (``set_parallelism(None)``,
``TPTPU_MESH=0``, or outside a fit) every rank computes on its own
rows.

Every entry point takes ``device=None`` (the card, which must be present)
or ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .device import resolve_device

#: at this many elements or more the reference leaves its float64 numpy
#: route for its float32 device kernels
_DEVICE_THRESHOLD = 1 << 22


@dataclasses.dataclass
class ColumnStats:
    count: int
    mean: np.ndarray      # [D]
    variance: np.ndarray  # [D]
    min: np.ndarray       # [D]
    max: np.ndarray       # [D]


def _stats_mesh(size: int):
    """The ambient execution mesh for a statistic of ``size`` elements
    when its data axis spans more than one rank, or None on the one-rank
    or small-problem path (the reference's ``_stats_mesh``). A mesh of
    one rank takes the one-rank route, so it computes the same bits."""
    if size < _DEVICE_THRESHOLD:
        return None
    from ..parallel.mesh import DATA_AXIS, execution_mesh

    mesh = execution_mesh()
    return mesh if mesh is not None and mesh.shape[DATA_AXIS] > 1 else None


@contextlib.contextmanager
def full_f32_matmul():
    """float32 products at full float32 precision (TF32 off) inside the
    block; the caller's setting is restored after it."""
    prior = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prior)


def route_dtype(size: int) -> torch.dtype:
    """float64 below ``_DEVICE_THRESHOLD`` elements, float32 at or above."""
    return torch.float64 if size < _DEVICE_THRESHOLD else torch.float32


def _on(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=dev, dtype=dtype)


def _host64(t: torch.Tensor) -> np.ndarray:
    return t.to(dtype=torch.float64).cpu().numpy()


def column_stats_tensor(t: torch.Tensor) -> ColumnStats:
    """Per-column count/mean/variance/min/max of ``t`` in its own dtype
    (sample variance, n-1 denominator). Large inputs in a world of several
    ranks reduce over the mesh (``parallel.reductions.pcolumn_stats``)."""
    n = t.shape[0]
    mesh = _stats_mesh(t.numel())
    if mesh is not None:
        from ..parallel.reductions import pcolumn_stats

        r = pcolumn_stats(t.detach(), mesh)
        cnt = float(r["count"])
        return ColumnStats(
            count=int(n), mean=r["mean"],
            variance=r["m2"] / max(cnt - 1.0, 1.0),
            min=r["min"].astype(np.float64), max=r["max"].astype(np.float64))
    mean = t.mean(dim=0)
    var = ((t - mean) ** 2).sum(dim=0) / max(n - 1, 1)
    return ColumnStats(
        count=int(n), mean=_host64(mean), variance=_host64(var),
        min=_host64(t.amin(dim=0)), max=_host64(t.amax(dim=0)),
    )


def column_stats(x, device=None) -> ColumnStats:
    """Per-column count/mean/variance/min/max (mllib colStats parity)."""
    dev = resolve_device(device)
    size = int(np.prod(x.shape))
    return column_stats_tensor(_on(x, dev, route_dtype(size)))


def correlation_tensor(m: torch.Tensor) -> torch.Tensor:
    """Pearson correlation of the columns of ``m`` via the centred gram
    matrix, in ``m``'s dtype, then as float64: zero-variance columns
    correlate 0 with everything, the diagonal is 1, values are clipped to
    [-1, 1]. Large inputs in a world of several ranks build the centred
    gram over the mesh (``parallel.reductions.pcentered_gram``)."""
    n = m.shape[0]
    mesh = _stats_mesh(m.numel())
    if mesh is not None:
        from ..parallel.reductions import pcentered_gram

        g, _, cnt = pcentered_gram(m.detach(), mesh)
        cov = g / max(cnt - 1.0, 1.0)
        std64 = np.sqrt(np.maximum(np.diag(cov), 0.0))
        denom64 = np.outer(std64, std64)
        corr = torch.from_numpy(
            cov / np.where(denom64 == 0, 1.0, denom64)).to(m.device)
        zero = torch.from_numpy(std64 == 0).to(m.device)
        corr[zero, :] = 0.0
        corr[:, zero] = 0.0
        corr.fill_diagonal_(1.0)
        return corr.clamp_(-1.0, 1.0)
    c = m - m.mean(dim=0)
    with full_f32_matmul():
        cov = (c.T @ c) / max(n - 1, 1)
    std = torch.sqrt(torch.diagonal(cov))
    denom = torch.outer(std, std)
    corr = (cov / torch.where(denom == 0, torch.ones_like(denom), denom)).double()
    zero = std == 0
    corr[zero, :] = 0.0
    corr[:, zero] = 0.0
    corr.fill_diagonal_(1.0)
    return corr.clamp_(-1.0, 1.0)


def _stack(x, y, dev: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """[X | y] on ``dev``, by default in the routing's dtype for its
    element count."""
    if dtype is None:
        dtype = route_dtype(int(np.prod(x.shape)) + (0 if y is None else len(y)))
    xt = _on(x, dev, dtype)
    if y is None:
        return xt
    return torch.cat([xt.reshape(xt.shape[0], -1), _on(y, dev, dtype)[:, None]], dim=1)


def correlation_matrix(x, y=None, device=None) -> np.ndarray:
    """Pearson correlation matrix of [X | y] (zero-variance columns give
    0 where mllib gives NaN; the variance rule flags them)."""
    dev = resolve_device(device)
    return correlation_tensor(_stack(x, y, dev)).cpu().numpy()


def rank_columns(m: torch.Tensor) -> torch.Tensor:
    """Fractional ranks of each column (ties share their mean position),
    float64, on ``m``'s device."""
    n = m.shape[0]
    vals, order = torch.sort(m, dim=0, stable=True)
    pos = torch.arange(n, device=m.device, dtype=torch.float64)[:, None].expand_as(vals)
    new = torch.ones_like(vals, dtype=torch.bool)
    new[1:] = vals[1:] != vals[:-1]
    last = torch.ones_like(vals, dtype=torch.bool)
    last[:-1] = new[1:]
    # first and last position of each run of equal values
    first_pos = torch.where(new, pos, torch.zeros_like(pos)).cummax(dim=0).values
    last_pos = torch.where(last, pos, torch.full_like(pos, float(n)))
    last_pos = last_pos.flip(0).cummin(dim=0).values.flip(0)
    ranks = torch.empty_like(pos)
    ranks.scatter_(0, order, (first_pos + last_pos) / 2.0)
    return ranks


def spearman_correlation_matrix(x, y=None, device=None) -> np.ndarray:
    """Spearman = Pearson on fractional ranks (CorrelationType.Spearman)."""
    dev = resolve_device(device)
    ranks = rank_columns(_stack(x, y, dev, torch.float64))
    return correlation_tensor(ranks.to(route_dtype(ranks.numel()))).cpu().numpy()


def contingency_tables(x: torch.Tensor, groups: list[list[int]],
                       y: torch.Tensor) -> list[np.ndarray]:
    """The [K_g, C] contingency Gᵀ·Y of each group g of columns of ``x``
    (K_g category-indicator columns) against ``y``'s C label columns, as
    host float64. Each table is taken in the dtype the reference's routing
    gives that group alone (N·K_g + N·C elements); groups that share a
    dtype share one gather and one product, so every table comes back in
    one device-to-host copy per dtype."""
    n, c = x.shape[0], y.shape[1]
    out: list = [None] * len(groups)
    by_dtype: dict[torch.dtype, list[int]] = {}
    for gi, cols in enumerate(groups):
        by_dtype.setdefault(route_dtype(n * (len(cols) + c)), []).append(gi)
    for dtype, members in by_dtype.items():
        cols = torch.tensor([i for gi in members for i in groups[gi]],
                            device=x.device)
        g, yd = x.index_select(1, cols).to(dtype), y.to(dtype)
        mesh = (_stats_mesh(g.numel() + yd.numel())
                if dtype == torch.float32 else None)
        if mesh is not None:
            # the reference's mesh route for tables at or above the
            # threshold: each rank's rows, the counts all-reduced
            from ..parallel.reductions import pcontingency

            table = pcontingency(g, yd, mesh)
        else:
            with full_f32_matmul():
                table = _host64(g.T @ yd)
        off = 0
        for gi in members:
            out[gi] = table[off:off + len(groups[gi])]
            off += len(groups[gi])
    return out


def contingency_table(group_cols, label_onehot, device=None) -> np.ndarray:
    """[K, C] contingency of K category-indicator columns vs C label
    classes: a single matmul Gᵀ·Y (OpStatistics.contingencyStats input)."""
    dev = resolve_device(device)
    g = _on(group_cols, dev, torch.float64)
    return contingency_tables(
        g, [list(range(g.shape[1]))], _on(label_onehot, dev, torch.float64)
    )[0]


def chi_squared(contingency: np.ndarray) -> float:
    """Pearson chi-squared statistic of a contingency table."""
    total = contingency.sum()
    if total == 0:
        return 0.0
    rows = contingency.sum(axis=1, keepdims=True)
    cols = contingency.sum(axis=0, keepdims=True)
    expected = rows @ cols / total
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(expected > 0, (contingency - expected) ** 2 / expected, 0.0)
    return float(terms.sum())


def cramers_v(contingency: np.ndarray) -> float:
    """Cramér's V (OpStatistics.cramersV): sqrt(chi2 / (n * (min(r,c)-1))).
    Degenerate tables (a single row/column) give 0."""
    # drop all-zero rows/cols: categories absent from the sample
    c = contingency[contingency.sum(axis=1) > 0][:, contingency.sum(axis=0) > 0]
    if c.size == 0:
        return 0.0
    r, k = c.shape
    denom_df = min(r - 1, k - 1)
    n = c.sum()
    if denom_df <= 0 or n == 0:
        return 0.0
    return float(np.sqrt(chi_squared(c) / (n * denom_df)))


def pointwise_mutual_information(contingency: np.ndarray) -> np.ndarray:
    """PMI matrix log2(P(x,y)/(P(x)P(y))) per cell; zero cells give 0."""
    total = contingency.sum()
    if total == 0:
        return np.zeros_like(contingency)
    p = contingency / total
    px = p.sum(axis=1, keepdims=True)
    py = p.sum(axis=0, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        pmi = np.where(p > 0, np.log2(p / (px @ py)), 0.0)
    return pmi


def association_rule_confidence(contingency: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-category (max rule confidence, support): confidence = max_c
    P(label=c | category), support = category count / total."""
    totals = contingency.sum(axis=1)
    n = contingency.sum()
    with np.errstate(divide="ignore", invalid="ignore"):
        conf = np.where(
            totals[:, None] > 0, contingency / totals[:, None], 0.0
        ).max(axis=1)
    support = totals / n if n else np.zeros_like(totals)
    return conf, support
