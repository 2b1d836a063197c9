"""Histogram tree machinery in PyTorch: quantile binning, level-wise tree
growth, boosting and bagged forests, and the traversal of dense
perfect-binary trees (level d uses node slots [0, 2^d); ``split_feat = -1``
marks a leaf that routes every row left).

The port of the JAX package's ``models/trees.py``. Growth follows the
reference step for step: feature groups (<= 2-bin indicator columns
searched at 2 bins), node compaction to ``cap`` live slots, node chunks
under a histogram memory budget, the per-chunk occupancy skip and the
early exit once a level makes no split, per-lane depth caps, routing and
leaf sums. Histograms come from ``hist.py`` (the plain scatter version on
the CPU; on the card kernel K2 up to 64 bins and K3 for wider sketches, at
every row count, where the reference takes one-hot GEMMs up to 4096 rows). Split search
(``hist.split_search``) keeps the reference's expression order, its
bin-axis sums in the order XLA's CPU backend takes them, and
``jnp.argmax``'s first-index tie-break, so where the histograms agree the
splits agree.

Control flow that the reference runs as ``lax.cond`` on the device is a
Python ``if`` on a device value here: one host sync per grown level
(``host_syncs`` counts them).

Sharded growth (``mesh=``, or the ambient ``parallel.mesh.execution_mesh``):
every rank grows over its block of the rows (padded to the data-axis
multiple with mask-0 rows at the global tail) and the grower all-reduces
at the reference's points (its ``trees.py:465-468``, ``:562-563``,
``:526-528``, ``:694-696``): each node chunk's histogram (with its row
counts) between the build and the split search, the occupancy before the
live-slot count is read (so every rank compacts, exits early and skips
chunks alike), and the leaf sums. The sums run in rank order
(``Mesh.all_reduce``), so every rank grows the same trees; the splits
equal the single-device fit's and the leaves agree to float
reassociation. The fused K4 stays off this route, as in the reference.
The outputs (margins, training predictions) stay row-sharded and are
gathered to the global rows once, at the end.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import prng
from . import hist as H
from . import leaf_sum as LS
from . import serve_trees as ST
from .hist import _REDUCE_WINDOW, _xla_sum


class Tree(NamedTuple):
    """Dense perfect-binary-tree arrays; stacked ensembles carry a leading
    tree axis [T, ...]."""

    split_feat: torch.Tensor  # [depth, 2^depth] int32, -1 = leaf (route left)
    split_bin: torch.Tensor   # [depth, 2^depth] int32, right when bin > split_bin
    leaf_value: torch.Tensor  # [2^depth] float32


#: device-to-host reads that steer growth (one per grown level)
host_syncs = 0

#: node slots per histogram build on the card's kernel routes (K2, K3):
#: the reference's TPU kernel cap, max(8, min(256, 2^19 / (8 b_pad))) with
#: b_pad the bin count rounded up to 128 (trees.py:395-403)
KERNEL_NODE_CAP = 256
#: histogram elements per node chunk, over all K fits, and the per-fit
#: floor (trees.py:369): the Spark maxMemoryInMB node-group equivalent
HIST_BUDGET_ELEMS = 1 << 25
HIST_BUDGET_FLOOR = 1 << 20


def quantile_thresholds(x: np.ndarray, max_bins: int = 32) -> np.ndarray:
    """Per-feature quantile bin edges [F, max_bins-1] float32, computed on
    the host once per dataset (NaN-free input takes the plain quantile)."""
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    xd = np.asarray(x, dtype=np.float64)
    qf = np.quantile if not np.isnan(xd).any() else np.nanquantile
    thr = qf(xd, qs, axis=0).T
    return np.ascontiguousarray(thr, dtype=np.float32)


def bin_data(x: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """int32 bin codes [N, F]: the number of thresholds strictly below x
    (NaN compares false, so a NaN value bins to 0). Accumulated one
    threshold column at a time so peak memory stays one [N, F] plane."""
    codes = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for j in range(thresholds.shape[1]):
        codes += x > thresholds[:, j]
    return codes


def predict_tree(binned: torch.Tensor, tree: Tree) -> torch.Tensor:
    """Leaf value per row for one tree, through ``serve_trees`` (the K1
    kernel on the card) over a one-tree stack."""
    stack = (a.unsqueeze(0).contiguous() for a in tree)
    return ST.serve_trees(binned, *stack)[:, 0]


def predict_forest_raw(
    x: torch.Tensor, thresholds: torch.Tensor, trees: Tree
) -> torch.Tensor:
    """Bin + forest mean over the stacked trees -> [N] float32."""
    return ST.predict_forest(bin_data(x, thresholds), trees)


def predict_boosted_raw(
    x: torch.Tensor, thresholds: torch.Tensor, trees: Tree, eta, base_score,
) -> torch.Tensor:
    """Bin + ``base + eta * Σ rounds`` -> [N] float32."""
    return ST.predict_boosted(bin_data(x, thresholds), trees, eta, base_score)


# --------------------------------------------------------------------------
# small-table primitives (the reference's one-hot compare/select forms are
# a TPU device; here they are gathers and ordered index sums)
# --------------------------------------------------------------------------
def _small_table_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[k, r] = table[k, idx[k, r]], idx in [0, M)."""
    return torch.gather(table, -1, idx.long())


def _row_feature_select(binned: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """code[k, r] = binned[r, max(feat[k, r], 0)]."""
    rows = torch.arange(binned.shape[0], device=binned.device)
    return binned[rows, feat.clamp(min=0).long()]


def _occupancy(idx: torch.Tensor, size: int) -> torch.Tensor:
    """[K, size] count of idx == m (ids >= size drop out); integer sums,
    so exact in any order."""
    out = torch.zeros((idx.shape[0], size + 1), dtype=torch.int64,
                      device=idx.device)
    out.scatter_add_(1, idx.clamp(max=size).long(),
                     torch.ones(idx.shape, dtype=torch.int64, device=idx.device))
    return out[:, :size]


#: the reference picks its one-hot forms while (index count x table
#: width) stays under this, or the table is at most _ONEHOT_MAX_WIDTH wide
#: (trees.py:79-91); the choice fixes the order of its leaf sums
_ONEHOT_MAX_WIDTH = 512
_ONEHOT_OPS_BUDGET = 1 << 28


def _scatter_form(k_fits: int, n: int, size: int) -> bool:
    """True where the reference sums leaves by its scatter-add form (past
    its one-hot limits), False where by its windowed one-hot reduction."""
    return size > _ONEHOT_MAX_WIDTH and k_fits * n * size > _ONEHOT_OPS_BUDGET


def _segment_sum_small(values: torch.Tensor, idx: torch.Tensor, size: int) -> torch.Tensor:
    """out[k, m] = Σ_r values[k, r]·1[idx[k, r] == m], idx in [0, size),
    in the reference's order: its one-hot form is a reduction over rows
    (windows of 32 rows summed in order, then the window sums as in
    ``_xla_sum``); past its ops budget it scatter-adds in row order
    (``leaf_sum``: the leaf-sum kernel on the card).

    The windowed form adds one row of every window per step, 32 steps in
    row order: a step's keys (lane, window, slot) are distinct, so each
    slot's window sum is the in-order sum on any device. (An accumulating
    ``index_put_`` on the card sums a key's many duplicates in another
    order.)"""
    k_fits, n = values.shape
    if _scatter_form(k_fits, n, size):
        return LS.leaf_sum(values, None, idx, size)[0]
    if n <= _REDUCE_WINDOW:
        nb, lo = 1, 0
    else:
        nb = -(-n // _REDUCE_WINDOW)
        lo = (nb * _REDUCE_WINDOW - n) // 2
    # rows laid out [K, window, position]; the padding rows add 0 to an
    # extra slot that is dropped
    hi = nb * _REDUCE_WINDOW - n - lo
    rows = F.pad(values, (lo, hi)).view(k_fits, nb, _REDUCE_WINDOW)
    slots = F.pad(idx.long(), (lo, hi), value=size).view(k_fits, nb, _REDUCE_WINDOW)
    part = torch.zeros((k_fits, nb, size + 1), dtype=values.dtype,
                       device=values.device)
    for j in range(_REDUCE_WINDOW):
        part.scatter_add_(2, slots[:, :, j:j + 1], rows[:, :, j:j + 1])
    return _xla_sum(part[:, :, :size], 1)


def _fma32(a, b, c) -> torch.Tensor:
    """float32 ``a*b + c`` rounded once, as XLA contracts it on the CPU:
    the f32 product is exact in float64, and rounding the float64 sum to
    f32 gives the fused result."""
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double()
            + c.double()).to(torch.float32)


def _vec(v, device) -> torch.Tensor:
    """Scalar or [K] knob -> float32 [1] or [K] on ``device``."""
    return torch.as_tensor(np.asarray(v, dtype=np.float32).reshape(-1)
                           if not isinstance(v, torch.Tensor) else v,
                           dtype=torch.float32, device=device).reshape(-1)


def _f32(v, device) -> torch.Tensor:
    """numpy or torch -> float32 tensor on ``device``."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _index(v, device):
    return None if v is None else torch.as_tensor(
        np.asarray(v) if not isinstance(v, torch.Tensor) else v,
        device=device,
    ).long()


def _knobs(device, feature_groups, **knobs):
    """Feature groups and per-lane knobs placed on the device once per fit,
    so that growing a tree copies nothing from the host."""
    groups = None if feature_groups is None else tuple(
        _index(a, device) for a in feature_groups
    )
    return groups, {k: _vec(v, device) for k, v in knobs.items()}


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to the card through pinned memory and
    without waiting, so the copy does not stall the host."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def grow_tree(binned, grad, hess, row_mask, feat_mask, max_depth, num_bins,
              reg_lambda=1.0, gamma=0.0, min_child_weight=1.0,
              min_info_gain=0.0, feature_groups=None) -> Tree:
    """Single-fit tree growth: the K=1 case of ``grow_tree_batched``."""
    tree = grow_tree_batched(
        binned, grad[None, :], hess[None, :], row_mask[None, :],
        feat_mask[None, :], max_depth=max_depth, num_bins=num_bins,
        reg_lambda=reg_lambda, gamma=gamma,
        min_child_weight=min_child_weight, min_info_gain=min_info_gain,
        feature_groups=feature_groups,
    )
    return Tree(*(a[0] for a in tree))


def grow_tree_batched(binned, grad, hess, row_mask, feat_mask, max_depth,
                      num_bins, reg_lambda=1.0, gamma=0.0, min_child_weight=1.0,
                      min_info_gain=0.0, feature_groups=None,
                      max_depth_v=None) -> Tree:
    """Grow K trees at once, one per batched fit (grid point x fold), over
    codes shared by the fits. Returned arrays carry a leading K axis."""
    return _grow_tree_impl(
        binned, grad, hess, row_mask, feat_mask, max_depth=max_depth,
        num_bins=num_bins, reg_lambda=reg_lambda, gamma=gamma,
        min_child_weight=min_child_weight, min_info_gain=min_info_gain,
        feature_groups=feature_groups, max_depth_v=max_depth_v,
    )[0]


def _psum(mesh, name: str, t: torch.Tensor) -> torch.Tensor:
    """All-reduce over the mesh's data axis (taped under ``name``);
    identity without a mesh."""
    return t if mesh is None else mesh.all_reduce(name, t)


def _grow_tree_impl(
    binned: torch.Tensor,     # [N, F] int32 codes, shared across fits
    grad: torch.Tensor,       # [K, N] float32
    hess: torch.Tensor,       # [K, N] float32
    row_mask: torch.Tensor,   # [K, N] float32
    feat_mask: torch.Tensor,  # [K, F] float32
    max_depth: int,
    num_bins: int,
    reg_lambda=1.0, gamma=0.0, min_child_weight=1.0, min_info_gain=0.0,
    feature_groups=None,      # (narrow_idx, wide_idx) original feature ids
    max_depth_v=None,         # [K] int per-lane depth caps
    mesh=None,                # rows: this rank's block of the mesh's data axis
) -> tuple[Tree, torch.Tensor]:
    """(trees [K, ...], each row's final leaf slot [K, N]).

    ``feature_groups`` partitions the columns into <= 2-bin indicator
    columns, recoded to ``code > 0`` and searched at 2 bins, and the rest;
    a split found in the narrow group stores bin 0, which routes the same
    in the original code space. Across groups the merge keeps the lowest
    original feature id on equal gain, as a single search would.
    ``max_depth_v`` caps each lane's depth: levels at or past a lane's cap
    emit no splits. With ``mesh`` the rows are this rank's block, and the
    histograms, occupancy and leaf sums are all-reduced over its data
    axis."""
    global host_syncs
    dev = binned.device
    k_fits, n = grad.shape
    n_global = n if mesh is None else n * mesh.shape["data"]
    b = num_bins
    max_nodes = 1 << max_depth
    g = grad * row_mask
    h = hess * row_mask

    groups = []
    if feature_groups is not None:
        narrow_idx, wide_idx = (_index(a, dev) for a in feature_groups)
        if narrow_idx.shape[0]:
            groups.append((
                H.pad_codes((binned[:, narrow_idx] > 0).to(torch.int32)),
                feat_mask[:, narrow_idx], 2, narrow_idx,
            ))
        if wide_idx.shape[0]:
            groups.append((
                H.pad_codes(binned[:, wide_idx]), feat_mask[:, wide_idx], b,
                wide_idx,
            ))
    if not groups:
        groups = [(H.pad_codes(binned), feat_mask, b, None)]

    lam = _vec(reg_lambda, dev)
    gam = _vec(gamma, dev)
    mcw = _vec(min_child_weight, dev)
    mig = _vec(min_info_gain, dev)[:, None]

    if max_depth == 0:
        # root-only tree: no splits, one leaf over every row
        node0 = torch.zeros((k_fits, n), dtype=torch.int32, device=dev)
        leaf_g0, leaf_h0 = _psum(mesh, "tree_leaf_sums", torch.stack(
            [_xla_sum(g, 1)[:, None], _xla_sum(h, 1)[:, None]]))
        return Tree(
            split_feat=torch.full((k_fits, 0, 1), -1, dtype=torch.int32, device=dev),
            split_bin=torch.zeros((k_fits, 0, 1), dtype=torch.int32, device=dev),
            leaf_value=-leaf_g0 / (leaf_h0 + lam[:, None]),
        ), node0

    # node compaction: at most min(2^depth, N) slots are live at any level
    # (N the global row count when sharded)
    cap = max_nodes
    if cap > n_global:
        cap = 1
        while cap < n_global:
            cap <<= 1
        cap = min(cap, max_nodes)

    routes = [H.histogram_route(dev, gb) for _, _, gb, _ in groups]
    sorted_routes = "binloop" in routes or "wide" in routes
    # per-chunk histogram memory scales with K: the node chunk keeps
    # [K, chunk, F, B, 2] inside the budget (trees.py:363-373)
    hist_width = sum(gbin.shape[1] * gb for gbin, _, gb, _ in groups)
    budget_elems = max(HIST_BUDGET_ELEMS // k_fits, HIST_BUDGET_FLOOR)
    chunk_cap = max(1, budget_elems // max(hist_width, 1))
    chunk_cap = 1 << (chunk_cap.bit_length() - 1)
    chunk_cap = min(chunk_cap, cap)
    if sorted_routes:
        b_pad = -(-b // 128) * 128
        m_cap = max(8, min(KERNEL_NODE_CAP, (1 << 19) // (8 * b_pad)))
        chunk_cap = min(chunk_cap, 1 << (m_cap.bit_length() - 1))
    n_nodes = cap
    chunk_nodes = min(chunk_cap, n_nodes)
    num_chunks = -(-n_nodes // chunk_nodes)

    def group_stats(gbin, gmask, gb, gidx, route, loc, m, rows, count):
        """(gain, original feature, bin) of the best split per slot."""
        if route == "binloop":
            hist = H.build_histogram_binloop(gbin, loc, g, h, m, gb, order=rows)
        elif route == "wide":
            hist = H.build_histogram_wide(gbin, loc, g, h, m, gb, order=rows)
        else:
            hist = H.build_histogram_scatter_batched(gbin, loc, g, h, m, gb)
        # the allreduce of the reference's Rabit step: every rank searches
        # the global histogram
        hist = _psum(mesh, "tree_histogram", hist)
        best_gain, best_feat, best_bin = H.split_search(
            hist, gmask, lam, gam, mcw, count=count)
        if gidx is not None:
            best_feat = gidx[best_feat.long()].to(torch.int32)
        return best_gain, best_feat, best_bin

    def chunk_stats(local, c0, m):
        """Best (feat, bin) per compact slot in [c0, c0 + m), merged across
        feature groups (tie-break: lowest original feature id)."""
        in_chunk = (local >= c0) & (local < c0 + m)
        loc = torch.where(in_chunk, local - c0, -1).to(torch.int32).contiguous()
        # the kernels' row order, shared by every group of the chunk
        rows = H.node_order(loc, m, g, h) if sorted_routes else None
        # the split search skips the slots that hold no row anywhere
        count = None if rows is None else _psum(mesh, "tree_node_count",
                                                rows[2])
        bg = bf = bb = None
        for (gbin, gmask, gb, gidx), route in zip(groups, routes):
            gg, gf, gbn = group_stats(gbin, gmask, gb, gidx, route, loc, m,
                                      rows, count)
            if bg is None:
                bg, bf, bb = gg, gf, gbn
            else:
                take = (gg > bg) | ((gg == bg) & (gf < bf))
                bg = torch.where(take, gg, bg)
                bf = torch.where(take, gf, bf)
                bb = torch.where(take, gbn, bb)
        do_split = bg > mig.clamp(min=0.0)
        return torch.where(do_split, bf, -1), torch.where(do_split, bb, 0)

    depth_cap = _index(max_depth_v, dev)
    sentinel = max_nodes
    node = torch.zeros((k_fits, n), dtype=torch.int32, device=dev)
    active = torch.ones((k_fits, n), dtype=torch.bool, device=dev)
    feats_levels, bins_levels = [], []
    for level in range(max_depth):
        # compaction: live slots (those holding an active row) numbered
        # densely from 0 by occupancy + exclusive prefix rank
        hist_node = torch.where(active, node, sentinel)
        occ = _psum(mesh, "tree_occupancy", _occupancy(hist_node, max_nodes))
        live = occ > 0
        live_i = live.to(torch.int64)
        rank = torch.cumsum(live_i, dim=1) - live_i
        local = _small_table_lookup(rank, hist_node.clamp(max=max_nodes - 1))
        local = torch.where(active, local, sentinel)
        # the one host sync of the level: how many slots are live. Live
        # slots fill [0, count) per lane, so chunks at or past the largest
        # count are empty (the reference's per-chunk occupancy skip), and
        # a count of 0 means the last level made no split: every deeper
        # level is all leaves (the reference's early level exit)
        n_live = int(live.sum(dim=1).max())
        host_syncs += 1
        if n_live == 0:
            break
        feats_c = torch.full((k_fits, num_chunks * chunk_nodes), -1,
                             dtype=torch.int32, device=dev)
        bins_c = torch.zeros_like(feats_c)
        for ci in range(-(-n_live // chunk_nodes)):
            c0 = ci * chunk_nodes
            cf, cb = chunk_stats(local, c0, chunk_nodes)
            feats_c[:, c0:c0 + chunk_nodes] = cf
            bins_c[:, c0:c0 + chunk_nodes] = cb
        feats_c, bins_c = feats_c[:, :n_nodes], bins_c[:, :n_nodes]
        if depth_cap is not None:
            lane_live = (level < depth_cap)[:, None]
            feats_c = torch.where(lane_live, feats_c, -1)
            bins_c = torch.where(lane_live, bins_c, 0)
        # per-slot decisions back into global node-id space
        rank_c = rank.clamp(max=n_nodes - 1)
        feats_levels.append(torch.where(live, _small_table_lookup(feats_c, rank_c), -1))
        bins_levels.append(torch.where(live, _small_table_lookup(bins_c, rank_c), 0))
        # route rows to children through their compact slots
        slot = local.clamp(0, n_nodes - 1)
        row_feat = _small_table_lookup(feats_c, slot)
        row_thr = _small_table_lookup(bins_c, slot)
        code = _row_feature_select(binned, row_feat)
        go_right = active & (row_feat >= 0) & (code > row_thr)
        node = (node * 2 + go_right).to(torch.int32)
        active = active & (row_feat >= 0)
    # levels after an early exit are all leaves, and rows keep going left
    rest = max_depth - len(feats_levels)
    if rest:
        node = node * (1 << rest)
        feats_levels += [torch.full((k_fits, max_nodes), -1, dtype=torch.int32,
                                    device=dev)] * rest
        bins_levels += [torch.zeros((k_fits, max_nodes), dtype=torch.int32,
                                    device=dev)] * rest
    feats = torch.stack(feats_levels, dim=1).to(torch.int32)
    bins = torch.stack(bins_levels, dim=1).to(torch.int32)
    if _scatter_form(k_fits, n, max_nodes):
        leaf_g, leaf_h = LS.leaf_sum(g, h, node, max_nodes)
    else:
        leaf_g = _segment_sum_small(g, node, max_nodes)
        leaf_h = _segment_sum_small(h, node, max_nodes)
    if mesh is not None:
        leaf_g, leaf_h = mesh.all_reduce("tree_leaf_sums",
                                         torch.stack([leaf_g, leaf_h]))
    leaf_value = -leaf_g / (leaf_h + lam[:, None])
    return Tree(feats, bins, leaf_value), node


# --------------------------------------------------------------------------
# boosting
# --------------------------------------------------------------------------
#: f32 constants of the exp that XLA's CPU backend emits (Cephes' range
#: reduction and polynomial): clamp range, 1/ln 2, ln 2 in two parts, and
#: the polynomial's coefficients, highest order first
_EXP_LO, _EXP_HI = -87.8, 88.8
_LOG2E = 1.44269504088896341
_LN2_HI, _LN2_LO = 0.693359375, -2.12194440e-4
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 0.5)


def _f32c(v: float) -> float:
    return float(np.float32(v))


def _xla_exp(x: torch.Tensor) -> torch.Tensor:
    """float32 exp bit-identical to XLA's CPU backend: range reduction to
    e^a * 2^n, a degree-7 polynomial for e^a, every multiply-add fused as
    that backend fuses it (``_fma32``), denormal results flushed to zero.
    Exact IEEE operations in a fixed order, so the same bits on any
    device."""
    x = torch.where(x < _f32c(_EXP_LO), _f32c(_EXP_LO), x)
    x = torch.where(x > _f32c(_EXP_HI), _f32c(_EXP_HI), x)
    fx = torch.floor(_fma32(_f32c(_LOG2E), x, torch.full_like(x, 0.5)))
    fx = fx.clamp(-127.0, 127.0)
    r = _fma32(-_f32c(_LN2_HI), fx, x)
    r = _fma32(-_f32c(_LN2_LO), fx, r)
    y = _fma32(r, _f32c(_EXP_POLY[0]), torch.full_like(r, _f32c(_EXP_POLY[1])))
    for c in _EXP_POLY[2:]:
        y = _fma32(y, r, torch.full_like(r, _f32c(c)))
    y = _fma32(y, r * r, r)
    y = 1.0 + y
    scale = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return _ftz(y * scale)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < torch.finfo(torch.float32).tiny, 0.0, x)


def _xla_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA's CPU backend computes it, 1/(1 + exp(-x)),
    bit for bit."""
    return _ftz(1.0 / (1.0 + _xla_exp(-x)))


def _grads(margin: torch.Tensor, y: torch.Tensor, objective: str):
    if objective == "binary:logistic":
        p = _xla_sigmoid(margin)
        return p - y, p * (1.0 - p)
    if objective == "reg:squarederror":
        return margin - y, torch.ones_like(margin)
    raise ValueError(f"unknown objective {objective!r}")


def _stack_trees(trees: list[Tree], dim: int) -> Tree:
    return Tree(*(torch.stack(parts, dim=dim) for parts in zip(*trees)))


def fit_boosted(binned, y, row_mask, num_rounds, max_depth, num_bins,
                eta=0.3, reg_lambda=1.0, gamma=0.0, min_child_weight=1.0,
                min_info_gain=0.0, base_score=0.0,
                objective="binary:logistic", feature_groups=None):
    """Gradient boosting, one fit: the K=1 case of ``fit_boosted_batched``.
    Each row's leaf read from the grower's routing is the value the
    reference's re-traversal (``predict_tree``) returns, so the margins
    match it bit for bit. Returns stacked trees [R, ...] and the training
    margin [N]."""
    trees, margin = fit_boosted_batched(
        binned, y, _f32(row_mask, binned.device)[None, :], num_rounds=num_rounds,
        max_depth=max_depth, num_bins=num_bins, eta=eta, reg_lambda=reg_lambda,
        gamma=gamma, min_child_weight=min_child_weight,
        min_info_gain=min_info_gain, base_score=base_score, objective=objective,
        feature_groups=feature_groups,
    )
    return Tree(*(a[0] for a in trees)), margin[0]


def _resolve_mesh(mesh):
    """``mesh``, or the ambient execution mesh when None."""
    if mesh is not None:
        return mesh
    from ..parallel.mesh import execution_mesh

    return execution_mesh()


def _shard(mesh, n: int):
    """(lo, hi) of this rank's block of the padded row space, or None
    without a mesh."""
    return None if mesh is None else mesh.row_block(n)[:2]


def _rows_of(t: torch.Tensor, blk, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` (zero rows past its end),
    or ``t`` itself without a mesh."""
    if blk is None:
        return t
    from ..parallel.mesh import take_rows

    return take_rows(t, blk[0], blk[1], dim).contiguous()


def _gather_rows(mesh, t: torch.Tensor, n: int) -> torch.Tensor:
    """Row-sharded [K, n_local] outputs -> the global [K, n] on every
    rank."""
    if mesh is None:
        return t
    return mesh.all_gather("tree_rows", t.contiguous(), 1)[:, :n]


def fit_boosted_batched(binned, y, row_mask, num_rounds, max_depth, num_bins,
                        eta=0.3, reg_lambda=1.0, gamma=0.0, min_child_weight=1.0,
                        min_info_gain=0.0, base_score=0.0,
                        objective="binary:logistic", feature_groups=None,
                        mesh=None):
    """K boosting runs batched over the fit axis (``_boost_chunk_body`` as
    one chunk of every round): each round grows all K trees together, and
    the margin update reads each row's leaf from the grower's own routing.
    Returns trees [K, R, ...] and the training margins [K, N].

    With ``mesh`` (default: the ambient execution mesh) rows shard over
    its data axis: gradients and margins stay row-sharded, each level's
    histogram is all-reduced, the trees come back the same on every rank
    and the margins are gathered once at the end."""
    mesh = _resolve_mesh(mesh)
    k_fits, n = row_mask.shape
    dev = binned.device
    y, row_mask = _f32(y, dev), _f32(row_mask, dev)
    blk = _shard(mesh, n)
    binned = _rows_of(binned, blk, 0)
    y, row_mask = _rows_of(y, blk, 0), _rows_of(row_mask, blk, 1)
    n_global, n = n, row_mask.shape[1]
    f = binned.shape[1]
    feat_mask = torch.ones((k_fits, f), dtype=torch.float32, device=dev)
    eta_v = torch.as_tensor(np.broadcast_to(
        np.asarray(eta, dtype=np.float32).reshape(-1), (k_fits,)).copy(),
        device=dev)
    margin = torch.as_tensor(np.broadcast_to(
        np.asarray(base_score, dtype=np.float32).reshape(-1, 1), (k_fits, n)
    ).copy(), device=dev)
    feature_groups, knobs = _knobs(
        dev, feature_groups, reg_lambda=reg_lambda, gamma=gamma,
        min_child_weight=min_child_weight, min_info_gain=min_info_gain,
    )
    trees = []
    for _ in range(num_rounds):
        g, h = _grads(margin, y[None, :], objective)
        tree, leaf_slot = _grow_tree_impl(
            binned, g, h, row_mask, feat_mask, max_depth=max_depth,
            num_bins=num_bins, feature_groups=feature_groups, mesh=mesh,
            **knobs,
        )
        step = _small_table_lookup(tree.leaf_value, leaf_slot)
        margin = _fma32(eta_v[:, None], step, margin)
        trees.append(tree)
    return _stack_trees(trees, 1), _gather_rows(mesh, margin, n_global)


# --------------------------------------------------------------------------
# bagged forests
# --------------------------------------------------------------------------
def _bag_masks(tkey, sub, col, row_mask, n, f, bootstrap):
    """Bootstrap row counts and feature masks for one tree across K fits,
    drawn on the host with the reference's keys: Poisson(sub[k]) counts
    from one key for every lane, so each lane equals its sequential draw.
    Returns (row masks [K, N], feature masks [K, F]) float32 numpy."""
    k1, k2 = prng.split(tkey)
    row_mask = np.asarray(row_mask, dtype=np.float32)
    k_fits = row_mask.shape[0]
    if bootstrap:
        draws: dict[float, np.ndarray] = {}  # lanes sharing a rate share a draw
        for r in np.asarray(sub, dtype=np.float32):
            if float(r) not in draws:
                draws[float(r)] = prng.poisson(k1, r, n)
        counts = np.stack([
            draws[float(r)] for r in np.asarray(sub, dtype=np.float32)
        ]).astype(np.float32)
    else:
        counts = np.ones((k_fits, n), dtype=np.float32)
    rmask = row_mask * counts
    col = np.asarray(col, dtype=np.float32)
    u = prng.uniform(k2, f) if (col < 1.0).any() else None
    fmask = np.stack([
        np.ones(f, np.float32) if c >= 1.0 else (u < c).astype(np.float32)
        for c in col
    ])
    fmask = np.where(fmask.sum(axis=1, keepdims=True) == 0, 1.0, fmask)
    return rmask, fmask.astype(np.float32)


def _forest_trees(binned, target, row_mask, seed, sub, col, min_instances,
                  min_info_gain, feature_groups=None, max_depth_v=None,
                  subset_n=None, subset_w=None, *, num_trees, max_depth,
                  num_bins, bootstrap, mesh=None):
    """The bagged forest tree by tree (``_forest_trees_scan``): per-tree
    keys split from ``seed``, masks drawn per tree, one batched growth per
    tree. Returns (trees [K, T, ...], each lane's mean-leaf output on every
    training row [K, N], read from the grower's own routing).

    With ``mesh`` the bag masks are drawn over the global unpadded rows
    with the same keys on every rank (so they equal the single-device
    draw), then each rank grows over its block (the reference's
    ``_fit_forest_batched_sharded``, its ``trees.py:1647-1690``)."""
    dev = binned.device
    rm_host = np.asarray(row_mask.detach().cpu() if isinstance(row_mask, torch.Tensor)
                         else row_mask, dtype=np.float32)
    k_fits, n = rm_host.shape
    f = binned.shape[1]
    blk = _shard(mesh, n)
    binned = _rows_of(binned, blk, 0)
    n_local = binned.shape[0]
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    gneg = -_rows_of(target if target.dim() == 2
                     else target[None, :].expand(k_fits, n), blk, 1)
    ones = torch.ones((k_fits, n_local), dtype=torch.float32, device=dev)
    tkeys = prng.split(prng.prng_key(seed), num_trees)
    col_t = np.ones_like(col) if subset_n is not None else col
    feature_groups, knobs = _knobs(
        dev, feature_groups, reg_lambda=0.0, gamma=0.0,
        min_child_weight=min_instances, min_info_gain=min_info_gain,
    )
    subset_n, subset_w = _index(subset_n, dev), _index(subset_w, dev)
    max_depth_v = _index(max_depth_v, dev)
    preds, trees = [], []
    for t in range(num_trees):
        rm_t, fm_t = _bag_masks(tkeys[t], sub, col_t, rm_host, n, f, bootstrap)
        rm_t = _rows_of(torch.from_numpy(rm_t), blk, 1).numpy()
        grp = (subset_n[t], subset_w[t]) if subset_n is not None else feature_groups
        tree, node = _grow_tree_impl(
            binned, gneg, ones, _upload(rm_t, dev), _upload(fm_t, dev),
            max_depth=max_depth, num_bins=num_bins,
            feature_groups=grp, max_depth_v=max_depth_v, mesh=mesh, **knobs,
        )
        preds.append(_small_table_lookup(tree.leaf_value, node))
        trees.append(tree)
    # the mean over trees as the reference's reduction takes it: the sum in
    # XLA's order times the f32 reciprocal of the tree count
    mean = _xla_sum(torch.stack(preds), 0) * _f32c(1.0 / num_trees)
    return _stack_trees(trees, 1), _gather_rows(mesh, mean, n)


def fit_forest_batched(binned, target, row_mask, num_trees, max_depth,
                       num_bins, subsample_rate=1.0, colsample_rate=1.0,
                       min_instances=1.0, min_info_gain=0.0, seed=42,
                       bootstrap=True, feature_groups=None,
                       max_depth_v=None, return_outputs=False, mesh=None):
    """K random forests batched over the fit axis. Returns trees
    [K, T, ...]; with ``return_outputs`` also the [K, N] mean-leaf training
    outputs. With ``mesh`` (default: the ambient execution mesh) rows
    shard over its data axis; per-lane depth caps and per-lane targets
    are single-device only, as in the reference.

    A plain-number ``colsample_rate`` < 1 with ``feature_groups`` draws an
    exact-count feature subset per tree on the host, stratified over the
    narrow and wide groups (Spark's featureSubsetStrategy), and grows each
    tree over only those columns; otherwise a Bernoulli feature mask is
    drawn per tree and lane."""
    k_fits = row_mask.shape[0]
    mesh = _resolve_mesh(mesh)
    if mesh is not None:
        if max_depth_v is not None:
            raise NotImplementedError(
                "per-lane depth caps are single-device only (the sweep path)")
        if getattr(target, "ndim", 1) != 1:
            raise NotImplementedError(
                "per-lane targets are single-device only (the multiclass "
                "sweep path); shard multiclass one class at a time")
    subset_n = subset_w = None
    rate = (
        float(colsample_rate)
        if isinstance(colsample_rate, (int, float)) else None
    )
    if rate is not None and rate < 1.0 and feature_groups is not None:
        narrow_idx = np.asarray(_index(feature_groups[0], "cpu"))
        wide_idx = np.asarray(_index(feature_groups[1], "cpu"))
        f_n, f_w = len(narrow_idx), len(wide_idx)
        f_all = f_n + f_w
        n_sub = max(1, int(round(f_all * rate)))
        if n_sub < f_all:
            n_sub_n = min(f_n, int(round(n_sub * f_n / max(f_all, 1))))
            n_sub_w = min(f_w, n_sub - n_sub_n)
            n_sub_n = min(f_n, n_sub - n_sub_w)
            rng = np.random.default_rng([int(seed), 0x5EED])

            def draw(idx, k):
                return np.stack([
                    np.sort(rng.choice(idx, size=k, replace=False))
                    for _ in range(num_trees)
                ]).astype(np.int32) if k else np.zeros(
                    (num_trees, 0), dtype=np.int32
                )

            subset_n = draw(narrow_idx, n_sub_n)
            subset_w = draw(wide_idx, n_sub_w)
            colsample_rate = 1.0

    def vec_np(v):
        return np.broadcast_to(
            np.asarray(v, dtype=np.float32).reshape(-1), (k_fits,)
        ).copy()

    trees, outs = _forest_trees(
        binned, target, row_mask, int(seed), vec_np(subsample_rate),
        vec_np(colsample_rate), min_instances, min_info_gain,
        feature_groups=feature_groups, max_depth_v=max_depth_v,
        subset_n=subset_n, subset_w=subset_w, num_trees=num_trees,
        max_depth=max_depth, num_bins=num_bins, bootstrap=bootstrap,
        mesh=mesh,
    )
    return (trees, outs) if return_outputs else trees


def fit_forest(binned, target, row_mask, num_trees, max_depth, num_bins,
               subsample_rate=1.0, colsample_rate=1.0, min_instances=1.0,
               min_info_gain=0.0, seed=42, bootstrap=True,
               feature_groups=None) -> Tree:
    """Random forest of mean-target trees: the K=1 case of
    ``fit_forest_batched``. Returns stacked trees [T, ...]."""
    trees = fit_forest_batched(
        binned, target, _f32(row_mask, binned.device)[None, :], num_trees=num_trees,
        max_depth=max_depth, num_bins=num_bins, subsample_rate=subsample_rate,
        colsample_rate=colsample_rate, min_instances=min_instances,
        min_info_gain=min_info_gain, seed=int(seed), bootstrap=bootstrap,
        feature_groups=feature_groups,
    )
    return Tree(*(a[0] for a in trees))
