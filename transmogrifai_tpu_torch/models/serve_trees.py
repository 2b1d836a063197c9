"""Serve-side multi-tree traversal: the port of ``models/serve_pallas.py``
(kernel K1).

``serve_trees(binned, split_feat, split_bin, leaf_value)`` gives every
(row, tree) pair its leaf value, [N, T] float32. A tree is a dense perfect
binary tree: level l uses node slots [0, 2^l); a row goes right iff
``split_feat >= 0`` and ``binned[r, split_feat] > split_bin``, and the child
is ``2 * node + right``; ``split_feat = -1`` routes left, and the walk goes
on below it.

The kernel (``csrc/serve_trees.cu``, built at first use) walks trees whose
nodes are packed in heap order (``PackedTrees``): one 32-bit word a node,
feature << 16 | split bin, or two words where a model's features or bins do
not fit 16 bits ("wide"). A model packs its stacks once, on the host, when
it is placed on a device (``pack_trees``), and its predict path calls
``serve_trees_packed``. ``serve_trees`` packs per call into the wide layout
with the same PyTorch ops (``pack_trees_plain`` on the tensors' device:
no host read of the split arrays) and walks that; no model path takes it.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs the plain PyTorch walk (``serve_trees_reference``, the gather walk
over the split arrays; ``serve_packed_plain``, the same walk over the
packed layout). The result is bit-identical every way: the walk is integer
compare logic.

The forest mean and the boosted ``base + eta * sum`` reduce the kernel's
output per row in tree order (``tree_sum.tree_sum``, a kernel of its own on
the card), as the reference's serving route does for batches of up to
16384 rows. Above that the reference takes its device route, which sums in
leaf windows: ``predict_device_route`` walks the stack a second time with
a leaf table of leaf // 32 (``window_stack``) and reduces both outputs
through ``tree_sum.tree_sum_device_route``.
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple

import torch

from ..utils import cuda_build
from .tree_sum import leaf_windows, tree_sum, tree_sum_device_route

_KERNEL = "serve_trees"

#: levels kept in shared memory; deeper levels are read from global memory
TOP_LEVELS = 10
#: bytes of one tile's nodes: two tiles and a row chunk's codes share a
#: block's shared memory
TILE_NODE_BYTES = 64 * 1024
#: shared memory a block may take (of the H100's 227 KB)
SMEM_BYTES = 232448 - 1024
#: a packed word holds 16-bit features and bins in [0, 0xFFFE]; a leaf is
#: (0, 0xFFFF), above every code the kernel compares it with (a word pair's
#: leaf is (0, INT32_MAX)). A model outside takes the wide layout
PACKED_MAX_FEATURES = 1 << 16
PACKED_MAX_BIN = 0xFFFE
_LEAF_WORD = 0xFFFF
_LEAF_PAIR = [0, 2**31 - 1]

#: the walk's block size (fixed in the kernel) and the walks a thread takes
#: at once (halved where a row chunk is too small for them)
THREADS = 1024
WALKS = 2


class PackedTrees(NamedTuple):
    """A tree stack in the kernel's layout (``csrc/serve_trees.cu``). Trees
    come in tiles of ``tile_trees``; ``top`` [tiles, 2^top_levels - 1,
    tile_trees] int32 (wide: [..., 2]) holds the top levels in heap order
    (level l, node m at 2^l - 1 + m) with the tile's trees interleaved, the
    last tile padded with leaf-only trees; ``bottom`` [T, 2^depth -
    2^top_levels] (wide: [..., 2]) the levels below, per tree;
    ``leaf_value`` [T, 2^depth] float32 and, at depth <= TOP_LEVELS,
    ``leaf_tiles`` [tiles, 2^depth, tile_trees] the same leaves interleaved
    as the nodes are. ``code_bytes``: the bytes a staged code needs for
    ``code > bin`` to stay exact when it saturates (1 where every live
    split bin is below 255, 2 below 65535, else 4)."""

    top: torch.Tensor
    bottom: torch.Tensor
    leaf_value: torch.Tensor
    leaf_tiles: torch.Tensor
    depth: int
    top_levels: int
    tile_trees: int
    wide: bool
    code_bytes: int

    @property
    def num_trees(self) -> int:
        return self.leaf_value.shape[0]

    def to(self, device) -> "PackedTrees":
        return self._replace(
            top=self.top.to(device), bottom=self.bottom.to(device),
            leaf_value=self.leaf_value.to(device),
            leaf_tiles=self.leaf_tiles.to(device),
        )


def _live_bins(split_feat, split_bin) -> tuple[int, int]:
    live = split_bin[split_feat >= 0]
    return (int(live.min()), int(live.max())) if live.numel() else (0, 0)


def fits_packed(split_feat: torch.Tensor, split_bin: torch.Tensor,
                num_features: int) -> bool:
    """Whether one 32-bit word a node holds this stack exactly (host
    tensors: it reads their values)."""
    lo, hi = _live_bins(split_feat, split_bin)
    return num_features <= PACKED_MAX_FEATURES and lo >= 0 and hi <= PACKED_MAX_BIN


def code_bytes_for(split_feat, split_bin) -> int:
    """The narrowest staged code for which a saturated code compares with
    every live split bin as the full code does (host tensors)."""
    lo, hi = _live_bins(split_feat, split_bin)
    if lo < 0:
        return 4
    return 1 if hi < 0xFF else 2 if hi < 0xFFFF else 4


def tile_trees_for(depth: int, wide: bool) -> int:
    """Trees a tile: the most, up to 32 (a warp), whose top levels fit
    ``TILE_NODE_BYTES``."""
    node_bytes = ((1 << min(depth, TOP_LEVELS)) - 1) * (8 if wide else 4)
    tile = 32
    while tile > 1 and tile * node_bytes > TILE_NODE_BYTES:
        tile //= 2
    return tile


@functools.lru_cache(maxsize=64)
def _heap_levels(depth: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(level, node) of every heap index in [0, 2^depth - 1), made on the
    host once per (depth, device)."""
    levels = torch.arange(depth)
    level = torch.repeat_interleave(levels, 1 << levels)
    node = torch.arange(level.numel()) + 1 - (1 << level)
    return level.to(device), node.to(device)


def _interleave(x: torch.Tensor, tile: int, fill: tuple) -> torch.Tensor:
    """[T, K, ...] -> [tiles, K, tile, ...]: trees in tiles of ``tile``,
    interleaved, the last tile padded with ``fill`` (one value per entry of
    the last axis, or one value)."""
    t = x.shape[0]
    tiles = -(-t // tile)
    out = x.new_empty((tiles * tile, *x.shape[1:]))
    out[:t] = x
    if len(fill) == 1:
        out[t:] = fill[0]
    else:
        for i, v in enumerate(fill):
            out[t:, ..., i] = v
    return out.reshape(tiles, tile, *x.shape[1:]).transpose(1, 2).contiguous()


def pack_trees_plain(split_feat: torch.Tensor, split_bin: torch.Tensor,
                     leaf_value: torch.Tensor, wide: bool) -> PackedTrees:
    """The packing, in PyTorch ops on the tensors' device: the split arrays
    [T, depth, W] in heap order, as 32-bit words or (``wide``) pairs, the
    top ``TOP_LEVELS`` levels in tiles of ``tile_trees_for`` trees. Packed
    words need ``fits_packed``; their staged codes are ``code_bytes_for``
    wide (it reads the bins), pairs' whole (no read of the values)."""
    t, depth, _ = split_feat.shape
    level, m = _heap_levels(depth, split_feat.device)
    feat = split_feat[:, level, m].long()        # [T, P]
    bin_ = torch.where(feat >= 0, split_bin[:, level, m].long(), 0)
    leaf = feat < 0
    if wide:
        nodes = torch.stack([torch.where(leaf, 0, feat),
                             torch.where(leaf, _LEAF_PAIR[1], bin_)],
                            dim=-1).to(torch.int32)
        pad = tuple(_LEAF_PAIR)
    else:
        word = torch.where(leaf, _LEAF_WORD, (feat << 16) | bin_)
        nodes = (word - ((word >= 1 << 31).long() << 32)).to(torch.int32)
        pad = (_LEAF_WORD,)
    top_levels = min(depth, TOP_LEVELS)
    ps = (1 << top_levels) - 1
    tile = tile_trees_for(depth, wide)
    leaf_value = leaf_value.contiguous()
    leaf_tiles = (_interleave(leaf_value, tile, (0.0,)) if depth <= TOP_LEVELS
                  else leaf_value.new_zeros((0,)))
    code_bytes = 4 if wide else code_bytes_for(split_feat, split_bin)
    return PackedTrees(_interleave(nodes[:, :ps], tile, pad),
                       nodes[:, ps:].contiguous(), leaf_value, leaf_tiles,
                       depth, top_levels, tile, wide, code_bytes)


def window_stack(packed: PackedTrees) -> PackedTrees:
    """The stack with every leaf's value replaced by its leaf window,
    float(leaf // 32) (exact in float32), interleaved as its leaves are:
    the walk over it gives each (row, tree)'s window. Its nodes are the
    stack's own tensors."""
    t, depth = packed.num_trees, packed.depth
    leaf = torch.arange(1 << depth, device=packed.leaf_value.device)
    table = (leaf // 32).to(torch.float32).expand(t, -1).contiguous()
    tiles = (_interleave(table, packed.tile_trees, (0.0,))
             if depth <= TOP_LEVELS else table.new_zeros((0,)))
    return packed._replace(leaf_value=table, leaf_tiles=tiles)


def pack_trees(split_feat, split_bin, leaf_value,
               num_features: int) -> PackedTrees:
    """A model's stack packed once, on the host, from CPU tensors whose
    feature indices are validated: 32-bit words where they hold it
    (``fits_packed``), else the wide layout."""
    wide = not fits_packed(split_feat, split_bin, num_features)
    return pack_trees_plain(split_feat, split_bin, leaf_value, wide)


def serve_trees_reference(
    binned: torch.Tensor, split_feat: torch.Tensor, split_bin: torch.Tensor,
    leaf_value: torch.Tensor,
) -> torch.Tensor:
    """The plain PyTorch walk: one ``gather`` per level over all trees at
    once, with -1 features clamped to column 0 and masked out."""
    n = binned.shape[0]
    t, depth, _ = split_feat.shape
    codes_t = binned.t().long()                      # [F, N]
    node = torch.zeros((t, n), dtype=torch.long, device=binned.device)
    for lvl in range(depth):
        feat = torch.gather(split_feat[:, lvl, :].long(), 1, node)  # [T, N]
        thr = torch.gather(split_bin[:, lvl, :].long(), 1, node)
        if codes_t.shape[0]:
            code = torch.gather(codes_t, 0, feat.clamp(min=0))
            right = (feat >= 0) & (code > thr)
        else:  # no features: every split is a leaf
            right = torch.zeros_like(feat, dtype=torch.bool)
        node = node * 2 + right.long()
    return torch.gather(leaf_value, 1, node).t().contiguous()


def unpack_trees(packed: PackedTrees):
    """The split arrays [T, depth, 2^depth] and leaves of a packed stack,
    decoded from its words (slots past 2^l on level l are leaves)."""
    t, depth = packed.num_trees, packed.depth
    tiles, ps, tile = packed.top.shape[:3]
    top = packed.top.transpose(1, 2).reshape(tiles * tile, ps,
                                             *packed.top.shape[3:])[:t]
    nodes = torch.cat([top, packed.bottom], dim=1).long()
    if packed.wide:
        feat, thr = nodes[..., 0], nodes[..., 1]
        leaf = thr == _LEAF_PAIR[1]
    else:
        word = nodes & 0xFFFFFFFF
        feat, thr = word >> 16, word & 0xFFFF
        leaf = thr == _LEAF_WORD
    feat = torch.where(leaf, -1, feat)
    thr = torch.where(leaf, 0, thr)
    split_feat = torch.full((t, depth, 1 << depth), -1, dtype=torch.int32,
                            device=nodes.device)
    split_bin = torch.zeros_like(split_feat)
    for lvl in range(depth):
        heap = slice((1 << lvl) - 1, (2 << lvl) - 1)
        split_feat[:, lvl, : 1 << lvl] = feat[:, heap].to(torch.int32)
        split_bin[:, lvl, : 1 << lvl] = thr[:, heap].to(torch.int32)
    return split_feat, split_bin, packed.leaf_value


def serve_packed_plain(binned: torch.Tensor, packed: PackedTrees) -> torch.Tensor:
    """The plain walk over a packed stack (the kernel's plain version): its
    words decoded (``unpack_trees``), then the gather walk."""
    return serve_trees_reference(binned, *unpack_trees(packed))


def _check_tensor(name, x, want, device) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != want:
        raise TypeError(
            f"serve_trees: {name} must be a {want} tensor, got "
            f"{getattr(x, 'dtype', type(x).__name__)}"
        )
    if not x.is_contiguous():
        raise ValueError(f"serve_trees: {name} must be contiguous")
    if x.device != device:
        raise ValueError(f"serve_trees: {name} is on {x.device}, binned on {device}")


def _check(binned, split_feat, split_bin, leaf_value) -> None:
    for name, x in (("binned", binned), ("split_feat", split_feat),
                    ("split_bin", split_bin), ("leaf_value", leaf_value)):
        want = torch.float32 if name == "leaf_value" else torch.int32
        _check_tensor(name, x, want, binned.device)
    if binned.dim() != 2 or split_feat.dim() != 3:
        raise ValueError(
            f"serve_trees: binned [N, F] and split_feat [T, depth, W] expected, "
            f"got {tuple(binned.shape)} and {tuple(split_feat.shape)}"
        )
    t, depth, width = split_feat.shape
    if split_bin.shape != split_feat.shape:
        raise ValueError(
            f"serve_trees: split_bin {tuple(split_bin.shape)} != split_feat "
            f"{tuple(split_feat.shape)}"
        )
    if depth and width < 1 << (depth - 1):
        raise ValueError(
            f"serve_trees: level width {width} < 2^(depth-1) at depth {depth}"
        )
    if tuple(leaf_value.shape) != (t, 1 << depth):
        raise ValueError(
            f"serve_trees: leaf_value {tuple(leaf_value.shape)} != "
            f"({t}, {1 << depth})"
        )
    if max(binned.numel(), split_feat.numel(), leaf_value.numel()) >= 2**31:
        raise ValueError("serve_trees: more than 2^31 elements in one input")


@functools.lru_cache(maxsize=256)
def _packed_shapes(t: int, depth: int, ls: int, tile: int, wide: bool) -> tuple:
    """(top, bottom, leaf_value, leaf_tiles) shapes of a valid layout."""
    tiles = -(-t // tile)
    pair = (2,) if wide else ()
    return ((tiles, (1 << ls) - 1, tile, *pair),
            (t, (1 << depth) - (1 << ls), *pair),
            (t, 1 << depth),
            (tiles, 1 << depth, tile) if depth <= TOP_LEVELS else (0,))


_PACKED_DTYPES = (torch.int32, torch.int32, torch.float32, torch.float32)
_PACKED_NAMES = ("top", "bottom", "leaf_value", "leaf_tiles")
#: stacks already validated, by the id of their ``top`` tensor: weak
#: references to the four tensors and the layout's ints (a model scores the
#: same stacks batch after batch, and its per-call cost is host time)
_VALIDATED: dict[int, tuple] = {}


def _validate_packed(packed: PackedTrees) -> None:
    dev = packed.top.device
    for name, x, want in zip(_PACKED_NAMES, packed[:4], _PACKED_DTYPES):
        _check_tensor(name, x, want, dev)
    t, depth, ls, tile = (packed.num_trees, packed.depth, packed.top_levels,
                          packed.tile_trees)
    # a word's leaf bin 0xFFFF is above every code only if codes saturate
    if ls != min(depth, TOP_LEVELS) or tile not in (1, 2, 4, 8, 16, 32) \
            or packed.code_bytes not in ((1, 2, 4) if packed.wide else (1, 2)):
        raise ValueError(f"serve_trees: packed layout (top_levels {ls}, tile "
                         f"{tile}, code bytes {packed.code_bytes}) at depth "
                         f"{depth}")
    want = _packed_shapes(t, depth, ls, tile, packed.wide)
    for name, x, shape in zip(_PACKED_NAMES, packed[:4], want):
        if x.shape != shape:
            raise ValueError(f"serve_trees: packed {name} {tuple(x.shape)} "
                             f"!= {shape}")
    if max(x.numel() for x in packed[:4]) >= 2**31:
        raise ValueError("serve_trees: more than 2^31 elements in one array")
    if dev.type == "cuda" and (packed.top.data_ptr() % 16
                               or packed.leaf_tiles.data_ptr() % 16):
        raise ValueError("serve_trees: packed top and leaf_tiles must be "
                         "16-byte aligned (bulk copies)")


def _check_packed(binned, packed: PackedTrees) -> None:
    """``binned`` on every call; the stack once, while it stays the same
    objects (``_VALIDATED``)."""
    if binned.dtype != torch.int32 or binned.dim() != 2 \
            or not binned.is_contiguous():
        _check_tensor("binned", binned, torch.int32, binned.device)
        raise ValueError(f"serve_trees: binned [N, F] expected, got "
                         f"{tuple(binned.shape)}")
    # a window stack shares its nodes with its model's stack
    key = (id(packed.top), id(packed.leaf_value))
    seen = _VALIDATED.get(key)
    if seen is None or seen[4] != packed[4:] or any(
            ref() is not x for ref, x in zip(seen[:4], packed[:4])):
        _validate_packed(packed)
        _VALIDATED[key] = (
            weakref.ref(packed.top, lambda _, key=key: _VALIDATED.pop(key, None)),
            *(weakref.ref(x) for x in packed[1:4]), tuple(packed[4:]))
    if binned.device != packed.top.device:
        raise ValueError(f"serve_trees: packed stack is on "
                         f"{packed.top.device}, binned on {binned.device}")
    if binned.numel() >= 2**31 or binned.shape[0] * packed.num_trees >= 2**31:
        raise ValueError("serve_trees: more than 2^31 elements in one array")


def _on_cuda(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type != "cpu":
        raise ValueError(f"serve_trees: unsupported device {x.device}")
    return True


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library(_KERNEL)
    fn = lib.tp_serve_trees
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_int),
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.tp_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_shape(packed: PackedTrees, n: int, f: int, sms: int = 132) -> dict:
    """``_plan`` for ``packed`` (a copy: the plans are cached)."""
    return dict(_plan(packed.depth, packed.top_levels, packed.tile_trees,
                      packed.wide, packed.code_bytes, packed.num_trees, n, f,
                      sms))


@functools.lru_cache(maxsize=256)
def _plan(depth: int, top_levels: int, tile: int, wide: bool, code_bytes: int,
          num_trees: int, n: int, f: int, sms: int) -> dict:
    """The walk's launch for ``packed`` over [n, f] codes. A pass of a
    block covers THREADS / tile_trees rows (``groups``) ``walks`` times.
    Chunk order stages a chunk of rows' codes, as many as fit beside two
    tile buffers while each block still gets 2 items, and moves about the
    codes once and the trees once per chunk; tile order moves the codes
    once per tile and the trees about once per block (``sms`` blocks). The
    order that moves fewer bytes is taken. Then the leaves go beside the
    nodes where they still fit: in chunk order beside both buffers, in tile
    order beside one if not two (a block of tile order seldom changes
    tiles)."""
    groups = THREADS // tile
    walks = WALKS
    tiles = -(-num_trees // tile)
    nodes = -(-tile * ((1 << top_levels) - 1) * (8 if wide else 4) // 16) * 16
    stride = -(-f * code_bytes // 16) * 16
    # as many rows as fit, but items enough (2 a block) to busy every block
    chunk = min((SMEM_BYTES - 2 * nodes) // stride if stride else 0,
                n * tiles // (2 * sms))
    chunk = min(chunk // groups * groups, -(-n // groups) * groups)
    plane = 4 * n * f
    by_chunk = (plane + -(-n // max(chunk, 1)) * tiles * nodes
                if chunk >= groups else None)
    by_tile = tiles * plane + sms * nodes
    order = "chunk" if by_chunk is not None and by_chunk < by_tile else "tile"
    if order == "chunk":
        while walks > 1 and chunk < groups * walks:
            walks //= 2
        rows = chunk // (groups * walks) * (groups * walks)
        staged = code_bytes
    else:
        rows, staged = groups * walks, 0
    codes = rows * stride if staged else 0
    buffers = 2 if 2 * nodes + codes <= SMEM_BYTES else 1
    with_leaves = nodes + tile * (4 << depth)
    stage = depth <= TOP_LEVELS
    if stage and buffers * with_leaves + codes > SMEM_BYTES:
        if order == "tile" and with_leaves + codes <= SMEM_BYTES:
            buffers = 1
        else:
            stage = False
    return {"threads": THREADS, "walks": walks, "order": order,
            "chunk_rows": rows, "code_bytes": staged, "buffers": buffers,
            "stage_leaves": stage, "bytes_moved": {"tile": by_tile,
                                                   "chunk": by_chunk}}


@functools.lru_cache(maxsize=256)
def _launch_args(depth: int, top_levels: int, tile: int, wide: bool,
                 code_bytes: int, num_trees: int, n: int, f: int,
                 sms: int) -> ctypes.Array:
    """The 13 ints ``tp_serve_trees`` takes, for this stack and batch."""
    plan = _plan(depth, top_levels, tile, wide, code_bytes, num_trees, n, f,
                 sms)
    vals = (n, f, num_trees, depth, top_levels, int(wide), tile,
            plan["walks"], plan["code_bytes"], plan["chunk_rows"],
            int(plan["order"] == "tile"), plan["buffers"],
            int(plan["stage_leaves"]))
    return (ctypes.c_int * len(vals))(*vals)


def _walk(binned: torch.Tensor, packed: PackedTrees) -> torch.Tensor:
    """Launch the walk kernel on checked CUDA tensors."""
    lib = _library()
    n, f = binned.shape
    if not f:  # every node is a leaf; the kernel reads a code all the same
        binned = torch.zeros((n, 1), dtype=torch.int32, device=binned.device)
    args = _launch_args(packed.depth, packed.top_levels, packed.tile_trees,
                        packed.wide, packed.code_bytes, packed.num_trees, n,
                        binned.shape[1], _sm_count(binned.device.index))
    out = torch.empty((n, packed.num_trees), dtype=torch.float32,
                      device=binned.device)
    rc = lib.tp_serve_trees(
        binned.data_ptr(), packed.top.data_ptr(), packed.bottom.data_ptr(),
        packed.leaf_value.data_ptr(), packed.leaf_tiles.data_ptr(),
        out.data_ptr(), args,
        # the raw handle: a Stream object costs microseconds a call, and a
        # serving batch's walk takes tens of them
        torch._C._cuda_getCurrentRawStream(binned.device.index),
    )
    _raise_on(lib, rc, "serve_trees")
    if n and packed.num_trees:
        serve_trees.launches += 1
    return out


def serve_trees(
    binned: torch.Tensor, split_feat: torch.Tensor, split_bin: torch.Tensor,
    leaf_value: torch.Tensor,
) -> torch.Tensor:
    """Per-tree leaf value for every row -> [N, T] float32.

    ``binned`` [N, F] int32 bin codes; ``split_feat``/``split_bin``
    [T, depth, W] int32 (W >= 2^(depth-1); every feature index < F, which
    the caller validates once per model); ``leaf_value`` [T, 2^depth]
    float32. All contiguous and on one device. On the card the stack is
    packed per call into the wide layout, which holds any stack without a
    read of its values (``pack_trees_plain``), and walked."""
    _check(binned, split_feat, split_bin, leaf_value)
    if not _on_cuda(binned):
        _on_cpu(binned)
        return serve_trees_reference(binned, split_feat, split_bin, leaf_value)
    return _walk(binned, pack_trees_plain(split_feat, split_bin, leaf_value,
                                          wide=True))


#: walk-kernel launches since the last reset, through ``serve_trees`` and
#: ``serve_trees_packed`` (the plain CPU walks are not counted)
serve_trees.launches = 0


def serve_trees_packed(binned: torch.Tensor, packed: PackedTrees) -> torch.Tensor:
    """``serve_trees`` over a stack packed once (``pack_trees``): the
    models' predict path."""
    _check_packed(binned, packed)
    if not _on_cuda(binned):
        _on_cpu(binned)
        return serve_packed_plain(binned, packed)
    return _walk(binned, packed)


def _per_tree(binned: torch.Tensor, trees) -> torch.Tensor:
    if isinstance(trees, PackedTrees):
        return serve_trees_packed(binned, trees)
    return serve_trees(binned, trees.split_feat, trees.split_bin,
                       trees.leaf_value)


def predict_forest(binned: torch.Tensor, trees) -> torch.Tensor:
    """Mean leaf value across the stacked forest (a ``Tree`` stack or
    ``PackedTrees``) -> [N] float32: the trees summed in order, then
    divided by T (``tree_sum``)."""
    return tree_sum(_per_tree(binned, trees), boosted=False)


def predict_boosted(binned: torch.Tensor, trees, eta, base_score) -> torch.Tensor:
    """``base + eta * Σ rounds`` -> [N] float32, the rounds summed in
    order (``tree_sum``)."""
    return tree_sum(_per_tree(binned, trees), boosted=True, eta=float(eta),
                    base_score=float(base_score))


def predict_device_route(binned: torch.Tensor, packed: PackedTrees,
                         windows: PackedTrees, boosted: bool, eta=0.0,
                         base_score=0.0) -> torch.Tensor:
    """[N] float32 in the reference's device-route order
    (``tree_sum.tree_sum_device_route``): the stack walked for its leaf
    values and, where the leaves form more than one window
    (``tree_sum.leaf_windows``), walked again over ``windows``
    (``window_stack(packed)``) for each leaf's window."""
    h = leaf_windows(binned.shape[0], packed.depth)
    per_tree = serve_trees_packed(binned, packed)
    win = serve_trees_packed(binned, windows) if h > 1 else None
    return tree_sum_device_route(per_tree, win, h, boosted, eta=float(eta),
                                 base_score=float(base_score))
