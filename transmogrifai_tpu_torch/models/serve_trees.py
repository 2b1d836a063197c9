"""Serve-side multi-tree traversal: the port of ``models/serve_pallas.py``.

``serve_trees(binned, split_feat, split_bin, leaf_value)`` gives every
(row, tree) pair its leaf value, [N, T] float32. A tree is a dense perfect
binary tree: level l uses node slots [0, 2^l); a row goes right iff
``split_feat >= 0`` and ``binned[r, split_feat] > split_bin``, and the child
is ``2 * node + right``; ``split_feat = -1`` is a leaf that routes left.

On a CUDA tensor the wrapper launches the hand-written kernel
``csrc/serve_trees.cu`` (built at first use) or raises; on a CPU tensor it
runs ``serve_trees_reference``, the plain PyTorch walk. The result is
bit-identical either way: the walk is integer compare logic.

The forest mean and the boosted ``base + eta * sum`` are PyTorch reductions
over the kernel's output, as in the reference.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build

_KERNEL = "serve_trees"


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


def _check(binned, split_feat, split_bin, leaf_value) -> None:
    tensors = {
        "binned": binned, "split_feat": split_feat, "split_bin": split_bin,
        "leaf_value": leaf_value,
    }
    for name, x in tensors.items():
        want = torch.float32 if name == "leaf_value" else torch.int32
        if not isinstance(x, torch.Tensor) or x.dtype != want:
            raise TypeError(
                f"serve_trees: {name} must be a {want} tensor, got "
                f"{getattr(x, 'dtype', type(x).__name__)}"
            )
        if not x.is_contiguous():
            raise ValueError(f"serve_trees: {name} must be contiguous")
        if x.device != binned.device:
            raise ValueError(
                f"serve_trees: {name} is on {x.device}, binned on {binned.device}"
            )
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


def _on_cuda(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library(_KERNEL)
    fn = lib.tp_serve_trees
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def serve_trees(
    binned: torch.Tensor, split_feat: torch.Tensor, split_bin: torch.Tensor,
    leaf_value: torch.Tensor,
) -> torch.Tensor:
    """Per-tree leaf value for every row -> [N, T] float32.

    ``binned`` [N, F] int32 bin codes; ``split_feat``/``split_bin``
    [T, depth, W] int32 (W >= 2^(depth-1); every feature index < F, which
    the caller validates once per model); ``leaf_value`` [T, 2^depth]
    float32. All contiguous and on one device."""
    _check(binned, split_feat, split_bin, leaf_value)
    if not _on_cuda(binned):
        if binned.device.type != "cpu":
            raise ValueError(f"serve_trees: unsupported device {binned.device}")
        return serve_trees_reference(binned, split_feat, split_bin, leaf_value)
    lib = _library()
    n, f = binned.shape
    t, depth, width = split_feat.shape
    out = torch.empty((n, t), dtype=torch.float32, device=binned.device)
    stream = torch.cuda.current_stream(binned.device).cuda_stream
    rc = lib.tp_serve_trees(
        binned.data_ptr(), split_feat.data_ptr(), split_bin.data_ptr(),
        leaf_value.data_ptr(), out.data_ptr(),
        n, f, t, depth, width, leaf_value.shape[1], stream,
    )
    if rc != 0:
        msg = lib.tp_cuda_error_string(rc).decode()
        raise RuntimeError(f"serve_trees kernel launch failed: {msg} ({rc})")
    serve_trees.launches += 1
    return out


#: kernel launches since the last reset (the plain CPU walk is not counted)
serve_trees.launches = 0


def predict_forest(binned: torch.Tensor, trees) -> torch.Tensor:
    """Mean leaf value across the stacked forest -> [N] float32."""
    per_tree = serve_trees(
        binned, trees.split_feat, trees.split_bin, trees.leaf_value
    )
    return per_tree.mean(dim=1)


def predict_boosted(binned: torch.Tensor, trees, eta, base_score) -> torch.Tensor:
    """``base + eta * Σ rounds`` -> [N] float32."""
    per_tree = serve_trees(
        binned, trees.split_feat, trees.split_bin, trees.leaf_value
    )
    eta = torch.as_tensor(eta, dtype=torch.float32, device=binned.device)
    base = torch.as_tensor(base_score, dtype=torch.float32, device=binned.device)
    return base + eta * per_tree.sum(dim=1)
