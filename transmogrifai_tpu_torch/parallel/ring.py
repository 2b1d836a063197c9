"""Feature-axis (column) sharding with ring passes: the wide-axis analog
of ring attention (the port of the JAX package's ``parallel/ring.py``).

The reference's long axis is the feature axis: hashing vectorizers reach
2^17 columns, and SanityChecker needs the F x F feature-feature gram. At
that width a replicated gram does not fit beside the data. The ring
layout:

* every rank holds one column block X_k [N, F/d];
* the gram is built in d ring steps: at step s a rank multiplies its
  resident block by a rotating block and passes the rotating block to its
  ring neighbour (point-to-point ``torch.distributed`` send / receive);
* rank k ends holding the row block G_k = X_kᵀ·X; the blocks are then
  gathered so every rank returns the whole gram, as the reference's host
  copy does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.stats import full_f32_matmul
from .guarded import guarded_collective
from .mesh import DATA_AXIS, Mesh


def pad_cols(x: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Zero-pad axis 1 to a multiple of ``multiple``; zero columns are
    neutral for gram and sum reductions. Returns (padded, original_f)."""
    f = x.shape[1]
    rem = f % multiple
    if rem == 0:
        return x, f
    pad = np.zeros((x.shape[0], multiple - rem), dtype=x.dtype)
    return np.concatenate([x, pad], axis=1), f


def shard_cols(mesh: Mesh, x) -> torch.Tensor:
    """This rank's column block of ``x`` (columns a multiple of the
    data-axis size) on the mesh's device."""
    d = mesh.shape[DATA_AXIS]
    fl = x.shape[1] // d
    lo = mesh.data_index * fl
    block = np.ascontiguousarray(np.asarray(x)[:, lo:lo + fl])
    return torch.from_numpy(block).to(mesh.device)


def _ring_pass(mesh: Mesh, rot: torch.Tensor) -> torch.Tensor:
    """Send ``rot`` to the next rank of the data ring and receive the
    previous rank's (``gloo`` moves a card's tensors through the host)."""
    import torch.distributed as dist

    _, members = mesh._groups[DATA_AXIS]
    pos = mesh.data_index
    d = len(members)
    staged = rot.cpu() if (mesh.backend == "gloo" and rot.is_cuda) else rot
    buf = torch.empty_like(staged.contiguous())
    ops = [dist.P2POp(dist.isend, staged.contiguous(), members[(pos + 1) % d]),
           dist.P2POp(dist.irecv, buf, members[(pos - 1) % d])]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf.to(rot.device)


def _ring_gram(mesh: Mesh, xl: torch.Tensor) -> torch.Tensor:
    d = mesh.shape[DATA_AXIS]
    fl = xl.shape[1]
    idx = mesh.data_index
    out = torch.zeros((fl, fl * d), dtype=xl.dtype, device=xl.device)
    rot = xl
    for s in range(d):
        # after s passes the rotating block started on ring position
        # (idx - s) mod d: the gram column block it fills
        j = (idx - s) % d
        with full_f32_matmul():
            out[:, j * fl:(j + 1) * fl] = xl.T @ rot
        if s + 1 < d:
            rot = guarded_collective("ring_pass", _ring_pass, mesh, rot)
    return mesh.all_gather("ring_gram", out, 0)


def ring_gram(x: np.ndarray, mesh: Mesh) -> np.ndarray:
    """XᵀX [F, F] of a column-sharded matrix by ring passes: rows stay
    resident, column blocks ride the ring."""
    d = mesh.shape[DATA_AXIS]
    xp, f = pad_cols(np.asarray(x, dtype=np.float32), d)
    xs = shard_cols(mesh, xp)
    g = _ring_gram(mesh, xs)
    return g.cpu().numpy().astype(np.float64)[:f, :f]


def ring_corr(x: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Pearson correlation [F, F] with the gram built over the ring; the
    per-column moments are host work, only the F x F term rides the ring.
    Constant columns correlate 0."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    mean = x.mean(axis=0)
    g = ring_gram(x - mean, mesh)
    var = np.clip(np.diag(g), 0.0, None)
    denom = np.sqrt(np.outer(var, var))
    with np.errstate(invalid="ignore", divide="ignore"):
        corr = np.where(denom > 0, g / np.where(denom > 0, denom, 1.0), 0.0)
    np.fill_diagonal(corr, np.where(var > n * 1e-18, 1.0, 0.0))
    return corr
