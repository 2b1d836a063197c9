"""Per-key segment reductions of event streams over the mesh (the port of
the JAX package's ``parallel/segments.py``).

The Aggregate and Conditional readers fold per-key event sequences; here
each rank reduces its block of the events per dense key and the per-key
partials are all-reduced over the data axis, so the whole monoid fold is
one collective instead of a shuffle. Monoids: sum, max, min, mean, count
and logical or. Keys are dense ints in [0, num_segments)
(:func:`factorize_keys`).
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh import DATA_AXIS, Mesh, shard_rows

_NEUTRAL = {"sum": 0.0, "mean": 0.0, "count": 0.0, "or": 0.0,
            "max": -np.inf, "min": np.inf}


def _reduce(mesh: Mesh, values: torch.Tensor, seg_ids: torch.Tensor,
            num_segments: int, op: str) -> torch.Tensor:
    out = torch.full((num_segments,), _NEUTRAL[op], dtype=torch.float32,
                     device=values.device)
    if op == "sum":
        out.scatter_add_(0, seg_ids, values)
    else:
        out.scatter_reduce_(0, seg_ids, values, reduce="amax" if op == "max"
                            else "amin", include_self=True)
    return mesh.all_reduce("psegment_reduce", out, op=op)


def psegment_reduce(values: np.ndarray, seg_ids: np.ndarray,
                    num_segments: int, mesh: Mesh, op: str = "sum") -> np.ndarray:
    """Per-segment reduction of ``values`` by dense int keys over the
    mesh. op: 'sum' | 'mean' | 'max' | 'min' | 'count' | 'or'. Padding
    rows carry the op's neutral element on segment 0, so results do not
    depend on the rank count or the padding."""
    if op not in _NEUTRAL:
        raise ValueError(f"unknown segment op {op!r}")
    values = np.asarray(values, dtype=np.float32)
    seg_ids = np.asarray(seg_ids, dtype=np.int64)
    if op == "count":
        values = np.ones_like(values, dtype=np.float32)
    if op == "or":
        values = (values != 0).astype(np.float32)
    if op == "mean":
        # one reduction: sums in segments [0, S), counts in [S, 2S)
        s = int(num_segments)
        both = psegment_reduce(
            np.concatenate([values, np.ones_like(values)]),
            np.concatenate([seg_ids, seg_ids + s]), 2 * s, mesh, op="sum")
        sums, counts = both[:s], both[s:]
        with np.errstate(invalid="ignore"):
            return np.where(counts > 0, sums / np.maximum(counts, 1), np.nan)
    d = mesh.shape[DATA_AXIS]
    n = len(values)
    pad = (-n) % d
    if pad:
        values = np.concatenate(
            [values, np.full(pad, _NEUTRAL[op], dtype=np.float32)])
        seg_ids = np.concatenate([seg_ids, np.zeros(pad, dtype=np.int64)])
    vl = torch.from_numpy(np.ascontiguousarray(shard_rows(mesh, values)))
    sl = torch.from_numpy(np.ascontiguousarray(shard_rows(mesh, seg_ids)))
    kernel_op = "sum" if op in ("count", "or") else op
    out = _reduce(mesh, vl.to(mesh.device), sl.to(mesh.device),
                  int(num_segments), kernel_op)
    out = out.cpu().numpy()
    if op == "or":
        out = (out > 0).astype(np.float32)
    return out


def factorize_keys(keys) -> tuple[np.ndarray, list]:
    """Host-side key densification: (dense int ids, sorted unique keys)."""
    uniq = sorted(set(keys))
    index = {k: i for i, k in enumerate(uniq)}
    return np.asarray([index[k] for k in keys], dtype=np.int32), uniq


def aggregate_events_on_device(keys, values: np.ndarray, mesh: Mesh,
                               op: str = "sum") -> dict:
    """Group ``values`` by arbitrary ``keys`` with the given monoid over
    the mesh; returns {key: reduced value}."""
    seg_ids, uniq = factorize_keys(keys)
    out = psegment_reduce(values, seg_ids, len(uniq), mesh, op=op)
    return {k: float(out[i]) for i, k in enumerate(uniq)}
