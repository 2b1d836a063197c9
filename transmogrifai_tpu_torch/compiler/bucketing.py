"""Lane buckets for batched GLM sweeps (the port of the JAX package's
``compiler/bucketing.py``).

A GLM sweep runs its K lanes (folds x same-static grid points) as the
columns of shared GEMMs. The reference pads K up to a small set of
buckets so that near-miss sweeps share one compiled program; the port
pads the same way, so its lanes run at the reference's padded lane counts
(the default logistic grid's 8 points x 3 folds = 24 lanes run as 32).
The padding replays lane 0 in the inert lanes and the caller slices the
real lanes back with ``[:k]``.

Buckets: powers of two up to 64, then multiples of 32.
``TPTPU_LANE_BUCKETS=0`` disables padding.

``mesh_lane_bucket`` is the sharded sweep's variant: lanes split over a
mesh's model axis, so the bucket is rounded up to that axis's size.
Left out: the compile-stats ledger that ``bucket_sweep_lanes`` feeds in
the reference (``record_sweep``, A14).
"""
from __future__ import annotations

import os

import numpy as np

_POW2_CAP = 64
_STEP = 32


def enabled() -> bool:
    return os.environ.get("TPTPU_LANE_BUCKETS", "1") != "0"


def lane_bucket(k: int) -> int:
    """Smallest bucket >= k (identity when padding is disabled or k<=1)."""
    if k <= 1 or not enabled():
        return k
    if k <= _POW2_CAP:
        b = 1
        while b < k:
            b *= 2
        return b
    return -(-k // _STEP) * _STEP


def mesh_lane_bucket(k: int, multiple: int = 1) -> int:
    """Smallest lane bucket >= k that ``multiple`` divides evenly: lanes
    split over a model axis of that size into equal blocks. With padding
    disabled it is the plain ceiling multiple (divisibility is needed by
    the sharded sweep, not an optimization)."""
    multiple = max(1, int(multiple))
    b = max(lane_bucket(k), multiple)
    while b % multiple:
        nb = lane_bucket(b + 1)
        b = nb if nb > b else b + 1
    return b


def bucket_sweep_lanes(*arrays: np.ndarray,
                       multiple: int = 1) -> tuple[int, tuple]:
    """Bucket the lane count of axis 0 (rounded up to ``multiple`` when the
    lanes split over a model axis of that size) and pad every array onto
    it by replicating lane 0. Returns ``(k, padded_arrays)``; callers
    slice the fit's outputs back with ``[:k]``."""
    arrays = tuple(np.asarray(a) for a in arrays)
    k = arrays[0].shape[0]
    bucket = mesh_lane_bucket(k, multiple) if multiple > 1 else lane_bucket(k)
    return k, pad_lane_arrays(bucket, *arrays)


def pad_lane_arrays(bucket: int, *arrays: np.ndarray) -> tuple:
    """Pad each array's axis 0 from K to ``bucket`` by replicating entry 0
    (a real lane, so the padded fit computes nothing undefined). Returns
    the arrays unchanged when no padding is needed."""
    if not arrays:
        return arrays
    k = arrays[0].shape[0]
    if bucket <= k:
        return arrays
    return tuple(
        np.concatenate([a, np.repeat(a[:1], bucket - k, axis=0)], axis=0)
        for a in arrays
    )
