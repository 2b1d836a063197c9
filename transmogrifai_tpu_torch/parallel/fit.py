"""Data- and model-parallel fit wrappers (the port of the JAX package's
``parallel/fit.py``).

* :func:`data_parallel_fit` runs one solver with the rows split over the
  mesh's data axis; the solver all-reduces every sum over rows
  (``models/solvers.py``, ``mesh=``), so every rank takes the same steps.
* :func:`grid_parallel_fit` splits the stacked hyperparameter points over
  the mesh's model axis (the reference's pool of candidate fits),
  each rank fitting its points over its row block, and gathers the fits.
* :func:`sweep_parallel_fit` is the CV candidate sweep's route: the
  batched GLM solvers already stack candidates on a lane axis, so lanes
  split over the model axis and rows over the data axis, on the blocks of
  ``parallel.sweep.SweepLayout``, in one batched fit per rank.

Padding rows carry row mask 0, inert in every mask-weighted solver. The
solvers' all-reduces and the lane gathers are taped inside a
``collective_scope``: the sweep's name, or the solver's for the other two.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from .guarded import collective_scope
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, pad_rows, shard_grid


def _f32(a) -> np.ndarray:
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a,
                      dtype=np.float32)


def _gather_lanes(mesh: Mesh, out):
    """A GLMParams of this rank's lanes -> every lane, in model order."""
    if mesh.shape[MODEL_AXIS] == 1:
        return out
    return type(out)(*(mesh.all_gather("fit_lanes", t.contiguous(), 0,
                                       MODEL_AXIS) for t in out))


def sweep_parallel_fit(fit_fn: Callable[..., Any], name: str, mesh: Mesh,
                       x, y, row_masks, reg_params, elastic_nets,
                       **static_kwargs: Any):
    """One sharded GLM sweep over ``mesh``.

    ``fit_fn`` is a batched solver ``(x [N, D], y [N], masks [K, N],
    regs [K], ens [K], mesh=, num_rows=, **statics) -> GLMParams``. Lanes
    pad onto the ``compiler.bucketing`` buckets rounded up to the
    model-axis size; rows pad to the data-axis multiple with mask 0.
    Returns GLMParams on every rank, sliced back to the real lanes; the
    collectives are taped under ``name``."""
    from ..compiler import bucketing
    from .sweep import SweepLayout, mesh_lane_capacity

    n = int(np.shape(x)[0])
    k, (row_masks, reg_params, elastic_nets) = bucketing.bucket_sweep_lanes(
        _f32(row_masks), _f32(reg_params), _f32(elastic_nets),
        multiple=mesh_lane_capacity(mesh))
    d = mesh.shape[DATA_AXIS]
    xp = pad_rows(_f32(x), d)[0]
    yp = pad_rows(_f32(y), d)[0]
    rpad = xp.shape[0] - row_masks.shape[1]
    if rpad:
        row_masks = np.pad(row_masks, ((0, 0), (0, rpad)))
    placed = SweepLayout().place(mesh, xp, yp, row_masks, reg_params,
                                 elastic_nets)
    static_kwargs.setdefault("device", mesh.device)
    with collective_scope(name):
        out = fit_fn(*(np.ascontiguousarray(a) for a in placed), mesh=mesh,
                     num_rows=n, **static_kwargs)
        out = _gather_lanes(mesh, out)
    return type(out)(*(t[:k] for t in out))


def data_parallel_fit(fit_fn: Callable[..., Any], mesh: Mesh, x, y,
                      row_mask, *args: Any, **kwargs: Any):
    """``fit_fn(x, y, row_mask, *args, mesh=, num_rows=, **kwargs)`` with
    the rows split over the mesh's data axis. Every rank returns the same
    fit; the collectives are taped under the solver's name."""
    n = int(np.shape(x)[0])
    xs, ys, ms = (mesh.local_rows(_f32(a)) for a in (x, y, row_mask))
    kwargs.setdefault("device", mesh.device)
    with collective_scope(fit_fn.__name__):
        return fit_fn(xs, ys, ms, *args, mesh=mesh, num_rows=n, **kwargs)


def ambient_fit(fit_fn: Callable[..., Any], x, y, row_mask, *args: Any,
                **kwargs: Any):
    """``fit_fn(x, y, row_mask, ...)`` under the ambient execution mesh:
    :func:`data_parallel_fit` over it, or the plain call without one."""
    from .mesh import execution_mesh

    mesh = execution_mesh()
    if mesh is None:
        return fit_fn(x, y, row_mask, *args, **kwargs)
    return data_parallel_fit(fit_fn, mesh, x, y, row_mask, *args, **kwargs)


def grid_parallel_fit(fit_fn: Callable[..., Any], mesh: Mesh, x, y, row_mask,
                      grid_arrays: Sequence, **static_kwargs: Any):
    """``fit_fn`` at every stacked hyperparameter point, the points split
    over the mesh's model axis (and rows over its data axis). The grid
    pads up to the model-axis multiple by repeating its last point (the
    extra fits are dropped). Returns the fits stacked on axis 0."""
    n_model = mesh.shape[MODEL_AXIS]
    n = int(np.shape(x)[0])
    g = int(np.shape(grid_arrays[0])[0])
    pad = (-g) % n_model
    padded = []
    for a in grid_arrays:
        a = _f32(a)
        if pad:
            a = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)
        padded.append(shard_grid(mesh, a))
    xs, ys, ms = (mesh.local_rows(_f32(a)) for a in (x, y, row_mask))
    static_kwargs.setdefault("device", mesh.device)
    with collective_scope(fit_fn.__name__):
        fits = [fit_fn(xs, ys, ms, *(float(p[i]) for p in padded),
                       mesh=mesh, num_rows=n, **static_kwargs)
                for i in range(padded[0].shape[0])]
        out = type(fits[0])(*(torch.stack(parts) for parts in zip(*fits)))
        out = _gather_lanes(mesh, out)
    return type(out)(*(t[:g] for t in out))
