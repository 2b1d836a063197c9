"""SweepLayout: which mesh axis each tensor of the CV candidate sweep
splits over (the port of the JAX package's ``parallel/sweep.py``).

The sweep's tensors fall into three roles:

* **plane**: the fold's shared feature matrix ``x [N, D]`` and target
  ``y [N]``: rows split over ``DATA_AXIS``, features whole on every rank;
* **lane**: per-candidate tensors stacked on axis 0 (``row_masks [K, N]``,
  ``reg_params [K]``, ``elastic_nets [K]``): lanes split over
  ``MODEL_AXIS``, and the mask's rows over ``DATA_AXIS`` too, so a rank
  holds its (lane block x row block) tile;
* **fold outputs**: the fitted ``GLMParams`` (``weights [K, D]``,
  ``intercept [K]``): lanes over ``MODEL_AXIS``, gathered over it once.

The reference states the layout as PartitionSpecs for its pjit'd program;
the port states it as the blocks :meth:`SweepLayout.place` cuts, which
``parallel/fit.py::sweep_parallel_fit`` hands to the batched solver.
"""
from __future__ import annotations

from .mesh import MODEL_AXIS, Mesh, shard_grid, shard_rows


class SweepLayout:
    """The axis of each tensor role of one GLM sweep: rows over
    ``DATA_AXIS``, lanes over ``MODEL_AXIS``."""

    def place(self, mesh: Mesh, x, y, row_masks, reg_params, elastic_nets):
        """This rank's blocks of ``(x, y, row_masks, reg_params,
        elastic_nets)`` (rows padded to the data-axis multiple and lanes
        to the model-axis multiple beforehand)."""
        return (
            shard_rows(mesh, x),
            shard_rows(mesh, y),
            shard_rows(mesh, shard_grid(mesh, row_masks), dim=1),
            shard_grid(mesh, reg_params),
            shard_grid(mesh, elastic_nets),
        )


def mesh_lane_capacity(mesh: Mesh | None) -> int:
    """Model-axis size of ``mesh`` (1 without one): the multiple the
    sweep's lane count pads onto, so lanes split evenly."""
    return 1 if mesh is None else int(mesh.shape[MODEL_AXIS])
