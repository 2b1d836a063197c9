"""The data-parallel plane: a (data, model) mesh over the ranks of a
``torch.distributed`` world, guarded collectives, sharded monoid
reductions, and data / model-parallel fit wrappers (the port of the JAX
package's ``parallel/``).

The reference maps Spark's substrate onto a single-controller JAX mesh
(RDD partitions -> rows sharded over the "data" axis, treeAggregate ->
``psum``, the candidate pool -> the "model" axis, XGBoost's
Rabit allreduce -> a ``psum`` inside the training step). The port is SPMD:
every rank is a process running the same program on the same dataset,
each takes its block of the rows, and every sum over rows is an
all-reduce in rank order (``mesh.Mesh.all_reduce``), so results come
back the same on every rank. The reference's ``compat.py`` (a ``shard_map`` shim
across JAX versions) has no counterpart: ``mesh.py`` covers it.
"""
from .guarded import guarded_collective  # noqa: F401
from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    auto_mesh,
    default_execution_mesh,
    execution_mesh,
    make_mesh,
    pad_rows,
    shard_grid,
    shard_rows,
    use_execution_mesh,
)
from .reductions import (  # noqa: F401
    pcentered_gram,
    pcolumn_stats,
    pcontingency,
    phistogram,
    pxtx,
)
from .fit import data_parallel_fit, grid_parallel_fit, sweep_parallel_fit  # noqa: F401
from .ring import pad_cols, ring_corr, ring_gram, shard_cols  # noqa: F401
from .multihost import (  # noqa: F401
    DCN_AXIS,
    global_column_stats,
    host_row_slice,
    ingest_global_array,
    initialize_distributed,
    make_global_array,
    make_multihost_mesh,
    padded_rows,
    read_host_block,
)
from .segments import (  # noqa: F401
    aggregate_events_on_device,
    factorize_keys,
    psegment_reduce,
)
