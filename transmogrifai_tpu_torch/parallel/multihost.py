"""Bringing up the world, and per-rank ingest (the port of the JAX
package's ``parallel/multihost.py``).

The reference brings up its cross-host control plane with
``jax.distributed.initialize`` (one process per host) and builds a global
(dcn, data, model) mesh. The port is SPMD from the start: each rank is a
process, :func:`initialize_distributed` joins it to a ``torch.distributed``
process group, and the mesh spans the ranks (:func:`make_multihost_mesh`).
A rank plays the reference's host.

Row layout (every helper here): the global row count is padded up to a
multiple of the world's rank count; rank r owns the padded block
[r·chunk, (r+1)·chunk) with chunk = padded // ranks; padding rows sit at
the global tail and are excluded from statistics by a validity column,
as in ``reductions.py``.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import NamedTuple

import numpy as np
import torch

from .mesh import Mesh, make_mesh, world_active, world_rank, world_size

log = logging.getLogger(__name__)

#: the cross-host axis name of the reference's multi-host mesh; the port's
#: ranks are its hosts, and its mesh's data axis spans them
DCN_AXIS = "dcn"


def layout_backend(local_ranks: int | None = None) -> str:
    """The layout rule: NCCL when there is a card for each rank of this
    host, ``gloo`` on the CPU or where ranks must share a card."""
    if local_ranks is None:
        env = os.environ.get("LOCAL_WORLD_SIZE")
        local_ranks = int(env) if env else world_size()
    if torch.cuda.is_available() and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           backend: str | None = None,
                           timeout: float | None = None) -> bool:
    """Join this process to the world (idempotent). Returns whether a
    process group is up.

    Explicit arguments win (``init_method`` a ``file://`` store or a
    ``tcp://`` address); otherwise ``torch.distributed``'s own environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as
    ``torchrun`` sets it) configures it. With nothing
    configured a single process stays without a group (a world of one).
    ``backend`` defaults to the layout rule (:func:`layout_backend`). A
    failed init raises: there is no retry on another backend."""
    import torch.distributed as dist

    if world_active():
        return True
    if world_size is None and os.environ.get("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    env_store = bool(os.environ.get("MASTER_ADDR"))
    configured = init_method is not None or (
        env_store and world_size is not None)
    if not configured:
        return False
    if init_method is None:
        init_method = "env://"
    if backend is None:
        backend = layout_backend(
            int(os.environ["LOCAL_WORLD_SIZE"])
            if os.environ.get("LOCAL_WORLD_SIZE") else world_size)
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kwargs)
    return True


def make_multihost_mesh(n_model: int = 1, device=None) -> Mesh:
    """The mesh over every rank of the world, rows over the data axis
    (the reference's (dcn, data) rows), lanes over ``n_model``, on
    ``device`` (the rank's card by default, as ``make_mesh``)."""
    world = world_size()
    if world % n_model:
        raise ValueError(f"n_model={n_model} does not divide the world's "
                         f"{world} ranks")
    return make_mesh(n_data=world // n_model, n_model=n_model, device=device)


def _ranks(mesh: Mesh | None) -> int:
    return world_size() if mesh is None else mesh.size


def padded_rows(num_rows: int, mesh: Mesh) -> int:
    """``num_rows`` rounded up to a multiple of the mesh's rank count."""
    t = mesh.size
    return (int(num_rows) + t - 1) // t * t


def host_row_slice(num_rows: int, mesh: Mesh | None = None) -> slice:
    """The half-open range of REAL rows this rank reads: its block of the
    padded row space clipped to the real rows (trailing ranks may own
    fewer, or none)."""
    n_hosts = _ranks(mesh)
    pid = world_rank()
    if mesh is not None:
        chunk = padded_rows(num_rows, mesh) // n_hosts
    else:
        chunk = (num_rows + n_hosts - 1) // n_hosts
    return slice(min(pid * chunk, num_rows), min((pid + 1) * chunk, num_rows))


def read_host_block(fetch, num_rows: int, mesh: Mesh | None = None,
                    retry_policy=None) -> np.ndarray:
    """This rank's real-row block via ``fetch(slice)``, behind the
    ``RetryPolicy`` the streamed readers use: transient errors (a flaky
    mount, an injected ``fail_chunk_read``) back off and retry, fatal
    ones fail at once."""
    from ..resilience import faults
    from ..resilience.retry import default_io_policy

    sl = host_row_slice(num_rows, mesh)
    token = f"host-block[{sl.start}:{sl.stop})"

    def attempt():
        plan = faults.active()
        if plan is not None:
            plan.on_stream_chunk(token)
        return fetch(sl)

    policy = retry_policy or default_io_policy()
    rows, attempts = policy.call(attempt)
    if attempts > 1:
        log.warning("host ingest %s fetched after %d attempts", token,
                    attempts)
    return np.asarray(rows)


class GlobalArray(NamedTuple):
    """A row-sharded global array: this rank's block of the padded rows
    (``local``, on the mesh's device), and the global shapes."""

    local: torch.Tensor
    num_rows: int      # padded global rows
    mesh: Mesh

    @property
    def shape(self) -> tuple:
        return (self.num_rows,) + tuple(self.local.shape[1:])

    def gather(self) -> torch.Tensor:
        """The whole array on every rank (an all-gather)."""
        return self.mesh.all_gather("gather_global_array", self.local)


def ingest_global_array(fetch, num_rows: int, mesh: Mesh,
                        retry_policy=None) -> GlobalArray:
    """The resilient per-rank ingest: ``host_row_slice`` -> retried
    ``fetch`` -> zero-pad to this rank's block -> :func:`make_global_array`.
    ``fetch(slice)`` returns this rank's real rows."""
    if mesh is None:
        raise ValueError(
            "ingest_global_array requires a mesh (the global array's "
            "sharding); single-process callers can use read_host_block "
            "directly: their block is all the real rows")
    local = read_host_block(fetch, num_rows, mesh, retry_policy)
    padded = padded_rows(num_rows, mesh)
    chunk = padded // mesh.size
    if local.shape[0] > chunk:
        raise ValueError(f"fetch returned {local.shape[0]} rows, more than "
                         f"this rank's {chunk}-row block")
    if local.shape[0] < chunk:
        pad = np.zeros((chunk - local.shape[0],) + local.shape[1:],
                       dtype=local.dtype)
        local = np.concatenate([local, pad], axis=0)
    return make_global_array(local, mesh, padded)


def make_global_array(local_rows, mesh: Mesh, num_rows: int) -> GlobalArray:
    """A row-sharded global array from this rank's block: ``num_rows`` a
    multiple of the mesh's rank count (``padded_rows``), ``local_rows``
    this rank's whole block (num_rows // ranks rows). No rank holds the
    global array."""
    t = mesh.size
    if num_rows % t != 0:
        raise ValueError(
            f"num_rows={num_rows} must be a multiple of the rank count {t} "
            "— pad first (parallel.multihost.padded_rows)")
    chunk = num_rows // t
    if local_rows.shape[0] != chunk:
        raise ValueError(f"local block has {local_rows.shape[0]} rows, "
                         f"expected {chunk} (= padded num_rows // ranks)")
    local = torch.as_tensor(np.ascontiguousarray(local_rows)
                            if isinstance(local_rows, np.ndarray)
                            else local_rows).to(mesh.device)
    return GlobalArray(local, int(num_rows), mesh)


def global_column_stats(x_local: np.ndarray, mesh: Mesh, num_rows: int) -> dict:
    """Per-column count/mean/var across ranks from each rank's REAL rows
    (``host_row_slice(num_rows, mesh)``), by the two-pass centred scheme
    of ``reductions.pcolumn_stats``. One all-reduce of the per-column
    partials per pass, never the data."""
    padded = padded_rows(num_rows, mesh)
    chunk = padded // mesh.size
    x_local = np.asarray(x_local, dtype=np.float32)
    f = x_local.shape[1]
    block = np.zeros((chunk, f + 1), dtype=np.float32)
    block[: len(x_local), :f] = x_local
    block[: len(x_local), f] = 1.0  # validity: padding rows stay 0
    xg = make_global_array(block, mesh, padded).local
    v = xg[:, -1:]
    cs = mesh.all_reduce("global_column_stats.sums", torch.cat(
        [v.sum().reshape(1), (xg[:, :-1] * v).sum(dim=0)]))
    cnt = float(cs[0])
    mean = cs[1:].cpu().numpy().astype(np.float64) / max(cnt, 1.0)
    c = (xg[:, :-1] - torch.from_numpy(mean.astype(np.float32)).to(xg.device)) * v
    m2 = mesh.all_reduce("global_column_stats.m2", (c * c).sum(dim=0))
    m2 = m2.cpu().numpy().astype(np.float64)
    return {"count": cnt, "mean": mean, "var": m2 / max(cnt, 1.0)}
