"""The (data, model) layout over the ranks of a ``torch.distributed``
world, and the row-sharding helpers (the port of the JAX package's
``parallel/mesh.py``).

The reference's mesh is single-controller: one process sees every device
and ``shard_map`` splits the rows among them. The port is SPMD, PyTorch's
own idiom: every rank is a process that runs the same program on the same
dataset, takes its own block of the rows, and meets the other ranks only
in ``torch.distributed`` collectives, whose results come back replicated.
A world of one is the plain single-process case.

Rank r sits at (data r // n_model, model r % n_model), the reference's
``devices.reshape(n_data, n_model)``. Rows split over the data axis: the
padded row space (a multiple of the data-axis size, padding at the global
tail with mask 0) is cut into equal blocks, block d on data index d.

Layout rule: NCCL where each rank has its own card, ``gloo`` on the CPU
or where ranks share a card (NCCL refuses two ranks on one card). The
backend is the process group's; ``make_mesh`` checks the rule and states
it in ``Mesh.describe()``. A failed init fails the run: there is never a
retry on another backend.

Every sum over ranks is an ``all_gather`` of the partials followed by
elementwise adds in rank order, ``((p0 + p1) + p2) + ...``: every rank
holds the same bits, and the result does not depend on which rank
finished first, on the backend or on the device. Minimum and maximum are
exact in any order; they use the same gather. The mesh's two collectives,
``Mesh.all_reduce`` and ``Mesh.all_gather``, run through the guarded seam
(``guarded.py``) and are taped under the name each caller gives them.
"""
from __future__ import annotations

import os
import socket
import threading

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _dist():
    import torch.distributed as dist

    return dist


def world_active() -> bool:
    """Whether this process belongs to an initialized process group."""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def world_rank() -> int:
    return _dist().get_rank() if world_active() else 0


def world_size() -> int:
    return _dist().get_world_size() if world_active() else 1


def local_rank() -> int:
    """The rank's index among the ranks of its host: ``LOCAL_RANK`` as
    launchers set it, else the global rank (one host)."""
    env = os.environ.get("LOCAL_RANK")
    return int(env) if env not in (None, "") else world_rank()


class Mesh:
    """A (data, model) layout of the world's ranks and the collectives
    over its axes. Built by :func:`make_mesh`."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, n_data: int, n_model: int, backend: str | None,
                 device: torch.device, groups: dict):
        self.shape = {DATA_AXIS: int(n_data), MODEL_AXIS: int(n_model)}
        self.size = int(n_data) * int(n_model)
        self.rank = world_rank()
        self.data_index, self.model_index = divmod(self.rank, int(n_model))
        self.backend = backend
        self.device = device
        #: axis -> (process group or None for the world, member ranks);
        #: an axis of one rank that is not the whole world has no group
        self._groups = groups

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, "
                f"model={self.shape[MODEL_AXIS]}, backend={self.backend}, "
                f"rank={self.rank}, device={self.device})")

    def describe(self) -> str:
        """The layout and the rule that chose its backend, for logs."""
        rule = {
            "nccl": "NCCL: each rank has its own card",
            "gloo": "gloo: ranks on the CPU or sharing a card",
            None: "no process group: a world of one",
        }[self.backend]
        return (f"{self.shape[DATA_AXIS]}x{self.shape[MODEL_AXIS]} "
                f"(data x model) over {self.size} rank(s); {rule}; "
                f"rank {self.rank} on {self.device}")

    # -------------------------------------------------------- collectives
    # The two public collectives run through the guarded seam
    # (``guarded.guarded_collective``) and are taped under their name; the
    # raw gather and fold below are theirs alone.
    def all_reduce(self, name: str, t: torch.Tensor, axis: str = DATA_AXIS,
                   op: str = "sum") -> torch.Tensor:
        """The reduction of ``t`` over the axis's ranks, ``op`` one of
        sum, min and max: gathered, then folded in rank order, so every
        rank, backend and device holds the same bits."""
        from .guarded import guarded_collective

        if op not in _FOLDS:
            raise ValueError(f"unknown all_reduce op {op!r}")
        return guarded_collective(name, self._reduce, t, axis, op)

    def all_gather(self, name: str, t: torch.Tensor, dim: int = 0,
                   axis: str = DATA_AXIS) -> torch.Tensor:
        """The axis's blocks of ``t`` concatenated along ``dim`` in rank
        order (row-sharded outputs back to the global rows)."""
        from .guarded import guarded_collective

        return guarded_collective(name, self._gather, t, dim, axis)

    def _parts(self, t: torch.Tensor, axis: str) -> list:
        """Every member's ``t`` along ``axis``, in rank order (the
        tensors must have one shape on every rank)."""
        group, members = self._groups[axis]
        if group is False:
            return [t]
        t = t.contiguous()
        dtype = t.dtype
        if dtype == torch.bool:
            t = t.to(torch.uint8)
        out = [torch.empty_like(t) for _ in members]
        _dist().all_gather(out, t, group=group)
        if dtype == torch.bool:
            out = [p.to(torch.bool) for p in out]
        return out

    def _reduce(self, t: torch.Tensor, axis: str, op: str) -> torch.Tensor:
        parts = self._parts(t, axis)
        out = parts[0]
        for p in parts[1:]:
            out = _FOLDS[op](out, p)
        return out

    def _gather(self, t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        parts = self._parts(t, axis)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)

    # --------------------------------------------------------------- rows
    def row_block(self, num_rows: int) -> tuple[int, int, int]:
        """(lo, hi, padded) of this rank's block of the padded row space
        (padded = num_rows rounded up to the data-axis size)."""
        d = self.shape[DATA_AXIS]
        padded = -(-int(num_rows) // d) * d
        chunk = padded // d
        lo = self.data_index * chunk
        return lo, lo + chunk, padded

    def local_rows(self, t, dim: int = 0) -> torch.Tensor:
        """This rank's block of ``t`` (a tensor or an array) along
        ``dim``: its rows of the padded row space, zero-filled past the
        end, on ``t``'s device."""
        t = torch.as_tensor(t)
        lo, hi, _ = self.row_block(t.shape[dim])
        return take_rows(t, lo, hi, dim).contiguous()


_FOLDS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device=None) -> Mesh:
    """A (data, model) mesh over the world's ranks (all of them when
    ``n_data`` is None). Needs an initialized process group unless the
    mesh is one rank. ``device`` is where the mesh's own reductions
    compute: the rank's card by default (``resolve_device``, which raises
    when there is none); the CPU only when named."""
    world = world_size()
    if n_data is None:
        n_data = world // n_model
    n = int(n_data) * int(n_model)
    if n != world and not (n == 1 and not world_active()):
        raise ValueError(
            f"mesh {n_data}x{n_model} needs {n} ranks, the world has "
            f"{world}: every rank of an SPMD world is a mesh member")
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    backend = _dist().get_backend() if world_active() else None
    if backend == "nccl":
        _check_nccl_layout(dev)
    groups = _axis_groups(int(n_data), int(n_model))
    return Mesh(n_data, n_model, backend, dev, groups)


def _check_nccl_layout(dev: torch.device) -> None:
    """NCCL needs one card per rank: refuse a layout where two ranks of a
    host drive one card (those ranks take ``gloo``)."""
    if dev.type != "cuda":
        raise ValueError("an NCCL mesh computes on the rank's card, "
                         f"not on {dev}")
    dist = _dist()
    mine = (socket.gethostname(), torch.cuda.current_device()
            if dev.index is None else dev.index)
    seen: list = [None] * dist.get_world_size()
    dist.all_gather_object(seen, mine)
    if len(set(seen)) != len(seen):
        raise ValueError(
            f"NCCL ranks share a card ({seen}); ranks that share a card "
            "take the gloo backend")


def _axis_groups(n_data: int, n_model: int) -> dict:
    """axis -> (group, members). An axis of one rank needs no group
    (``False``: its collectives are the identity), the world's default
    group (``None``) serves an axis that spans every rank, and sub-groups
    are made for the others, by every rank in one order as ``new_group``
    requires."""
    world = n_data * n_model
    d_idx, m_idx = divmod(world_rank(), n_model)

    def data_ranks(m: int) -> list:
        return [d * n_model + m for d in range(n_data)]

    def model_ranks(d: int) -> list:
        return [d * n_model + m for m in range(n_model)]

    groups = {}
    for axis, count, ranks_of, mine, others in (
            (DATA_AXIS, n_data, data_ranks, m_idx, n_model),
            (MODEL_AXIS, n_model, model_ranks, d_idx, n_data)):
        members = ranks_of(mine)
        if not world_active() or (count == 1 and world > 1):
            groups[axis] = (False, members)
        elif count == world:
            groups[axis] = (None, members)
        else:
            made = [_dist().new_group(ranks_of(j)) for j in range(others)]
            groups[axis] = (made[mine], members)
    return groups


def auto_mesh(min_devices: int = 2) -> Mesh | None:
    """The all-ranks data mesh, or None in a world of fewer than
    ``min_devices`` ranks (the single-process fast path)."""
    if world_size() < min_devices:
        return None
    return make_mesh(n_data=world_size(), n_model=1)


# --------------------------------------------------------------------------
# execution mesh: the ambient mesh Workflow.train / score install around
# their fit and score phases; estimator fit paths consult it
# --------------------------------------------------------------------------
_EXECUTION_MESH: Mesh | None = None


def execution_mesh() -> Mesh | None:
    """The ambient mesh installed by the workflow (None = one device)."""
    return _EXECUTION_MESH


def set_execution_mesh(mesh: Mesh | None) -> None:
    global _EXECUTION_MESH
    _EXECUTION_MESH = mesh


class use_execution_mesh:
    """Context manager installing ``mesh`` as the ambient execution mesh;
    ``use_execution_mesh(None)`` forces single-device execution."""

    def __init__(self, mesh: Mesh | None):
        self.mesh = mesh
        self._saved = None

    def __enter__(self):
        global _EXECUTION_MESH
        self._saved = _EXECUTION_MESH
        _EXECUTION_MESH = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _EXECUTION_MESH
        _EXECUTION_MESH = self._saved
        return False


_AUTO_MESH: dict = {}
_AUTO_MESH_LOCK = threading.Lock()


def default_execution_mesh() -> Mesh | None:
    """The mesh Workflow installs when the user picked none: the data mesh
    over the world when it has more than one rank, else None;
    ``TPTPU_MESH=0`` forces None. Cached per process group, so concurrent
    first callers agree on one mesh."""
    if os.environ.get("TPTPU_MESH", "") == "0" or world_size() < 2:
        return None
    key = id(_dist().group.WORLD)
    with _AUTO_MESH_LOCK:
        if key not in _AUTO_MESH:
            _AUTO_MESH.clear()
            _AUTO_MESH[key] = auto_mesh()
        return _AUTO_MESH[key]


def data_row_multiple() -> int:
    """Row-count multiple needed to shard over the ambient mesh's data
    axis (1 without a mesh)."""
    mesh = execution_mesh()
    return 1 if mesh is None else mesh.shape[DATA_AXIS]


def model_lane_multiple() -> int:
    """Lane-count multiple needed to split lanes over the ambient mesh's
    model axis (1 without a mesh)."""
    mesh = execution_mesh()
    return 1 if mesh is None else mesh.shape[MODEL_AXIS]


def pad_rows(x: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Zero-pad axis 0 to a multiple of ``multiple``. Returns (padded,
    original_n). Zero rows are neutral for the sums; reductions that are
    not (min, max) mask padding by count."""
    n = x.shape[0]
    pad = (-n) % int(multiple)
    if pad == 0:
        return x, n
    z = np.zeros((pad,) + x.shape[1:], dtype=x.dtype)
    return np.concatenate([x, z], axis=0), n


def shard_rows(mesh: Mesh, x, dim: int = 0):
    """This rank's data-axis block of ``x`` along ``dim`` (the length must
    divide evenly: ``pad_rows`` first)."""
    d = mesh.shape[DATA_AXIS]
    length = x.shape[dim]
    if length % d:
        raise ValueError(f"{length} rows do not split over {d} data ranks: "
                         "pad_rows first")
    chunk = length // d
    lo = mesh.data_index * chunk
    if isinstance(x, torch.Tensor):
        return x.narrow(dim, lo, chunk)
    return np.take(x, np.arange(lo, lo + chunk), axis=dim)


def shard_grid(mesh: Mesh, x):
    """This rank's model-axis block of stacked per-candidate arrays."""
    m = mesh.shape[MODEL_AXIS]
    if x.shape[0] % m:
        raise ValueError(f"{x.shape[0]} lanes do not split over {m} model "
                         "ranks")
    chunk = x.shape[0] // m
    return x[mesh.model_index * chunk:(mesh.model_index + 1) * chunk]


def shard_rows_if_active(x):
    """This rank's block of ``x`` under the ambient mesh (rows already a
    multiple of ``data_row_multiple()``); identity without one."""
    mesh = execution_mesh()
    return x if mesh is None else shard_rows(mesh, x)


def take_rows(t: torch.Tensor, lo: int, hi: int, dim: int = 0) -> torch.Tensor:
    """Rows [lo, hi) of ``t`` along ``dim``, zero-filled past its end: a
    rank's block of the padded row space without padding the whole."""
    n = t.shape[dim]
    real = max(0, min(hi, n) - lo)
    part = t.narrow(dim, min(lo, n), real)
    if real == hi - lo:
        return part
    shape = list(t.shape)
    shape[dim] = hi - lo - real
    return torch.cat([part, torch.zeros(shape, dtype=t.dtype,
                                        device=t.device)], dim=dim)
