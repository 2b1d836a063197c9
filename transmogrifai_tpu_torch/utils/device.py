"""The device seam: every entry point of the port runs on the card unless
the caller asks for the CPU."""
from __future__ import annotations

import torch


def _world_card() -> str:
    """``cuda``, or under a ``torch.distributed`` world the rank's card:
    ``cuda:{local rank}`` (``LOCAL_RANK``, else the rank), taken modulo
    the host's card count so that ranks sharing one card (the ``gloo``
    layout) land on it."""
    from ..parallel.mesh import local_rank, world_active

    count = torch.cuda.device_count()
    if not world_active() or not count:
        return "cuda"
    return f"cuda:{local_rank() % count}"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card (``cuda``; under a world the rank's card).
    A CUDA device with no card present raises: the CPU is used only when
    the caller names it."""
    dev = torch.device(_world_card() if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
