"""The fused scoring graph's one upload per batch, the port's counterpart
of the JAX package's ``compiler/dispatch.py``.

A batch's ingest arrays (numeric values and masks, pivot codes, hashed-text
codes and weights: whatever the members' host codecs made) are packed into
ONE host staging buffer, sent to the device with one copy, and read there as
views by dtype and offset. On the card the host buffer is pinned, so the
copy is asynchronous and makes the host wait for nothing: the batch's only
host synchronization is the download of the predictor's core.

Buffers are pooled by size (one size per row bucket), and a batch holds its
buffer from the fill until its download has returned: by then the stream
has run the upload, so the next batch may refill it. Concurrent batches on
one closure each take their own buffer.

The reference's other two seams have no counterpart here. Buffer donation
(``donating``) lets XLA reuse an argument's memory for an output; PyTorch
frees a tensor when its last reference goes, and the device buffer here is
reused across batches, so there is nothing to donate. The training-matrix
prefetch (``prefetch_f32`` / ``device_f32``) overlaps an upload with host
stages of the staged loop; the fused graph's host stages run before its
single upload, so it has nothing to overlap.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

#: byte alignment of each array in a staging buffer (any dtype's view of
#: the device buffer starts on a multiple of its item size)
ALIGN = 256


def layout(arrays: list[np.ndarray]) -> tuple[list[int], int]:
    """(byte offset of each array, total bytes) of a packed buffer."""
    offsets, at = [], 0
    for a in arrays:
        offsets.append(at)
        at += -(-a.nbytes // ALIGN) * ALIGN
    return offsets, at


class StagingBuffer:
    """One host buffer (pinned when the device is a card) and its device
    twin, ``nbytes`` each."""

    def __init__(self, nbytes: int, device: torch.device):
        self.nbytes = nbytes
        pinned = device.type == "cuda"
        self.host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned)
        self.device = torch.empty(nbytes, dtype=torch.uint8, device=device)
        self._host_np = self.host.numpy()

    def upload(self, arrays: list[np.ndarray]) -> list[torch.Tensor]:
        """Pack ``arrays`` into the host buffer, copy it up in one copy
        (non-blocking from pinned memory), and return each array's view on
        the device, in order."""
        offsets, total = layout(arrays)
        for a, off in zip(arrays, offsets):
            dst = self._host_np[off:off + a.nbytes].view(a.dtype)
            dst.reshape(a.shape)[...] = a
        self.device[:total].copy_(self.host[:total], non_blocking=True)
        return [
            self.device[off:off + a.nbytes].view(_torch_dtype(a.dtype))
            .view(a.shape)
            for a, off in zip(arrays, offsets)
        ]


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


class StagingPool:
    """Staging buffers by size, each held by one batch at a time."""

    def __init__(self, device: torch.device):
        self.device = device
        self._free: dict[int, list[StagingBuffer]] = {}
        self._lock = threading.Lock()

    def acquire(self, arrays: list[np.ndarray]) -> StagingBuffer:
        """A free buffer that holds ``arrays`` packed, made if none is."""
        _, nbytes = layout(arrays)
        with self._lock:
            free = self._free.get(nbytes)
            if free:
                return free.pop()
        return StagingBuffer(nbytes, self.device)

    def release(self, buf: StagingBuffer) -> None:
        """Return a buffer whose batch has downloaded its result (so its
        upload has run). A batch that raised keeps its buffer out of the
        pool: its copy may still be in flight."""
        with self._lock:
            self._free.setdefault(buf.nbytes, []).append(buf)
