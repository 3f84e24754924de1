"""Host <-> CUDA device transfer helpers.

A decoded host array moves to device memory once per batch
(``to_device``); results come back either blocking (``from_device``) or
as a pending copy (``from_device_async``): a non-blocking copy into
pinned host memory on the current stream, with a CUDA event recorded
behind it.  The batcher's finishers wait on that event, so the readback
of one batch overlaps the launch of the next.  ``from_device_many``
issues the pending copies of several tensors before it waits.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Union

import numpy as np
import torch


def to_device(arr: np.ndarray, device: Union[str, torch.device]) -> torch.Tensor:
    """Move a host array onto ``device``.

    For CUDA the array is staged in pinned memory, so the upload is
    asynchronous on the current stream; the staging copy also lifts the
    read-only request buffers (``np.frombuffer`` views) that torch will
    not wrap."""
    device = torch.device(device)
    arr = np.asarray(arr)
    staging = torch.empty(arr.shape, dtype=torch.from_numpy(np.empty(0, arr.dtype)).dtype,
                          pin_memory=device.type == "cuda")
    staging.numpy()[...] = arr
    return staging.to(device, non_blocking=True)


def from_device(x: Any) -> np.ndarray:
    """Fetch a tensor back to host memory as numpy (blocking)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class PendingHostCopy:
    """A device->host copy in flight; ``result()`` waits for it."""

    def __init__(self, x: torch.Tensor):
        self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        self.host.copy_(x, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(x.device))

    def result(self) -> np.ndarray:
        self.event.synchronize()
        return self.host.numpy()


def from_device_async(x: Any) -> Union[PendingHostCopy, np.ndarray]:
    """Start the readback of a CUDA tensor; host data converts at once."""
    if is_device_array(x):
        return PendingHostCopy(x)
    return from_device(x)


def from_device_many(xs: Sequence[Any], dtype: Optional[Any] = None) -> List[np.ndarray]:
    """Fetch N tensors to host memory as numpy arrays, issuing every
    device-to-host copy before waiting on any, so N outputs cost about
    one transfer's wait instead of N in turn.  Host arrays pass through
    untouched; ``dtype`` casts each result (no copy where it matches)."""
    pending = [from_device_async(x) for x in xs]
    out = [p.result() if isinstance(p, PendingHostCopy) else p for p in pending]
    if dtype is not None:
        out = [a.astype(dtype, copy=False) for a in out]
    return out


def is_device_array(x: Any) -> bool:
    """True for a tensor in CUDA device memory."""
    return isinstance(x, torch.Tensor) and x.is_cuda
