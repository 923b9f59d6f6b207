"""Device-to-host fetches that overlap the caller's host work.

`BackgroundFetch(arrays)` starts copying a nest of tensors (tuples and
lists of tensors, with numpy arrays, numbers or None passed through) to
the host when it is made, and returns numpy when asked. It is not a
thread: on CUDA each tensor is copied into pinned host memory with
`non_blocking=True` on the current stream, and a CUDA event is recorded
behind the copies. `done()` asks the event; `get()` waits for it. On the
CPU the tensors are copied at once.

`done()` may only be used to decide when to START further work; whether a
result is folded in is decided by the caller's fixed landing schedule,
which calls `get()` (see `pipeline/tracking.py`).
"""
from __future__ import annotations

import numpy as np
import torch


def _start(x, cuda_seen: list):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.device.type == "cuda":
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x, non_blocking=True)
            cuda_seen.append(x.device)
            return host
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_start(v, cuda_seen) for v in x)
    return x


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_numpy(v) for v in x)
    return x


class BackgroundFetch:
    """Fetch a nest of tensors to the host; `get()` returns it as numpy."""

    def __init__(self, arrays):
        cuda_seen: list = []
        self._host = _start(arrays, cuda_seen)
        self._event = None
        if cuda_seen:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(cuda_seen[0]))

    def done(self) -> bool:
        return self._event is None or self._event.query()

    def get(self):
        if self._event is not None:
            self._event.synchronize()
        return _numpy(self._host)


def fetch(arrays):
    """Blocking fetch of a nest of tensors as numpy: one `BackgroundFetch`,
    waited for at once."""
    return BackgroundFetch(arrays).get()


def to_numpy(x) -> np.ndarray:
    """A tensor (any device) or an array as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
