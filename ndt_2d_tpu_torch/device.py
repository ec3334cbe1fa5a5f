"""Device selection and the card's identity.

The port runs on ``cuda`` unless a caller asks for ``cpu`` explicitly; the
CPU runs every kernel's plain-PyTorch twin (the wrappers dispatch on the
tensor's device, never on a fallback).
"""

from __future__ import annotations

import functools
import shutil
import subprocess
from typing import Callable, Optional, Union

import numpy as np
import torch


def get_device(device: Optional[Union[str, torch.device]] = None
               ) -> torch.device:
    """``cuda`` unless ``device`` names another; raises when ``cuda`` is
    asked for and absent.  Turns TF32 off for float32 matmuls and
    convolutions (the reference computes in full float32)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain-PyTorch twins")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def thread_binder(dev: torch.device) -> Callable[[], None]:
    """A function that makes ``dev`` the calling thread's current CUDA
    device (a new thread starts on device 0); a thread that launches on
    ``dev`` calls it first.  ``cuda`` without an index means the device
    current in the thread that asks for the binder.  On the CPU it does
    nothing."""
    if dev.type != "cuda":
        return lambda: None
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    return functools.partial(torch.cuda.set_device, index)


def upload(array, device: torch.device) -> torch.Tensor:
    """A host array as a new tensor on ``device``.  To a CUDA device the
    copy is non-blocking, from a pinned staging copy, so it never waits
    for the stream (PyTorch's host allocator keeps the staging buffer until
    the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


class HostCopy:
    """A device tensor on its way to the host: a non-blocking copy into a
    pinned buffer and one CUDA event after it.  The source stays referenced
    until the event has completed.  A CPU tensor is copied at once."""

    def __init__(self, flat: torch.Tensor):
        self.event = None
        if flat.device.type == "cuda":
            self.host = torch.empty(flat.shape, dtype=flat.dtype,
                                    pin_memory=True)
            self.host.copy_(flat, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
            self._source = flat
        else:
            self.host = flat.clone()

    def wait(self) -> np.ndarray:
        """The host values, after waiting on this copy's event alone.  Safe
        from several threads (the live server's client reads a copy that
        the mapper's drain may read at the same time)."""
        event = self.event
        if event is not None:
            event.synchronize()
            self.event = self._source = None
        return self.host.numpy()

    def ready(self) -> bool:
        """True once the copy has landed; never blocks."""
        event = self.event
        return event is None or event.query()

    def future(self, index) -> "HostFuture":
        """A future of ``wait()[index]``."""
        return HostFuture(self, index)


class HostFuture:
    """Part of a ``HostCopy``: ``result()`` waits for the copy and returns
    the part as float64."""

    def __init__(self, copy: HostCopy, index):
        self.copy, self.index = copy, index

    def result(self) -> np.ndarray:
        return np.asarray(self.copy.wait()[self.index], np.float64)

    def ready(self) -> bool:
        """True once ``result()`` would not wait."""
        return self.copy.ready()


def card_identity() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (one line per card), or "" where nvidia-smi is absent."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return ""
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=False)
    return out.stdout.strip()
