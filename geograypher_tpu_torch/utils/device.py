"""Where the port's tensors go: the card unless the caller asks for the CPU."""

from __future__ import annotations

import typing

import numpy as np
import torch


def resolve_device(device, caller: str) -> torch.device:
    """``torch.device(device)``; raises for a CUDA device when there is no
    card, never falling back to the CPU.  ``caller`` names the entry point
    in the message."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{caller}(device={str(device)!r}) needs a CUDA device and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU"
        )
    return dev


class PinnedUpload:
    """Host arrays to ``device`` through one page-locked staging buffer,
    allocated at the first upload and grown when a larger array comes: the
    copy into it and the DMA out of it together take a third to a half of
    the time of a pageable ``.to(device)`` for a 4K one-hot stack.  Before
    it overwrites the buffer it waits for the last copy out of it to end.
    On a CPU device the array is wrapped as it is."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._stage: typing.Optional[torch.Tensor] = None
        self._left: typing.Optional[torch.cuda.Event] = None

    def __call__(self, array: np.ndarray) -> torch.Tensor:
        host = torch.as_tensor(np.ascontiguousarray(array))
        if self.device.type != "cuda" or host.numel() == 0:
            return host.to(self.device)
        if self._left is not None:
            self._left.synchronize()  # the last array has left the buffer
        n_bytes = host.numel() * host.element_size()
        if self._stage is None or self._stage.numel() < n_bytes:
            self._stage = torch.empty(n_bytes, dtype=torch.uint8, pin_memory=True)
        stage = self._stage[:n_bytes].view(host.dtype).view(host.shape)
        stage.copy_(host)
        on_device = stage.to(self.device, non_blocking=True)
        self._left = torch.cuda.Event()
        self._left.record(torch.cuda.current_stream(self.device))
        return on_device
