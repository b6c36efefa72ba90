"""Where the port's tensors go: the card unless the caller asks for the CPU."""

from __future__ import annotations

import typing

import numpy as np
import torch

from geograypher_tpu_torch.utils.profiling import _StageTimer


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
    """Host arrays to ``device`` through two page-locked staging buffers
    used in turn, each copy issued on one copy stream of the device.

    The copy into a staging buffer and the DMA out of it together take a
    third to a half of the time of a pageable ``.to(device)`` for a 4K
    one-hot stack.  The consumer waits on the device, not on the host: the
    caller's current stream waits on the copy's event, and the returned
    tensor is recorded on that stream, so the caching allocator does not
    hand its memory out before the consumer's work on it has run.  The host
    blocks only before it refills a slot, on the copy that last read that
    slot (two uploads back), never on the compute chain, so the copy of
    one view overlaps the kernels of the view before it.  ``wait_s`` adds
    up the seconds the host blocked there (span ``upload.wait``), and
    ``stage_s`` those it spent making the array contiguous and copying it
    into the staging buffer (span ``upload.stage``).  On a CPU device the
    array is wrapped as it is, inside ``upload.stage``."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._stage: list = [None, None]  # page-locked staging buffers
        self._read: list = [None, None]  # event of the copy out of each slot
        self._slot = 0
        self._stream: typing.Optional[torch.cuda.Stream] = None
        self._timer = _StageTimer()

    @property
    def wait_s(self) -> float:
        return self._timer.seconds("upload.wait")

    @property
    def stage_s(self) -> float:
        return self._timer.seconds("upload.stage")

    def __call__(self, array: np.ndarray) -> torch.Tensor:
        on_card = self.device.type == "cuda" and np.size(array) > 0
        if on_card:
            k, self._slot = self._slot, 1 - self._slot
            if self._read[k] is not None:
                with self._timer("upload.wait"):
                    self._read[k].synchronize()  # the copy two uploads back has left
        with self._timer("upload.stage"):
            host = torch.as_tensor(np.ascontiguousarray(array))
            if not on_card:
                return host.to(self.device)
            n_bytes = host.numel() * host.element_size()
            if self._stage[k] is None or self._stage[k].numel() < n_bytes:
                self._stage[k] = torch.empty(n_bytes, dtype=torch.uint8,
                                             pin_memory=True)
            stage = self._stage[k][:n_bytes].view(host.dtype).view(host.shape)
            stage.copy_(host)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        consumer = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            # allocated on the copy stream: a block the consumer freed with
            # work still queued is not reused before that work has run
            on_device = torch.empty(host.shape, dtype=host.dtype,
                                    device=self.device)
            on_device.copy_(stage, non_blocking=True)
        read = torch.cuda.Event()
        read.record(self._stream)
        consumer.wait_event(read)
        on_device.record_stream(consumer)
        self._read[k] = read
        return on_device
