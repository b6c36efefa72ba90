"""Where the port's tensors go: the card unless the caller asks for the CPU."""

from __future__ import annotations

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
