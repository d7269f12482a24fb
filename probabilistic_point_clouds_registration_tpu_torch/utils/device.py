"""Where the port's entry points run: a CUDA device unless the caller asks
for the CPU. Nothing falls back to the CPU when CUDA is asked for and
absent."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when it names CUDA and no CUDA
    device is available, and for a ``bool`` (a stray positional flag)."""
    if isinstance(device, bool):
        raise TypeError(f"device={device!r} is a bool, not a device")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass "
            "device='cpu' to run on the CPU"
        )
    return dev
