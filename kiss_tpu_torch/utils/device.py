"""The port's one rule for devices: the caller names the device, and a
device that is not there is an error, never a quiet move to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device`` ("cuda", "cuda:1", "cpu" or a
    ``torch.device``). Raises ``RuntimeError`` when a CUDA device is
    asked for and ``torch.cuda.is_available()`` is false."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was requested but torch.cuda.is_available()"
            " is false; pass --device cpu (or device='cpu') to run on the "
            "CPU"
        )
    return dev
