"""Device resolution for the port's entry points.

The port runs on the card. An entry point that is given no device uses
`cuda`, and raises when PyTorch sees no CUDA device: it never carries on
silently on the CPU. Tests pass `device="cpu"` explicitly.
"""

from __future__ import annotations

import torch


class NoCudaDevice(RuntimeError):
    """No device was requested and PyTorch sees no CUDA device."""


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: `device` when given, else
    `cuda`. Raises NoCudaDevice when the result is a CUDA device and
    CUDA is unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDevice(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev
