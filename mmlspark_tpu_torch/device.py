"""Device resolution for the port's entry points.

`None` means the card: the port exists to run on CUDA, so an entry point
called without a device never continues quietly on the CPU. The CPU is
used only when the caller asks for it (`device="cpu"`), as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> `cuda` (raises when no card is visible); anything else is
    taken as the caller's explicit choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: the port runs on the card by "
                "default; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)
