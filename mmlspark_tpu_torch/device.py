"""Device resolution for the port's entry points.

`None` means the card: the port exists to run on CUDA, so an entry point
called without a device never continues quietly on the CPU. The CPU is
used only when the caller asks for it (`device="cpu"`), as the tests do.
"""
from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def exact_f32():
    """Within the block, cuDNN runs f32 convolutions as f32, not TF32.

    PyTorch lets cuDNN use TF32 for f32 convolutions by default; the port
    computes f32 as f32 (the reference's f32 convolutions are exact f32
    on the CPU). The flag is scoped here, never set for the process, and
    every other cuDNN setting is passed through unchanged (`flags()`
    otherwise resets them, `enabled` included). bf16 convolutions do not
    read it."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield
