"""Device resolution for the port's entry points.

`None` means the card: the port exists to run on CUDA, so an entry point
called without a device never continues quietly on the CPU. The CPU is
used only when the caller asks for it (`device="cpu"`), as the tests do.
"""
from __future__ import annotations

import contextlib
import threading

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


# exact_f32's process-wide state: the TF32 flags are one setting each for
# the whole process, so concurrent scopes (serving's partition workers)
# share them: the first to enter saves them and clears TF32, the last to
# leave restores them
_F32_LOCK = threading.Lock()
_f32_depth = 0
_f32_saved = None


@contextlib.contextmanager
def exact_f32():
    """Within the block, f32 convolutions (cuDNN) and f32 matrix products
    (cuBLAS) run as f32, not TF32.

    PyTorch lets cuDNN use TF32 for f32 convolutions by default, and a
    caller may let cuBLAS do so for products; the port computes f32 as
    f32 (the reference's f32 convolutions and products are exact f32 on
    the CPU; a TF32 product reorders SAR's and KNN's neighbours). The
    flags (`torch.backends.cudnn.allow_tf32`,
    `torch.backends.cuda.matmul.allow_tf32`) are scoped here, never set
    for the process, and every other setting is left as it is. The flags
    are global, so the scope is counted across threads: while any thread
    is inside, both are False, and the last thread out restores the
    values the first one found. bf16 work does not read them."""
    global _f32_depth, _f32_saved
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    with _F32_LOCK:
        if _f32_depth == 0:
            _f32_saved = (cudnn.allow_tf32, matmul.allow_tf32)
            cudnn.allow_tf32 = False
            matmul.allow_tf32 = False
        _f32_depth += 1
    try:
        yield
    finally:
        with _F32_LOCK:
            _f32_depth -= 1
            if _f32_depth == 0:
                cudnn.allow_tf32, matmul.allow_tf32 = _f32_saved
                _f32_saved = None
