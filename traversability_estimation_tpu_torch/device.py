"""Device selection: the port runs on CUDA unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` by default; the CPU only when the caller names it.

    Raises when CUDA is asked for (explicitly or by default) and no CUDA
    device is present: the CPU is never a silent fallback, because the CPU
    path runs the plain PyTorch versions instead of the kernels.
    """
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
