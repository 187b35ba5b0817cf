"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """The requested device; CUDA must be present when it is requested.

    Entry points default to ``"cuda"``; tests pass ``"cpu"`` explicitly.
    There is no silent fallback from CUDA to the CPU.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def synchronize(device: Union[str, torch.device]) -> None:
    """Wait for the work queued on a CUDA device (nothing on the CPU), so a
    host clock read next includes it."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
