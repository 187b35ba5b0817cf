"""Device selection for the port's entry points."""
from __future__ import annotations

import contextlib
import functools
from typing import Iterator, List, Union

import torch

# the keep-alive lists of the CUDA graphs being captured (see device_cache)
_holders: List[list] = []


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


def device_cache(maxsize: int):
    """``functools.lru_cache`` for a function that makes a tensor once and
    hands it out many times (a camera's rays, a constant divisor).

    A captured CUDA graph reads such a tensor by its address, and the
    cache may later drop it and free its memory.  So every result handed
    out while a graph is being captured (inside :func:`holding`) is also
    appended to that graph's keep-alive list.  ``cache_clear`` clears the
    cache as ``lru_cache``'s does."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            out = cached(*args, **kwargs)
            for held in _holders:
                if not any(x is out for x in held):
                    held.append(out)
            return out

        call.cache_clear = cached.cache_clear
        return call
    return wrap


@contextlib.contextmanager
def holding(held: list) -> Iterator[list]:
    """Inside this block every :func:`device_cache` result is appended to
    ``held`` (a graph's keep-alive list, filled while it captures)."""
    _holders.append(held)
    try:
        yield held
    finally:
        _holders.pop()
