"""Device selection shared by the port's entry points."""
from __future__ import annotations

import functools

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises when a CUDA device is
    asked for (the default) and none is present.  The CPU runs only when
    the caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (its launch plans fill them)."""
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count
