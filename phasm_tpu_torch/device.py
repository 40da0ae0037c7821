"""Device selection: an explicit torch.device, never a silent CPU fallback."""
from __future__ import annotations

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """The torch.device for ``name``.

    Raises when a CUDA device is asked for and none is available: a run
    that asked for the card must not quietly measure the CPU instead."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is False"
        )
    return dev
