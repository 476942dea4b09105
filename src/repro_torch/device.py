"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.  ``"cuda"`` (the
    default everywhere) raises when no GPU is present: a caller that wants
    the CPU says so, nothing falls back to it silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev
