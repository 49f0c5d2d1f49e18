"""Device resolution: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when a CUDA device is asked
    for and none is present — the port never falls back to the CPU on its
    own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r}: no CUDA device is available "
            "(pass device='cpu' to run the plain PyTorch path)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device={str(device)!r}: pick 'cuda' or 'cpu'")
    return dev
