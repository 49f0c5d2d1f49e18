"""Device resolution: the card unless the caller asks for the CPU, and
each tensor-parallel rank's device."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when a CUDA device is asked
    for and none is present — the port never falls back to the CPU on its
    own.  ``"meta"`` (tensors with shapes and no data: the launch tools'
    dry run) is taken only where a caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r}: no CUDA device is available "
            "(pass device='cpu' to run the plain PyTorch path)")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"device={str(device)!r}: pick 'cuda' or 'cpu' "
                         "(or 'meta' for a shape-only dry run)")
    return dev


def rank_device(device_type, rank: int, backend=None) -> torch.device:
    """Tensor-parallel rank ``rank``'s device for ``device_type``: the CPU
    when the caller asks for it; on the card, ``cuda:rank`` under nccl
    (one card a rank), and under gloo the card ``rank`` mod the count —
    every rank on ``cuda:0`` when the machine has one card.  Raises, as
    :func:`resolve_device` does, when no card is present."""
    dev = resolve_device(device_type)
    if dev.type != "cuda":
        return dev
    count = torch.cuda.device_count()
    if backend == "nccl":
        if rank >= count:
            raise RuntimeError(f"rank {rank} under nccl needs card {rank}; "
                               f"{count} visible")
        return torch.device("cuda", rank)
    return torch.device("cuda", rank % count)
