"""Wrapper of the Triton RMSNorm kernel: any ``(..., D)`` shape.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
launches the kernel or raises — there is no fallback."""
from __future__ import annotations

import torch

from ..counter import LaunchCounter
from .kernel import MAX_D, launch
from .ref import rms_norm_ref

_DTYPES = (torch.float32, torch.bfloat16)


def rms_norm(x, w, eps=1e-5):
    if x.device.type == "cpu":
        return rms_norm_ref(x, w, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"rms_norm: no kernel for device {x.device}")
    d = x.shape[-1]
    if d > MAX_D:
        raise ValueError(f"rms_norm kernel: D={d} exceeds {MAX_D}")
    if w.shape != (d,) or w.device != x.device:
        raise ValueError(f"weight {tuple(w.shape)} on {w.device} does not "
                         f"match x {tuple(x.shape)} on {x.device}")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"rms_norm kernel: dtypes {x.dtype}/{w.dtype}")
    x2 = x.reshape(-1, d)
    if x2.stride(-1) != 1:
        raise ValueError("rms_norm kernel: rows must be contiguous")
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    if x2.shape[0]:
        launch(x2, w.contiguous(), out, eps)
        rms_norm.launches.add()
    return out.reshape(x.shape)


rms_norm.launches = LaunchCounter()
