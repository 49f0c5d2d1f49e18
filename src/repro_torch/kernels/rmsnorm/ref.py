"""Plain PyTorch RMSNorm — the math of ``repro/models/layers.py::rms_norm``
(the Pallas kernel's oracle): statistics in f32, output in x's dtype."""
from __future__ import annotations

import torch


def rms_norm_ref(x, w, eps=1e-5):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)
