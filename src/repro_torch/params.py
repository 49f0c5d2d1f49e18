"""Weights bridge: a parameter tree handed over as numpy becomes the
port's tree, leaf for leaf, in the same layout.

The reference's ``repro.models.lm.init_params`` tree (converted to numpy
by the caller) carries flat ``(d, H*dh)`` projections stacked on a
leading ``n_repeats`` axis — exactly the layout ``repro_torch.models.lm``
consumes, so nothing is reshaped here; every leaf is checked against
``param_meta``.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.lm import LeafMeta, param_meta


def params_from_numpy(tree, cfg, device="cuda", dtype=None):
    """``tree``: dict/tuple tree of numpy arrays (the reference layout).
    Returns the same tree of torch tensors on ``device``; floating leaves
    become ``dtype`` (default ``cfg.dtype``)."""
    device = resolve_device(device)
    dtype = getattr(torch, dtype or cfg.dtype)

    def conv(meta, leaf, path):
        if isinstance(meta, LeafMeta):
            arr = np.asarray(leaf)
            if tuple(arr.shape) != tuple(meta.shape):
                raise ValueError(f"{path}: shape {arr.shape} != "
                                 f"{meta.shape}")
            t = torch.tensor(arr)                   # a copy
            if t.is_floating_point():
                t = t.to(dtype)
            return t.to(device)
        if isinstance(meta, dict):
            if set(meta) != set(leaf):
                raise ValueError(f"{path}: keys {sorted(leaf)} != "
                                 f"{sorted(meta)}")
            return {k: conv(meta[k], leaf[k], f"{path}/{k}") for k in meta}
        if len(meta) != len(leaf):
            raise ValueError(f"{path}: {len(leaf)} entries != {len(meta)}")
        return tuple(conv(m, x, f"{path}[{i}]")
                     for i, (m, x) in enumerate(zip(meta, leaf)))

    return conv(param_meta(cfg), tree, "params")
