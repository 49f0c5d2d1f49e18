"""Weights bridge: a parameter tree (or a whole train state) handed over
as numpy becomes the port's tree, leaf for leaf, in the same layout.

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


def _tensor(arr):
    """A numpy array as a fresh CPU tensor; ml_dtypes' ``bfloat16`` (what
    the reference's bf16 leaves become in numpy), which torch cannot read,
    goes over by its bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.tensor(arr)


def params_from_numpy(tree, cfg, device="cuda", dtype=None):
    """``tree``: dict/tuple tree of numpy arrays (the reference layout).
    Returns the same tree of torch tensors on ``device``; floating leaves
    become ``dtype`` (default ``cfg.dtype``)."""
    device = resolve_device(device)
    dtype = getattr(torch, dtype or cfg.dtype)

    def conv(meta, leaf, path):
        if isinstance(meta, LeafMeta):
            t = _tensor(leaf)                       # a copy
            if tuple(t.shape) != tuple(meta.shape):
                raise ValueError(f"{path}: shape {tuple(t.shape)} != "
                                 f"{meta.shape}")
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


def train_state_from_numpy(tree, cfg, device="cuda"):
    """The reference's ``init_train_state`` tree (``{"params", "opt":
    {"m", "v"}, "step"}``, as numpy) as the port's train state: master
    params in ``cfg.param_dtype`` (not ``cfg.dtype``, which is the compute
    copy's), m and v in ``cfg.opt_dtype``, ``step`` a 0-d int32 tensor."""
    device = resolve_device(device)
    return {
        "params": params_from_numpy(tree["params"], cfg, device,
                                    cfg.param_dtype),
        "opt": {k: params_from_numpy(tree["opt"][k], cfg, device,
                                     cfg.opt_dtype) for k in ("m", "v")},
        "step": torch.tensor(int(np.asarray(tree["step"])),
                             dtype=torch.int32, device=device),
    }
