"""Weights bridge: a parameter tree (or a whole train state) handed over
as numpy becomes the port's tree, leaf for leaf, in the same layout.

The reference's ``repro.models.lm.init_params`` tree (converted to numpy
by the caller) carries flat ``(d, H*dh)`` projections stacked on a
leading ``n_repeats`` axis — exactly the layout ``repro_torch.models.lm``
consumes, so nothing is reshaped here; every leaf is checked against
``param_meta``.

Under a tensor-parallel mesh (``launch.mesh``) a rank holds only its
shard: :func:`shard_params` cuts each leaf by its logical axes under
``steps.TP_SERVE_RULES`` (strictly: a dim that does not split evenly
stays whole), and the SSD mixer's leaves by the port's own layout
(``models.ssm.TP_LOCAL``).  A train state on a data mesh (FSDP) is cut
by :func:`shard_train_state` under the reference's ``LOGICAL_RULES``
(``"fsdp"`` -> ``data``).
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.layers import tree_map
from .models.lm import LeafMeta, _is_meta, param_meta
from .models.ssm import TP_LOCAL, tp_local
from .sharding import local_shard, logical_spec
from .steps import (TP_SERVE_RULES, check_tp, check_train_mesh, data_size,
                    model_size)


def _tensor(arr):
    """A numpy array as a fresh CPU tensor; ml_dtypes' ``bfloat16`` (what
    the reference's bf16 leaves become in numpy), which torch cannot read,
    goes over by its bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.tensor(arr)


def shard_params(tree, cfg, mesh):
    """This rank's shard of the full parameter tree ``tree`` (torch
    tensors in the reference layout) on ``mesh`` (``mesh.coords`` names
    the rank): every leaf cut to its block, copied, so that the full
    tree can be freed.  The tree itself without a mesh or on a model axis
    of 1.  Raises where ``steps.check_tp`` refuses the config."""
    check_tp(cfg, mesh)
    n = model_size(mesh)
    if n == 1:
        return tree
    ssm_blocks = {i for i, spec in enumerate(cfg.pattern)
                  if spec.kind == "ssm"}

    def cut(meta, t, name, ssm):
        if ssm and name in TP_LOCAL:
            out = tp_local(name, t, cfg, mesh.coords["model"], n)
        else:
            spec = logical_spec(meta.shape, meta.axes, mesh, TP_SERVE_RULES,
                                strict=True)
            out = local_shard(t, spec, mesh)
        return out.clone(memory_format=torch.contiguous_format)

    def walk(meta, t, name="", ssm=False):
        if isinstance(meta, LeafMeta):
            return cut(meta, t, name, ssm)
        if isinstance(meta, dict):
            return {k: walk(meta[k], t[k], k, ssm) for k in meta}
        return tuple(walk(m, x) for m, x in zip(meta, t))

    meta = param_meta(cfg)
    out = {k: walk(meta[k], tree[k], k) for k in meta if k != "blocks"}
    out["blocks"] = tuple(
        {part: {k: walk(bm[part][k], tree["blocks"][i][part][k], k,
                        part == "mixer" and i in ssm_blocks)
                for k in bm[part]}
         for part in bm}
        for i, bm in enumerate(meta["blocks"]))
    return out


def params_from_numpy(tree, cfg, device="cuda", dtype=None, mesh=None):
    """``tree``: dict/tuple tree of numpy arrays (the reference layout).
    Returns the same tree of torch tensors on ``device``; floating leaves
    become ``dtype`` (default ``cfg.dtype``).  With ``mesh``, each leaf
    is this rank's shard (:func:`shard_params`), cut on the host before
    it moves to ``device``."""
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
            return t
        if isinstance(meta, dict):
            if set(meta) != set(leaf):
                raise ValueError(f"{path}: keys {sorted(leaf)} != "
                                 f"{sorted(meta)}")
            return {k: conv(meta[k], leaf[k], f"{path}/{k}") for k in meta}
        if len(meta) != len(leaf):
            raise ValueError(f"{path}: {len(leaf)} entries != {len(meta)}")
        return tuple(conv(m, x, f"{path}[{i}]")
                     for i, (m, x) in enumerate(zip(meta, leaf)))

    host = shard_params(conv(param_meta(cfg), tree, "params"), cfg, mesh)
    return _to(host, device)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, device) for v in tree)
    return tree.to(device)


def fsdp_shard(tree, cfg, mesh):
    """This rank's blocks of a whole parameter-shaped tree (params, m or v)
    on a data mesh: each leaf cut by its logical axes under the
    reference's ``LOGICAL_RULES`` (``"fsdp"`` -> ``data``) strictly, so a
    dim that ``data`` does not divide stays whole; each block copied, so
    that the whole tree can be freed."""
    def cut(m, t):
        spec = logical_spec(m.shape, m.axes, mesh, strict=True)
        return local_shard(t, spec, mesh).clone(
            memory_format=torch.contiguous_format)

    return tree_map(cut, param_meta(cfg), tree, is_leaf=_is_meta)


def shard_train_state(tree, cfg, mesh):
    """This rank's shard of the whole train state ``tree`` (``{"params",
    "opt": {"m", "v"}, "step"}``, torch tensors) on a data mesh: params, m
    and v cut alike (:func:`fsdp_shard`), ``step`` copied whole.  The tree
    itself without a mesh or on a data axis of 1; raises where
    ``steps.check_train_mesh`` refuses."""
    check_train_mesh(cfg, mesh)
    if data_size(mesh) == 1:
        return tree
    return {"params": fsdp_shard(tree["params"], cfg, mesh),
            "opt": {k: fsdp_shard(tree["opt"][k], cfg, mesh)
                    for k in ("m", "v")},
            "step": tree["step"].clone()}


def train_state_from_numpy(tree, cfg, device="cuda", mesh=None):
    """The reference's ``init_train_state`` tree (``{"params", "opt":
    {"m", "v"}, "step"}``, as numpy) as the port's train state: master
    params in ``cfg.param_dtype`` (not ``cfg.dtype``, which is the compute
    copy's), m and v in ``cfg.opt_dtype``, ``step`` a 0-d int32 tensor.
    With ``mesh`` (a data mesh), this rank's shard
    (:func:`shard_train_state`), cut on the host before it moves to
    ``device``."""
    device = resolve_device(device)
    host = {
        "params": params_from_numpy(tree["params"], cfg, "cpu",
                                    cfg.param_dtype),
        "opt": {k: params_from_numpy(tree["opt"][k], cfg, "cpu",
                                     cfg.opt_dtype) for k in ("m", "v")},
        "step": torch.tensor(int(np.asarray(tree["step"])),
                             dtype=torch.int32),
    }
    return _to(shard_train_state(host, cfg, mesh), device)
