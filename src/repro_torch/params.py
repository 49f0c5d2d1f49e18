"""Weights bridge: a parameter tree (or a whole train state) handed over
as numpy becomes the port's tree, leaf for leaf, in the same layout.

The reference's ``repro.models.lm.init_params`` tree (converted to numpy
by the caller) carries flat ``(d, H*dh)`` projections stacked on a
leading ``n_repeats`` axis — exactly the layout ``repro_torch.models.lm``
consumes, so nothing is reshaped here; every leaf is checked against
``param_meta``.

On a mesh (``launch.mesh``) a rank holds only its shard, by the layout
of ``steps.train_plan``: each leaf's logical axes under the reference's
``LOGICAL_RULES``, strictly (a dim that does not split evenly stays
whole; ``"tp"``, ``heads``, ``vocab``, ``ssm_heads`` -> ``model``,
``"fsdp"`` -> ``data``), the SSD mixer's leaves by the port's own
layout (``models.ssm.TP_LOCAL``).  Serving cuts the weights over
``model`` (:func:`shard_params`; its rules differ from training's only
in activations' axes), training cuts a whole train state over both
axes (:func:`shard_train_state`).
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.layers import tree_map
from .models.lm import LeafMeta, param_meta
from .sharding.fsdp import shard_leaf
from .steps import check_tp, model_size, tp_splits, train_plan


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
    the rank): every leaf cut to its block over ``model``
    (``steps.tp_splits``), copied, so that the full tree can be freed.
    The tree itself without a mesh or on a model axis of 1.  Raises where
    ``steps.check_tp`` refuses the config."""
    check_tp(cfg, mesh)
    if model_size(mesh) == 1:
        return tree
    return tree_map(lambda t, sp: shard_leaf(t, None, sp, mesh), tree,
                    tp_splits(cfg, mesh))


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


def train_shard(tree, cfg, mesh):
    """This rank's blocks of a whole parameter-shaped tree (params, m or v)
    on a mesh, by the step's layout (``steps.train_plan``): each leaf cut
    over ``model`` (its logical axes under the reference's
    ``LOGICAL_RULES``, strictly, or ``models.ssm.TP_LOCAL``), then over
    ``data`` (its ``"fsdp"`` dim), so a dim an axis does not divide stays
    whole on it; each block copied, so that the whole tree can be
    freed.  The tree itself without a mesh or on one rank."""
    plan = train_plan(cfg, mesh)
    if plan is None:
        return tree
    return tree_map(lambda t, d, sp: shard_leaf(t, d, sp, mesh), tree,
                    plan.dims, plan.tp)


def shard_train_state(tree, cfg, mesh):
    """This rank's shard of the whole train state ``tree`` (``{"params",
    "opt": {"m", "v"}, "step"}``, torch tensors) on a mesh: params, m and
    v cut alike (:func:`train_shard`), ``step`` copied whole.  The tree
    itself without a mesh or on one rank; raises where
    ``steps.check_train_mesh`` refuses."""
    if train_plan(cfg, mesh) is None:
        return tree
    return {"params": train_shard(tree["params"], cfg, mesh),
            "opt": {k: train_shard(tree["opt"][k], cfg, mesh)
                    for k in ("m", "v")},
            "step": tree["step"].clone()}


def train_state_from_numpy(tree, cfg, device="cuda", mesh=None):
    """The reference's ``init_train_state`` tree (``{"params", "opt":
    {"m", "v"}, "step"}``, as numpy) as the port's train state: master
    params in ``cfg.param_dtype`` (not ``cfg.dtype``, which is the compute
    copy's), m and v in ``cfg.opt_dtype``, ``step`` a 0-d int32 tensor.
    With ``mesh``, this rank's shard
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
