"""AdamW with decoupled weight decay, global-norm clipping and a
warmup+cosine schedule (PyTorch port of ``repro/optim/adamw.py``).

Trees are the port's dict/tuple trees of tensors.  The math is the
reference's, in f32, with m and v stored in ``opt_dtype``; the schedule
and the bias corrections are 0-d f32 tensors on the step's device, so a
step never waits for the host.  Unlike the reference, ``adamw_update``
updates params, m and v in place (the master weights and both moments
are the bulk of a training card's memory; a second copy would not fit at
full width) and returns the same trees.

On a mesh (``sharding.fsdp.Plan``) each rank holds its blocks of
params, grads, m and v: the update stays elementwise on them, so a leaf
that is whole and equal on every model rank, with a gradient that is
too, stays bit-equal across them; and the clip norm is the whole
gradient's (the reference's, whose leaves are whole): each leaf's
squares summed over the axes it is split on, its parts that are whole
on an axis counted once (the SSD mixer's B and C columns, whole on every
model rank inside leaves whose x channels are split: ``TPSplit.width``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.layers import tree_leaves, tree_map
from ..sharding.fsdp import data_sum, model_parts, model_sum


class OptHParams(NamedTuple):
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    min_lr_frac: float = 0.1


def lr_schedule(step, hp: OptHParams):
    """Linear warmup to ``hp.lr``, then cosine down to ``min_lr_frac``;
    a 0-d f32 tensor (on ``step``'s device when it is a tensor)."""
    step = torch.as_tensor(step).float()
    warm = hp.lr * (step + 1) / max(hp.warmup, 1)
    t = ((step - hp.warmup) / max(hp.total_steps - hp.warmup, 1)).clamp(
        0.0, 1.0)
    cos = hp.lr * (hp.min_lr_frac + (1 - hp.min_lr_frac) * 0.5 *
                   (1 + torch.cos(math.pi * t)))
    return torch.where(step < hp.warmup, warm, cos)


def adamw_init(params, opt_dtype="float32"):
    dt = getattr(torch, opt_dtype) if isinstance(opt_dtype, str) \
        else opt_dtype
    zeros = lambda p: torch.zeros(p.shape, dtype=dt,  # noqa: E731
                                  device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def _sq(x):
    return torch.linalg.vector_norm(x, dtype=torch.float32).square()


def global_norm(tree, plan=None):
    """sqrt of the sum of squares of every leaf, in f32 (0-d tensor).
    ``plan`` (a ``sharding.fsdp.Plan``): ``tree`` holds this rank's blocks.
    Each leaf's squares are taken in two parts, the part split over
    ``model`` (summed over it, in one all-reduce of every leaf's) and the
    part whole on every model rank (counted once); then the leaves split
    over ``data`` are summed over it (one all-reduce), and the leaves
    whole there counted once.  Every rank gets the same bits."""
    leaves = tree_leaves(tree)
    if plan is None:
        return torch.stack([_sq(x) for x in leaves]).sum().sqrt()
    zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    parts = [[zero if p is None else _sq(p) for p in model_parts(
        x, sp, plan.mesh.shape["model"])]
        for x, sp in zip(leaves, tree_leaves(plan.tp))]
    split, whole = (torch.stack(col) for col in zip(*parts))
    sq = model_sum(split, plan.mesh) + whole
    # the leaves split over data, and the rest, picked by index (a
    # boolean mask has no shape on meta, where the dry run takes it)
    dims = tree_leaves(plan.dims)
    on, off = (torch.tensor([i for i, d in enumerate(dims)
                             if (d is None) == whole],
                            dtype=torch.long, device=sq.device)
               for whole in (False, True))
    part = data_sum(sq.index_select(0, on).sum().reshape(1), plan.mesh)[0]
    return (part + sq.index_select(0, off).sum()).sqrt()


@torch.no_grad()
def adamw_update(grads, opt_state, params, step, hp: OptHParams,
                 plan=None):
    """One AdamW step, in place: params, ``opt_state["m"]`` and ``["v"]``
    are updated where they lie; ``grads`` are read, not written.  Returns
    (params, opt_state, metrics) with metrics ``grad_norm`` (before
    clipping) and ``lr``, 0-d f32 tensors.  ``plan``: the trees are this
    rank's shards on a mesh (:func:`global_norm`)."""
    gnorm = global_norm(grads, plan)
    scale = torch.clamp(hp.clip_norm / (gnorm + 1e-9), max=1.0)
    step = torch.as_tensor(step, device=gnorm.device)
    lr = lr_schedule(step, hp)
    b1, b2 = hp.b1, hp.b2
    sf = (step + 1).float()
    bc1 = 1 - torch.pow(b1, sf)
    bc2 = 1 - torch.pow(b2, sf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        g = g.float() * scale
        m32, v32 = m.float(), v.float()      # the leaves themselves in f32
        m32.mul_(b1).add_(g, alpha=1 - b1)
        v32.mul_(b2).addcmul_(g, g, value=1 - b2)
        del g
        delta = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(hp.eps))
        p32 = p.float()
        p32.sub_(delta.add_(p32, alpha=hp.weight_decay).mul_(lr))
        for dst, src in ((p, p32), (m, m32), (v, v32)):
            if dst is not src:
                dst.copy_(src)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
