"""FSDP over the mesh's ``data`` axis: the reference's ``"fsdp"`` rule
(``repro/sharding/rules.py``: each weight's d_model / fan-in axis on
``data``) on processes that each hold their own block.

The reference cuts each weight's "fsdp" dim over ``data`` and leaves it
to GSPMD to gather the weight where it is used and to reduce its
gradient.  The port runs one process per rank, so both are written out:

* :func:`data_dims`: per leaf of a parameter meta tree, the dim that
  ``"fsdp"`` splits over ``data`` under ``LOGICAL_RULES``, resolved
  strictly (``_resolve_dim(strict=True)``), or None for a leaf the rule
  leaves whole: a dim ``data`` does not divide, norm weights, biases.
  The same dims cut AdamW's ``m`` and ``v`` (``params.shard_train_state``).
* :func:`gather`: one autograd op.  Forward: every rank's block of a
  leaf, in rank order, concatenated along its dim (an all-gather in the
  leaf's dtype: callers gather the compute copy, bf16 on the card, not
  the f32 master).  Backward: the gathered leaf's gradient upcast to
  f32, summed over the data ranks, and this rank's block kept.  Gloo has
  no CUDA ``reduce_scatter``, so the sum is an all-reduce plus a slice,
  on both backends (a reduce-scatter under nccl waits for a machine with
  two cards).  Autograd hands the block back in the leaf's dtype, and
  the cast's backward upcasts it to the master's f32 gradient.
* :func:`data_sum`: a sum over the data ranks in place: whole leaves'
  gradients, the labelled-token counts, the loss, the clip norm's
  squares.

Every gather and every reduction is counted, with the bytes it carries
(``gather.calls`` / ``gather.bytes``, ``data_sum.calls`` /
``data_sum.bytes``).  The collectives run over all of the mesh's ranks,
so its model axis must be 1 (``steps.check_train_mesh``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.counter import LaunchCounter
from .rules import logical_spec


class Plan(NamedTuple):
    """A train state's layout on a data mesh: the mesh and, per parameter
    leaf, the dim split over ``data`` (None: whole on every rank)."""
    mesh: object
    dims: object

    def state_dims(self):
        """The dims of a train state ``{"params", "opt": {"m", "v"},
        "step"}``: m and v split as the params, ``step`` whole."""
        return {"params": self.dims,
                "opt": {"m": self.dims, "v": self.dims}, "step": None}


def _is_meta(x):
    return hasattr(x, "axes") and hasattr(x, "shape")


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(t[k] for t in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map(fn, v, *(t[i] for t in rest))
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


def data_dims(meta, mesh):
    """The dim each leaf of ``meta`` (a tree of leaves with ``shape`` and
    logical ``axes``: ``models.lm.param_meta``) splits over ``data`` on
    ``mesh``, strictly, or None where it stays whole."""
    def dim(m):
        spec = logical_spec(m.shape, m.axes, mesh, strict=True)
        for d, part in enumerate(spec):
            names = (part,) if isinstance(part, str) else part or ()
            if "data" in names:
                return d
        return None

    def walk(t):
        if _is_meta(t):
            return dim(t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return tuple(walk(v) for v in t)

    return walk(meta)


def block(t, dim, mesh):
    """This rank's block of the whole tensor ``t`` along ``dim``."""
    n = mesh.shape["data"]
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"{n} ways")
    step = t.shape[dim] // n
    return t.narrow(dim, mesh.coords["data"] * step, step)


def data_sum(t, mesh):
    """Sum ``t`` over the data ranks, in place (one all-reduce, counted);
    returns it."""
    data_sum.calls.add()
    data_sum.bytes.add(t.numel() * t.element_size())
    return mesh.all_reduce(t)


def gather_blocks(local, dim, mesh):
    """Every rank's ``local``, in rank order, along ``dim`` (one
    all-gather, counted)."""
    out = torch.cat(mesh.all_gather(local), dim=dim)
    gather.calls.add()
    gather.bytes.add(out.numel() * out.element_size())
    return out


def sum_blocks(grad, dim, mesh):
    """This rank's block of ``grad`` summed over the data ranks, in f32:
    an all-reduce and a slice."""
    return block(data_sum(grad.float().contiguous(), mesh), dim, mesh)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return gather_blocks(local.contiguous(), dim, mesh)

    @staticmethod
    def backward(ctx, grad):
        return sum_blocks(grad, ctx.dim, ctx.mesh), None, None


def gather(local, dim, mesh):
    """The whole leaf from every rank's block ``local`` along ``dim``
    (autograd: the gradient's f32 sum over the ranks, this rank's block;
    see the module's docstring)."""
    return _Gather.apply(local, dim, mesh)


def take(tree, dims, mesh, index=None):
    """``tree`` with each split leaf (``dims`` not None) gathered whole;
    ``index``: each leaf's ``[index]`` first (one repeat of a stacked
    block, whose split dim moves down by one)."""
    def one(t, d):
        if index is not None:
            t, d = t[index], None if d is None else d - 1
        return t if d is None else gather(t, d, mesh)

    return _map(one, tree, dims)


def whole_on_host(t, dim, mesh):
    """Rank 0: the whole leaf on the host, assembled from every rank's
    block (``dim`` None: this rank's copy, whole already).  Every rank
    must call it in the same order: it gathers over the data plane.
    Returns None on the other ranks."""
    if dim is not None:
        t = gather_blocks(t.contiguous(), dim, mesh)
    return t.to("cpu", copy=True) if mesh.rank == 0 else None


gather.calls = LaunchCounter()
gather.bytes = LaunchCounter()
data_sum.calls = LaunchCounter()
data_sum.bytes = LaunchCounter()

__all__ = ["Plan", "data_dims", "block", "data_sum", "gather", "take",
           "gather_blocks", "sum_blocks", "whole_on_host"]
